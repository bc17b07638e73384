"""Budgeted-DP kernels (paper Algorithm 2) for Hopper, with their plain
PyTorch versions (``ref``), the tile choice (``tiling``) and the solve
wrappers (``ops``: the cold solve and the warm-started one)."""
from .kernel import (LAUNCHES, dp_chunk, dp_edge, dp_epilogue,
                     dp_forward_batched, dp_forward_blocked,
                     dp_forward_fused, epilogue_table)
from .ops import (VALUE_BOUND, WarmCudaSolver, check_horizon_value_bound,
                  max_achievable_value, prepare_tables,
                  solve_budgeted_dp_batched, validate_value_row)
from .tiling import (SMEM_LIMIT_BYTES, check_tiling, choose_tiling,
                     fused_smem_bytes, whole_plane_smem_bytes)

__all__ = ["LAUNCHES", "dp_forward_batched", "dp_edge", "dp_chunk",
           "dp_forward_blocked", "dp_forward_fused", "dp_epilogue",
           "epilogue_table", "VALUE_BOUND", "prepare_tables",
           "max_achievable_value", "check_horizon_value_bound",
           "validate_value_row", "solve_budgeted_dp_batched",
           "WarmCudaSolver",
           "SMEM_LIMIT_BYTES", "check_tiling", "choose_tiling",
           "fused_smem_bytes", "whole_plane_smem_bytes"]
