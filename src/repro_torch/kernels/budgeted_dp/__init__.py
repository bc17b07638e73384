"""Budgeted-DP kernels (paper Algorithm 2) for Hopper, with their plain
PyTorch versions (``ref``) and the solve wrappers (``ops``)."""
from .kernel import (LAUNCHES, SMEM_LIMIT_BYTES, dp_epilogue, dp_forward,
                     dp_forward_batched, smem_bytes)
from .ops import (VALUE_BOUND, max_achievable_value, prepare_tables,
                  solve_budgeted_dp_batched, solve_budgeted_dp_kernel,
                  validate_value_row)

__all__ = ["LAUNCHES", "SMEM_LIMIT_BYTES", "smem_bytes", "dp_forward",
           "dp_forward_batched", "dp_epilogue", "VALUE_BOUND",
           "prepare_tables", "max_achievable_value", "validate_value_row",
           "solve_budgeted_dp_kernel", "solve_budgeted_dp_batched"]
