"""Flash attention (K6) for Hopper, forward and backward, with their plain
PyTorch versions (``ref``)."""
from .kernel import (BWD_LIBRARY, BWD_REFEREE, BWD_ROUTES, LAUNCHES,
                     LIBRARY, MAX_HEAD_DIM, TF32_LIBRARY, WGMMA_LIBRARY,
                     bwd_route, bwd_work, flash_attention,
                     flash_attention_bwd, fwd_work, kernel_for, pairs,
                     zero_pad)
from .ops import FlashAttentionFn, flash_attention_op
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["BWD_LIBRARY", "BWD_REFEREE", "BWD_ROUTES", "FlashAttentionFn",
           "LAUNCHES", "LIBRARY", "MAX_HEAD_DIM", "TF32_LIBRARY",
           "WGMMA_LIBRARY", "bwd_route", "bwd_work", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_op", "flash_attention_ref", "fwd_work",
           "kernel_for", "pairs", "zero_pad"]
