"""Forward flash attention (K6) for Hopper, with its plain PyTorch version
(``ref``)."""
from .kernel import (LAUNCHES, LIBRARY, MAX_HEAD_DIM, TF32_LIBRARY,
                     WGMMA_LIBRARY, flash_attention, kernel_for, zero_pad)
from .ops import flash_attention_op
from .ref import flash_attention_ref

__all__ = ["LAUNCHES", "LIBRARY", "MAX_HEAD_DIM", "TF32_LIBRARY",
           "WGMMA_LIBRARY", "flash_attention", "flash_attention_op",
           "flash_attention_ref", "kernel_for", "zero_pad"]
