"""Forward attention in the standard (B, S, H, hd) layout: the contract of
the JAX package's ``kernels/flash_attention/ops.py::flash_attention_op``,
layout-compatible with ``models/attention.py::chunked_attention``."""
from __future__ import annotations

from .kernel import flash_attention

__all__ = ["flash_attention_op"]


def flash_attention_op(
    q, k, v, *, scale: float, causal: bool = True, window=None, chunk: int = 1024
):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, vh) with
    H = KH·g, any strides; returns (B, Sq, H, vh).  ``window`` None or ≤ 0
    means no sliding window.  The plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale=scale, causal=causal,
                           window=max(window or 0, 0), chunk=chunk)
