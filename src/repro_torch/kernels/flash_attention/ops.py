"""Forward attention in the standard (B, S, H, hd) layout: the contract of
the JAX package's ``kernels/flash_attention/ops.py::flash_attention_op``,
layout-compatible with ``models/attention.py::chunked_attention`` — and,
for training, its gradient under autograd (:class:`FlashAttentionFn`)."""
from __future__ import annotations

import torch

from .kernel import flash_attention, flash_attention_bwd

__all__ = ["FlashAttentionFn", "flash_attention_op"]


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a hand-written backward.  Forward: the kernel (on the
    CPU its plain version) with each row's log-sum-exp; it saves q, k, v,
    the output and the log-sum-exp.  Backward: ``flash_attention_bwd``,
    the backward kernel on the card (``ref.flash_attention_bwd_ref`` on the
    CPU); a CUDA tensor reaches the kernel or raises.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass, and its launch counts again."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, chunk):
        out, lse = flash_attention(q, k, v, scale=scale, causal=causal,
                                   window=window, chunk=chunk,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(scale=scale, causal=causal, window=window, chunk=chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_op(
    q, k, v, *, scale: float, causal: bool = True, window=None, chunk: int = 1024
):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, vh) with
    H = KH·g, any strides; returns (B, Sq, H, vh).  ``window`` None or ≤ 0
    means no sliding window.  The plain version for CPU tensors, the CUDA
    kernel for CUDA tensors; through :class:`FlashAttentionFn` when a
    gradient is wanted, else the forward alone (no log-sum-exp)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    window = max(window or 0, 0)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, scale, causal, window, chunk)
    return flash_attention(q, k, v, scale=scale, causal=causal,
                           window=window, chunk=chunk)
