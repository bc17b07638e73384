"""The SSD op in the substrate's (B, S, H, P) layout: the contract of the
JAX package's ``kernels/ssd/ops.py::ssd_op`` and
``models/ssm.py::ssd_chunked`` (B/C shared across heads) — and, for
training, its gradient under autograd (:class:`SsdFn`)."""
from __future__ import annotations

import torch

from .kernel import ssd_bwd, ssd_scan, ssd_scan_saved

__all__ = ["SsdFn", "ssd_op"]


class SsdFn(torch.autograd.Function):
    """The SSD scan with a hand-written backward.  Forward: the kernels
    (on the CPU the plain version); on the card it keeps the forward's
    chunk states and cum.  Backward: ``ssd_bwd``, the backward kernels on
    the card (``ref.ssd_bwd_ref`` on the CPU); a CUDA tensor reaches the
    kernels or raises.  The gradients of x, B_ and C_ come back as plain
    contiguous tensors, also where the inputs were strided views of one
    tensor (the model's split): autograd's split joins them."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, chunk):
        y, state, states, cum = ssd_scan_saved(x, dt, A, B_, C_, chunk)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B_, C_, states, cum)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B_, C_, states, cum = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC = ssd_bwd(x, dt, A, B_, C_, ctx.chunk, dy,
                                      dstate, states, cum)
        return dx, ddt, dA, dB, dC, None


def ssd_op(x, dt, A, B_, C_, chunk: int):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); B_/C_: (B, S, N), any float
    dtype (computed in f32; f32 views are read as they are).  Returns
    (y (B,S,H,P) f32, final_state (B,H,N,P) f32): the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors; through :class:`SsdFn`
    when a gradient is wanted."""
    args = (x.float(), dt.float(), A.float(), B_.float(), C_.float())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SsdFn.apply(*args, chunk)
    return ssd_scan(*args, chunk)
