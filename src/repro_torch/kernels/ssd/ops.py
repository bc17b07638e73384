"""The SSD op in the substrate's (B, S, H, P) layout: the contract of the
JAX package's ``kernels/ssd/ops.py::ssd_op`` and
``models/ssm.py::ssd_chunked`` (B/C shared across heads)."""
from __future__ import annotations

from .kernel import ssd_scan

__all__ = ["ssd_op"]


def ssd_op(x, dt, A, B_, C_, chunk: int):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); B_/C_: (B, S, N), any float
    dtype (computed in f32; f32 views are read as they are).  Returns
    (y (B,S,H,P) f32, final_state (B,H,N,P) f32): the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    return ssd_scan(x.float(), dt.float(), A.float(), B_.float(),
                    C_.float(), chunk)
