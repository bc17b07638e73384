"""Wrapper of the SSD CUDA kernel (``csrc/ssd.cu``), K7's counterpart.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor launches the kernel or raises — there is no fallback.  The
wrapper counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from ..nvcc import SMEM_LIMIT_BYTES, CudaLibrary

__all__ = ["LAUNCHES", "LIBRARY", "smem_bytes", "ssd_scan"]

# launches of the CUDA kernel (plain-version calls are not counted)
LAUNCHES = {"ssd_scan": 0}


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = ([p, ll, ll, ll, p, ll, ll, ll, p, p, ll,
                                     ll, p, ll, ll, p, p] + [i] * 6 + [p])
    lib.ssd_scan_launch.restype = i


LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "ssd.cu", _declare,
    "ssd_error_string")


def smem_bytes(P: int, N: int, Q: int) -> int:
    """Shared memory of one block (``ssd_smem_bytes`` in the source), f32:
    with Qp = Q rounded up to 8, the chunk's x (Qp, P), C and B transposed
    (N, Qp + 4), B (Qp, N), M (Qp, Qp), the state (N, P) and three (Qp,)
    vectors."""
    Qp = -(-Q // 8) * 8
    return 4 * (Qp * P + 2 * N * (Qp + 4) + Qp * N + Qp * Qp + N * P
                + 3 * Qp)


def _check(name, t, ndim, dev):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def ssd_scan(x, dt, A, B_, C_, chunk: int):
    """The SSD chunked scan over the model's layouts.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; A: (H,); B_, C_:
    (B, S, N) shared across heads; all f32 on one device, read through
    their strides (innermost stride 1; A contiguous); P and N multiples of
    4.  Chunks of
    Q = min(chunk, S) steps; a ragged last chunk is masked, not padded.
    Returns (y (B, S, H, P), final_state (B, H, N, P)), f32, contiguous.
    Raises ``ValueError`` when a chunk does not fit one block's shared
    memory.
    """
    dev = x.device
    _check("x", x, 4, dev)
    Bb, S, H, P = x.shape
    _check("dt", dt, 3, dev)
    _check("A", A, 1, dev)
    _check("B_", B_, 3, dev)
    _check("C_", C_, 3, dev)
    N = B_.shape[-1]
    for name, t, shape in (("dt", dt, (Bb, S, H)), ("A", A, (H,)),
                           ("B_", B_, (Bb, S, N)), ("C_", C_, (Bb, S, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if chunk < 1 or S < 1:
        raise ValueError(f"chunk={chunk} and S={S} must be positive")
    if P % 4 or N % 4:
        raise ValueError(f"P={P} and N={N} must be multiples of 4 (the "
                         "kernel moves 16-byte vectors)")
    Q = min(chunk, S)
    need = smem_bytes(P, N, Q)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"an SSD chunk of Q={Q}, P={P}, N={N} needs {need} bytes of "
            f"shared memory, over the {SMEM_LIMIT_BYTES}-byte limit of one "
            "block")
    if dev.type == "cpu":
        return ref.ssd_ref(x, dt, A, B_, C_, chunk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if (x.stride(-1) != 1 or B_.stride(-1) != 1 or C_.stride(-1) != 1
            or not A.is_contiguous()):
        raise ValueError("x, B_ and C_ need innermost stride 1 and A must "
                         "be contiguous")
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # the library launches on the current one
        err = LIBRARY.load().ssd_scan_launch(
            x.data_ptr(), *x.stride()[:3], dt.data_ptr(), *dt.stride(),
            A.data_ptr(), B_.data_ptr(), *B_.stride()[:2], C_.data_ptr(),
            *C_.stride()[:2], y.data_ptr(), state.data_ptr(), Bb, S, H, P, N,
            Q, torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, state
