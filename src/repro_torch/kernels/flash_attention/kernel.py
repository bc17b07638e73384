"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``),
K6's counterpart.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor launches the kernel or raises — there is no fallback.  The
wrapper counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from . import ref
from ..nvcc import CudaLibrary

__all__ = ["LAUNCHES", "LIBRARY", "MAX_HEAD_DIM", "flash_attention"]

# launches of the CUDA kernel (plain-version calls are not counted)
LAUNCHES = {"flash_attention": 0}

# the kernel keeps hd / 4 accumulator columns per thread in registers
MAX_HEAD_DIM = 256


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([p] * 4 + [i] * 7
                                           + [ctypes.c_float, i, i, p])
    lib.flash_attention_launch.restype = i


LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    _declare, "fa_error_string")


def flash_attention(
    q, k, v, *, scale: float, causal: bool = True, window: int = 0, chunk: int = 1024
):
    """Forward attention, f32 online softmax.

    q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd) with H = KH·g; contiguous,
    one dtype (float32 or bfloat16), one device; hd a multiple of 8 up to
    256.  Causal and ``window`` > 0 masks; query i sits at position
    i + Sk − Sq.  Returns (B, Sq, H, hd) in q's dtype.  ``chunk`` is the
    plain version's KV chunk (its summation order); the kernel's tiles are
    its own.
    """
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         "be (B, S, heads, hd)")
    B, Sq, H, hd = q.shape
    _, Sk, KH, _ = k.shape
    if tuple(k.shape) != (B, Sk, KH, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, Sk, KH, {hd})")
    if KH < 1 or H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16) or \
                t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}: q, k and v must all be "
                            "float32 or all bfloat16")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):  # the library launches on the current one
        err = LIBRARY.load().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KH, hd,
            float(scale), int(causal), int(window),
            torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
