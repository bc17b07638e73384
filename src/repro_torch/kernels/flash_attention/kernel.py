"""Wrapper of the flash-attention CUDA kernels, K6's counterparts.

Two kernels, chosen by the dtype alone (:func:`kernel_for`), both on the
tensor cores and both for hd a multiple of 8 up to 256:

- ``flash_attention_wgmma`` (``csrc/flash_attention_wgmma.cu``): bf16 q,
  k, v; both products on ``wgmma``, K/V tiles by TMA, hd padded to one to
  four 64-column boxes;
- ``flash_attention_tf32`` (``csrc/flash_attention_tf32.cu``): f32 q, k,
  v; both products in split TF32 (three TF32 products each) on
  ``mma.sync``.

The CUDA-core kernel ``flash_fwd_kernel`` (``csrc/flash_attention.cu``,
``LIBRARY``) runs every product as f32 FMAs.  No input is routed to it:
it stays only as the f32 referee that ``chip_smoke.py`` and the card
tests launch raw, beside the f64 plain version, and its ``LAUNCHES`` entry
stays 0.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor launches its kernel or raises — there is no fallback.  The
wrapper counts each kernel's launches in ``LAUNCHES``.  A v head dim
other than q/k's runs the kernel at the wider of the two, on zero columns
(:func:`flash_attention`).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch
import torch.nn.functional as F

from . import ref
from ..nvcc import CudaLibrary

__all__ = ["LAUNCHES", "LIBRARY", "WGMMA_LIBRARY", "TF32_LIBRARY",
           "MAX_HEAD_DIM", "kernel_for", "zero_pad", "flash_attention"]

# launches of each CUDA kernel by the wrapper (plain-version calls are not
# counted; "flash_attention", the referee, is never launched by it)
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_tf32": 0}

# both kernels: the bf16 one pads hd to at most four 64-column boxes (the
# N = 256 of wgmma's p·V), the f32 one holds hd / 2 accumulator registers
# a thread at most
MAX_HEAD_DIM = 256


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([p] * 4 + [i] * 7
                                           + [ctypes.c_float, i, i, p])
    lib.flash_attention_launch.restype = i


def _declare_tensor_core(fn: str):
    """The declaration of the tensor-core kernels' entry point ``fn``:
    ``int fn(q, k, v, o, B, Sq, Sk, H, KH, hd, float scale, causal,
    window, stream)``."""
    def declare(lib) -> None:
        p, i = ctypes.c_void_p, ctypes.c_int
        entry = getattr(lib, fn)
        entry.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, i, i, p]
        entry.restype = i
    return declare


_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "flash_attention.cu", _declare,
                      "fa_error_string")
WGMMA_LIBRARY = CudaLibrary(
    _CSRC / "flash_attention_wgmma.cu",
    _declare_tensor_core("flash_attention_wgmma_launch"), "faw_error_string")
TF32_LIBRARY = CudaLibrary(
    _CSRC / "flash_attention_tf32.cu",
    _declare_tensor_core("flash_attention_tf32_launch"), "fat_error_string")


def kernel_for(dtype, hd: int) -> str:
    """The kernel that takes q, k, v of ``dtype`` and head dim ``hd`` on the
    card: ``"flash_attention_wgmma"`` for bfloat16, ``"flash_attention_tf32"``
    for float32.  Raises for what neither takes: ``ValueError`` for hd not
    a multiple of 8 up to 256, ``TypeError`` for a dtype other than float32
    and bfloat16."""
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{dtype}: q, k and v must all be float32 or all "
                        "bfloat16")
    if dtype == torch.bfloat16:
        return "flash_attention_wgmma"
    return "flash_attention_tf32"


def zero_pad(q, k, v, width: int):
    """q, k and v with zero columns appended up to head dim ``width``: the
    extra columns add exact zeros to every q·k, and give output columns
    past v's own that the caller cuts away."""
    return tuple(t if t.shape[-1] == width
                 else F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))


def flash_attention(
    q, k, v, *, scale: float, causal: bool = True, window: int = 0, chunk: int = 1024
):
    """Forward attention, f32 online softmax.

    q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, vh) with
    H = KH·g; contiguous, one dtype (float32 or bfloat16), one device;
    max(hd, vh) a multiple of 8 up to 256.  Causal and ``window`` > 0
    masks; query i sits at position i + Sk − Sq.  Returns (B, Sq, H, vh)
    in q's dtype.  On the card the kernel is :func:`kernel_for`'s at
    width max(hd, vh): where vh ≠ hd, the narrower of (q, k) and v gets
    zero columns up to that width, which add exact zeros to q·k and to
    p·v, and the output is cut back to vh.  ``chunk`` is the plain
    version's KV chunk (its summation order); the kernels' tiles are
    their own.
    """
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         "be (B, S, heads, hd)")
    B, Sq, H, hd = q.shape
    _, Sk, KH, _ = k.shape
    if tuple(k.shape) != (B, Sk, KH, hd) or v.dim() != 4 or \
            tuple(v.shape[:3]) != (B, Sk, KH):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, Sk, KH, {hd}) and ({B}, Sk, KH, vh)")
    if KH < 1 or H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    vh = v.shape[-1]
    width = max(hd, vh)
    name = kernel_for(q.dtype, width)
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{t_name} is {t.dtype}: q, k and v must all be "
                            "float32 or all bfloat16")
        if t.device != dev:
            raise ValueError(f"{t_name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{t_name} must be contiguous")
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if vh != hd:
        q, k, v = zero_pad(q, k, v, width)
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:  # both kernels read rows in 16-byte pieces
            raise ValueError(f"{t_name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KH, width, float(scale), int(causal), int(window))
    with torch.cuda.device(dev):  # the libraries launch on the current one
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "flash_attention_wgmma":
            library = WGMMA_LIBRARY
            err = library.load().flash_attention_wgmma_launch(*args, stream)
        else:
            library = TF32_LIBRARY
            err = library.load().flash_attention_tf32_launch(*args, stream)
    library.check(err, name)
    LAUNCHES[name] += 1
    return out if vh == width else out[..., :vh].contiguous()
