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

For training, both tensor-core kernels also write each row's log-sum-exp
when asked (``return_lse``), and :func:`flash_attention_bwd` launches the
backward (``csrc/flash_attention_bwd.cu``: a preprocess, a dK/dV kernel
and a dQ kernel), counted as ``flash_attention_bwd`` whatever the route.
:func:`bwd_route` picks the route from the dtype alone, both on the tensor
cores: bf16 on ``mma.sync`` m16n8k16, f32 in split TF32 on ``mma.sync``
m16n8k8.  The backward's first, CUDA-core f32 kernels (``BWD_REFEREE``)
take no input: like ``flash_fwd_kernel`` they stay only as a referee that
``chip_smoke.py`` launches raw.  ``ops.FlashAttentionFn`` puts the forward
and the backward under autograd.

Each wrapper allocates its outputs and scratch itself and hands them to a
``torch.library`` operator (``kernels.work.kernel_op``),
``repro_torch::flash_attention_fwd`` or ``::flash_attention_bwd``, that
fills them: on the card it launches the kernel, on the CPU it runs the
plain version, and on the meta device (or under ``FakeTensorMode``) it
does nothing.  So a dry run on meta tensors sees every byte the card
would allocate and launches nothing; and the operators' work
(:func:`fwd_work`, :func:`bwd_work`) is what ``FlopCounterMode`` counts
for them on any device.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch
import torch.nn.functional as F

from . import ref
from ..nvcc import CudaLibrary
from ..work import kernel_op

__all__ = ["LAUNCHES", "LIBRARY", "WGMMA_LIBRARY", "TF32_LIBRARY",
           "BWD_LIBRARY", "BWD_ROUTES", "BWD_REFEREE", "MAX_HEAD_DIM",
           "kernel_for", "bwd_route", "zero_pad", "pairs", "fwd_work",
           "bwd_work", "flash_attention", "flash_attention_bwd"]

# launches of each CUDA kernel by the wrapper (plain-version calls are not
# counted; "flash_attention", the referee, is never launched by it)
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_tf32": 0, "flash_attention_bwd": 0}

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
    ``int fn(q, k, v, o, lse, B, Sq, Sk, H, KH, hd, float scale, causal,
    window, stream)``."""
    def declare(lib) -> None:
        p, i = ctypes.c_void_p, ctypes.c_int
        entry = getattr(lib, fn)
        entry.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, i, i, p]
        entry.restype = i
    return declare


def _declare_bwd(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry, _ in (*BWD_ROUTES.values(), BWD_REFEREE):
        fn = getattr(lib, entry)
        fn.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, i, i, p]
        fn.restype = i


# the backward's route by the inputs' dtype: its C entry point in
# csrc/flash_attention_bwd.cu and the kernels one call launches, in order
BWD_ROUTES = {
    torch.bfloat16: ("flash_attention_bwd_bf16_launch",
                     ("fa_bwd_pre_kernel", "fa_bwd_dkdv_mma_kernel",
                      "fa_bwd_dq_mma_kernel")),
    torch.float32: ("flash_attention_bwd_tf32_launch",
                    ("fa_bwd_pre_kernel", "fa_bwd_dkdv_tf32_kernel",
                     "fa_bwd_dq_tf32_kernel")),
}
# the f32 backward's first kernels, f32 FMAs on the CUDA cores: launched
# raw as a referee, never by the wrapper
BWD_REFEREE = ("flash_attention_bwd_f32_launch",
               ("fa_bwd_pre_kernel", "fa_bwd_dkdv_kernel", "fa_bwd_dq_kernel"))

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "flash_attention.cu", _declare,
                      "fa_error_string")
WGMMA_LIBRARY = CudaLibrary(
    _CSRC / "flash_attention_wgmma.cu",
    _declare_tensor_core("flash_attention_wgmma_launch"), "faw_error_string")
TF32_LIBRARY = CudaLibrary(
    _CSRC / "flash_attention_tf32.cu",
    _declare_tensor_core("flash_attention_tf32_launch"), "fat_error_string")
BWD_LIBRARY = CudaLibrary(_CSRC / "flash_attention_bwd.cu", _declare_bwd,
                          "fab_error_string")


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


def bwd_route(dtype):
    """(C entry point, kernel names) of the backward for q, k, v of
    ``dtype`` on the card, both on the tensor cores: bfloat16 →
    ``mma.sync`` m16n8k16 (bf16 operands, f32 accumulators), float32 →
    ``mma.sync`` m16n8k8 in split TF32 (three TF32 products an f32
    product).  Raises ``TypeError`` for another dtype."""
    if dtype not in BWD_ROUTES:
        raise TypeError(f"{dtype}: q, k and v must all be float32 or all "
                        "bfloat16")
    return BWD_ROUTES[dtype]


def zero_pad(q, k, v, width: int):
    """q, k and v with zero columns appended up to head dim ``width``: the
    extra columns add exact zeros to every q·k, and give output columns
    past v's own that the caller cuts away."""
    return tuple(t if t.shape[-1] == width
                 else F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))


def _check_inputs(q, k, v):
    """(B, Sq, Sk, H, KH, hd, vh, the kernel's name) of valid q, k, v."""
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
    name = kernel_for(q.dtype, max(hd, vh))
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{t_name} is {t.dtype}: q, k and v must all be "
                            "float32 or all bfloat16")
        if t.device != dev:
            raise ValueError(f"{t_name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{t_name} must be contiguous")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return B, Sq, Sk, H, KH, hd, vh, name


def pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs an attention of Sq queries over Sk keys scores:
    all of them bidirectionally; causally, query i (at position
    i + Sk − Sq) the keys up to its own, the last ``window`` of them
    (0: no window) — the sum of min(i + 1 + Sk − Sq, window) over i."""
    if not causal:
        return Sq * Sk
    w = window or Sk
    first = 1 + Sk - Sq  # the keys query 0 sees before the window
    below = min(max(w - first, 0), Sq)  # the queries the window leaves whole
    return below * first + below * (below - 1) // 2 + (Sq - below) * w


def fwd_work(
    B: int,
    Sq: int,
    Sk: int,
    H: int,
    KH: int,
    hd: int,
    vh: int,
    causal: bool,
    window: int,
    itemsize: int,
    lse: bool = False,
) -> tuple[int, int]:
    """(operations, bytes) of the forward: q·k and p·v over the scored
    pairs at the function's own widths (not a padded one), 2 a
    multiply-add; q, k, v read and o (and the log-sum-exp, f32, with
    ``lse``) written once."""
    ops = 2 * (hd + vh) * B * H * pairs(Sq, Sk, causal, window)
    nbytes = itemsize * (B * Sq * H * hd + B * Sk * KH * (hd + vh)
                         + B * Sq * H * vh)
    return ops, nbytes + (4 * B * H * Sq if lse else 0)


def bwd_work(
    B: int,
    Sq: int,
    Sk: int,
    H: int,
    KH: int,
    hd: int,
    vh: int,
    causal: bool,
    window: int,
    itemsize: int,
) -> tuple[int, int]:
    """(operations, bytes) of the backward: the five products over the
    scored pairs (S recomputed and dQ and dK at hd, dP and dV at vh), 2
    a multiply-add; q, k, v, o, dO and the log-sum-exp read and dq, dk,
    dv written once."""
    ops = 2 * (3 * hd + 2 * vh) * B * H * pairs(Sq, Sk, causal, window)
    nbytes = itemsize * 2 * (B * Sq * H * (hd + vh) + B * Sk * KH * (hd + vh))
    return ops, nbytes + 4 * B * H * Sq


def _fwd_impl(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: Optional[torch.Tensor],
    hd: int,
    vh: int,
    scale: float,
    causal: bool,
    window: int,
    chunk: int,
) -> None:
    """Fills ``out`` (and ``lse``): the plain version on the CPU; on the
    card the kernel on q, k, v already padded to the kernel's width."""
    if q.device.type == "cpu":
        got = ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                      window=window, chunk=chunk,
                                      return_lse=lse is not None)
        if lse is None:
            out.copy_(got)
        else:
            out.copy_(got[0])
            lse.copy_(got[1])
        return
    dev = q.device
    B, Sq, H, width = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    name = kernel_for(q.dtype, width)
    for t_name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:  # both kernels read rows in 16-byte pieces
            raise ValueError(f"{t_name} must start on a 16-byte boundary")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KH, width,
            float(scale), int(causal), int(window))
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


def _fwd_op_work(q, k, v, out, lse, hd, vh, scale, causal, window, chunk):
    B, Sq, H, _ = q.shape
    return fwd_work(B, Sq, k.shape[1], H, k.shape[2], hd, vh, causal, window,
                    q.element_size(), lse is not None)


_fwd_op = kernel_op(
    "flash_attention_fwd(Tensor q, Tensor k, Tensor v, Tensor(a!) out, "
    "Tensor(b!)? lse, int hd, int vh, float scale, bool causal, int window, "
    "int chunk) -> ()", _fwd_impl, _fwd_op_work)


def flash_attention(
    q,
    k,
    v,
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
    return_lse: bool = False,
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
    their own.  ``return_lse``: also return each row's natural log-sum-exp
    of the scaled logits, f32 (B, H, Sq), which the backward reads; the
    output's bits are the same either way.  On the meta device the same
    tensors are allocated and nothing is computed.
    """
    B, Sq, Sk, H, KH, hd, vh, _ = _check_inputs(q, k, v)
    dev = q.device
    if dev.type != "cpu" and vh != hd:
        q, k, v = zero_pad(q, k, v, max(hd, vh))
    out = torch.empty((B, Sq, H, v.shape[-1]), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    _fwd_op(q.detach(), k.detach(), v.detach(), out, lse, hd, vh,
            float(scale), bool(causal), int(window), int(chunk))
    if out.shape[-1] != vh:
        out = out[..., :vh].contiguous()
    return (out, lse) if return_lse else out


def _bwd_impl(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    dq: torch.Tensor,
    dk: torch.Tensor,
    dv: torch.Tensor,
    delta: Optional[torch.Tensor],
    hd: int,
    vh: int,
    scale: float,
    causal: bool,
    window: int,
    chunk: int,
) -> None:
    """Fills dq, dk, dv: the plain version on the CPU; on the card the
    backward kernels of :func:`bwd_route` on tensors already padded to
    the kernel's width, with ``delta`` their scratch."""
    if q.device.type == "cpu":
        for dst, got in zip((dq, dk, dv), ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, scale=scale, causal=causal,
                window=window, chunk=chunk)):
            dst.copy_(got)
        return
    dev = q.device
    B, Sq, H, width = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    entry, _ = bwd_route(q.dtype)
    for t_name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{t_name} must start on a 16-byte boundary")
    with torch.cuda.device(dev):
        err = getattr(BWD_LIBRARY.load(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KH, width,
            float(scale), int(causal), int(window),
            torch.cuda.current_stream(dev).cuda_stream)
    BWD_LIBRARY.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1


def _bwd_op_work(
    q, k, v, o, lse, do, dq, dk, dv, delta, hd, vh, scale, causal, window, chunk
):
    B, Sq, H, _ = q.shape
    return bwd_work(B, Sq, k.shape[1], H, k.shape[2], hd, vh, causal, window,
                    q.element_size())


_bwd_op = kernel_op(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
    "Tensor do, Tensor(a!) dq, Tensor(b!) dk, Tensor(c!) dv, "
    "Tensor(d!)? delta, int hd, int vh, float scale, bool causal, "
    "int window, int chunk) -> ()", _bwd_impl, _bwd_op_work)


def flash_attention_bwd(
    q,
    k,
    v,
    o,
    lse,
    do,
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at q, k, v,
    from its output ``o`` (B, Sq, H, vh), its ``lse`` (B, H, Sq) f32 and
    the output's gradient ``do`` (B, Sq, H, vh); the same masks, layouts
    and dtypes as the forward, all contiguous.  On the card the kernel of
    ``csrc/flash_attention_bwd.cu`` (counted as ``flash_attention_bwd``),
    at width max(hd, vh) on zero columns where vh ≠ hd, by
    :func:`bwd_route`'s route for the dtype; on the CPU
    ``ref.flash_attention_bwd_ref``; on the meta device the same tensors
    allocated, nothing computed.  Gradients come in the inputs' dtype.
    Both routes read rows in 16-byte pieces and raise for a tensor that
    does not start on a 16-byte boundary."""
    B, Sq, Sk, H, KH, hd, vh, _ = _check_inputs(q, k, v)
    dev = q.device
    for t_name, t, shape in (("o", o, (B, Sq, H, vh)), ("do", do, (B, Sq, H, vh))):
        if tuple(t.shape) != shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{t_name} must be {q.dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{t_name} must be contiguous")
    if (tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != dev or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 ({B}, {H}, {Sq}) "
                         f"on {dev}")
    width, delta = max(hd, vh), None
    if dev.type != "cpu":
        if vh != hd:
            q, k, v = zero_pad(q, k, v, width)
            o, do = (F.pad(t, (0, width - vh)) for t in (o, do))
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _bwd_op(q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(),
            do.detach(), dq, dk, dv, delta, hd, vh, float(scale),
            bool(causal), int(window), int(chunk))
    if dq.shape[-1] != hd or dv.shape[-1] != vh:
        dq, dk, dv = (dq[..., :hd].contiguous(), dk[..., :hd].contiguous(),
                      dv[..., :vh].contiguous())
    return dq, dk, dv
