"""Wrapper of the SSD CUDA kernels (``csrc/ssd.cu``), K7's counterpart.

One call of :func:`ssd_scan` on the card is one call of the C entry point
``ssd_scan_launch``, which launches three kernels back to back (chunk
states, state passing, outputs) and counts as one ``ssd_scan`` launch.
A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor launches the kernels or raises — there is no fallback.  The
wrapper counts its launches in ``LAUNCHES``.

For training, :func:`ssd_scan_saved` also returns the forward's scratch
(each chunk's starting state and cum as (hi, lo) pairs), and
:func:`ssd_bwd` launches the backward (``csrc/ssd_bwd.cu``, one C entry
point ``ssd_bwd_launch``, six launches of five kernels, counted as one
``ssd_bwd`` launch; split-TF32 ``mma.sync`` products, blocks of
``BWD_HEAD_GROUP`` heads) from it; ``ops.SsdFn`` puts the two under
autograd.

Each wrapper allocates its outputs and scratch itself and hands them to a
``torch.library`` operator (``kernels.work.kernel_op``),
``repro_torch::ssd_scan`` or ``::ssd_bwd``, that fills them: on the card
it launches the kernels, on the CPU it runs the plain version, and on the
meta device (or under ``FakeTensorMode``) it does nothing.  So a dry run
on meta tensors sees every byte the card would allocate and launches
nothing, and the kernels' shape limits hold there too; the operators'
work (:func:`scan_work`, :func:`bwd_work`) is what ``FlopCounterMode``
counts for them on any device.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from . import ref
from ..nvcc import SMEM_LIMIT_BYTES, CudaLibrary
from ..work import kernel_op

__all__ = ["LAUNCHES", "LIBRARY", "BWD_LIBRARY", "KERNELS", "BWD_KERNELS",
           "BWD_LAUNCHES_PER_CALL", "BWD_HEAD_GROUP", "Q_MAX", "smem_bytes",
           "bwd_shares", "scan_work", "bwd_work", "ssd_scan",
           "ssd_scan_saved", "ssd_bwd"]

# calls of the CUDA entry point (plain-version calls are not counted)
LAUNCHES = {"ssd_scan": 0, "ssd_bwd": 0}
# the kernels one call launches, in order
KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_output_kernel")
BWD_KERNELS = ("ssd_bwd_adj_kernel", "ssd_bwd_pass_kernel",
               "ssd_bwd_chunk_kernel", "ssd_bwd_reduce_kernel",
               "ssd_bwd_reduce_a_kernel")
# the launches of each a call: the reduction runs for dB and for dC
BWD_LAUNCHES_PER_CALL = {name: 1 + (name == "ssd_bwd_reduce_kernel")
                         for name in BWD_KERNELS}
# the heads of one block of the backward's adjoint and chunk kernels
# (HEAD_GROUP in csrc/ssd_bwd.cu): C·Bᵀ is formed once for them, and dB
# and dC are written as one share per group
BWD_HEAD_GROUP = 4
# the longest chunk: a warp holds its tiles of C·Bᵀ in registers
Q_MAX = 128


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = ([p, ll, ll, ll, p, ll, ll, ll, p, p, ll,
                                     ll, p, ll, ll, p, p, p, p] + [i] * 6
                                    + [p])
    lib.ssd_scan_launch.restype = i


def _declare_bwd(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_bwd_launch.argtypes = ([p, ll, ll, ll, p, ll, ll, ll, p, p, ll,
                                    ll, p, ll, ll] + [p] * 13 + [i] * 6
                                   + [p])
    lib.ssd_bwd_launch.restype = i


_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARY = CudaLibrary(_CSRC / "ssd.cu", _declare, "ssd_error_string")
BWD_LIBRARY = CudaLibrary(_CSRC / "ssd_bwd.cu", _declare_bwd,
                          "ssdb_error_string")
# the backward's widest state head and state: one 64-column slab of P, two
# of N (csrc/ssd_bwd.cu)
BWD_MAX_P, BWD_MAX_N = 64, 128


def smem_bytes(P: int, N: int, Q: int) -> int:
    """Shared memory of the largest block one call launches, f32 (the
    source's ``ssd_state_smem_bytes`` and ``ssd_output_smem_bytes``).
    With Qp = Q rounded up to 16: the state kernel holds the chunk's B
    (Qp, N rounded up to 16, + 8) and x (Qp, P rounded up to 64, + 8),
    dt and w (Qp,) and the scan's 4 f64 warp totals; the output kernel a
    64-column tile of C and one of x (Qp, 68 each), a 64 × 64 tile of the
    state (64, 72), cum as (hi, lo) pairs (Qp, 2) and dt (Qp,), whatever N
    and P."""
    Qp, Nm, Pw = -(-Q // 16) * 16, -(-N // 16) * 16, -(-P // 64) * 64
    state = 4 * (Qp * (Nm + 8) + Qp * (Pw + 8) + 2 * Qp + 8)
    output = 4 * (2 * Qp * 68 + 64 * 72 + 3 * Qp)
    return max(state, output)


def bwd_shares(H: int) -> int:
    """The groups of ``BWD_HEAD_GROUP`` heads over H heads, the last one
    short where the group does not divide H: the backward's dB and dC
    shares."""
    return -(-H // BWD_HEAD_GROUP)


def _check(name, t, ndim, dev):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def scan_work(B: int, S: int, H: int, P: int, N: int, Q: int) -> tuple[int, int]:
    """(operations, bytes) of the scan: C·Bᵀ on each chunk's lower
    triangle once per (b, chunk) (B and C are per batch row), and per
    (b, h, chunk) the masked product with x, C·state and the chunk
    state, 2 a multiply-add; x, dt, A, B, C read and y and the final
    state written once (the chunk states are the design's own
    traffic)."""
    n_chunks, tri = -(-S // Q), Q * (Q + 1) // 2
    ops = 2 * (B * n_chunks * tri * N
               + B * H * n_chunks * (tri * P + 2 * Q * N * P))
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N
                  + B * H * N * P)
    return ops, nbytes


def bwd_work(B: int, S: int, H: int, P: int, N: int, Q: int) -> tuple[int, int]:
    """(operations, bytes) of the backward: C·Bᵀ on the lower triangle
    once per (b, chunk); per (b, h, chunk) dy·xᵀ and Mᵀ·dy on the
    triangle, R·C and R·B (dB, dC), and four Q·N·P products with the
    chunk-boundary states, 2 a multiply-add; x, dt, A, B, C, dy read and
    dx, ddt, dA, dB, dC written once."""
    n_chunks, tri = -(-S // Q), Q * (Q + 1) // 2
    ops = 2 * (B * n_chunks * tri * N
               + B * H * n_chunks * (2 * tri * P + 2 * tri * N
                                     + 4 * Q * N * P))
    nbytes = 4 * 2 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N)
    return ops, nbytes


def _scan_impl(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    y: torch.Tensor,
    state: torch.Tensor,
    states: Optional[torch.Tensor],
    cum: Optional[torch.Tensor],
    chunk: int,
) -> None:
    """Fills y and the final state: the plain version on the CPU; on the
    card the three kernels, which also write the scratch ``states`` and
    ``cum``."""
    if x.device.type == "cpu":
        got_y, got_state = ref.ssd_ref(x, dt, A, B_, C_, chunk)
        y.copy_(got_y)
        state.copy_(got_state)
        return
    dev = x.device
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    with torch.cuda.device(dev):  # the library launches on the current one
        err = LIBRARY.load().ssd_scan_launch(
            x.data_ptr(), *x.stride()[:3], dt.data_ptr(), *dt.stride(),
            A.data_ptr(), B_.data_ptr(), *B_.stride()[:2], C_.data_ptr(),
            *C_.stride()[:2], y.data_ptr(), state.data_ptr(),
            states.data_ptr(), cum.data_ptr(), Bb, S, H, P, N,
            min(chunk, S), torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1


def _scan_op_work(x, dt, A, B_, C_, y, state, states, cum, chunk):
    Bb, S, H, P = x.shape
    return scan_work(Bb, S, H, P, B_.shape[-1], min(chunk, S))


_scan_op = kernel_op(
    "ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor B_, Tensor C_, "
    "Tensor(a!) y, Tensor(b!) state, Tensor(c!)? states, Tensor(d!)? cum, "
    "int chunk) -> ()", _scan_impl, _scan_op_work)


def ssd_scan(x, dt, A, B_, C_, chunk: int):
    """The SSD chunked scan over the model's layouts: (y, final_state), as
    :func:`ssd_scan_saved` without its scratch."""
    return ssd_scan_saved(x, dt, A, B_, C_, chunk)[:2]


def ssd_scan_saved(x, dt, A, B_, C_, chunk: int):
    """The SSD chunked scan over the model's layouts.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; A: (H,); B_, C_:
    (B, S, N) shared across heads; all f32 on one device, read through
    their strides (innermost stride 1; A contiguous); P and N multiples of
    4.  Chunks of Q = min(chunk, S) ≤ ``Q_MAX`` steps; a ragged last chunk
    is masked, not padded.  Returns (y (B, S, H, P), final_state
    (B, H, N, P), states, cum), f32, contiguous: on the card ``states``
    (B, H, chunks, N, P) holds the state each chunk starts from and ``cum``
    (B, H, chunks, Qp, 2) the chunks' cumsums as (hi, lo) pairs, which the
    backward reads; on the CPU both are None; on the meta device all four
    are allocated and nothing is computed.  Raises ``ValueError`` for a
    chunk over ``Q_MAX`` steps, or one whose blocks do not fit one block's
    shared memory.
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
    if Q > Q_MAX:
        raise ValueError(
            f"an SSD chunk of Q={Q} steps is over the kernel's limit of "
            f"{Q_MAX}: each warp holds its tiles of the chunk's C·Bᵀ in "
            "registers")
    need = smem_bytes(P, N, Q)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"an SSD chunk of Q={Q}, P={P}, N={N} needs {need} bytes of "
            f"shared memory, over the {SMEM_LIMIT_BYTES}-byte limit of one "
            "block")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((Bb, S, H, P), **f32)
    state = torch.empty((Bb, H, N, P), **f32)
    states = cum = None
    if dev.type != "cpu":
        if (x.stride(-1) != 1 or B_.stride(-1) != 1 or C_.stride(-1) != 1
                or not A.is_contiguous()):
            raise ValueError("x, B_ and C_ need innermost stride 1 and A "
                             "must be contiguous")
        n_chunks, Qp = -(-S // Q), -(-Q // 16) * 16
        # scratch: each chunk's state (then the state it starts from) and
        # cum as (hi, lo) pairs
        states = torch.empty((Bb, H, n_chunks, N, P), **f32)
        cum = torch.empty((Bb, H, n_chunks, Qp, 2), **f32)
    _scan_op(*(t.detach() for t in (x, dt, A, B_, C_)), y, state, states,
             cum, int(chunk))
    return y, state, states, cum


def _bwd_impl(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor],
    states: Optional[torch.Tensor],
    cum: Optional[torch.Tensor],
    dx: torch.Tensor,
    ddt: torch.Tensor,
    dA: torch.Tensor,
    dB: torch.Tensor,
    dC: torch.Tensor,
    gbuf: Optional[torch.Tensor],
    dBpart: Optional[torch.Tensor],
    dCpart: Optional[torch.Tensor],
    dApart: Optional[torch.Tensor],
    chunk: int,
) -> None:
    """Fills dx, ddt, dA, dB, dC: the plain version on the CPU; on the
    card the backward kernels, with the forward's scratch and their own
    (``gbuf`` and the head groups' shares)."""
    if x.device.type == "cpu":
        for dst, got in zip((dx, ddt, dA, dB, dC), ref.ssd_bwd_ref(
                x, dt, A, B_, C_, chunk, dy, dstate)):
            dst.copy_(got)
        return
    dev = x.device
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    with torch.cuda.device(dev):
        err = BWD_LIBRARY.load().ssd_bwd_launch(
            x.data_ptr(), *x.stride()[:3], dt.data_ptr(), *dt.stride(),
            A.data_ptr(), B_.data_ptr(), *B_.stride()[:2], C_.data_ptr(),
            *C_.stride()[:2], dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), states.data_ptr(),
            cum.data_ptr(), gbuf.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dBpart.data_ptr(),
            dCpart.data_ptr(), dApart.data_ptr(), Bb, S, H, P, N,
            min(chunk, S), torch.cuda.current_stream(dev).cuda_stream)
    BWD_LIBRARY.check(err, "ssd_bwd")
    LAUNCHES["ssd_bwd"] += 1


def _bwd_op_work(
    x,
    dt,
    A,
    B_,
    C_,
    dy,
    dstate,
    states,
    cum,
    dx,
    ddt,
    dA,
    dB,
    dC,
    gbuf,
    dBpart,
    dCpart,
    dApart,
    chunk,
):
    Bb, S, H, P = x.shape
    return bwd_work(Bb, S, H, P, B_.shape[-1], min(chunk, S))


_bwd_op = kernel_op(
    "ssd_bwd(Tensor x, Tensor dt, Tensor A, Tensor B_, Tensor C_, Tensor dy, "
    "Tensor? dstate, Tensor? states, Tensor? cum, Tensor(a!) dx, "
    "Tensor(b!) ddt, Tensor(c!) dA, Tensor(d!) dB, Tensor(e!) dC, "
    "Tensor(f!)? gbuf, Tensor(g!)? dBpart, Tensor(h!)? dCpart, "
    "Tensor(i!)? dApart, int chunk) -> ()", _bwd_impl, _bwd_op_work)


def ssd_bwd(x, dt, A, B_, C_, chunk: int, dy, dstate=None, states=None, cum=None):
    """The gradients (dx, ddt, dA, dB_, dC_) of :func:`ssd_scan` at x, dt,
    A, B_, C_ (the forward's inputs and layouts) from dy (B, S, H, P) and
    the final state's gradient ``dstate`` (B, H, N, P), or None for zero.
    On the card ``states`` and ``cum`` are the forward's scratch from
    :func:`ssd_scan_saved` on the same inputs, and the kernels of
    ``csrc/ssd_bwd.cu`` run (one ``ssd_bwd`` launch); on the CPU the
    plain version ``ref.ssd_bwd_ref`` runs; on the meta device the same
    tensors are allocated and nothing is computed.  All f32; gradients
    contiguous.  Raises ``ValueError`` where P > 64 or N > 128, except on
    the CPU."""
    dev = x.device
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    for name, t, shape in (("dy", dy, (Bb, S, H, P)),
                           ("dstate", dstate, (Bb, H, N, P))):
        if t is None:
            continue
        _check(name, t, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = (None,) * 4
    if dev.type != "cpu":
        if P > BWD_MAX_P or N > BWD_MAX_N:
            raise ValueError(f"the SSD backward takes P <= {BWD_MAX_P} and "
                             f"N <= {BWD_MAX_N}, got P={P}, N={N}")
        Q = min(chunk, S)
        n_chunks, Qp = -(-S // Q), -(-Q // 16) * 16
        if (states is None or cum is None
                or tuple(states.shape) != (Bb, H, n_chunks, N, P)
                or tuple(cum.shape) != (Bb, H, n_chunks, Qp, 2)):
            raise ValueError("states and cum must be the forward's scratch "
                             "(ssd_scan_saved) on the same inputs")
        dy = dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        # scratch: the state gradients, the head groups' shares of dB and
        # dC, the heads' of dA
        scratch = (torch.empty_like(states),
                   torch.empty((bwd_shares(H), Bb, S, N), **f32),
                   torch.empty((bwd_shares(H), Bb, S, N), **f32),
                   torch.empty((Bb, H, n_chunks), **f32))
    grads = (torch.empty((Bb, S, H, P), **f32), torch.empty((Bb, S, H), **f32),
             torch.empty((H,), **f32), torch.empty((Bb, S, N), **f32),
             torch.empty((Bb, S, N), **f32))
    _bwd_op(*(None if t is None else t.detach()
              for t in (x, dt, A, B_, C_, dy, dstate, states, cum)),
            *grads, *scratch, int(chunk))
    return grads
