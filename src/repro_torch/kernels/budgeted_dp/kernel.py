"""Wrappers of the budgeted-DP CUDA kernels (``csrc/budgeted_dp.cu``) and
the host loops of the tiled forwards.

Every forward is batch-first, B ≥ 1 instances with shared feasibility,
offsets and seed plane and per-instance Υ̂, Σ̂² and ``allowed`` (masked in
the kernel):

- ``dp_forward_batched``: the whole plane in one block's shared memory,
  one launch for all E edges (counterpart of the JAX package's
  ``_dp_kernel`` at B = 1 and ``_dp_kernel_batched``, K1/K2);
- ``dp_forward_blocked``: one ``dp_edge`` launch per edge, each after the
  first chained to the one before, the plane ping-ponged between two
  buffers in device memory (``_edge_tile_kernel``/``_edge_stile_kernel``
  scanned by ``_dp_forward_blocked``, K3);
- ``dp_forward_fused``: one ``dp_chunk`` launch per chunk of ``block_e``
  edges, a cooperative launch over the whole card with a grid barrier
  between edges (``_fused_chunk_kernel``, K4, and
  ``_batched_fused_kernel``, K5).

``dp_epilogue`` runs the eq.-17 s* rule and the backtrack on the card;
``epilogue_table`` makes its optional (word row, bit) table on a device,
checked once on the host.  ``tiling.choose_tiling`` picks the pipeline and
its tiles.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``, under
the same host loop (chunk loop, ping-pong, word zeroing); a CUDA tensor
launches the kernel or raises — there is no fallback.  Each wrapper counts
its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import build, ref, tiling
from .ref import packed_words

__all__ = ["LAUNCHES", "dp_forward_batched", "dp_edge", "dp_chunk",
           "dp_forward_blocked", "dp_forward_fused", "dp_epilogue",
           "epilogue_table", "packed_words"]

# launches of each CUDA kernel wrapper (plain-version calls are not counted)
LAUNCHES = {"dp_forward_batched": 0, "dp_edge": 0, "dp_chunk": 0,
            "dp_epilogue": 0}


def _check(name, t, shape, device):
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(upsilon, sigma2, allowed, feasible, offsets, S, C, dev):
    B, E = upsilon.shape
    _check("upsilon", upsilon, (B, E), dev)
    _check("sigma2", sigma2, (B, E), dev)
    if allowed is not None:
        _check("allowed", allowed, (B, E), dev)
    _check("feasible", feasible, (E, C), dev)
    _check("offsets", offsets, (E,), dev)
    return B, E


def _check_planes(vin, vout, words, B, E, dev):
    """``vin`` is (S, C), shared by the batch, or (B, S, C); returns
    (S, C, the batch stride of ``vin`` in elements)."""
    S, C = vout.shape[-2:]
    _check("vout", vout, (B, S, C), dev)
    _check("words", words, (B, packed_words(E), S, C), dev)
    _check("vin", vin, (S, C) if vin.dim() == 2 else (B, S, C), dev)
    return S, C, 0 if vin.dim() == 2 else S * C


def _device(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def dp_forward_batched(upsilon, sigma2, allowed, feasible, offsets, v0):
    """B whole-plane DP forwards in one launch (K1's counterpart at B = 1,
    K2's for a fleet).

    ``upsilon``/``sigma2`` (B, E) int32 and ``allowed`` (B, E) int32 0/1
    or ``None`` per instance; ``feasible`` (E, C), ``offsets`` (E,) and
    ``v0`` (S, C) int32 shared.  Returns ``V`` (B, S, C) and the words
    (B, ⌈E/32⌉, S, C), int32.  Raises ``ValueError`` when the plane does
    not fit one block's shared memory.
    """
    S, C = v0.shape
    dev = v0.device
    B, E = _check_operands(upsilon, sigma2, allowed, feasible, offsets, S, C,
                           dev)
    _check("v0", v0, (S, C), dev)
    tiling.check_tiling(S, C, 0, 0, None, None, None)
    if dev.type == "cpu":
        return ref.dp_forward_ref(upsilon, sigma2, allowed, feasible,
                                  offsets, v0)
    _device(dev)
    V = torch.empty((B, S, C), dtype=torch.int32, device=dev)
    words = torch.empty((B, packed_words(E), S, C), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):  # the library launches on the current one
        err = build.load().dp_forward_launch(
            upsilon.data_ptr(), sigma2.data_ptr(), _ptr(allowed),
            feasible.data_ptr(), offsets.data_ptr(), v0.data_ptr(),
            V.data_ptr(), words.data_ptr(), B, E, S, C,
            torch.cuda.current_stream(dev).cuda_stream)
    build.LIBRARY.check(err, "dp_forward_batched")
    LAUNCHES["dp_forward_batched"] += 1
    return V, words


def dp_edge(
    vin,
    vout,
    words,
    upsilon,
    sigma2,
    allowed,
    feasible,
    offsets,
    e,
    *,
    chained: bool = False,
):
    """Edge ``e`` over the plane, one launch of the per-edge kernel (K3's
    counterpart): it reads ``vin`` ((S, C) shared or (B, S, C)) and writes
    ``vout`` (B, S, C), and ORs bit e % 32 into word e // 32 of ``words``
    (B, ⌈E/32⌉, S, C).  ``vout`` must not be ``vin``.  The halos are
    reads of ``vin``, so no tiling shapes it.

    ``chained``: on the card the launch may start while the kernel
    launched just before it on the stream still runs (Hopper's
    programmatic dependent launch), and waits for that kernel's writes
    before it reads ``vin``; that kernel must write none of the edge's
    operands (Υ̂, Σ̂², ``allowed``, ``feasible``, ``offsets``).  The
    per-edge pipeline chains each edge to the one before."""
    dev = vout.device
    B, E = _check_operands(upsilon, sigma2, allowed, feasible, offsets,
                           vout.shape[-2], vout.shape[-1], dev)
    S, C, vin_stride = _check_planes(vin, vout, words, B, E, dev)
    if not 0 <= e < E:
        raise ValueError(f"edge {e} outside [0, {E})")
    if vin.data_ptr() == vout.data_ptr():
        raise ValueError("dp_edge reads vin while it writes vout: pass two "
                         "buffers")
    if dev.type == "cpu":
        V, _ = ref.dp_edge_ref(vin, words, upsilon, sigma2, allowed,
                               feasible, offsets, e)
        vout.copy_(V)
        return vout, words
    _device(dev)
    with torch.cuda.device(dev):
        lib = build.load()
        launch = lib.dp_edge_chain_launch if chained else lib.dp_edge_launch
        err = launch(
            upsilon.data_ptr(), sigma2.data_ptr(), _ptr(allowed),
            feasible.data_ptr(), offsets.data_ptr(), vin.data_ptr(),
            vin_stride, vout.data_ptr(), words.data_ptr(), B, E, S, C, e,
            torch.cuda.current_stream(dev).cuda_stream)
    build.LIBRARY.check(err, "dp_edge")
    LAUNCHES["dp_edge"] += 1
    return vout, words


def dp_chunk(
    vin,
    vout,
    words,
    upsilon,
    sigma2,
    allowed,
    feasible,
    offsets,
    lo: int,
    hi: int,
    *,
    u_max: int,
    off_max: int,
    block_s,
    block_c: int,
):
    """Edges ``hi−1 … lo`` over the plane, one launch of the fused kernel
    (K4's counterpart at B = 1, K5's for a fleet).

    One cooperative launch spreads the B·S·C cells over every block the
    card holds at once; each edge goes from one plane in device memory to
    the other (``vout`` and a scratch plane this wrapper allocates, in
    turn) with a grid barrier between edges.  Reads ``vin`` ((S, C) shared
    or (B, S, C)), writes ``vout`` (B, S, C) — which may be ``vin`` — and
    ORs each edge's bit into its word of ``words``.  ``u_max``,
    ``off_max``, ``block_s`` and ``block_c`` are checked for legality as
    the JAX package checks them (``tiling.check_tiling``); they do not
    shape the grid.
    """
    dev = vout.device
    B, E = _check_operands(upsilon, sigma2, allowed, feasible, offsets,
                           vout.shape[-2], vout.shape[-1], dev)
    S, C, vin_stride = _check_planes(vin, vout, words, B, E, dev)
    if not 0 <= lo < hi <= E:
        raise ValueError(f"edge chunk [{lo}, {hi}) outside [0, {E})")
    tiling.check_tiling(S, C, u_max, off_max, hi - lo, block_s, block_c)
    if dev.type == "cpu":
        V, _ = ref.dp_chunk_ref(vin, words, upsilon, sigma2, allowed,
                                feasible, offsets, lo, hi)
        vout.copy_(V)
        return vout, words
    _device(dev)
    scratch = torch.empty((B, S, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.load().dp_chunk_launch(
            upsilon.data_ptr(), sigma2.data_ptr(), _ptr(allowed),
            feasible.data_ptr(), offsets.data_ptr(), vin.data_ptr(),
            vin_stride, vout.data_ptr(), scratch.data_ptr(),
            words.data_ptr(), B, E, S, C, lo, hi,
            torch.cuda.current_stream(dev).cuda_stream)
    build.LIBRARY.check(err, "dp_chunk")
    LAUNCHES["dp_chunk"] += 1
    return vout, words


def _zero_words(B, E, S, C, dev):
    return torch.zeros((B, packed_words(E), S, C), dtype=torch.int32,
                       device=dev)


def dp_forward_blocked(upsilon, sigma2, allowed, feasible, offsets, v0):
    """The per-edge pipeline: E ``dp_edge`` launches, edges E−1 … 0, from
    the shared plane ``v0`` (S, C) through two (B, S, C) buffers in turn,
    each launch after the first chained to the one before.  The words are
    zeroed once.  Returns ``V`` and the words as
    :func:`dp_forward_batched` does."""
    B, E = upsilon.shape
    S, C = v0.shape
    dev = v0.device
    words = _zero_words(B, E, S, C, dev)
    if E == 0:
        return v0.expand(B, S, C).contiguous(), words
    bufs = [torch.empty((B, S, C), dtype=torch.int32, device=dev)
            for _ in range(min(E, 2))]
    V = v0
    for n, e in enumerate(range(E - 1, -1, -1)):
        V, words = dp_edge(V, bufs[n % 2], words, upsilon, sigma2, allowed,
                           feasible, offsets, e, chained=n > 0)
    return V, words


def dp_forward_fused(
    upsilon,
    sigma2,
    allowed,
    feasible,
    offsets,
    v0,
    *,
    u_max: int,
    off_max: int,
    block_e: int,
    block_s,
    block_c: int,
):
    """The edge-fused pipeline: ⌈E/block_e⌉ ``dp_chunk`` launches, edges
    E−1 … 0 in chunks of ``block_e`` (the last chunk may be shorter), the
    first reading ``v0`` and each writing one (B, S, C) plane in place.
    The words are zeroed once; a chunk that straddles a word boundary
    writes both words.  Returns ``V`` and the words."""
    B, E = upsilon.shape
    S, C = v0.shape
    dev = v0.device
    words = _zero_words(B, E, S, C, dev)
    if E == 0:
        return v0.expand(B, S, C).contiguous(), words
    V = torch.empty((B, S, C), dtype=torch.int32, device=dev)
    vin = v0
    for hi in range(E, 0, -block_e):
        dp_chunk(vin, V, words, upsilon, sigma2, allowed, feasible, offsets,
                 max(hi - block_e, 0), hi, u_max=u_max, off_max=off_max,
                 block_s=block_s, block_c=block_c)
        vin = V
    return V, words


# epilogue tables on the card checked on the host, by their word_rows
# tensor: (bits, the two tensors' versions then, word rows the table reads)
_TABLES = WeakIdKeyDictionary()


def _table_rows(word_rows, bits) -> int:
    """The word rows an (E,) (word row, bit) table reads, from host
    arrays; raises ``ValueError`` on an entry outside [0, ∞) × [0, 32)."""
    rows, bits = np.asarray(word_rows), np.asarray(bits)
    if rows.size and (rows.min() < 0 or bits.min() < 0 or bits.max() >= 32):
        raise ValueError("word_rows outside [0, W) or bits outside [0, 32)")
    return int(rows.max()) + 1 if rows.size else 0


def epilogue_table(word_rows, bits, device):
    """The epilogue's (word row, bit) table on ``device`` from host arrays
    (E,): two int32 tensors for :func:`dp_epilogue`, checked here, once, so
    that the wrapper reads nothing back from the card per call."""
    n_rows = _table_rows(word_rows, bits)
    rows_t = torch.as_tensor(np.asarray(word_rows, np.int32), device=device)
    bits_t = torch.as_tensor(np.asarray(bits, np.int32), device=device)
    _TABLES[rows_t] = (bits_t, rows_t._version, bits_t._version, n_rows)
    return rows_t, bits_t


def _checked_rows(word_rows, bits) -> int:
    """:func:`_table_rows` of a table on any device: a CPU table as it is,
    a card table from its host check (:func:`epilogue_table`, or one host
    read the first time, kept while neither tensor changes)."""
    if word_rows.device.type == "cpu":
        return _table_rows(word_rows.numpy(), bits.numpy())
    known = _TABLES.get(word_rows)
    if known is not None and known[0] is bits and known[1:3] == (
            word_rows._version, bits._version):
        return known[3]
    n_rows = _table_rows(word_rows.cpu().numpy(), bits.cpu().numpy())
    _TABLES[word_rows] = (bits, word_rows._version, bits._version, n_rows)
    return n_rows


def dp_epilogue(
    V, words, upsilon, offsets, s_limit, full_state: int, word_rows=None, bits=None
):
    """s* (eq. 17), the backtrack and the value row for B instances.

    ``V`` (B, S, C), ``words`` (B, W, S, C), ``upsilon`` (B, E),
    ``offsets`` (E,), ``s_limit`` (B,), all int32 on one device.  Edge
    e's decision is bit e % 32 of word e // 32 (W = ⌈E/32⌉), or, with the
    optional (E,) int32 table ``word_rows``/``bits``, bit ``bits[e]`` of
    word ``word_rows[e]`` (any W): the packing of a forward run in
    segments (``ops.WarmCudaSolver``).  A bad entry raises before any
    launch; a table on the card is checked on its host copy (made by
    :func:`epilogue_table`; any other is read back once).  Returns ``x``
    (B, E), ``s_star`` (B,) and ``value_row`` (B, S) int32, the value row
    NEG at budget-infeasible entries.
    """
    B, S, C = V.shape
    E = upsilon.shape[1]
    dev = V.device
    W = packed_words(E) if word_rows is None else words.shape[1]
    _check("V", V, (B, S, C), dev)
    _check("words", words, (B, W, S, C), dev)
    _check("upsilon", upsilon, (B, E), dev)
    _check("offsets", offsets, (E,), dev)
    _check("s_limit", s_limit, (B,), dev)
    if (word_rows is None) != (bits is None):
        raise ValueError("word_rows and bits go together")
    if word_rows is not None:
        _check("word_rows", word_rows, (E,), dev)
        _check("bits", bits, (E,), dev)
        # on the card a bad entry reads outside ``words``
        if _checked_rows(word_rows, bits) > W:
            raise ValueError(f"word_rows outside [0, {W}) or bits outside "
                             "[0, 32)")
    if not 0 <= full_state < C:
        raise ValueError(f"full_state={full_state} outside [0, {C})")
    if dev.type == "cpu":
        return ref.dp_epilogue_ref(V, words, upsilon, offsets, s_limit,
                                   full_state, word_rows, bits)
    _device(dev)
    x = torch.empty((B, E), dtype=torch.int32, device=dev)
    s_star = torch.empty((B,), dtype=torch.int32, device=dev)
    value_row = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.load().dp_epilogue_launch(
            V.data_ptr(), words.data_ptr(), upsilon.data_ptr(),
            offsets.data_ptr(), s_limit.data_ptr(), _ptr(word_rows),
            _ptr(bits), full_state, B, E, W, S, C, x.data_ptr(),
            s_star.data_ptr(), value_row.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.LIBRARY.check(err, "dp_epilogue")
    LAUNCHES["dp_epilogue"] += 1
    return x, s_star, value_row
