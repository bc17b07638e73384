"""Plain PyTorch versions of the budgeted-DP kernels.

``dp_edge_ref`` is one edge of the forward that ``csrc/budgeted_dp.cu``
computes (the plain version of the per-edge kernel, the counterpart of
the JAX package's ``_edge_tile_kernel``/``_edge_stile_kernel``), in int32
with the capacity transition written as the uniform shift next(c) =
c − offsets[e] and the decisions bit-packed: bit e % 32 of word e // 32 is
edge e.  ``dp_chunk_ref`` is a chunk of edges (the fused kernel's,
``_fused_chunk_kernel``/``_batched_fused_kernel``), and ``dp_forward_ref``
all of them (the whole-plane kernel's, ``_dp_kernel``/
``_dp_kernel_batched``; the JAX package's ``dp_forward_ref``).
``dp_epilogue_ref`` is the eq.-17 s* rule and the backtrack over the
packed words (``ops._solve``'s epilogue in the JAX package).

The kernel wrappers in ``kernel.py`` send CPU tensors here; the CUDA
kernels are held against these functions bit for bit on the card.
"""
from __future__ import annotations

import torch

from ...core.dp import NEG

__all__ = ["packed_words", "dp_edge_ref", "dp_chunk_ref", "dp_forward_ref",
           "dp_epilogue_ref"]


def packed_words(n_edges: int) -> int:
    """Words of the packed decision tensor: ⌈E/32⌉ int32 words."""
    return (n_edges + 31) // 32


def dp_edge_ref(V, words, upsilon, sigma2, allowed, feasible, offsets, e):
    """Edge ``e`` on B planes.

    ``V`` (B, S, C) int32, or (S, C) shared by the batch; ``words``
    (B, ⌈E/32⌉, S, C) int32, into which bit e % 32 of word e // 32 is ORed
    in place; ``upsilon``/``sigma2`` (B, E) int32; ``allowed`` (B, E)
    int32 0/1 or ``None`` (every edge allowed); ``feasible`` (E, C) int32
    0/1 and ``offsets`` (E,) int32 shared.  Returns the new (B, S, C)
    plane and ``words``.

    ``take = V[max(s−Υ̂_e, 0), c−off_e] + Σ̂²_e``, NEG where ``c < off_e``,
    where the state is infeasible or the edge not allowed;
    ``dec = take > V``; ``V′ = max(V, take)``.
    """
    B = upsilon.shape[0]
    S, C = V.shape[-2:]
    dev = V.device
    V = V.expand(B, S, C)
    rows = torch.arange(S, device=dev)
    cols = torch.arange(C, device=dev)
    off = offsets[e]
    src_s = torch.clamp(rows[None, :] - upsilon[:, e, None], min=0)
    shifted = torch.gather(V, 1, src_s[:, :, None].expand(B, S, C))
    take = shifted[:, :, torch.clamp(cols - off, min=0)]
    take = take + sigma2[:, e, None, None]
    live = ((feasible[e] > 0) & (cols >= off))[None, None, :]
    if allowed is not None:
        live = live & (allowed[:, e] > 0)[:, None, None]
    take = torch.where(live, take, NEG)
    dec = (take > V).to(torch.int32)
    words[:, e // 32] |= dec << (e % 32)  # bit 31 wraps to the sign bit
    return torch.maximum(V, take), words


def dp_chunk_ref(V, words, upsilon, sigma2, allowed, feasible, offsets, lo, hi):
    """Edges ``hi−1 … lo`` of the fold from plane ``V`` ((B, S, C) or
    shared (S, C)): :func:`dp_edge_ref` in turn, each edge's bit at its
    global position.  Returns the (B, S, C) plane and ``words``."""
    for e in range(hi - 1, lo - 1, -1):
        V, words = dp_edge_ref(V, words, upsilon, sigma2, allowed, feasible,
                               offsets, e)
    return V, words


def dp_forward_ref(upsilon, sigma2, allowed, feasible, offsets, v0):
    """B DP forwards over edges E−1 … 0 from the shared (S, C) plane
    ``v0``: :func:`dp_chunk_ref` over all edges.  Returns ``V`` (B, S, C)
    int32 and the decision words (B, ⌈E/32⌉, S, C) int32."""
    B, E = upsilon.shape
    S, C = v0.shape
    words = torch.zeros((B, packed_words(E), S, C), dtype=torch.int32,
                        device=v0.device)
    V, words = dp_chunk_ref(v0, words, upsilon, sigma2, allowed, feasible,
                            offsets, 0, E)
    return V.expand(B, S, C).contiguous(), words


def dp_epilogue_ref(
    V, words, upsilon, offsets, s_limit, full_state: int, word_rows=None, bits=None
):
    """The eq.-17 selection and the backtrack, per instance.

    ``V`` (B, S, C) and ``words`` (B, W, S, C) from the forward,
    ``upsilon`` (B, E), ``offsets`` (E,), ``s_limit`` (B,) int32.
    s* is the first argmax of ``s + sqrt(float(v))`` over ``s ≤ s_limit``
    with ``v = V[s, full_state] ≥ 0``; the walk starts at (s*, full_state)
    and, on each taken edge, moves to (max(s−Υ̂_e, 0), c − off_e).
    Edge e's decision is bit ``bits[e]`` of word ``word_rows[e]``: the
    packing of a forward run in segments, each numbering its edges from
    0 (``ops.WarmCudaSolver``); without the table, bit e % 32 of word
    e // 32, and then W = ⌈E/32⌉.

    Returns ``x`` (B, E) int32, ``s_star`` (B,) int32 and the value row
    (B, S) int32 with exactly NEG at budget-infeasible entries.
    """
    B, S, _ = V.shape
    E = upsilon.shape[1]
    dev = V.device
    v_row = V[:, :, full_state]
    s_vals = torch.arange(S, device=dev, dtype=torch.int32)
    ok = (v_row >= 0) & (s_vals[None, :] <= s_limit[:, None])
    score = s_vals.to(torch.float32) + torch.sqrt(
        torch.clamp(v_row, min=0).to(torch.float32))
    s_star = torch.argmax(torch.where(ok, score, -torch.inf), dim=1)

    b_idx = torch.arange(B, device=dev)
    s = s_star
    cs = torch.full((B,), full_state, dtype=torch.long, device=dev)
    x = torch.zeros((B, E), dtype=torch.int32, device=dev)
    for e in range(E):
        w, bit = ((e // 32, e % 32) if word_rows is None
                  else (int(word_rows[e]), int(bits[e])))
        d = (words[b_idx, w, s, cs] >> bit) & 1
        x[:, e] = d
        taken = d > 0
        s = torch.where(taken, torch.clamp(s - upsilon[:, e], min=0), s)
        cs = torch.where(taken, cs - offsets[e], cs)
    value_row = torch.where(v_row >= 0, v_row, NEG)
    return x, s_star.to(torch.int32), value_row
