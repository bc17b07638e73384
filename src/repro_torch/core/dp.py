"""Polynomial-time dynamic programming (paper Algorithm 2) + oracle knapsack.

Counterpart of ``repro.core.dp``.  The budgeted integer program
P4(s,t):  max Σ̂²ᵀx  s.t.  A x ≤ c,  Υ̂ᵀx ≥ s  is solved for every s at once
by one DP over (budget s, capacity state c) planes, folding edges
E−1 … 0:

    V(s, c', i) = max( V(s, c', i+1),
                       [A_{:,i} ≤ c']·( V(max(s−Υ̂_i,0), c'−A_{:,i}, i+1) + Σ̂²_i ) )

Capacity vectors are mixed-radix state ids (Π_k (c_k+1) states).  This
module is the plain int32 ``reference`` backend of ``core.solvers``; the
CUDA kernels in ``kernels.budgeted_dp`` are held against it bit for bit.

Every function is batch-first: statistics may carry a leading seed
dimension (B, E), and the result keeps it.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["NEG", "FNEG", "DPTables", "build_tables", "solve_budgeted_dp",
           "oracle_knapsack", "oracle_value", "dp_edge_fold", "initial_plane",
           "select_and_backtrack"]

NEG = -(2 ** 29)  # -inf sentinel; NEG + any value < 2²⁹ stays negative
FNEG = -1e30
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash — cache key
class DPTables:
    """Static per-instance tables for capacity-state transitions.

    ``offsets``: serving edge e from any *feasible* state c lands on
    ``next_state[c, e] == c - offsets[e]`` (no borrows: feasibility means
    every digit has cap_k ≥ A[k,e]).  The kernels turn the capacity gather
    into a uniform shift with it; ``build_tables`` checks the identity on
    every feasible pair.
    """

    feasible: np.ndarray  # (n_states, E) bool — A_{:,e} ≤ capacity(state)
    next_state: np.ndarray  # (n_states, E) int32 — state after taking edge e
    n_states: int
    full_state: int  # encoding of the full capacity vector c
    radices: np.ndarray  # (K,) int32 — c_k + 1
    cap_of_state: np.ndarray  # (n_states, K) int32 — decoded capacity vectors
    strides: np.ndarray  # (K,) int64 — mixed-radix strides of the encoding
    offsets: np.ndarray  # (E,) int32 — Σ_k A[k,e]·strides[k]


def build_tables(A: np.ndarray, c: np.ndarray) -> DPTables:
    """Build the capacity-state transition tables for one instance.

    ``A`` is the (K, E) demand matrix, ``c`` the (K,) capacities.  Raises
    ``AssertionError`` if the offset identity fails on a feasible pair.
    Host numpy; build once per instance and share it across slots.
    """
    A = np.asarray(A, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    K, E = A.shape
    radices = (c + 1).astype(np.int64)
    n_states = int(np.prod(radices))

    ids = np.arange(n_states, dtype=np.int64)
    cap = np.zeros((n_states, K), dtype=np.int64)
    strides = np.zeros(K, dtype=np.int64)
    stride = 1
    for k in range(K):
        strides[k] = stride
        cap[:, k] = (ids // stride) % radices[k]
        stride *= radices[k]

    feasible = np.all(cap[:, None, :] >= A.T[None, :, :], axis=2)  # (C, E)
    nxt_cap = np.maximum(cap[:, None, :] - A.T[None, :, :], 0)  # (C, E, K)
    next_state = (nxt_cap * strides[None, None, :]).sum(axis=2)
    next_state = np.where(feasible, next_state, 0).astype(np.int32)

    offsets = (A.T * strides[None, :]).sum(axis=1)  # (E,)
    expect = ids[:, None] - offsets[None, :]  # (C, E)
    if not np.array_equal(next_state[feasible],
                          expect.astype(np.int32)[feasible]):
        raise AssertionError(
            "mixed-radix offset identity violated: next_state[c, e] != "
            "c - offsets[e] on a feasible pair")

    full_state = int((c * strides).sum())
    if full_state != n_states - 1:
        raise AssertionError("full capacity must encode the last state")
    return DPTables(
        feasible=feasible.astype(bool),
        next_state=next_state,
        n_states=n_states,
        full_state=full_state,
        radices=radices.astype(np.int32),
        cap_of_state=cap.astype(np.int32),
        strides=strides,
        offsets=offsets.astype(np.int32),
    )


@functools.lru_cache(maxsize=32)
def _device_tables(tables: DPTables, device: torch.device):
    """(feasible (C, E) bool, next_state (C, E) int64) on ``device``,
    made once per tables object and device."""
    return (torch.as_tensor(tables.feasible, device=device),
            torch.as_tensor(tables.next_state, device=device).long())


def initial_plane(s_cap: int, n_states: int, device=None):
    """The cold-start DP plane: 0 at s = 0, NEG elsewhere, (S, C) int32,
    on ``device`` (``None`` is the card, see ``resolve_device``)."""
    v0 = torch.full((s_cap + 1, n_states), NEG, dtype=torch.int32,
                    device=resolve_device(device))
    v0[0] = 0
    return v0


def dp_edge_fold(V, ups, sig, feas_col, next_col, rows):
    """One fold step of the layered DP for a batch of planes.

    ``V`` (B, S, C) int32; ``ups``/``sig`` (B,) int32; ``feas_col``
    (B, C) bool; ``next_col`` (C,) int64; ``rows`` is ``arange(S)``.
    Returns the new plane and the (B, S, C) decision ``take > V`` (strict,
    so ties keep x_e = 0).
    """
    src = torch.clamp(rows[None, :] - ups[:, None], min=0)  # max(s−Υ̂_e, 0)
    shifted = torch.gather(V, 1, src[:, :, None].expand(-1, -1, V.shape[2]))
    take = shifted.index_select(2, next_col) + sig[:, None, None]
    # every plane value is ≥ NEG and Σ̂² ≥ 0, so take ≥ NEG: the minimum
    # with NEG masks an infeasible state, with INT32_MAX keeps the value
    lim = torch.where(feas_col, _INT32_MAX, NEG).to(torch.int32)
    take = torch.minimum(take, lim[:, None, :])
    return torch.maximum(V, take), take > V


def _batched(upsilon, sigma2, s_limit, allowed):
    """Lift (E,) inputs to a batch of one; returns the squeeze flag."""
    single = upsilon.dim() == 1
    if single:
        upsilon, sigma2 = upsilon[None], sigma2[None]
        if allowed is not None:
            allowed = allowed[None]
    B = upsilon.shape[0]
    s_limit = torch.as_tensor(s_limit, device=upsilon.device)
    s_limit = s_limit.to(torch.int32).reshape(-1).expand(B)
    return single, upsilon, sigma2, s_limit, allowed


def solve_budgeted_dp(
    upsilon, sigma2, tables: DPTables, s_cap: int, s_limit, allowed=None
):
    """Solve {P4(s,t)}_{s≤s_cap} and apply the s*-selection rule (eq. 17).

    Args:
      upsilon, sigma2: (E,) or (B, E) int32 scaled statistics Υ̂(t), Σ̂²(t).
      tables: capacity-state transition tables.
      s_cap: static bound on s (value-row height − 1).
      s_limit: ξ(t)·m, scalar or (B,) — s beyond it is masked out.
      allowed: optional (E,)/(B, E) bool — edges eligible this slot.

    Returns:
      ``x`` int32 of the input's shape and ``{"s_star", "value_row"}``;
      the value row is the raw int32 DP row at the full capacity state.
    """
    single, upsilon, sigma2, s_limit, allowed = _batched(
        upsilon, sigma2, s_limit, allowed)
    dev = upsilon.device
    feasible, next_state = _device_tables(tables, dev)
    B, E = upsilon.shape
    S = s_cap + 1
    rows = torch.arange(S, device=dev)
    V = initial_plane(s_cap, tables.n_states, dev).expand(B, S, -1)
    decisions = [None] * E
    for e in range(E - 1, -1, -1):
        feas = feasible[:, e][None, :].expand(B, -1)
        if allowed is not None:
            feas = feas & allowed[:, e, None].bool()
        V, decisions[e] = dp_edge_fold(V, upsilon[:, e], sigma2[:, e], feas,
                                       next_state[:, e], rows)

    x, s_star, v_row = select_and_backtrack(V, decisions.__getitem__,
                                            upsilon, s_limit, tables)
    if single:
        return x[0], {"s_star": s_star[0], "value_row": v_row[0]}
    return x, {"s_star": s_star, "value_row": v_row}


def select_and_backtrack(V, decision, upsilon, s_limit, tables: DPTables):
    """The eq.-17 s* rule and the backtrack over B folded planes.

    ``V`` (B, S, C) int32 after all E edges; ``decision(e)`` the (B, S, C)
    bool decision plane of edge e; ``upsilon`` (B, E); ``s_limit`` (B,).
    Returns ``x`` (B, E) int32, ``s_star`` (B,) int32 and the raw value
    row (B, S) at the full capacity state.
    """
    B, S, _ = V.shape
    E = upsilon.shape[1]
    dev = V.device
    _, next_state = _device_tables(tables, dev)
    v_row = V[:, :, tables.full_state]  # (B, S)
    s_vals = torch.arange(S, device=dev, dtype=torch.int32)
    # feasible ⇔ value ≥ 0: Σ̂² ≥ 0, while NEG-seeded chains stay < 0
    ok = (v_row >= 0) & (s_vals[None, :] <= s_limit[:, None])
    score = s_vals.to(torch.float32) + torch.sqrt(
        torch.clamp(v_row, min=0).to(torch.float32))
    score = torch.where(ok, score, FNEG)
    s_star = torch.argmax(score, dim=1).to(torch.int32)  # first maximum

    b_idx = torch.arange(B, device=dev)
    s = s_star.long()
    cs = torch.full((B,), tables.full_state, dtype=torch.long, device=dev)
    x = torch.zeros((B, E), dtype=torch.int32, device=dev)
    for e in range(E):
        d = decision(e)[b_idx, s, cs]
        x[:, e] = d.to(torch.int32)
        s = torch.where(d, torch.clamp(s - upsilon[:, e], min=0), s)
        cs = torch.where(d, next_state[cs, e], cs)
    return x, s_star, v_row


def _oracle_fold(values, tables: DPTables, take_allowed, decisions=None):
    """The oracle's float32 fold over edges E−1 … 0; appends each edge's
    decisions to ``decisions`` (edge order E−1 … 0) when given."""
    single = take_allowed.dim() == 1
    alw = take_allowed[None] if single else take_allowed
    B, E = alw.shape
    vals = values.expand(B, E) if values.dim() == 1 else values
    feasible, next_state = _device_tables(tables, alw.device)
    V = torch.zeros((B, tables.n_states), dtype=torch.float32,
                    device=alw.device)
    for e in range(E - 1, -1, -1):
        take = V[:, next_state[:, e]] + vals[:, e, None]
        take = torch.where(feasible[:, e][None, :] & alw[:, e, None], take,
                           FNEG)
        if decisions is not None:
            decisions.append(take > V)
        V = torch.maximum(V, take)
    return single, V


def oracle_value(values, tables: DPTables, take_allowed):
    """The value of :func:`oracle_knapsack` without the backtrack — what
    the simulator's regret needs each slot."""
    single, V = _oracle_fold(values, tables, take_allowed)
    value = V[:, tables.full_state]
    return value[0] if single else value


def oracle_knapsack(values, tables: DPTables, take_allowed):
    """Omniscient per-slot optimum: max valuesᵀx s.t. Ax ≤ c, x ∈ {0,1}^E.

    ``values`` (E,) or (B, E) float32; ``take_allowed`` (E,)/(B, E) bool
    masks edges of ports with no arrival (constraint (2)).  Exact DP over
    capacity states × edges with a float32 objective; returns ``(x,
    value)`` with the batch shape of ``take_allowed``.
    """
    decisions = []
    single, V = _oracle_fold(values, tables, take_allowed, decisions)
    decisions.reverse()  # index by edge id
    B, E = V.shape[0], len(decisions)
    dev = V.device
    _, next_state = _device_tables(tables, dev)
    b_idx = torch.arange(B, device=dev)
    cs = torch.full((B,), tables.full_state, dtype=torch.long, device=dev)
    x = torch.zeros((B, E), dtype=torch.int32, device=dev)
    for e in range(E):
        d = decisions[e][b_idx, cs]
        x[:, e] = d.to(torch.int32)
        cs = torch.where(d, next_state[cs, e], cs)
    value = V[:, tables.full_state]
    return (x[0], value[0]) if single else (x, value)
