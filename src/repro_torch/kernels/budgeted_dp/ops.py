"""ESDP Algorithm 2 on the budgeted-DP kernels: operands, checks, solves.

Counterpart of the JAX package's ``kernels/budgeted_dp/ops.py``.
``solve_budgeted_dp_batched`` is the one cold solve entry point,
batch-first (B ≥ 1): the forward — the whole-plane kernel, or the fused or
per-edge pipeline on tiles when the plane outgrows one block's shared
memory (``tiling.choose_tiling``) — then the epilogue
(``kernel.dp_epilogue``: s*, backtrack, value row), with no host sync.
:class:`WarmCudaSolver` (the JAX package's ``WarmPallasSolver``) re-solves
one instance slot after slot, launching only the fold segments after the
first changed edge.

VALUE_BOUND: the int32 plane with ``core.dp.NEG = -2**29`` is exact while
every DP partial sum stays below 2²⁹ (NEG-seeded chains then stay
negative).  A solve checks this bound, and ``max Υ̂ ≤ u_max``, for CPU
inputs only, where they cost no device sync.  For every device, the runs
that solve the DP slot after slot (``core.env``'s ESDP runs,
``sched.ClusterSim``, ``sched.DispatchEngine``) check the bound once for
their whole horizon before the first slot
(:func:`check_horizon_value_bound`), from the schedule on the host;
``tests/test_torch_budgeted_dp.py`` and ``tests/test_torch_tiling.py`` pin
the default schedules under ``u_max``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core import dp as core_dp
from ...core import stats
from ...core.dp import DPTables
from ...device import resolve_device
from .kernel import (dp_epilogue, dp_forward_batched, dp_forward_blocked,
                     dp_forward_fused, epilogue_table, packed_words)
from .tiling import check_tiling, choose_tiling

__all__ = ["VALUE_BOUND", "prepare_tables", "prepare_operands",
           "max_achievable_value", "check_horizon_value_bound",
           "validate_value_row", "solve_budgeted_dp_batched",
           "WarmCudaSolver"]

VALUE_BOUND = 2 ** 29  # int32 plane: NEG + any partial sum stays negative


def validate_value_row(value_row) -> "str | None":
    """Host-side invariant check of a returned DP value row.

    The properties are theorems of the P4/P5 recurrence, so a violation
    means a corrupted plane, never a legitimate input: ``value_row[0] >=
    0``; every entry ``>= 0`` or exactly ``core.dp.NEG``; feasible values
    ``< VALUE_BOUND``; feasible s form a prefix; values are non-increasing
    in s over it.  Takes an (S,) row or a (B, S) stack; returns ``None``
    or the first violation.
    """
    row = np.asarray(value_row)
    if row.ndim == 2:
        for b in range(row.shape[0]):
            reason = validate_value_row(row[b])
            if reason is not None:
                return f"row {b}: {reason}"
        return None
    neg = core_dp.NEG
    feas = row != neg
    if not feas[0] or row[0] < 0:
        return f"source: value_row[0] = {row[0]} (must be >= 0)"
    bad = feas & (row < 0)
    if bad.any():
        s = int(np.flatnonzero(bad)[0])
        return (f"neg-contract: value_row[{s}] = {row[s]} is negative but "
                f"not the NEG sentinel ({neg})")
    over = feas & (row >= VALUE_BOUND)
    if over.any():
        s = int(np.flatnonzero(over)[0])
        return f"value-bound: value_row[{s}] = {row[s]} >= 2^29"
    n_feas = int(feas.sum())
    if not feas[:n_feas].all():
        s = int(np.flatnonzero(~feas)[0])
        return (f"feasible-prefix: value_row[{s}] is infeasible but a "
                "larger budget is feasible")
    pre = row[:n_feas]
    rising = np.flatnonzero(np.diff(pre.astype(np.int64)) > 0)
    if rising.size:
        s = int(rising[0])
        return (f"monotone: value_row[{s + 1}] = {pre[s + 1]} > "
                f"value_row[{s}] = {pre[s]} (must be non-increasing in s)")
    return None


@functools.lru_cache(maxsize=32)
def prepare_tables(tables: DPTables):
    """(feasible (E, C) int32 0/1, offsets (E,) int32) kernel operands.

    Offsets of never-feasible edges (infeasible even at full capacity) are
    zeroed: those edges are masked everywhere.  Cached by tables identity;
    the returned arrays are shared and read-only.
    """
    feas = np.ascontiguousarray(np.asarray(tables.feasible).T, dtype=np.int32)
    usable = np.asarray(tables.feasible)[tables.full_state]  # (E,)
    offsets = np.where(usable, np.asarray(tables.offsets), 0)
    return feas, offsets.astype(np.int32)


@functools.lru_cache(maxsize=32)
def _off_max(tables: DPTables) -> int:
    """The largest kernel offset: the left-halo width of a tiled plane."""
    offs = prepare_tables(tables)[1]
    return int(offs.max()) if offs.size else 0


@functools.lru_cache(maxsize=32)
def _operands(tables: DPTables, s_cap: int, device: torch.device):
    """(feasible, offsets, v0) on ``device``, made once per tables object,
    height and device."""
    feas, offs = prepare_tables(tables)
    return (torch.as_tensor(feas, device=device),
            torch.as_tensor(offs, device=device),
            core_dp.initial_plane(s_cap, tables.n_states, device))


def prepare_operands(tables: DPTables, s_cap: int, device) -> None:
    """Make the kernels' operands of ``tables`` at height ``s_cap`` on
    ``device`` now (one copy to the card, kept for later solves), so that
    a loop of solves that follows copies nothing from the host."""
    dev = torch.empty(0, device=device).device  # "cuda" → "cuda:0"
    _operands(tables, int(s_cap), dev)


def max_achievable_value(sigma2, tables: DPTables) -> int:
    """Upper bound on any DP partial sum: max Σ̂²ᵀx over capacity-feasible x.

    If every usable edge consumes ≥ 1 device the selection size is capped
    by Σ_k c_k, else by E; the top-k sum of Σ̂² bounds every value the
    kernel can materialize.
    """
    sig = np.asarray(sigma2, dtype=np.int64)
    E = sig.shape[0]
    usable = np.asarray(tables.feasible)[tables.full_state]
    if not usable.any():
        return 0
    cap = np.asarray(tables.cap_of_state, dtype=np.int64)
    c = np.asarray(tables.radices, dtype=np.int64) - 1
    nxt = np.asarray(tables.next_state)[tables.full_state]
    req_total = (c[None, :] - cap[nxt]).sum(axis=1)
    k = min(E, int(c.sum())) if np.all(req_total[usable] >= 1) else E
    top = np.sort(sig[usable])[::-1][:k]
    return int(top.sum())


def _refuse(bound: int, where: str = "") -> None:
    if bound >= VALUE_BOUND:
        raise ValueError(
            f"budgeted-DP values can reach {bound} ≥ 2^29{where}: the int32 "
            "plane can no longer tell NEG-seeded chains from values. Rescale "
            "Σ̂².")


def _check_value_bound(sigma2, tables: DPTables) -> None:
    if sigma2.device.type != "cpu":
        return  # no device sync a solve: the runs check their horizon
    sig = sigma2.numpy()
    worst = sig.max(axis=0) if sig.ndim == 2 else sig
    _refuse(max_achievable_value(worst, tables))


def check_horizon_value_bound(tables: DPTables, m: int, xi, g) -> int:
    """The bound on every DP value of a horizon: :func:`max_achievable_value`
    with every edge at the worst Σ̂² of the (T,) schedule ``xi``, ``g``
    (``stats.sigma2_bound``, read to the host once).  Raises the solves'
    ``ValueError`` when it reaches ``VALUE_BOUND``, whatever the device: a
    run calls this before its first slot."""
    worst = stats.sigma2_bound(xi, g, m)
    bound = max_achievable_value(np.full(tables.feasible.shape[1], worst),
                                 tables)
    _refuse(bound, f" over this horizon (m = {m}, T = {len(xi)})")
    return bound


def _check_u_max(upsilon, u_max: int) -> None:
    """The JAX package's fused kernel clamps Υ̂ at u_max, the height of its
    up halo, so a solve with a larger Υ̂ is outside the contract that both
    packages share: a CPU input that breaks the bound raises (a CUDA one is
    not read back, which would sync; ``stats.u_max_for_horizon`` bounds the
    default schedules)."""
    if upsilon.device.type != "cpu" or upsilon.numel() == 0:
        return
    top = int(upsilon.max())
    if top > u_max:
        raise ValueError(
            f"max Υ̂ = {top} exceeds u_max = {u_max}: the shift scratch is "
            "too short and the kernel would clamp (wrong values). Pass "
            "u_max ≥ max Υ̂ (stats.u_max_for_horizon bounds the default "
            "schedules) or leave u_max=None.")


def _s_limit(s_limit, B: int, device) -> torch.Tensor:
    s_limit = torch.as_tensor(s_limit, device=device).to(torch.int32)
    return s_limit.reshape(-1).expand(B).contiguous()


def _forward(args, tiling, u_max, off_max):
    """The forward pipeline ``tiling = (block_e, block_s, block_c)``
    selects, on ``args = (ups, sig, alw, feas, offs, v0)``: the whole plane
    (``block_c`` None), the per-edge one (``block_e`` None) or the fused
    one.  Returns ``(V, words)``."""
    block_e, block_s, block_c = tiling
    if block_c is None:
        return dp_forward_batched(*args)
    if block_e is None:
        return dp_forward_blocked(*args)
    return dp_forward_fused(*args, block_e=block_e, u_max=u_max,
                            off_max=off_max, block_s=block_s,
                            block_c=block_c)


def solve_budgeted_dp_batched(
    upsilon,
    sigma2,
    tables: DPTables,
    s_cap: int,
    s_limit,
    u_max=None,
    allowed=None,
    block_c="auto",
    block_s=None,
    block_e=None,
):
    """B solves against shared tables: one forward (one launch, or one per
    chunk or edge on a tiled plane) and one epilogue launch.

    ``upsilon``/``sigma2`` (B, E) int32, ``s_limit`` scalar or (B,),
    ``allowed`` optional (B, E) bool — multiplied into the mask inside the
    kernel.  ``u_max`` bounds max Υ̂ and sets the tile floor ``block_s ≥
    u_max`` of a tiled plane; ``None`` means ``s_cap + 1``.

    The tiling knobs are the JAX package's: ``block_c="auto"`` (default)
    picks ``(block_e, block_s, block_c)`` with ``tiling.choose_tiling`` —
    the whole plane when it fits one block's shared memory, else the fused
    pipeline, else the per-edge one — and raises if another knob was
    forced.  ``block_c=None`` forces the whole plane (``ValueError`` when
    it does not fit); an int forces the per-edge pipeline (``block_e=None``,
    B = 1 only) or the fused one (``block_e`` in [1, 32]); ``block_s=None``
    is a full-height tile.  No grid on the card follows the tiles or the
    batch, so the JAX package's ``block_b`` has no counterpart.

    Returns ``(x (B, E), {"s_star": (B,), "value_row": (B, S)})``,
    bit-equal to a per-instance loop over the reference for every legal
    tiling.
    """
    dev = upsilon.device
    B, E = upsilon.shape
    S, C = s_cap + 1, tables.n_states
    _check_value_bound(sigma2, tables)
    u_max = s_cap + 1 if u_max is None else int(u_max)
    _check_u_max(upsilon, u_max)
    feas, offs, v0 = _operands(tables, s_cap, dev)
    off_max = _off_max(tables)
    if block_c == "auto":
        forced = next((name for name, val in (("block_s", block_s),
                                              ("block_e", block_e))
                       if val is not None and val != "auto"), None)
        if forced is not None:
            raise ValueError(
                f'{forced} was forced but block_c is "auto": the auto '
                "tiling would overwrite it — pass a concrete block_c "
                "(e.g. the number of capacity states for a single "
                "full-width tile)")
        block_e, block_s, block_c = choose_tiling(S, C, E, u_max, off_max)
    if block_c is not None and block_e is None and B > 1:
        raise ValueError(
            "batched dispatch supports the whole-plane kernel "
            "(block_c=None) and the edge-fused pipeline (block_e set); the "
            "per-edge-scan pipelines re-stream the plane once per edge and "
            "gain nothing from sharing a launch — run those instances "
            "sequentially instead")
    check_tiling(S, C, u_max, off_max, block_e, block_s, block_c)
    ups = upsilon.to(torch.int32).contiguous()
    sig = sigma2.to(torch.int32).contiguous()
    alw = None if allowed is None else allowed.to(torch.int32).contiguous()
    V, words = _forward((ups, sig, alw, feas, offs, v0),
                        (block_e, block_s, block_c), u_max, off_max)
    x, s_star, row = dp_epilogue(V, words, ups, offs,
                                 _s_limit(s_limit, B, dev), tables.full_state)
    return x, {"s_star": s_star, "value_row": row}


class WarmCudaSolver:
    """Warm-started solves of one instance: carried value planes and
    per-segment forward launches (the JAX package's ``WarmPallasSolver``).

    The fold (edges E−1 … 0) is split into fixed segments of
    ``checkpoint_every`` fold steps, segment si covering edges
    ``[max(E−(si+1)k, 0), E−si·k)``.  Each segment is one forward of the
    cold path on the segment's contiguous slices of Υ̂, Σ̂², allowed,
    feasible and offsets, seeded with the previous segment's plane: on a
    whole plane one ``dp_forward_batched`` launch (K1 at B = 1), on a
    tiled one ``dp_chunk`` launches (K4, one per ≤ 32 edges) or, without a
    fused tile, ``dp_edge`` ones — the tiling ``choose_tiling`` picks for
    the segment's edge count, as the JAX package does.  Chaining launches
    through a plane is the same int32 operation sequence as one launch, so
    the split is bit-invisible.  Across calls the solver keeps every
    inter-segment plane and each segment's packed words: when the new
    inputs leave a prefix of fold steps unchanged (Υ̂, Σ̂² and allowed, in
    fold order), every fully unchanged segment is skipped and the fold
    resumes from the stored plane before the first touched one.  A call
    whose only change is ``s_limit`` launches no forward.

    The words are packed per segment in local edge numbering and stacked
    along the word axis; the epilogue (one launch a call) reads edge e at
    the (word row, bit) of a table made here.  ``stats`` counts solves,
    segments launched and skipped, edges folded and skipped and full hits,
    under the JAX package's keys, and ``skip_rate`` the skipped share of
    edges.

    One instance is bound to one (tables, s_cap) problem on one device
    (``None`` is the card; on the CPU the wrappers run the plain
    versions).  Inputs may be tensors on that device or host arrays; the
    delta mask is computed on the host (one copy a call).  Nothing catches
    a failed launch.  ``accepts_batch`` is False: batched fleets use the
    solve cache (``core.solvers.CachedSolver``).
    """

    accepts_batch = False

    def __init__(
        self,
        tables: DPTables,
        s_cap: int,
        u_max=None,
        checkpoint_every: int = 8,
        device=None,
    ):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:  # as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.tables = tables
        self.s_cap = int(s_cap)
        self.u_max = int(u_max) if u_max is not None else self.s_cap + 1
        self.k = k = int(checkpoint_every)
        if k < 1:
            raise ValueError("checkpoint_every must be >= 1")
        feas, offs, v0 = _operands(tables, self.s_cap, self.device)
        self._feas, self._offs, self._v0 = feas, offs, v0
        E = offs.shape[0]
        S, C = self.s_cap + 1, tables.n_states
        self._E = E
        off_max = _off_max(tables)
        self._off_max = off_max

        # fold-order segments: segment si covers fold steps
        # [si·k, (si+1)·k) = edges [max(E−(si+1)k, 0), E−si·k)
        self._n_seg = max(1, -(-E // k))
        self._bounds = [(max(E - (si + 1) * k, 0), E - si * k)
                        for si in range(self._n_seg)]
        word_off, off = [], 0
        for lo, hi in self._bounds:
            word_off.append(off)
            off += packed_words(hi - lo)
        # global edge e → its word row and bit in the stacked packing
        e_ids = np.arange(E)
        si_of = np.minimum((E - 1 - e_ids) // k, self._n_seg - 1)
        lo_of = np.array([self._bounds[si][0] for si in si_of], np.int64)
        local = e_ids - lo_of
        rows = np.array([word_off[si] for si in si_of], np.int64)
        # checked here on the host, so no solve reads it back from the card
        self._w_rows, self._bits = epilogue_table(rows + local // 32,
                                                  local % 32, self.device)
        self._segments = [
            (lo, hi, feas[lo:hi].contiguous(), offs[lo:hi].contiguous(),
             choose_tiling(S, C, hi - lo, self.u_max, off_max))
            for lo, hi in self._bounds]
        self.reset()
        self.stats = {"solves": 0, "segments_launched": 0,
                      "segments_skipped": 0, "edges_folded": 0,
                      "edges_skipped": 0, "full_hits": 0}

    @property
    def name(self) -> str:
        return "warm:cuda"

    @property
    def skip_rate(self) -> float:
        n = self.stats["edges_folded"] + self.stats["edges_skipped"]
        return self.stats["edges_skipped"] / n if n else 0.0

    def reset(self) -> None:
        """Drop the carried solve (the next call folds everything)."""
        self._planes = [self._v0] + [None] * self._n_seg
        self._words = [None] * self._n_seg
        self._words_cat = None
        self._prev = None  # host (ups, sig, alw) of the carried solve

    def _segment_forward(self, seg, ups, sig, alw, vin):
        """One segment's forward from the (S, C) plane ``vin``: the cold
        path's pipeline for the segment's tiling."""
        lo, hi, feas, offs, tiling = seg
        args = (ups[:, lo:hi].contiguous(), sig[:, lo:hi].contiguous(),
                alw[:, lo:hi].contiguous(), feas, offs, vin)
        return _forward(args, tiling, self.u_max, self._off_max)

    def _tensor(self, a, dtype):
        if isinstance(a, torch.Tensor) and a.device != self.device:
            raise ValueError(f"input on {a.device}; this WarmCudaSolver is "
                             f"bound to {self.device}")
        return torch.as_tensor(a, device=self.device).to(dtype)

    def __call__(
        self,
        upsilon,
        sigma2,
        tables: DPTables,
        s_cap: int,
        s_limit,
        allowed=None,
        u_max=None,
    ):
        from ...core.incremental import host
        if tables is not self.tables or int(s_cap) != self.s_cap:
            raise ValueError(
                "WarmCudaSolver is bound to one (tables, s_cap) problem; "
                "build a new instance for a different one")
        E = self._E
        ups_t = self._tensor(upsilon, torch.int32).reshape(1, E)
        sig_t = self._tensor(sigma2, torch.int32).reshape(1, E)
        alw_t = (torch.ones((1, E), dtype=torch.int32, device=self.device)
                 if allowed is None
                 else self._tensor(allowed, torch.int32).reshape(1, E))
        _check_value_bound(sig_t, self.tables)
        _check_u_max(ups_t, self.u_max)
        ups, sig = host(ups_t)[0], host(sig_t)[0]
        alw = host(alw_t)[0].astype(bool)

        # delta mask in fold order → longest unchanged fold prefix
        if self._prev is None:
            p = 0
        else:
            pu, ps, pa = self._prev
            changed = ((ups[::-1] != pu[::-1]) | (sig[::-1] != ps[::-1])
                       | (alw[::-1] != pa[::-1]))
            nz = np.flatnonzero(changed)
            p = int(nz[0]) if nz.size else E
        si_r = self._n_seg if p >= E else p // self.k

        self.stats["solves"] += 1
        self.stats["segments_skipped"] += si_r
        self.stats["segments_launched"] += self._n_seg - si_r
        folded = 0
        if si_r == self._n_seg:
            self.stats["full_hits"] += 1
        else:
            V = self._planes[si_r]
            for si in range(si_r, self._n_seg):
                V, words = self._segment_forward(
                    self._segments[si], ups_t, sig_t, alw_t, V)
                V = V[0]
                self._planes[si + 1] = V
                self._words[si] = words
                lo, hi = self._bounds[si]
                folded += hi - lo
            self._words_cat = torch.cat(self._words, dim=1)
            self._prev = (ups.copy(), sig.copy(), alw.copy())
        self.stats["edges_folded"] += folded
        self.stats["edges_skipped"] += E - folded

        x, s_star, row = dp_epilogue(
            self._planes[self._n_seg][None], self._words_cat, ups_t,
            self._offs, _s_limit(self._tensor(s_limit, torch.int32), 1,
                                 self.device),
            self.tables.full_state, self._w_rows, self._bits)
        return x[0], {"s_star": s_star[0], "value_row": row[0],
                      "edges_folded": folded}
