"""Cross-slot incremental re-solves for the per-slot Algorithm-2 DP.

Counterpart of ``repro.core.incremental``.  Between slots only the scaled
statistics (Υ̂, Σ̂²) and the eligibility mask move, and after exploration
they move slowly, so most solves are near-duplicates of the previous one.
Two layers use that:

**Solve cache** (:class:`SolveCache`): a host-side memo keyed on the
quantized solve inputs ``(Υ̂ ÷ q_ups, Σ̂² ÷ q_sig, eligibility,
s_limit)``.  With quantum 1 the key is the exact inputs and a hit returns
the bit-identical ``(x, s_star, value_row)`` without a launch; coarser
quanta serve solutions of nearby statistics (still capacity-feasible),
each entry for at most ``max_stale`` cache ticks.  The keys are the JAX
package's bytes, so both packages hit and miss on the same calls.
Consumed through :class:`repro_torch.core.solvers.CachedSolver`.

**Warm-started value planes** (:func:`solve_budgeted_dp_warm`): a re-solve
that carries the previous solve's checkpointed planes (every
``checkpoint_every`` fold steps), its decision planes and its inputs, and
re-folds only from the last checkpoint at or before the first changed
edge.  Resuming from a plane that has absorbed exactly the unchanged fold
prefix, never from the final plane (which would take a re-folded edge
twice), keeps the result bit-identical to a cold solve.

Fold order: edges fold E−1 down to 0, so fold step j is edge E−1−j, and
every edge-indexed carry member here is in fold order.  The kernel-side
warm path, segment launches chained through a carried plane, is
``repro_torch.kernels.budgeted_dp.ops.WarmCudaSolver``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .dp import NEG, DPTables, _device_tables, dp_edge_fold, initial_plane
from .dp import select_and_backtrack

__all__ = [
    "SolveCache", "CacheStats", "solve_key",
    "WarmCarry", "warm_carry_init", "solve_budgeted_dp_warm",
    "changed_edge_mask", "unchanged_fold_prefix", "n_checkpoints",
]


def host(a):
    """A numpy array of ``a`` (a tensor on any device, an array or a
    scalar); a CUDA tensor is copied to the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# quantized solve keys + the host-side cache
# ---------------------------------------------------------------------------

def solve_key(
    upsilon, sigma2, allowed, s_limit, q_ups: int = 1, q_sig: int = 1
) -> bytes:
    """Deterministic cache key of one solve's dynamic inputs: the JAX
    package's bytes for the same values.

    ``q_ups``/``q_sig`` floor-divide the statistics into buckets; quantum 1
    keys the exact inputs.  Eligibility and ``s_limit`` are always exact.
    Fixed field order and fixed per-field widths keep distinct inputs of
    one problem apart.
    """
    ups = host(upsilon).astype(np.int64) // int(q_ups)
    sig = host(sigma2).astype(np.int64) // int(q_sig)
    alw = (np.ones(ups.shape, bool) if allowed is None
           else host(allowed).astype(bool))
    return (np.int64(int(host(s_limit))).tobytes() + ups.tobytes()
            + sig.tobytes() + np.packbits(alw).tobytes())


@dataclasses.dataclass
class CacheStats:
    """Counters of one :class:`SolveCache` (row granularity for batches)."""

    hits: int = 0  # key lookups served from the cache
    misses: int = 0  # key lookups that fell through
    evictions: int = 0  # entries dropped by the capacity bound
    stale_rejects: int = 0  # quantized entries refused by max_stale
    bypasses: int = 0  # kept for the JAX package's keys; always 0 here
    launches_saved: int = 0  # backend solves skipped entirely

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "stale_rejects": self.stale_rejects,
                "bypasses": self.bypasses,
                "launches_saved": self.launches_saved,
                "cache_hit_rate": self.hit_rate}


class SolveCache:
    """Bounded host-side memo of budgeted-DP solutions.

    * ``capacity`` bounds the entry count; overflow evicts in LRU order
      (a hit refreshes recency), deterministic for a given call sequence.
    * ``q_ups``/``q_sig`` = 1 (default) is the bit-exact mode; larger
      quanta give the bounded-staleness approximate mode, where
      ``max_stale`` bounds how many ticks (:meth:`tick`, one per solve
      call) an entry may serve after insertion.
    * ``exact`` says which contract a consumer gets.
    """

    def __init__(
        self,
        capacity: int = 512,
        q_ups: int = 1,
        q_sig: int = 1,
        max_stale: "int | None" = None,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if q_ups < 1 or q_sig < 1:
            raise ValueError("quantization quanta must be >= 1")
        self.capacity = int(capacity)
        self.q_ups = int(q_ups)
        self.q_sig = int(q_sig)
        self.max_stale = max_stale
        self.stats = CacheStats()
        self._entries: "collections.OrderedDict[bytes, tuple[int, Any]]" = (
            collections.OrderedDict())
        self._tick = 0

    @property
    def exact(self) -> bool:
        return self.q_ups == 1 and self.q_sig == 1

    def key(self, upsilon, sigma2, allowed, s_limit) -> bytes:
        return solve_key(upsilon, sigma2, allowed, s_limit,
                         q_ups=self.q_ups, q_sig=self.q_sig)

    def tick(self) -> None:
        """Advance the staleness clock — once per solve call."""
        self._tick += 1

    def get(self, key: bytes):
        ent = self._entries.get(key)
        if ent is None:
            self.stats.misses += 1
            return None
        born, value = ent
        if self.max_stale is not None and self._tick - born > self.max_stale:
            del self._entries[key]
            self.stats.stale_rejects += 1
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        return value

    def put(self, key: bytes, value) -> None:
        self._entries[key] = (self._tick, value)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def clear(self) -> None:
        self._entries.clear()
        self.stats = CacheStats()
        self._tick = 0

    def __len__(self) -> int:
        return len(self._entries)


# ---------------------------------------------------------------------------
# delta mask + warm-started (checkpoint-resumed) reference solve
# ---------------------------------------------------------------------------

class WarmCarry(NamedTuple):
    """Cross-slot fold artifacts of one solve, in fold order (entry j is
    edge E−1−j).  ``ckpts[i]`` is the plane after exactly i·k fold steps
    (``ckpts[0]`` the cold-start plane), ``v_final`` the plane after all E,
    ``decisions[j]`` fold step j's decision plane.  The carry always holds
    what a cold solve of ``(ups_f, sig_f, alw_f)`` would produce."""

    ups_f: torch.Tensor  # (E,) int32
    sig_f: torch.Tensor  # (E,) int32
    alw_f: torch.Tensor  # (E,) bool
    ckpts: torch.Tensor  # (n_ckpt, S, C) int32
    v_final: torch.Tensor  # (S, C) int32
    decisions: torch.Tensor  # (E, S, C) bool
    valid: bool  # False forces a full cold fold


def n_checkpoints(n_edges: int, checkpoint_every: int) -> int:
    """Planes stored at fold steps i·k for i = 0 .. (E−1)//k (a resume
    point is always < E; the final plane is carried separately)."""
    return max(1, (n_edges - 1) // checkpoint_every + 1)


def warm_carry_init(
    n_edges: int,
    s_cap: int,
    n_states: int,
    checkpoint_every: int = 8,
    device=None,
) -> WarmCarry:
    """A fresh (invalid) carry on ``device`` (``None`` is the card): the
    first warm solve runs a full cold fold."""
    dev = resolve_device(device)
    S = s_cap + 1
    ckpts = torch.zeros((n_checkpoints(n_edges, checkpoint_every), S,
                         n_states), dtype=torch.int32, device=dev)
    ckpts[0] = initial_plane(s_cap, n_states, dev)
    return WarmCarry(
        ups_f=torch.zeros(n_edges, dtype=torch.int32, device=dev),
        sig_f=torch.zeros(n_edges, dtype=torch.int32, device=dev),
        alw_f=torch.zeros(n_edges, dtype=torch.bool, device=dev),
        ckpts=ckpts,
        v_final=torch.zeros((S, n_states), dtype=torch.int32, device=dev),
        decisions=torch.zeros((n_edges, S, n_states), dtype=torch.bool,
                              device=dev),
        valid=False)


def changed_edge_mask(carry: WarmCarry, upsilon, sigma2, allowed):
    """(E,) bool in fold order — the delta mask: True where the edge's
    solve inputs differ from the carried solve (an invalid carry marks
    every edge changed)."""
    alw = (torch.ones(upsilon.shape, dtype=torch.bool, device=upsilon.device)
           if allowed is None else allowed.bool())
    changed = ((upsilon.flip(0) != carry.ups_f)
               | (sigma2.flip(0) != carry.sig_f)
               | (alw.flip(0) != carry.alw_f))
    return changed | (not carry.valid)


def unchanged_fold_prefix(changed) -> int:
    """Length of the leading all-False run of a fold-order delta mask."""
    nz = torch.nonzero(changed)
    return int(nz[0, 0]) if nz.numel() else int(changed.shape[0])


def solve_budgeted_dp_warm(
    upsilon,
    sigma2,
    tables: DPTables,
    s_cap: int,
    s_limit,
    carry: WarmCarry,
    allowed=None,
    checkpoint_every: int = 8,
):
    """Warm-started :func:`repro_torch.core.dp.solve_budgeted_dp` for one
    (E,) instance: bit-identical outputs, folding only the edges after the
    last checkpoint at or before the first changed edge.

    ``s_limit`` is not part of the delta mask: the eq.-17 selection and the
    backtrack run every call, so a changed budget alone folds nothing.
    The checkpoint and decision tensors of ``carry`` are updated in place
    and returned in the new carry (the old carry is not to be reused).
    Returns ``(x, info, carry')`` where ``info`` adds ``edges_folded`` (an
    int32 0-d tensor, E minus the skipped fold steps) to ``s_star`` and
    ``value_row`` (exactly NEG at budget-infeasible entries).  Plain
    PyTorch on the inputs' device.
    """
    E = upsilon.shape[0]
    S = s_cap + 1
    k = int(checkpoint_every)
    dev = upsilon.device
    upsilon = upsilon.to(torch.int32)
    sigma2 = sigma2.to(torch.int32)
    alw = (torch.ones(E, dtype=torch.bool, device=dev) if allowed is None
           else allowed.bool())

    p = unchanged_fold_prefix(changed_edge_mask(carry, upsilon, sigma2,
                                                alw))
    # resume at the last checkpoint at or below the first change; a fully
    # unchanged fold (p == E) reuses the final plane and the decisions
    resume = E if p >= E else (p // k) * k
    V = (carry.v_final if resume == E
         else carry.ckpts[min(resume // k, carry.ckpts.shape[0] - 1)])
    V = V[None]
    ckpts, decisions = carry.ckpts, carry.decisions
    feasible, next_state = _device_tables(tables, dev)
    rows = torch.arange(S, device=dev)
    ups_f, sig_f, alw_f = upsilon.flip(0), sigma2.flip(0), alw.flip(0)
    for j in range(resume, E):
        if j % k == 0:
            ckpts[j // k] = V[0]
        e = E - 1 - j
        feas = (feasible[:, e] & alw[e])[None]
        V, d = dp_edge_fold(V, ups_f[j:j + 1], sig_f[j:j + 1], feas,
                            next_state[:, e], rows)
        decisions[j] = d[0]

    s_limit = torch.as_tensor(s_limit, device=dev).to(torch.int32).reshape(1)
    x, s_star, v_row = select_and_backtrack(
        V, lambda e: decisions[E - 1 - e][None], upsilon[None], s_limit,
        tables)
    new_carry = WarmCarry(ups_f=ups_f, sig_f=sig_f, alw_f=alw_f, ckpts=ckpts,
                          v_final=V[0], decisions=decisions, valid=True)
    info = {"s_star": s_star[0],
            "value_row": torch.where(v_row[0] >= 0, v_row[0], NEG),
            "edges_folded": torch.tensor(E - resume, dtype=torch.int32)}
    return x[0], info, new_carry
