"""ESDP — Efficient Sampling-based Dynamic Programming (paper Algorithm 1).

Counterpart of ``repro.core.esdp``.  A policy is a pair (init, step) that
``env.simulate`` drives slot by slot, batch-first: ``init(B, device)``
builds the state of B runs, and

    step(state, slot, eligible, arrived, vhat, n, pol_u) -> (x, state)

takes the slot's schedule values (:class:`Slot`), ``eligible`` (B, E)
bool — channels dispatchable this slot —, ``arrived`` (B, L) bool,
the shared statistics ``vhat`` (B, E) float32 and ``n`` (B, E) int32, and
``pol_u`` (B, E), the slot's uniform draws for policies that break ties
at random.

The per-slot Algorithm-2 solve is pluggable: ``solver=`` names a backend
of ``core.solvers`` (``"reference"`` | ``"cuda"`` | ``"auto"``/None).
A single run is a batch of one: every slot solves the B runs together,
with ``u_max = stats.u_max_for_horizon(T, m, δ)`` bounding Υ̂.

Incremental re-solves (``cache=``), both bit-identical to ``cache=None``:

  ``cache="memo"`` — a one-entry exact memo per run: a run whose (Υ̂, Σ̂²,
    eligibility, s_limit) equal its previous slot's counts a hit and
    reuses its previous x; the slot solves the batch unless every run
    hits (a host-side check, one sync a slot).  Any backend.
  ``cache="warm"`` — each run carries its previous solve's checkpointed
    planes and re-folds only from the first changed edge
    (``core.incremental.solve_budgeted_dp_warm``); the ``reference``
    backend only, as in the JAX package.  The kernel-side warm path is
    ``kernels.budgeted_dp.ops.WarmCudaSolver``, which ``sched.dispatcher``
    drives.

Both count their work in the policy state; ``Policy.finalize`` maps the
final state (``SimResult.policy_final``) of one run to a stats dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from . import stats as stats_mod
from .dp import DPTables, build_tables
from .graph import Instance
from .incremental import solve_budgeted_dp_warm, warm_carry_init
from .solvers import Solver, get_solver

__all__ = ["Slot", "Policy", "PolicyFactory", "make_esdp_policy",
           "esdp_factory", "CACHE_MODES"]

CACHE_MODES = (None, "memo", "warm")


class Slot(NamedTuple):
    """One slot's schedule values (0-d tensors on the device)."""

    xi: Any  # ξ(t) int32
    g: Any  # g(t) float32
    log1p_t: Any  # log(t+1) float32


@dataclasses.dataclass(frozen=True, eq=False)
class Policy:
    """A dispatch policy; ``delta_fn``/``g_fn`` set the schedule the
    simulator tabulates for it (``stats.schedule_table``).  ``finalize``,
    where set, maps a final policy state (numpy, as
    ``SimResult.policy_final`` holds it) and a run's row to a stats
    dict."""

    name: str
    init: Callable[[int, torch.device], Any]
    step: Callable[..., tuple]
    delta_fn: Callable = stats_mod.delta_default
    g_fn: Callable = stats_mod.g_default
    finalize: "Callable[..., dict] | None" = None


# factory(instance, T, tables) -> Policy
PolicyFactory = Callable[[Instance, int, "DPTables | None"], Policy]


def make_esdp_policy(
    instance: Instance,
    T: int,
    delta_fn=stats_mod.delta_default,
    g_fn=stats_mod.g_default,
    tables: DPTables | None = None,
    solver: "str | Solver | None" = None,
    cache: "str | None" = None,
    cache_checkpoint_every: int = 8,
) -> Policy:
    """Build the ESDP policy for an instance over horizon T.

    Scale the statistics with δ(t) (Algorithm 1 Step 3), solve {P4(s,t)}
    and pick s* (Steps 4–8, Algorithm 2), then zero channels that are not
    eligible (Steps 9–16).  ``cache`` selects an incremental re-solve mode
    (``None`` | ``"memo"`` | ``"warm"``, see the module docstring);
    ``cache_checkpoint_every`` is the warm path's checkpoint spacing.
    """
    if cache not in CACHE_MODES:
        raise ValueError(
            f"unknown cache mode {cache!r}; choose from {CACHE_MODES}")
    if tables is None:
        tables = build_tables(instance.A, instance.c)
    solve = get_solver(solver)
    m = instance.m
    E = instance.n_edges
    s_cap = stats_mod.s_cap_for_horizon(T, m, delta_fn)
    # the up-halo height of a tiled plane (Υ̂ ≤ ξ(T))
    u_max = stats_mod.u_max_for_horizon(T, m, delta_fn)

    def scaled(vhat, n, slot):
        ups, sig, s_limit = stats_mod.scale_statistics(vhat, n, slot.xi,
                                                       slot.g, m)
        return ups, sig, s_limit.to(torch.int32).reshape(-1).expand(
            ups.shape[0])

    def policy(init, step, finalize=None):
        return Policy(name="esdp", init=init, step=step, delta_fn=delta_fn,
                      g_fn=g_fn, finalize=finalize)

    if cache is None:
        def init(batch, device):
            return ()  # all ESDP state is the simulator's shared (n, Σz̃)

        def step(state, slot, eligible, arrived, vhat, n, pol_u):
            ups, sig, s_limit = scaled(vhat, n, slot)
            x, _ = solve(ups, sig, tables, s_cap, s_limit, allowed=eligible,
                         u_max=u_max)
            return x * eligible.to(torch.int32), state

        return policy(init, step)

    if cache == "memo":
        def init(batch, device):
            def z(dtype):
                return torch.zeros((batch, E), dtype=dtype, device=device)
            counts = torch.zeros(batch, dtype=torch.int64, device=device)
            # previous inputs and x, valid, hits, solves
            return (z(torch.int32), z(torch.int32), z(torch.bool),
                    torch.zeros(batch, dtype=torch.int32, device=device),
                    z(torch.int32),
                    torch.zeros(batch, dtype=torch.bool, device=device),
                    counts, counts.clone())

        def step(state, slot, eligible, arrived, vhat, n, pol_u):
            p_ups, p_sig, p_alw, p_slim, p_x, valid, hits, solves = state
            ups, sig, s_limit = scaled(vhat, n, slot)
            same = (valid & (ups == p_ups).all(-1) & (sig == p_sig).all(-1)
                    & (eligible == p_alw).all(-1) & (s_limit == p_slim))
            if bool(same.all()):
                x = p_x
            else:
                x, _ = solve(ups, sig, tables, s_cap, s_limit,
                             allowed=eligible, u_max=u_max)
            x = x * eligible.to(torch.int32)
            return x, (ups, sig, eligible, s_limit, x,
                       torch.ones_like(valid), hits + same, solves + 1)

        def finalize(final_state, row: int = 0):
            hits, solves = (int(final_state[6][row]),
                            int(final_state[7][row]))
            return {"cache_hits": hits, "cache_solves": solves,
                    "cache_hit_rate": hits / solves if solves else 0.0}

        return policy(init, step, finalize)

    # cache == "warm": the checkpoint-resumed plain fold, per run
    if solve.name != "reference":
        raise ValueError(
            'cache="warm" carries value-plane checkpoints across slots and '
            "is implemented for the 'reference' backend; got "
            f"{solve.name!r}. Use cache=\"memo\" (any backend) or the "
            "host-loop WarmCudaSolver in sched.dispatcher instead.")
    k = int(cache_checkpoint_every)

    def init(batch, device):
        counts = torch.zeros(batch, dtype=torch.int64, device=device)
        carries = [warm_carry_init(E, s_cap, tables.n_states, k, device)
                   for _ in range(batch)]
        return carries, counts, counts.clone()  # edges folded, solves

    def step(state, slot, eligible, arrived, vhat, n, pol_u):
        carries, folded, solves = state
        ups, sig, s_limit = scaled(vhat, n, slot)
        if ups.device.type != "cpu":
            raise ValueError(
                'cache="warm" folds with the plain reference on CPU '
                f"tensors only, got {ups.device}")
        xs, done = [], []
        for b, carry in enumerate(carries):
            x, info, carries[b] = solve_budgeted_dp_warm(
                ups[b], sig[b], tables, s_cap, s_limit[b], carry,
                allowed=eligible[b], checkpoint_every=k)
            xs.append(x)
            done.append(int(info["edges_folded"]))
        x = torch.stack(xs) * eligible.to(torch.int32)
        return x, (carries, folded + torch.tensor(done), solves + 1)

    def finalize(final_state, row: int = 0):
        folded, solves = int(final_state[1][row]), int(final_state[2][row])
        total = solves * E
        return {"edges_folded": folded, "cache_solves": solves,
                "edge_skip_rate": 1.0 - folded / total if total else 0.0}

    return policy(init, step, finalize)


def esdp_factory(**overrides) -> PolicyFactory:
    """``esdp_factory(g_fn=...)(inst, T, tables)``: ``overrides`` go to
    :func:`make_esdp_policy`; a ``solver=``/``cache=`` given at call time
    (``experiments.sweep.run_spec`` passes its spec's, guided by the
    ``accepts_solver``/``accepts_cache`` flags) applies unless the factory
    pinned one."""
    def make(
        instance: Instance,
        T: int,
        tables: DPTables | None = None,
        solver: "str | Solver | None" = None,
        cache: "str | None" = None,
    ) -> Policy:
        kw = dict(overrides)
        if solver is not None and "solver" not in kw:
            kw["solver"] = solver
        if cache is not None and "cache" not in kw:
            kw["cache"] = cache
        return make_esdp_policy(instance, T, tables=tables, **kw)

    make.policy_name = "esdp"
    make.accepts_solver = True
    make.accepts_cache = True
    return make
