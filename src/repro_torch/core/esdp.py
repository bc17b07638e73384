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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from . import stats as stats_mod
from .dp import DPTables, build_tables
from .graph import Instance
from .solvers import Solver, get_solver

__all__ = ["Slot", "Policy", "PolicyFactory", "make_esdp_policy",
           "esdp_factory"]


class Slot(NamedTuple):
    """One slot's schedule values (0-d tensors on the device)."""

    xi: Any  # ξ(t) int32
    g: Any  # g(t) float32
    log1p_t: Any  # log(t+1) float32


@dataclasses.dataclass(frozen=True, eq=False)
class Policy:
    """A dispatch policy; ``delta_fn``/``g_fn`` set the schedule the
    simulator tabulates for it (``stats.schedule_table``)."""

    name: str
    init: Callable[[int, torch.device], Any]
    step: Callable[..., tuple]
    delta_fn: Callable = stats_mod.delta_default
    g_fn: Callable = stats_mod.g_default


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
) -> Policy:
    """Build the ESDP policy for an instance over horizon T.

    Scale the statistics with δ(t) (Algorithm 1 Step 3), solve {P4(s,t)}
    and pick s* (Steps 4–8, Algorithm 2), then zero channels that are not
    eligible (Steps 9–16).  ``cache`` must be ``None``: the incremental
    re-solve modes of the JAX package are not ported yet.
    """
    if cache in ("memo", "warm"):
        raise NotImplementedError(
            f"cache={cache!r} comes with the incremental re-solve slice of "
            "the port; use cache=None")
    if cache is not None:
        raise ValueError(f"unknown cache mode {cache!r}; choose None")
    if tables is None:
        tables = build_tables(instance.A, instance.c)
    solve = get_solver(solver)
    m = instance.m
    s_cap = stats_mod.s_cap_for_horizon(T, m, delta_fn)
    # the up-halo height of a tiled plane (Υ̂ ≤ ξ(T))
    u_max = stats_mod.u_max_for_horizon(T, m, delta_fn)

    def init(batch, device):
        return ()  # all ESDP state is the simulator's shared (n, Σz̃)

    def step(state, slot, eligible, arrived, vhat, n, pol_u):
        ups, sig, s_limit = stats_mod.scale_statistics(vhat, n, slot.xi,
                                                       slot.g, m)
        x, _ = solve(ups, sig, tables, s_cap, s_limit, allowed=eligible,
                     u_max=u_max)
        return x * eligible.to(torch.int32), state

    return Policy(name="esdp", init=init, step=step, delta_fn=delta_fn,
                  g_fn=g_fn)


def esdp_factory(**overrides) -> PolicyFactory:
    """``esdp_factory(g_fn=...)(inst, T, tables)``: ``overrides`` go to
    :func:`make_esdp_policy`; a ``solver=``/``cache=`` given at call time
    applies unless the factory pinned one."""
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
    return make
