"""The dispatcher's lockstep loop (counterpart of the lockstep half of
``repro.sched.engine``).

:func:`lockstep_run` is the loop behind ``ClusterSim.run``: every arrival
is dispatchable the slot it lands, the bandit keeps float64 host
accumulators, the baselines break ties with a host RNG, and the
failure-aware and malleable runtimes settle work per slot.  It is the JAX
package's loop step for step, so the same seeds give the same dispatch
vectors.  Each slot's tensor work — ESDP's scaled statistics and
Algorithm-2 solve, the baselines' greedy packing, the regret oracle —
runs on the simulator's device (:class:`_SlotOps`); the host reads back
the slot's x and the oracle's x*.

The JAX package's streaming engine (``DispatchEngine``: admission, a
bounded queue with backpressure, weighted A/B policy variants, and a
stream mode bit-identical to this loop) is not ported yet.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..core import stats as stats_mod
from ..core.baselines import greedy_pack
from ..core.dp import oracle_knapsack
from ..core.graph import Instance
from ..core.incremental import host

__all__ = ["LOCKSTEP_POLICIES", "feasible_ports", "lockstep_run"]

# named policies the lockstep loop implements (ClusterSim.run / run_batch
# validate against this)
LOCKSTEP_POLICIES = ("esdp", "hswf", "lcf", "lwtf")


def feasible_ports(instance: Instance) -> np.ndarray:
    """(P,) bool: ports with at least one capacity-respecting edge.

    A port fails when it has no edges at all or when every edge's
    requirement column exceeds cluster capacity; arrivals on such ports
    can never run.
    """
    ok = np.zeros(instance.n_ports, bool)
    fits = np.all(np.asarray(instance.A) <= np.asarray(instance.c)[:, None],
                  axis=0)
    np.logical_or.at(ok, instance.port_of_edge, fits)
    return ok


def _check_policy(policy: str) -> None:
    if policy not in LOCKSTEP_POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}; valid lockstep policies: "
            f"{', '.join(LOCKSTEP_POLICIES)}")


class _SlotOps:
    """A simulator's per-slot tensor work on its device, for one run or a
    fleet (leading batch axis): numpy in, numpy out."""

    def __init__(self, sim):
        self.sim = sim
        self.dev = sim.device
        inst = sim.inst
        self.A = torch.as_tensor(np.asarray(inst.A), device=self.dev)
        self.c = torch.as_tensor(np.asarray(inst.c), device=self.dev)
        # the ESDP solver: the warm path, or the (possibly cached) backend
        self.solver = sim._warm if sim.incremental == "warm" else sim.solver

    def _on(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=self.dev)

    def esdp(self, vhat, n, allowed, t0: int) -> np.ndarray:
        """ESDP's x for slot ``t0`` (0-based): the scaled statistics from
        the schedule table's ξ(t), g(t) at t = t0 + 1, then the solve."""
        sim = self.sim
        ups, sig, s_lim = stats_mod.scale_statistics(
            self._on(vhat), self._on(n, np.int32), sim.xi_tab[t0],
            sim.g_tab[t0], sim.m)
        x, _ = self.solver(ups, sig, sim.tables, sim.s_cap, s_lim,
                           allowed=self._on(allowed), u_max=sim.u_max)
        return host(x)

    def greedy(self, score, allowed) -> np.ndarray:
        """Greedy packing by ``score`` (cast to float32, as the JAX package
        hands a float64 score to its jitted packer)."""
        score = np.asarray(score, np.float32)
        single = score.ndim == 1
        x = greedy_pack(self._on(score[None] if single else score),
                        self._on(allowed[None] if single else allowed),
                        self.A, self.c)
        return host(x[0] if single else x)

    def oracle(self, v_true, allowed) -> np.ndarray:
        """The omniscient x*(t) under the slot's eligibility."""
        x_star, _ = oracle_knapsack(self._on(v_true), self.sim.tables,
                                    self._on(allowed))
        return host(x_star)


def lockstep_run(sim, policy: str = "esdp", tiebreak: float = 1e-4):
    """The paper-faithful lockstep loop behind ``ClusterSim.run``.

    With ``sim.malleable`` set the slot flow gains the malleable phases
    (grow → solve → admit/shrink/preempt → advance) and the bandit learns
    realized per-job gains at completion; with ``sim.failures`` set the
    slot's crashes are settled (replicas, checkpoints) before the bandit
    update.
    """
    from .dispatcher import FailureRuntime, MalleableRuntime, SimOutput

    _check_policy(policy)
    inst = sim.inst
    E, R = inst.n_edges, inst.n_servers
    port = inst.port_of_edge
    server = inst.edges[:, 1]
    arrivals, noise = sim._streams()
    rng = np.random.default_rng(sim.seed + 1)
    ops = _SlotOps(sim)

    n = np.zeros(E, np.int64)
    sumz = np.zeros(E, np.float64)
    waiting = np.zeros(inst.n_ports, np.int64)

    sw = np.zeros(sim.T, np.float32)
    regret = np.zeros(sim.T, np.float32)
    share = np.zeros((sim.T, R), np.float32)
    xs = np.zeros((sim.T, E), np.int32)

    fr = (FailureRuntime(sim.failures, inst, sim.T, sim.alive_fn, sim.seed)
          if sim.failures is not None else None)
    mr = (MalleableRuntime(sim.malleable, inst, sim.T)
          if sim.malleable is not None else None)

    for t0 in range(sim.T):
        alive_srv = np.asarray(sim.alive_fn(t0), bool)  # 0-based
        alive = alive_srv[server]
        arrived = arrivals[t0][port]
        allowed = arrived & alive
        if fr is not None:
            allowed = fr.eligibility(allowed, server)
        if mr is not None:
            mr.grow(t0)
        vhat = np.where(n > 0, sumz / np.maximum(n, 1), 0.0).astype(
            np.float32)

        if policy == "esdp":
            x = ops.esdp(vhat, n, allowed, t0)
        else:
            tb = rng.random(E).astype(np.float32) * tiebreak
            if policy == "hswf":
                score = vhat + tb
            elif policy == "lcf":
                score = -inst.cost + tb
            else:  # lwtf
                score = waiting[port] * 1e3 + vhat + tb
            x = ops.greedy(score, allowed)

        x = x * allowed
        z = sim._z(t0, noise[t0])
        settled = None
        if mr is not None:
            x = mr.admit(t0, x, vhat)
            sw[t0], settled = mr.advance(t0, z)
        elif fr is None:
            sw[t0] = float((x * z).sum())
            bandit_z = x * z
        else:
            crashed = fr.crashed_servers(t0, alive_srv)
            reps = fr.place_replicas(t0, x, allowed)
            sw[t0], bandit_z = fr.settle(t0, x, z, crashed, reps)
            fr.observe(t0, crashed)
        xs[t0] = x
        v_true = sim._v_true(t0)
        x_star = ops.oracle(v_true, allowed)
        regret[t0] = float((v_true * x_star).sum() - (v_true * x).sum())

        if mr is not None:
            # the bandit learns realized per-job totals at settlement
            # (completion or shutdown) — mid-flight jobs are not yet signal
            for e0, gain in settled:
                n[e0] += 1
                sumz[e0] += max(gain, 0.0)
        else:
            n += x
            sumz += bandit_z
        served = np.zeros(inst.n_ports, bool)
        np.maximum.at(served, port, x > 0)
        waiting = np.where(served, 0, waiting + arrivals[t0])
        if x.sum() > 0:
            np.add.at(share[t0], server, x / x.sum())

    return SimOutput(sw=sw, regret=regret, dispatch_share=share,
                     asw=float(sw.sum()),
                     solve_stats=(sim._solve_stats()
                                  if policy == "esdp" else None),
                     failures=fr.summary() if fr is not None else None,
                     malleable=mr.summary() if mr is not None else None,
                     x=xs)


def lockstep_run_batch(sim, seeds, policy: str = "esdp", tiebreak: float = 1e-4):
    """``ClusterSim.run_batch``'s loop: the rigid lockstep loop for a seed
    fleet, each seed with its own streams and bandit state against the
    shared schedule, one batched solve (or greedy pack, or oracle) per
    slot for the whole fleet."""
    from .dispatcher import SimOutput

    _check_policy(policy)
    inst = sim.inst
    E, R = inst.n_edges, inst.n_servers
    port = inst.port_of_edge
    server = inst.edges[:, 1]
    seeds = [int(s) for s in seeds]
    B = len(seeds)
    streams = [sim._streams(s) for s in seeds]
    arrivals = np.stack([a for a, _ in streams])  # (B, T, P)
    noise = np.stack([z for _, z in streams])  # (B, T, E)
    rngs = [np.random.default_rng(s + 1) for s in seeds]
    b_ids = np.arange(B)[:, None]
    ops = _SlotOps(sim)

    n = np.zeros((B, E), np.int64)
    sumz = np.zeros((B, E), np.float64)
    waiting = np.zeros((B, inst.n_ports), np.int64)

    sw = np.zeros((B, sim.T), np.float32)
    regret = np.zeros((B, sim.T), np.float32)
    share = np.zeros((B, sim.T, R), np.float32)
    xs = np.zeros((B, sim.T, E), np.int32)

    for t0 in range(sim.T):
        alive = np.asarray(sim.alive_fn(t0), bool)[server]  # shared
        arrived = arrivals[:, t0][:, port]  # (B, E)
        allowed = arrived & alive[None, :]
        vhat = np.where(n > 0, sumz / np.maximum(n, 1), 0.0).astype(
            np.float32)

        if policy == "esdp":
            x = ops.esdp(vhat, n, allowed, t0)
        else:
            tb = np.stack([r.random(E) for r in rngs]).astype(
                np.float32) * tiebreak
            if policy == "hswf":
                score = vhat + tb
            elif policy == "lcf":
                score = -inst.cost[None, :] + tb
            else:  # lwtf
                score = waiting[:, port] * 1e3 + vhat + tb
            x = ops.greedy(score, allowed)

        x = x * allowed
        xs[:, t0] = x
        z = sim._z(t0, noise[:, t0])  # broadcasts to (B, E)
        sw[:, t0] = (x * z).sum(axis=1)
        v_true = sim._v_true(t0)
        x_star = ops.oracle(v_true, allowed)
        regret[:, t0] = ((v_true[None, :] * x_star).sum(axis=1)
                         - (v_true[None, :] * x).sum(axis=1))

        n += x
        sumz += x * z
        served = np.zeros((B, inst.n_ports), bool)
        np.maximum.at(served, (b_ids, port[None, :]), x > 0)
        waiting = np.where(served, 0, waiting + arrivals[:, t0])
        tot = x.sum(axis=1)
        for b in np.flatnonzero(tot > 0):
            np.add.at(share[b, t0], server, x[b] / tot[b])

    stats = sim._solve_stats() if policy == "esdp" else None
    if stats is not None:
        # the counters cover the whole fleet's solves: label them, and
        # hand every output its own copy (nested counters included)
        stats["scope"] = "fleet"
    return [SimOutput(sw=sw[b], regret=regret[b], dispatch_share=share[b],
                      asw=float(sw[b].sum()),
                      solve_stats=(copy.deepcopy(stats) if stats is not None
                                   else None),
                      x=xs[b])
            for b in range(B)]
