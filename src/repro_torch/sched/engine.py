"""The streaming dispatch engine and the dispatcher's lockstep loop
(counterpart of ``repro.sched.engine``).

:class:`DispatchEngine` is the production form of the dispatcher:
arrivals on ports with no capacity-respecting edge are dead-lettered at
admission; the rest wait in a bounded per-port FIFO (plus a global
bound) whose overflow fires a backpressure policy (``drop_oldest``,
``block`` or ``shed_by_utility``); each slot every port serves at most
its head job on one edge, in priority order (estimated utility, then the
oldest job, the least-loaded server, the edge index), each start
capacity-checked against what is left; and jobs hash onto weighted A/B
policy variants (ESDP and the greedy baselines), each with its own bandit
state, welfare and regret.  The slot functions are batch-first: every
carry tensor has a leading seed axis B.

* ``mode="stream"`` runs the horizon as one loop over device tensors
  (queue, bandit counts and sums, server load, every per-slot trace) and
  reads nothing back from the card until the loop ends;
  ``run_batch(seeds)`` is the same loop with B = len(seeds), so each ESDP
  variant solves the whole fleet of a slot in one forward and one
  epilogue launch.
* ``mode="lockstep"`` drives the same slot functions one slot at a time
  and reads each slot back: host-side solver wrappers (``CachedSolver``,
  ``FallbackSolver``, ``WarmCudaSolver``) act on every call, and the
  failure runtime settles each variant's crashes on the host.  Fault-free
  it is bit-identical to ``stream``.

:func:`lockstep_run` is the loop behind ``ClusterSim.run``: every arrival
is dispatchable the slot it lands, the bandit keeps float64 host
accumulators, the baselines break ties with a host RNG, and the
failure-aware and malleable runtimes settle work per slot.  It is the JAX
package's loop step for step, so the same seeds give the same dispatch
vectors.  Each slot's tensor work — ESDP's scaled statistics and
Algorithm-2 solve, the baselines' greedy packing, the regret oracle —
runs on the simulator's device (:class:`_SlotOps`); the host reads back
the slot's x and the oracle's x*.

Roundings follow XLA's on the JAX engine's slot: the valuation mean
μ·speed − cost and the noise added to it are each one fused multiply-add
(``torch.addcmul``), as are the greedy scores' tie-break terms; the
failure path's settlement computes the same two lines in numpy, a
multiply and then an add, as the JAX engine's host settlement does.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..core import stats as stats_mod
from ..core.baselines import greedy_pack
from ..core.dp import build_tables, oracle_knapsack
from ..core.graph import Instance
from ..core.incremental import host
from ..device import resolve_device

__all__ = ["BACKPRESSURE_POLICIES", "LOCKSTEP_POLICIES", "VARIANT_KINDS",
           "VariantSpec", "EngineConfig", "EngineOutput", "DispatchEngine",
           "route_u01", "lexsort_order", "feasible_ports", "lockstep_run"]

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


BACKPRESSURE_POLICIES = ("drop_oldest", "block", "shed_by_utility")
VARIANT_KINDS = ("esdp", "hswf", "lcf", "lwtf")

_EMPTY = -1  # queue sentinel: no job in this slot of the FIFO
_I32_MAX = 2 ** 31 - 1
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One policy variant in the weighted A/B rollout.

    ``kind`` picks the dispatch rule (``esdp`` — the paper's Algorithm 1/2
    bandit; ``hswf``/``lcf``/``lwtf`` — the greedy baselines); ``weight``
    is the traffic fraction (normalized over the config); ``solver``
    optionally pins an ``esdp`` variant's Algorithm-2 backend (a registry
    name or a solver object; host-side wrappers act on every call in
    either mode, and read the statistics back to the host to do so).
    """
    name: str
    kind: str = "esdp"
    weight: float = 1.0
    solver: "str | object | None" = None

    def __post_init__(self):
        if self.kind not in VARIANT_KINDS:
            raise ValueError(f"unknown variant kind {self.kind!r}; "
                             f"choose from {VARIANT_KINDS}")
        if not self.weight > 0:
            raise ValueError("variant weight must be > 0")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Queueing and rollout knobs of the streaming engine.

    ``queue_capacity`` bounds each port's FIFO; ``total_capacity`` bounds
    the whole queue (default ``P × queue_capacity``: only the per-port
    bound binds).  ``backpressure`` picks the overflow policy
    (:data:`BACKPRESSURE_POLICIES`).  ``route_salt`` perturbs the
    deterministic job-id → variant hash (same seed and salt, same split).
    """
    queue_capacity: int = 4
    total_capacity: "int | None" = None
    backpressure: str = "drop_oldest"
    variants: "tuple[VariantSpec, ...]" = (VariantSpec("esdp"),)
    route_salt: int = 0x5A17

    def __post_init__(self):
        if self.backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"unknown backpressure policy {self.backpressure!r}; "
                f"choose from {BACKPRESSURE_POLICIES}")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if not self.variants:
            raise ValueError("need at least one variant")
        names = [v.name for v in self.variants]
        if len(set(names)) != len(names):
            raise ValueError(f"variant names must be unique: {names}")


@dataclasses.dataclass(frozen=True)
class EngineOutput:
    """Per-slot traces, per-variant accounting and the conservation
    ledger of one trace.

    ``ledger`` conserves exactly:

        arrivals  = rejected + blocked + admitted               (admission)
        admitted  = dispatched + dropped + shed + final_queue   (queue)

    with ``rejected`` the dead-letter count (never-feasible ports) and
    ``dispatched`` the jobs started.  ``n``/``sumz`` are the final
    per-variant bandit statistics; rejected and shed jobs never enter
    them.  ``x`` (T, V, E) holds each slot's dispatch vector per variant.
    """
    sw: np.ndarray  # (T,)
    regret: np.ndarray  # (T,)
    dispatch_share: np.ndarray  # (T, R)
    asw: float
    variants: "tuple[str, ...]"
    sw_variant: np.ndarray  # (T, V)
    regret_variant: np.ndarray  # (T, V)
    dispatched_variant: np.ndarray  # (T, V) jobs started per variant
    routed_variant: np.ndarray  # (T, V) admitted arrivals routed per variant
    n: np.ndarray  # (V, E) final bandit pull counts
    sumz: np.ndarray  # (V, E) final bandit reward sums
    ledger: dict  # per-slot int32 arrays + totals (see the docstring)
    queue_len: np.ndarray  # (T,) jobs queued after each slot
    mode: str
    solve_stats: "dict | None" = None  # {variant: counters} for wrappers
    failures: "dict | None" = None  # combined + per-variant crash ledgers
    x: "np.ndarray | None" = None  # (T, V, E) dispatch vectors

    @property
    def cum_regret(self):
        return np.cumsum(self.regret)


def _mul_u32(a, b: int):
    """(a · b) mod 2³² for int64 ``a`` in [0, 2³²) and a host constant
    ``b`` < 2³², in int64 throughout: ``b`` split into 16-bit halves keeps
    every product below 2⁴⁹."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + ((a * hi) & 0xFFFF) * 65536) & _MASK32


def route_u01(job_id, salt):
    """Deterministic job-id → [0, 1) hash (splitmix-style avalanche): the
    JAX package's uint32 arithmetic, wrapped, on int64 tensors masked to
    32 bits after every multiply (the card has no full uint32
    arithmetic).  ``job_id`` and ``salt`` broadcast; negative ids wrap as
    a uint32 cast does.  The hash is rounded to float32 (to nearest) and
    scaled by 2⁻³²."""
    h = _mul_u32(job_id & _MASK32, 0x9E3779B1)
    h = h ^ (salt & _MASK32)
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * 2.0 ** -32


def lexsort_order(keys, descending):
    """Row-wise ``jnp.lexsort`` (the last key primary; equal keys, −0.0
    and 0.0 among them, keep index order) of (B, E) ``keys``: one stable
    sort per key from the least significant, each ascending or
    ``descending``.  Returns the (B, E) int64 order."""
    B, E = keys[0].shape
    perm = torch.arange(E, device=keys[0].device).expand(B, E)
    for key, desc in zip(keys, descending):
        idx = torch.sort(key.gather(1, perm), dim=1, descending=desc,
                         stable=True).indices
        perm = perm.gather(1, idx)
    return perm


class DispatchEngine:
    """The streaming admission/queue/dispatch loop over one instance, on
    ``device`` (``None`` is the card).

    Construction mirrors :class:`ClusterSim`: ``scenario=`` (a registered
    regime's name, a ``core.env.Scenario`` unrolled on the host from
    ``seed``, or an unrolled ``(arr_scale, speed, alive)`` trace) or raw
    ``speed_fn``/``alive_fn`` schedules and ``arr_scale`` (a scalar or
    (T, P)); the schedule is shared by every seed.  ``schedule`` —
    ``(xi, g)``, each (T,) — replaces the per-slot ξ(t), g(t) of ESDP's
    statistics (default ``stats.schedule_table`` on ``device``).
    ``ClusterSim.engine()`` builds one that shares the sim's instance,
    horizon, schedule, seed and failure model.
    """

    def __init__(
        self,
        instance: Instance,
        T: int,
        config: "EngineConfig | None" = None,
        *,
        scenario=None,
        speed_fn=None,
        alive_fn=None,
        arr_scale=None,
        g_fn=stats_mod.g_logt_only,
        seed: int = 0,
        failures=None,
        device=None,
        schedule=None,
    ):
        from ..core.solvers import get_solver
        self.device = resolve_device(device)
        self.inst = instance
        self.T = T = int(T)
        self.config = config or EngineConfig()
        self.g_fn = g_fn
        self.seed = int(seed)
        self.failures = failures
        self.tables = build_tables(instance.A, instance.c)
        self.m = instance.m
        self.s_cap = stats_mod.s_cap_for_horizon(T, self.m)
        self.u_max = stats_mod.u_max_for_horizon(T, self.m)
        P, R = instance.n_ports, instance.n_servers

        if scenario is not None:
            if speed_fn is not None or alive_fn is not None:
                raise ValueError("pass either scenario= or "
                                 "speed_fn/alive_fn, not both")
            from .dispatcher import unrolled_trace
            arr_scale, self.speed, self.alive = unrolled_trace(
                scenario, instance, T, self.seed)
        else:
            self.speed = (np.ones((T, R), np.float32) if speed_fn is None
                          else np.stack([np.asarray(speed_fn(t), np.float32)
                                         for t in range(T)]))
            self.alive = (np.ones((T, R), bool) if alive_fn is None
                          else np.stack([np.asarray(alive_fn(t), bool)
                                         for t in range(T)]))
        self.arr_scale = (np.ones((T, P), np.float32) if arr_scale is None
                          else np.asarray(arr_scale, np.float32))
        self.port_ok = feasible_ports(instance)
        if schedule is None:
            schedule = stats_mod.schedule_table(
                T, self.m, stats_mod.delta_default, g_fn, self.device)
        self.xi_tab, self.g_tab = (torch.as_tensor(a, device=self.device)
                                   for a in tuple(schedule)[:2])
        if any(v.kind == "esdp" for v in self.config.variants):
            # a variant solves the DP every slot: refuse, before any, a
            # horizon whose DP values could reach the int32 plane's bound
            from ..kernels.budgeted_dp.ops import check_horizon_value_bound
            check_horizon_value_bound(self.tables, self.m, self.xi_tab,
                                      self.g_tab)

        cfg = self.config
        self.Q = int(cfg.queue_capacity)
        self.Ktot = int(cfg.total_capacity if cfg.total_capacity is not None
                        else P * self.Q)
        w = np.asarray([v.weight for v in cfg.variants], np.float64)
        # routing thresholds: variant v wins u01 ∈ [cum[v-1], cum[v])
        self._cum_w = np.cumsum(w / w.sum())[:-1].astype(np.float32)
        self._solvers = []
        for v in cfg.variants:
            if v.kind != "esdp":
                self._solvers.append(None)
            elif v.solver is None or isinstance(v.solver, str):
                self._solvers.append(get_solver(v.solver))
            else:
                if getattr(v.solver, "scope", "") is None:
                    v.solver.scope = v.name  # per-variant stats scoping
                self._solvers.append(v.solver)
        self._k = None

    # -- host-side randomness and device constants ------------------------
    def _streams(self, seed: "int | None" = None):
        """(arrivals (T, P) bool, noise (T, E) f32, tiebreak (T, E) f32).

        The JAX package's layout: arrivals and valuation noise off
        ``seed`` (as ``ClusterSim._streams``), the greedy tie-break stream
        off ``seed + 1``; ``run_batch([s])`` replays ``run(seed=s)``."""
        seed = self.seed if seed is None else int(seed)
        rng = np.random.default_rng(seed)
        inst = self.inst
        rho_t = np.clip(inst.rho[None, :] * self.arr_scale, 0.0, 1.0)
        arrivals = rng.random((self.T, inst.n_ports)) < rho_t
        noise = rng.normal(0.0, 1.0, (self.T, inst.n_edges)).astype(np.float32)
        tb = np.random.default_rng(seed + 1).random(
            (self.T, inst.n_edges)).astype(np.float32)
        return arrivals, noise, tb

    def _route_salt(self, seed: int) -> int:
        return (self.config.route_salt ^ (seed * 0x85EBCA6B)) & _MASK32

    def _consts(self) -> dict:
        """The instance, schedule and lookup tables on the device, made
        once (each a copy to the card), with the device tables the solves
        and the oracle read, so the horizon loop copies nothing."""
        if self._k is None:
            from ..core.dp import _device_tables
            from ..kernels.budgeted_dp.ops import prepare_operands
            inst = self.inst
            # as tensors report it ("cuda:0"), the key of the device caches
            dev = torch.empty(0, device=self.device).device

            def on(a, dtype=None):
                return torch.as_tensor(np.asarray(a, dtype), device=dev)

            k = {"A": on(inst.A), "c": on(inst.c),
                 "port": on(inst.port_of_edge, np.int64),
                 "server": on(inst.edges[:, 1], np.int64),
                 "mu": on(inst.mu), "sigma": on(inst.sigma),
                 "neg_cost": on(-np.asarray(inst.cost)),
                 "port_ok": on(self.port_ok),
                 "cum_w": on(self._cum_w),
                 "ports": torch.arange(inst.n_ports, device=dev),
                 "qpos": torch.arange(self.Q, device=dev),
                 "vs": torch.arange(len(self.config.variants), device=dev),
                 "ranks": torch.arange(inst.n_edges, dtype=torch.int32,
                                       device=dev),
                 "speed": on(self.speed, np.float32),
                 "alive": on(self.alive, bool),
                 "c3": on(np.float32(1e3)), "c4": on(np.float32(1e-4))}
            k["AT"] = k["A"].T.contiguous()
            _device_tables(self.tables, dev)
            if any(v.kind == "esdp" for v in self.config.variants):
                prepare_operands(self.tables, self.s_cap, dev)
            self._k = k
        return self._k

    # -- before the loop: what the carry does not decide -----------------
    def _inputs(self, streams, seeds) -> dict:
        """One copy of every trace's streams to the device (B, T, ...),
        then, for the whole horizon at once: the feasible arrivals and the
        admission counts they fix; every job id's variant (the routing
        hash of the ids t·P + p, and of an empty head's −P + p, offset by
        P); the realized valuations z̃ (B, T, E) and the oracle's means
        v (T, E), each multiply-add rounded once."""
        k = self._consts()
        dev = k["A"].device
        i32 = torch.int32
        P, T = self.inst.n_ports, self.T

        def on(i):
            return torch.as_tensor(np.stack([s[i] for s in streams]),
                                   device=dev)

        arrived_raw, noise, tb = on(0), on(1), on(2)
        salt = torch.as_tensor([self._route_salt(s) for s in seeds],
                               dtype=torch.int64, device=dev)
        arrived = arrived_raw & k["port_ok"]
        ids = torch.arange(-P, T * P, device=dev)
        u01 = route_u01(ids[None], salt[:, None])
        variant = (u01[:, None, :] >= k["cum_w"][None, :, None]).sum(1)
        # the admission-time split: this slot's arrival on port l has job
        # id t·P + l, the id its queue head carries later
        avar = variant[:, P:].reshape(-1, T, P)
        routed = (arrived[:, :, None, :] & (avar[:, :, None, :] == k["vs"][
            None, None, :, None])).sum(3, dtype=i32)
        # μ·speed − cost, and the noise on it, each rounded once (XLA's
        # fused multiply-adds on the JAX engine's slot)
        mean = torch.addcmul(k["neg_cost"], k["mu"], k["speed"][:, k["server"]])
        return {"arrived": arrived, "tb": tb, "noise": noise,
                "variant": variant, "routed": routed,
                "z": torch.clamp(torch.addcmul(mean, k["sigma"], noise), 0.0,
                                 1.0),
                "v_true": torch.clamp(mean, 0.0, 1.0),
                "arrivals": arrived_raw.sum(2, dtype=i32),
                "rejected": (arrived_raw & ~k["port_ok"]).sum(2, dtype=i32)}

    def _carry0(self, B: int) -> dict:
        inst, V, dev = self.inst, len(self.config.variants), self.device
        return {
            "queue": torch.full((B, inst.n_ports, self.Q), _EMPTY,
                                dtype=torch.int32, device=dev),
            "n": torch.zeros((B, V, inst.n_edges), dtype=torch.int32,
                             device=dev),
            "sumz": torch.zeros((B, V, inst.n_edges), dtype=torch.float32,
                                device=dev),
            "load": torch.zeros((B, inst.n_servers), dtype=torch.int32,
                                device=dev)}

    # -- slot functions (shared by the stream and lockstep loops) --------
    def _admit(self, k, queue, arrived, n, sumz, t0: int):
        """Admission of the slot's feasible arrivals (B, P) into the
        queues (B, P, Q) under the backpressure policy.  The global bound
        couples the ports, so they are admitted one after another, each
        step vectorised over B.  Returns the queues and the (B,) counts
        blocked, dropped, shed and admitted."""
        B, P, Q = queue.shape
        bp = self.config.backpressure
        i32 = torch.int32
        qpos, ports = k["qpos"], k["ports"]
        if bp == "shed_by_utility":
            # pooled value estimate → per-port utility; the max starts
            # from 0, as the JAX package's scatter does
            n_all = n.sum(1)
            vpool = torch.where(n_all > 0, sumz.sum(1) / n_all.clamp(min=1),
                                0.0)
            u_port = torch.zeros((B, P), dtype=torch.float32,
                                 device=queue.device).scatter_reduce(
                1, k["port"].expand(B, -1), vpool, "amax", include_self=True)
        # the global bound binds only below P·Q; above it a full queue is
        # a full port, and drop_oldest evicts the port's own head
        glob = self.Ktot < P * Q
        qs = queue.clone()
        zero = torch.zeros(B, dtype=i32, device=queue.device)
        blocked, dropped, shed, admitted = zero, zero, zero, zero
        for l in range(P):
            arr = arrived[:, l]
            cnt = (qs >= 0).sum(2)
            port_full = cnt[:, l] >= Q
            full = port_full | (cnt.sum(1) >= self.Ktot) if glob else port_full
            overflow = arr & full
            if bp == "block":
                put = arr & ~full
                blocked = blocked + overflow.to(i32)
            elif bp == "drop_oldest":
                # evict the oldest queued job (the port's own head when it
                # is full), then enqueue
                if glob:
                    heads = qs[:, :, 0]
                    oldest = torch.argmin(torch.where(heads >= 0, heads,
                                                      _I32_MAX), dim=1)
                    tgt = torch.where(port_full, l, oldest)
                    ev = overflow[:, None] & (ports[None] == tgt[:, None])
                else:
                    ev = overflow[:, None] & (ports[None] == l)
                shifted = torch.cat([qs[:, :, 1:],
                                     torch.full_like(qs[:, :, :1], _EMPTY)], 2)
                qs = torch.where(ev[:, :, None], shifted, qs)
                put = arr
                dropped = dropped + overflow.to(i32)
            else:
                # shed_by_utility: evict the lowest-utility job, newest
                # first on ties; a full port ties with the newcomer, which
                # is then shed itself
                uq = torch.where(cnt > 0, u_port, torch.inf)
                pmin = torch.argmin(uq, dim=1)
                shed_new = port_full | (u_port[:, l] <= uq.gather(
                    1, pmin[:, None])[:, 0])
                evict = overflow & ~shed_new
                hit = ((evict[:, None] & (ports[None] == pmin[:, None]))[
                    :, :, None] & (qpos[None, None] == (cnt - 1)[:, :, None]))
                qs = torch.where(hit, _EMPTY, qs)
                put = (arr & ~full) | evict
                shed = shed + overflow.to(i32)
            row = qs[:, l]
            at = (row >= 0).sum(1)
            qs[:, l] = torch.where(put[:, None] & (qpos[None] == at[:, None]),
                                   t0, row)
            admitted = admitted + (put if bp == "block" else arr).to(i32)
        return qs, {"blocked": blocked, "dropped": dropped, "shed": shed,
                    "admitted": admitted}

    def _solve(self, v, ups, sig, s_lim, elig_v):
        """Variant ``v``'s Algorithm-2 x for (B, E) statistics: a registry
        backend solves the batch in one call; a host-side wrapper gets
        each row (E,) as the JAX package's lockstep loop hands it, or the
        batch when it takes one."""
        from ..core.solvers import Solver
        solver, args = self._solvers[v], (self.tables, self.s_cap, s_lim)
        B = ups.shape[0]
        if isinstance(solver, Solver) or (B > 1 and solver.accepts_batch):
            return solver(ups, sig, *args, allowed=elig_v,
                          u_max=self.u_max)[0]
        return torch.stack([solver(ups[b], sig[b], *args, allowed=elig_v[b],
                                   u_max=self.u_max)[0] for b in range(B)])

    def _variant_x(self, k, v, elig_v, vhat_v, n_v, age, tb_t, t0):
        """Variant ``v``'s raw proposal (B, E), possibly more than one
        edge a port."""
        spec = self.config.variants[v]
        if spec.kind == "esdp":
            ups, sig, s_lim = stats_mod.scale_statistics(
                vhat_v, n_v, self.xi_tab[t0], self.g_tab[t0], self.m)
            return self._solve(v, ups, sig, s_lim, elig_v)
        # the tie-break term is fused into the add, as XLA does
        if spec.kind == "hswf":
            score = torch.addcmul(vhat_v, tb_t, k["c4"])
        elif spec.kind == "lcf":
            score = torch.addcmul(k["neg_cost"], tb_t, k["c4"])
        else:  # lwtf: the oldest head job first (queue age)
            score = torch.addcmul(torch.addcmul(
                vhat_v, age[:, k["port"]].to(torch.float32), k["c3"]),
                tb_t, k["c4"])
        return greedy_pack(score, elig_v, k["A"], k["c"])

    def _dispatch(self, k, qs, load, x_raw, elig, vhat, age):
        """Trim to one head job a port, capacity-check in priority order
        (utility desc, oldest job, least-loaded server, edge index), the
        challengers packing into what the primary left; pop served heads.
        Only each port's best-ranked candidate can start, so the check
        walks those (at most P a variant) in rank order.  Returns the
        per-variant x (B, V, E), the served ports, queues and loads."""
        B, P, _ = qs.shape
        E, V = self.inst.n_edges, len(self.config.variants)
        port, server, AT = k["port"], k["server"], k["AT"]
        port_b = port.expand(B, -1)
        i32 = torch.int32
        dev = qs.device
        ranks = k["ranks"].expand(B, -1)
        # the two shared keys sorted once; the primary key per variant
        base = lexsort_order([load[:, server], age[:, port]], [False, True])
        n_pick = min(P, E)
        residual = k["c"].expand(B, -1)
        xs = []
        for v in range(V):
            cand = (x_raw[:, v] > 0) & elig[:, v]
            order = base.gather(1, lexsort_order(
                [vhat[:, v].gather(1, base)], [True]))
            rank = torch.empty((B, E), dtype=i32, device=dev).scatter_(
                1, order, ranks)
            best = torch.full((B, P), E, dtype=i32, device=dev).scatter_reduce(
                1, port_b, torch.where(cand, rank, E), "amin",
                include_self=True)
            x1 = cand & (rank == best.gather(1, port_b))
            first = torch.sort(torch.where(x1, rank, E), dim=1).values[
                :, :n_pick]
            edges = order.gather(1, first.clamp(max=E - 1).long())
            need = AT[edges]  # (B, n_pick, K)
            take = []
            for j in range(n_pick):
                t = (first[:, j] < E) & (residual >= need[:, j]).all(1)
                residual = residual - torch.where(t[:, None], need[:, j], 0)
                take.append(t)
            xs.append(torch.zeros((B, E), dtype=i32, device=dev).scatter_add_(
                1, edges, torch.stack(take, 1).to(i32)))
        xv = torch.stack(xs, 1)  # one unit a served port
        x = xv.sum(1, dtype=i32)
        served = torch.zeros((B, P), dtype=i32, device=dev).scatter_add_(
            1, port_b, x) > 0
        popped = torch.cat([qs[:, :, 1:], torch.full_like(qs[:, :, :1],
                                                          _EMPTY)], 2)
        queue3 = torch.where(served[:, :, None], popped, qs)
        load2 = load + torch.zeros_like(load).scatter_add_(
            1, server.expand(B, -1), x)
        return xv, served, queue3, load2

    def _slot(self, k, inp, carry, t0: int, suspicious):
        """One slot up to the bandit update: admission, heads, routing
        and eligibility, each variant's proposal, the dispatch.  Returns
        (x (B, V, E), eligibility (B, V, E), the slot's record, queues,
        loads)."""
        V = len(self.config.variants)
        P = self.inst.n_ports
        port, vs = k["port"], k["vs"]
        n, sumz = carry["n"], carry["sumz"]
        qs, counts = self._admit(k, carry["queue"], inp["arrived"][:, t0], n,
                                 sumz, t0)
        head = qs[:, :, 0]
        has = head >= 0
        age = torch.where(has, t0 - head, 0)
        hvar = inp["variant"].gather(1, head.long() * P + k["ports"] + P)
        ok = (k["alive"][t0] & ~suspicious)[k["server"]]
        elig = (has[:, port] & ok)[:, None, :] & (
            hvar[:, port][:, None, :] == vs[None, :, None])
        vhat = torch.where(n > 0, sumz / n.clamp(min=1), 0.0)
        x_raw = torch.stack([
            self._variant_x(k, v, elig[:, v], vhat[:, v], n[:, v], age,
                            inp["tb"][:, t0], t0)
            for v in range(V)], 1)
        xv, served, queue3, load2 = self._dispatch(k, qs, carry["load"],
                                                   x_raw, elig, vhat, age)
        counts.update(qlen=(queue3 >= 0).sum((1, 2), dtype=torch.int32),
                      dispatched=served.sum(1, dtype=torch.int32))
        return xv, elig, counts, queue3, load2

    # -- the horizon ------------------------------------------------------
    def _horizon(self, inp, B: int, lockstep: bool = False, settle=None):
        """The loop over the horizon.  Every carry and every record stays
        on the device, (T, B, ...) stacked at the end; ``stream`` reads
        nothing back inside it.  ``lockstep`` reads each slot's record
        back before the next slot starts and returns those host rows too;
        ``settle`` (the failure runtime's host settlement) replaces the
        bandit update.  Returns (carry, records, host rows)."""
        k = self._consts()
        carry = self._carry0(B)
        suspicious = torch.zeros(self.inst.n_servers, dtype=torch.bool,
                                 device=k["A"].device)
        recs, rows = [], []
        for t0 in range(self.T):
            xv, elig, counts, queue3, load2 = self._slot(k, inp, carry, t0,
                                                         suspicious)
            rec = dict(counts, x=xv, elig=elig)
            if settle is None:
                carry = {"queue": queue3, "load": load2,
                         "n": carry["n"] + xv,
                         "sumz": carry["sumz"] + xv * inp["z"][:, t0, None]}
            else:
                row, carry, suspicious = settle(t0, carry, queue3, load2,
                                                xv, elig)
                rows.append(row)
            if lockstep:
                row = {name: host(a) for name, a in rec.items()}
                if settle is None:
                    rows.append(row)
                else:
                    rows[-1].update(row)
            recs.append(rec)
        return carry, {name: torch.stack([r[name] for r in recs])
                       for name in recs[0]}, rows

    def _account(self, inp, recs) -> dict:
        """Welfare, per-variant and overall regret, dispatch share and the
        dispatch counts of every slot at once, from the records (T, B,
        ...): one oracle fold for every (slot, trace, variant), and with
        V > 1 their union, on the slot's means."""
        from ..core.dp import oracle_value
        k = self._consts()
        xv, elig = recs["x"], recs["elig"]
        T, B, V, E = xv.shape
        z = inp["z"].transpose(0, 1)[:, :, None]  # (T, B, 1, E)
        sw_v = (xv * z).sum(3)
        v_true = inp["v_true"][:, None, None]  # (T, 1, 1, E)
        masks = elig if V == 1 else torch.cat(
            [elig, elig.any(2, keepdim=True)], 2)
        best = oracle_value(v_true.expand(masks.shape).reshape(-1, E),
                            self.tables, masks.reshape(-1, E)).reshape(
            T, B, -1)
        regret_v = best[..., :V] - (v_true * xv).sum(3)
        x = xv.sum(2, dtype=torch.int32)
        regret = (regret_v[..., 0] if V == 1
                  else best[..., V] - (v_true[:, :, 0] * x).sum(2))
        share = torch.zeros((T, B, self.inst.n_servers), dtype=torch.float32,
                            device=x.device).scatter_add_(
            2, k["server"].expand(T, B, -1),
            x / x.sum(2).clamp(min=1)[..., None])
        return {"sw": sw_v.sum(2), "sw_v": sw_v, "regret": regret,
                "regret_v": regret_v, "share": share,
                "dispatched_v": xv.sum(3, dtype=torch.int32)}

    def _traces(self, inp, recs, carry, rows=None) -> list:
        """Per-trace host dicts of (T, ...) arrays, with the final n and
        sumz: the stacked records read back at once, or a lockstep run's
        host rows."""
        ys = {name: recs[name] for name in ("blocked", "dropped", "shed",
                                            "admitted", "qlen",
                                            "dispatched", "x")}
        if rows and "sw" in rows[0]:  # the failure runtime's host values
            ys = {name: host(a) for name, a in ys.items()}
            ys.update({name: np.stack([r[name] for r in rows])[:, None]
                       for name in ("sw", "sw_v", "regret", "regret_v",
                                    "share")})
            ys["dispatched_v"] = ys["x"].sum(3, dtype=np.int32)
        else:
            ys.update(self._account(inp, recs))
            ys = {name: host(a) for name, a in ys.items()}
        if rows:  # lockstep: the rows read back slot by slot
            for name in ("blocked", "dropped", "shed", "admitted", "qlen",
                         "dispatched", "x"):
                ys[name] = np.stack([r[name] for r in rows])
        for name in ("arrivals", "rejected", "routed"):
            ys[name] = host(inp[name].transpose(0, 1))
        ys["routed_v"] = ys.pop("routed")
        for name in ("sw", "regret"):
            ys[name] = ys[name].astype(np.float32)
        n, sumz = host(carry["n"]), host(carry["sumz"])
        return [({name: a[:, b] for name, a in ys.items()}, n[b], sumz[b])
                for b in range(n.shape[0])]

    def _outputs(self, ys, n, sumz, mode, solve_stats=None, failures=None):
        """One trace's :class:`EngineOutput` from host arrays (T, ...)."""
        led = {name: ys[name] for name in ("arrivals", "rejected",
                                           "blocked", "dropped", "shed",
                                           "admitted", "dispatched")}
        led["queue_len"] = ys["qlen"]
        led["final_queue"] = int(ys["qlen"][-1])
        for name in ("arrivals", "rejected", "blocked", "dropped", "shed",
                     "admitted", "dispatched"):
            led[f"total_{name}"] = int(led[name].sum())
        return EngineOutput(
            sw=ys["sw"], regret=ys["regret"], dispatch_share=ys["share"],
            asw=float(ys["sw"].sum()),
            variants=tuple(v.name for v in self.config.variants),
            sw_variant=ys["sw_v"], regret_variant=ys["regret_v"],
            dispatched_variant=ys["dispatched_v"],
            routed_variant=ys["routed_v"], n=n, sumz=sumz, ledger=led,
            queue_len=ys["qlen"], mode=mode, solve_stats=solve_stats,
            failures=failures, x=ys["x"])

    def _wrapper_stats(self) -> "dict | None":
        from ..core.solvers import Solver
        out = {}
        for spec, solver in zip(self.config.variants, self._solvers):
            if solver is None or isinstance(solver, Solver):
                continue
            if hasattr(solver, "stats_dict"):
                out[spec.name] = solver.stats_dict()
            elif isinstance(getattr(solver, "stats", None), dict):
                out[spec.name] = copy.deepcopy(solver.stats)
        return out or None

    def run(
        self, mode: str = "auto", seed: "int | None" = None, streams=None
    ) -> EngineOutput:
        """One trace.  ``mode="stream"`` is the device loop with no host
        read until it ends; ``"lockstep"`` drives the same slot functions
        one slot at a time, reading each slot back (the failure runtime
        settles on the host); ``"auto"`` picks lockstep iff a failure
        model is attached."""
        if mode == "auto":
            mode = "lockstep" if self.failures is not None else "stream"
        if mode not in ("stream", "lockstep"):
            raise ValueError(f"unknown mode {mode!r}")
        seed = self.seed if seed is None else int(seed)
        if streams is None:
            streams = self._streams(seed)
        if mode == "stream" and self.failures is not None:
            raise ValueError("failure settlement is host-side: use "
                             'mode="lockstep" (or "auto")')
        inp = self._inputs([streams], [seed])
        failures = settle = None
        if self.failures is not None:
            settle, summary = self._failure_runtime(inp)
        carry, recs, rows = self._horizon(inp, 1, lockstep=mode == "lockstep",
                                          settle=settle)
        if settle is not None:
            failures = summary()
        (ys, n, sumz), = self._traces(inp, recs, carry, rows)
        return self._outputs(ys, n, sumz, mode,
                             solve_stats=self._wrapper_stats(),
                             failures=failures)

    def run_batch(self, seeds, mode: str = "stream") -> "list[EngineOutput]":
        """One trace per seed in one batch-first pass of the stream loop:
        each ESDP variant solves a slot's B statistics in one forward and
        one epilogue launch, whatever B is.  Stream-only; every seed
        shares the schedule, as in ``ClusterSim.run_batch``."""
        if mode != "stream":
            raise NotImplementedError("run_batch is the batched stream "
                                      "path; loop run() for lockstep")
        if self.failures is not None:
            raise NotImplementedError("failure settlement is host-side "
                                      "and single-seed; loop run()")
        seeds = [int(s) for s in seeds]
        inp = self._inputs([self._streams(s) for s in seeds], seeds)
        carry, recs, _ = self._horizon(inp, len(seeds))
        return [self._outputs(ys, n, sumz, "stream")
                for ys, n, sumz in self._traces(inp, recs, carry)]

    # -- the failure runtime (lockstep) -----------------------------------
    def _failure_runtime(self, inp):
        """(settle, summary) of a fresh ``FailureRuntime`` over this
        engine's schedule: ``settle`` is the per-slot host settlement of
        :meth:`_horizon`, ``summary`` the combined and per-variant
        ledgers after the run."""
        from .dispatcher import FailureRuntime
        inst, V, T = self.inst, len(self.config.variants), self.T
        alive = self.alive
        fr = FailureRuntime(self.failures, inst, T, lambda t: alive[t],
                            self.seed)
        vled = [{name: np.zeros(T, np.float64) for name in
                 ("dispatched", "completed", "lost", "salvaged",
                  "ckpt_cost")} for _ in range(V)]
        noise = host(inp["noise"][0])

        def settle(t0, carry, queue3, load2, xv, elig):
            return self._settle_failures(fr, vled, t0, carry, queue3, load2,
                                         xv, elig, noise[t0])

        def summary():
            out = fr.summary()
            out["per_variant"] = {
                self.config.variants[v].name: {
                    **{name: a.astype(np.float32)
                       for name, a in vled[v].items()},
                    **{f"total_{name}": float(a.sum())
                       for name, a in vled[v].items()},
                } for v in range(V)}
            return out

        return settle, summary

    def _settle_failures(self, fr, vled, t0, carry, queue3, load2, xv, elig, noise_t):
        """Host-side crash settlement per variant: each variant's units
        settle into its own conserving ledger (dispatched = completed +
        lost + salvaged every slot), and its bandit sees the realized,
        crash-discounted signal.  The valuations are the JAX engine's
        numpy lines, a multiply and then an add (two roundings each).
        Returns (the slot's host row, the carry, the suspicious
        servers)."""
        from ..core.dp import oracle_knapsack
        inst, V = self.inst, len(self.config.variants)
        server = inst.edges[:, 1]
        xv_np = host(xv)[0]
        x_np = xv_np.sum(axis=0)
        elig_np = host(elig)[0]
        speed_t = self.speed[t0]
        mean = inst.mu * speed_t[server] - inst.cost
        z = np.clip(mean + inst.sigma * noise_t, 0.0, 1.0)
        v_true = np.clip(mean, 0.0, 1.0).astype(np.float32)
        dev = xv.device

        def oracle_x(allowed):
            x_star, _ = oracle_knapsack(torch.as_tensor(v_true, device=dev),
                                        self.tables,
                                        torch.as_tensor(allowed, device=dev))
            return host(x_star)

        crashed = fr.crashed_servers(t0, np.asarray(self.alive[t0], bool))
        reps = fr.place_replicas(t0, x_np, elig_np.any(axis=0))
        sw_v, regret_v = np.zeros(V, np.float32), np.zeros(V, np.float32)
        n2 = host(carry["n"])[0].copy()
        sumz2 = host(carry["sumz"])[0].copy()
        for v in range(V):
            sw_v[v], realized = fr.settle(t0, xv_np[v], z, crashed, reps,
                                          ledger=vled[v])
            n2[v] += xv_np[v]
            sumz2[v] += realized.astype(np.float32)
            regret_v[v] = ((v_true * oracle_x(elig_np[v])).sum()
                           - (v_true * xv_np[v]).sum())
        for name in fr.ledger:
            fr.ledger[name][t0] = sum(vled[v][name][t0] for v in range(V))
        fr.observe(t0, crashed)
        regret = ((v_true * oracle_x(elig_np.any(axis=0))).sum()
                  - (v_true * x_np).sum())
        share = np.zeros(inst.n_servers, np.float32)
        np.add.at(share, server, x_np / max(x_np.sum(), 1))
        carry2 = {"queue": queue3, "load": load2,
                  "n": torch.as_tensor(n2, device=dev)[None],
                  "sumz": torch.as_tensor(sumz2, device=dev)[None]}
        row = {"sw": np.float32(sw_v.sum()), "sw_v": sw_v,
               "regret": np.float32(regret), "regret_v": regret_v,
               "share": share}
        return row, carry2, torch.as_tensor(fr.suspicious, device=dev)


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
