"""ESDP-backed gang dispatcher over a cluster, with time-varying service
rates (stragglers), elastic events (slice loss/join) and server failures
(crash/repair with lost-work accounting): the counterpart of
``repro.sched.dispatcher``.

``ClusterSim`` runs the paper's lockstep loop (``sched.engine.
lockstep_run``) on host numpy accumulators — the bandit counts ``n``
(int64) and valuation sums (float64), exactly as the JAX package keeps
them — and sends each slot's work to the device: ESDP's scaled
statistics (``core.stats.scale_statistics`` on a per-horizon schedule
table) and its Algorithm-2 solve (the budgeted-DP kernels through the
solver registry), the baselines' greedy packing, and the regret oracle.
``device=None`` is the card; ``device="cpu"`` runs the same loop on the
CPU, where the kernel wrappers take their plain versions.  Schedules
are ``speed_fn``/``alive_fn`` callbacks of the 0-based slot, or a
``scenario=``: a registered regime (``experiments.scenarios``, by name or
object), unrolled on the host from the sim's seed, or an unrolled
``(arr_scale, speed, alive)`` trace.

Incremental re-solves: ``incremental="cache"`` wraps the backend in a
``core.solvers.CachedSolver``; ``incremental="warm"`` drives the
segmented carried-plane path ``kernels.budgeted_dp.ops.WarmCudaSolver``.
Both are bit-identical to the cold loop.

Failure-aware mode (``failures=FailureModel(...)``): a job dispatched onto
a server that crashes in-slot loses its accumulated service, unless it
was dispatched redundantly (r-way, consuming r× capacity) or salvaged by
opportunistic checkpointing with a per-checkpoint cost.  The crash process
is ``runtime.fault.FailureInjector`` (counter-based, the JAX package's
streams bit for bit) coupled with the aliveness schedule's up→down
transitions; detection-driven eligibility uses
``runtime.fault.CrashRateTracker``.  Malleable jobs
(``malleable=MalleableModel(...)``) run for several slots and shrink or
grow between config-family edges.

``fallback=True`` wraps the backend in the degradation chain
``core.solvers.FallbackSolver``, whose counters surface in
``solve_stats``.  :meth:`ClusterSim.engine` builds the streaming engine
(``sched.engine.DispatchEngine``) on the sim's instance and schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import build_tables, stats as stats_mod
from ..core.env import Scenario
from ..core.graph import Instance
from ..core.solvers import CachedSolver, FallbackSolver, get_solver
from ..device import resolve_device
from ..runtime.fault import CrashRateTracker, FailureInjector

__all__ = ["ClusterSim", "SimOutput", "FailureModel", "FailureRuntime",
           "MalleableModel", "MalleableRuntime", "unrolled_trace"]


@dataclasses.dataclass(frozen=True)
class SimOutput:
    sw: np.ndarray  # (T,)
    regret: np.ndarray  # (T,)
    dispatch_share: np.ndarray  # (T, R) fraction of dispatches per slice
    asw: float
    # incremental-solve counters (cache hit rate / warm skip rate) and/or
    # fallback-chain degradation events when the sim ran with incremental=
    # or a wrapped solver; None otherwise
    solve_stats: "dict | None" = None
    # lost/salvaged/restart ledger when the sim ran failure-aware
    # (failures=FailureModel(...)); None otherwise.  Per-slot arrays
    # dispatched/completed/lost/salvaged/ckpt_cost (value units, satisfying
    # dispatched = completed + lost + salvaged exactly), crash/replica
    # counts, and scalar totals.
    failures: "dict | None" = None
    # work-units ledger when the sim ran with malleable jobs
    # (malleable=MalleableModel(...)); None otherwise.  Per-slot arrays
    # dispatched/done/lost (work units, satisfying dispatched = done + lost
    # + residual exactly), reconfiguration/shutdown costs and counts, and
    # scalar totals (see MalleableRuntime.summary).
    malleable: "dict | None" = None
    # (T, E) int32 dispatch vectors x(t) as dispatched (after the
    # eligibility mask; the admitted vector with malleable jobs)
    x: "np.ndarray | None" = None

    @property
    def cum_regret(self):
        return np.cumsum(self.regret)


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Knobs of the failure-aware runtime (the JAX package's
    ``docs/robustness.md``).

    Crash channels (all counter-based off the sim seed, so runs replay):
      * the aliveness schedule's up→down transitions — a server alive at
        dispatch time but dead next slot died mid-slot (the
        ``server_failures`` scenario emits exactly this coupling);
      * ``p_crash``: extra iid in-slot crashes per (server, slot) — the
        server loses the slot's work but stays in the schedule (crashes
        and recovers within the slot);
      * ``n_racks``/``p_rack``: correlated in-slot crashes — servers
        partition into ``n_racks`` contiguous groups and each group fails
        as a unit with ``p_rack`` per slot.

    Mitigations (arXiv:1707.01655's redundancy-vs-checkpointing axis):
      * ``redundancy`` — r-way dispatch: each job unit greedily places up
        to r−1 replicas on same-port edges with distinct servers within
        residual capacity (replicas consume capacity, produce no utility,
        and save the job if any copy's server survives);
      * ``checkpoints``/``checkpoint_cost`` — opportunistic checkpointing:
        n checkpoints per slot at fractions i/(n+1), each costing
        ``checkpoint_cost`` utility when written; a crash at in-slot
        fraction U salvages ⌊U·(n+1)⌋/(n+1) of the job's value;
      * ``detect`` — CrashRateTracker-driven eligibility: servers whose
        crash-rate EMA is elevated are masked out of dispatch for a
        probation window (~4 slots at the tracker defaults).
    """
    p_crash: float = 0.0
    n_racks: int = 0
    p_rack: float = 0.0
    redundancy: int = 1
    checkpoints: int = 0
    checkpoint_cost: float = 0.0
    detect: bool = False

    def __post_init__(self):
        if self.redundancy < 1:
            raise ValueError("redundancy is the total copy count (>= 1)")
        if self.checkpoints < 0 or self.checkpoint_cost < 0:
            raise ValueError("checkpoints/checkpoint_cost must be >= 0")


class FailureRuntime:
    """Host-side crash/repair bookkeeping for one ``ClusterSim`` run.

    Owns the in-slot crash process (a counter-based
    :class:`repro_torch.runtime.fault.FailureInjector` — pure in (seed, slot,
    channel), so reruns and tests replay the identical failure stream),
    replica placement, salvage/cost settlement, detection state, and the
    per-slot ledger.  Built fresh inside every ``run()`` call: the runtime
    is mutable, the sim object stays reusable.
    """

    # injector draw channels (salt residues mod 3 keep them independent)
    _CRASH, _RACK, _FRAC = 0, 1, 2

    def __init__(
        self,
        model: FailureModel,
        instance: Instance,
        T: int,
        alive_fn: Callable[[int], np.ndarray],
        seed: int,
    ):
        self.model = model
        self.inst = instance
        self.T = T
        self.alive_fn = alive_fn
        self.inj = FailureInjector(p_fail=model.p_crash, seed=seed)
        R = instance.n_servers
        self.trackers = [CrashRateTracker() for _ in range(R)]
        self.suspicious = np.zeros(R, bool)
        self.restarts = 0
        self.ledger = {k: np.zeros(T, np.float64) for k in
                       ("dispatched", "completed", "lost", "salvaged",
                        "ckpt_cost")}
        self.crashes = np.zeros(T, np.int32)
        self.replicas = np.zeros(T, np.int32)

    def eligibility(self, allowed: np.ndarray, server: np.ndarray) -> np.ndarray:
        """Mask suspicious servers' edges out of dispatch (detection)."""
        if not self.model.detect:
            return allowed
        return allowed & ~self.suspicious[server]

    def crashed_servers(self, t0: int, alive_now: np.ndarray) -> np.ndarray:
        """(R,) bool: which servers crash DURING slot t0 (all channels)."""
        m = self.model
        R = self.inst.n_servers
        crashed = np.zeros(R, bool)
        if t0 + 1 < self.T:  # schedule transition: up now, down next slot
            nxt = np.asarray(self.alive_fn(t0 + 1), bool)
            crashed |= alive_now & ~nxt
        if m.p_crash > 0.0:
            u = np.array([self.inj.draw(t0, r * 3 + self._CRASH)
                          for r in range(R)])
            crashed |= alive_now & (u < m.p_crash)
        if m.n_racks > 0 and m.p_rack > 0.0:
            rack_of = (np.arange(R) * m.n_racks) // R
            u = np.array([self.inj.draw(t0, g * 3 + self._RACK)
                          for g in range(m.n_racks)])
            crashed |= alive_now & (u < m.p_rack)[rack_of]
        return crashed

    def place_replicas(self, t0: int, x: np.ndarray, eligible: np.ndarray):
        """Greedy r-way replica placement within residual capacity.

        For each dispatched job unit (edge e, unit i), walk the other
        eligible same-port edges in index order and claim up to
        ``redundancy − 1`` replicas on DISTINCT servers, each consuming
        its edge's full capacity column from the residual c − A·x.
        Returns ``{(e, i): [replica server ids]}``; placement is
        best-effort — a saturated cluster simply gets fewer replicas.
        """
        m, inst = self.model, self.inst
        reps: dict = {}
        if m.redundancy <= 1 or not x.any():
            return reps
        A = np.asarray(inst.A)
        residual = np.asarray(inst.c) - A @ x
        port, server = inst.port_of_edge, inst.edges[:, 1]
        placed_total = 0
        for e in np.flatnonzero(x):
            cands = np.flatnonzero((port == port[e]) & (server != server[e])
                                   & eligible)
            for i in range(int(x[e])):
                placed: list[int] = []
                used = {int(server[e])}
                for e2 in cands:
                    if len(placed) >= m.redundancy - 1:
                        break
                    if int(server[e2]) in used:
                        continue
                    if np.all(A[:, e2] <= residual):
                        residual = residual - A[:, e2]
                        placed.append(int(server[e2]))
                        used.add(int(server[e2]))
                if placed:
                    reps[(int(e), i)] = placed
                    placed_total += len(placed)
        self.replicas[t0] = placed_total
        return reps

    def settle(self, t0, x, z, crashed, reps, ledger=None):
        """Charge the slot's crashes; return (sw_t, per-edge bandit signal).

        Per job unit of value z: survived (own server or any replica's
        server up) → completed; crashed with checkpointing → the fraction
        checkpointed before the crash instant is salvaged, the rest lost;
        crashed bare → lost.  ``completed + lost + salvaged = dispatched``
        holds exactly (checkpoint costs are charged separately, including
        for completed jobs — opportunistic checkpoints are written whether
        or not the slot ends in a crash).  Social welfare for the slot is
        completed + salvaged − checkpoint costs; the bandit signal is the
        per-edge realized utility clipped at 0 (the learned v̂ then absorbs
        crash risk and checkpoint overhead, steering dispatch away from
        crashy servers).

        ``ledger`` targets an alternative (same-shape) ledger dict (the JAX
        package's streaming engine settles each A/B variant's units into
        its own); default is the runtime's combined one.
        """
        m, inst = self.model, self.inst
        server = inst.edges[:, 1]
        nck = m.checkpoints
        led = self.ledger if ledger is None else ledger
        realized = np.zeros(x.shape[0], np.float64)
        for e in np.flatnonzero(x):
            ze = float(z[e])
            sv = int(server[e])
            # the server dies ONCE, at one in-slot instant: every unit on
            # it sees the same crash fraction U (counter-based, per slot)
            U = self.inj.draw(t0, sv * 3 + self._FRAC)
            for i in range(int(x[e])):
                led["dispatched"][t0] += ze
                survived = (not crashed[sv]) or any(
                    not crashed[r] for r in reps.get((int(e), i), ()))
                if survived:
                    led["completed"][t0] += ze
                    cost = nck * m.checkpoint_cost
                    gain = ze - cost
                else:
                    self.restarts += 1
                    if nck > 0:
                        written = int(U * (nck + 1))
                        salv = written / (nck + 1) * ze
                        cost = written * m.checkpoint_cost
                        led["salvaged"][t0] += salv
                        led["lost"][t0] += ze - salv
                        gain = salv - cost
                    else:
                        cost = 0.0
                        led["lost"][t0] += ze
                        gain = 0.0
                led["ckpt_cost"][t0] += cost
                realized[e] += max(gain, 0.0)
        sw_t = (led["completed"][t0] + led["salvaged"][t0]
                - led["ckpt_cost"][t0])
        return sw_t, realized

    def observe(self, t0: int, crashed: np.ndarray) -> None:
        """Feed the slot's crash indicators to the per-server trackers."""
        self.crashes[t0] = int(crashed.sum())
        for r, tr in enumerate(self.trackers):
            tr.observe(bool(crashed[r]))
        if self.model.detect:
            self.suspicious = np.array([tr.suspicious
                                        for tr in self.trackers])

    def summary(self) -> dict:
        led = {k: v.astype(np.float32) for k, v in self.ledger.items()}
        return dict(
            led,
            crashes=self.crashes.copy(),
            replicas=self.replicas.copy(),
            restarts=self.restarts,
            total_dispatched=float(self.ledger["dispatched"].sum()),
            total_completed=float(self.ledger["completed"].sum()),
            total_lost=float(self.ledger["lost"].sum()),
            total_salvaged=float(self.ledger["salvaged"].sum()),
            total_ckpt_cost=float(self.ledger["ckpt_cost"].sum()),
            model=dataclasses.asdict(self.model),
        )


@dataclasses.dataclass(frozen=True)
class MalleableModel:
    """Knobs of the malleable-jobs runtime (malleable MPI-style
    scheduling; the JAX package's ``docs/scenarios.md``).

    Jobs carry ``duration`` work units (slots at the full-gang rate) instead
    of completing in-slot.  A running job occupies its current config edge's
    capacity column until done; when a new dispatch does not fit the
    residual capacity, running jobs are *shrunk* one config level
    (``sched.cluster.build_instance`` emits the shrunk same-(port, server)
    edges for malleable job types), and — with ``grow_back`` — regrown
    toward their dispatched config when capacity frees.  Every shrink or
    grow is one reconfiguration charging ``reconfig_cost`` utility exactly
    once; with ``preempt`` a still-blocked dispatch may shut a low-value
    running job down entirely, charging ``shutdown_cost`` and losing the
    job's remaining work units into the ledger.
    """
    duration: int = 4
    reconfig_cost: float = 0.02
    shutdown_cost: float = 0.05
    grow_back: bool = True
    preempt: bool = False

    def __post_init__(self):
        if self.duration < 1:
            raise ValueError("duration is the job's work units (>= 1)")
        if self.reconfig_cost < 0 or self.shutdown_cost < 0:
            raise ValueError("reconfig_cost/shutdown_cost must be >= 0")


class MalleableRuntime:
    """Host-side shrink/grow bookkeeping for one ``ClusterSim`` run.

    Edges sharing a (port, server) pair form a *config family* ordered by
    gang size — the full config plus the shrunk configs ``build_instance``
    emitted for malleable job types.  A running job tracks its dispatched
    config ``e0`` and current config ``ecur``; per slot it advances
    ``rate[ecur] = Σ_k A[k, ecur] / Σ_k A[k, full]`` work units and accrues
    value ``z[ecur] · w / duration`` (an always-full job realizes exactly
    one z draw's worth in total — ``duration=1`` on a family-free instance
    reproduces the rigid loop bit-for-bit).  The work-units ledger conserves
    exactly, as the failure ledger does::

        Σ dispatched = Σ done + Σ lost + residual  (work units, float64)

    with ``lost`` the remaining units of shutdown jobs and ``residual`` the
    units still in flight at the horizon.  Reconfiguration/shutdown costs
    are charged to the slot's welfare AND to the affected job's bandit gain
    exactly once per transition (``transitions`` counts them, so
    ``total_reconfig_cost == transitions · model.reconfig_cost``).
    """

    def __init__(self, model: MalleableModel, instance: Instance, T: int):
        self.model = model
        self.inst = instance
        self.T = T
        A = np.asarray(instance.A, np.int64)
        self.A = A
        self.c = np.asarray(instance.c, np.int64)
        port, server = instance.port_of_edge, instance.edges[:, 1]
        E = instance.n_edges
        gang = A.sum(axis=0)
        families: dict = {}
        for e in range(E):
            families.setdefault((int(port[e]), int(server[e])), []).append(e)
        self.full_of = np.arange(E)
        self.shrunk_of = np.full(E, -1)  # next-smaller config, -1 at bottom
        self.parent_of = np.full(E, -1)  # next-larger config, -1 at full
        for es in families.values():
            es.sort(key=lambda e: (-gang[e], e))
            for e in es:
                self.full_of[e] = es[0]
            for up, dn in zip(es, es[1:]):
                self.shrunk_of[up] = dn
                self.parent_of[dn] = up
        self.rate = gang / np.maximum(gang[self.full_of], 1)
        self.jobs: list[dict] = []  # start-ordered: {e0, ecur, rem, gain}
        self._settled: list[tuple[int, float]] = []  # (e0, gain) this slot
        self.ledger = {k: np.zeros(T, np.float64) for k in
                       ("dispatched", "done", "lost",
                        "reconfig_cost", "shutdown_cost")}
        self.counts = {k: np.zeros(T, np.int32) for k in
                       ("started", "completed", "shrinks", "grows",
                        "shutdowns", "blocked", "running")}
        self.occupancy = np.zeros((T, self.c.shape[0]), np.int64)
        self.transitions = 0

    def occupied(self) -> np.ndarray:
        occ = np.zeros_like(self.c)
        for j in self.jobs:
            occ += self.A[:, j["ecur"]]
        return occ

    def residual(self) -> np.ndarray:
        return self.c - self.occupied()

    def _reconfig(self, t0: int, job: dict, to: int, grow: bool) -> None:
        job["ecur"] = to
        cost = self.model.reconfig_cost
        self.ledger["reconfig_cost"][t0] += cost
        job["gain"] -= cost
        self.counts["grows" if grow else "shrinks"][t0] += 1
        self.transitions += 1

    def grow(self, t0: int) -> None:
        """Regrow shrunk jobs toward their dispatched config (FIFO), one
        config level per fit check — each level is one charged transition."""
        if not self.model.grow_back:
            return
        for j in self.jobs:
            while j["ecur"] != j["e0"]:
                up = self.parent_of[j["ecur"]]
                if up < 0:
                    break
                need = self.A[:, up] - self.A[:, j["ecur"]]
                if np.all(need <= self.residual()):
                    self._reconfig(t0, j, int(up), grow=True)
                else:
                    break

    def _shrink_for_room(self, t0: int, need: np.ndarray) -> bool:
        """Shrink running jobs (FIFO, one level each) until ``need`` fits
        the residual; returns whether it fits."""
        while True:
            if np.all(need <= self.residual()):
                return True
            victim = next((j for j in self.jobs
                           if self.shrunk_of[j["ecur"]] >= 0), None)
            if victim is None:
                return False
            self._reconfig(t0, victim, int(self.shrunk_of[victim["ecur"]]),
                           grow=False)

    def _preempt_for_room(
        self, t0: int, need: np.ndarray, value: float, vhat: np.ndarray
    ) -> bool:
        """Shut down running jobs whose estimated remaining value is below
        the newcomer's until ``need`` fits; returns whether it fits."""
        W = float(self.model.duration)
        while not np.all(need <= self.residual()):
            live = [(vhat[j["e0"]] * j["rem"] / W, i)
                    for i, j in enumerate(self.jobs)]
            if not live:
                return False
            remval, i = min(live)
            if remval >= value:
                return False
            job = self.jobs.pop(i)
            job["gain"] -= self.model.shutdown_cost
            self.ledger["shutdown_cost"][t0] += self.model.shutdown_cost
            self.ledger["lost"][t0] += job["rem"]
            self.counts["shutdowns"][t0] += 1
            self._settled.append((job["e0"], job["gain"]))
        return True

    def admit(self, t0: int, x: np.ndarray, vhat: np.ndarray) -> np.ndarray:
        """Fit the slot's desired dispatch into the residual capacity.

        Units are tried in descending estimated value; a unit that does not
        fit triggers shrink (then, with ``preempt``, shutdown) of running
        jobs; units that still do not fit are blocked (never started, never
        ledgered as dispatched).  Returns the admitted dispatch vector."""
        x = np.asarray(x, np.int64)
        admitted = np.zeros_like(x)
        units = [e for e in np.flatnonzero(x) for _ in range(int(x[e]))]
        units.sort(key=lambda e: (-float(vhat[e]), e))
        W = float(self.model.duration)
        for e in units:
            need = self.A[:, e]
            ok = np.all(need <= self.residual())
            if not ok:
                ok = self._shrink_for_room(t0, need)
            if not ok and self.model.preempt:
                ok = self._preempt_for_room(t0, need, float(vhat[e]), vhat)
            if not ok:
                self.counts["blocked"][t0] += 1
                continue
            self.jobs.append({"e0": int(e), "ecur": int(e),
                              "rem": W, "gain": 0.0})
            self.ledger["dispatched"][t0] += W
            self.counts["started"][t0] += 1
            admitted[e] += 1
        return admitted

    def advance(self, t0: int, z: np.ndarray):
        """Advance every running job one slot against the slot's realized
        valuations; returns (slot welfare, settled (e0, gain) pairs)."""
        self.occupancy[t0] = self.occupied()
        W = float(self.model.duration)
        accrual = 0.0
        still: list[dict] = []
        for j in self.jobs:
            w = min(self.rate[j["ecur"]], j["rem"])
            val = float(z[j["ecur"]]) * w / W
            j["gain"] += val
            j["rem"] -= w
            accrual += val
            self.ledger["done"][t0] += w
            if j["rem"] <= 1e-9:
                self.ledger["done"][t0] += j["rem"]  # absorb float residue
                j["rem"] = 0.0
                self.counts["completed"][t0] += 1
                self._settled.append((j["e0"], j["gain"]))
            else:
                still.append(j)
        self.jobs = still
        self.counts["running"][t0] = len(still)
        sw_t = (accrual - self.ledger["reconfig_cost"][t0]
                - self.ledger["shutdown_cost"][t0])
        settled, self._settled = self._settled, []
        return sw_t, settled

    @property
    def residual_units(self) -> float:
        return float(sum(j["rem"] for j in self.jobs))

    def summary(self) -> dict:
        led = {k: v.astype(np.float32) for k, v in self.ledger.items()}
        return dict(
            led,
            **{k: v.copy() for k, v in self.counts.items()},
            occupancy=self.occupancy.copy(),
            transitions=self.transitions,
            residual_units=self.residual_units,
            **{f"total_{k}": float(v.sum()) for k, v in self.ledger.items()},
            model=dataclasses.asdict(self.model),
        )


def unrolled_trace(scenario, instance: Instance, T: int, seed: int):
    """(arr_scale (T, P), speed (T, R), alive (T, R)) host arrays of a
    ``scenario=`` argument: a registered regime's name or a
    ``core.env.Scenario``, unrolled from ``seed`` on the CPU (so every
    device replays the same realization), or an unrolled ``(arr_scale,
    speed, alive)`` trace, checked and broadcast."""
    from ..experiments.scenarios import get_scenario, unroll_scenario
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    if isinstance(scenario, Scenario):
        return unroll_scenario(scenario, T, instance.n_servers, seed,
                               n_ports=instance.n_ports, device="cpu")
    arr_scale, speed, alive = (np.asarray(a) for a in scenario)
    shapes = {"speed": (speed.shape, (T, instance.n_servers)),
              "alive": (alive.shape, (T, instance.n_servers))}
    for name, (got, want) in shapes.items():
        if got != want:
            raise ValueError(f"scenario trace {name} has shape {got}, "
                             f"expected {want}")
    arr_scale = np.broadcast_to(
        arr_scale.astype(np.float32).reshape(T, -1), (T, instance.n_ports))
    return (arr_scale, speed.astype(np.float32), alive.astype(bool))


class ClusterSim:
    """Paired simulation of ESDP vs greedy policies on one cluster
    instance, on ``device`` (``None`` is the card)."""

    def __init__(
        self,
        instance: Instance,
        T: int,
        speed_fn: Optional[Callable[[int], np.ndarray]] = None,
        alive_fn: Optional[Callable[[int], np.ndarray]] = None,
        g_fn=stats_mod.g_logt_only,
        seed: int = 0,
        scenario=None,
        solver=None,
        incremental: "str | None" = None,
        solve_cache=None,
        warm_checkpoint_every: int = 8,
        failures: "FailureModel | None" = None,
        fallback: bool = False,
        malleable: "MalleableModel | None" = None,
        device=None,
        schedule=None,
    ):
        """``incremental`` turns on cross-slot re-solve reuse for ESDP
        (bit-identical to the cold loop):

          ``"cache"`` — wrap the backend in a ``CachedSolver``: a slot
            whose statistics were seen before skips the solve.  Any
            backend, ``run`` and ``run_batch`` (per-seed keys).
            ``solve_cache`` optionally supplies a preconfigured
            ``core.incremental.SolveCache`` (e.g. quantized).
          ``"warm"`` — ``WarmCudaSolver``: re-fold only the segments of
            ``warm_checkpoint_every`` edges after the first changed one.
            Needs the ``"cuda"`` backend (or ``"auto"``/None, which is
            ``"cuda"`` on the card) and the single-seed ``run()``.

        ``failures=FailureModel(...)`` and ``malleable=MalleableModel(...)``
        turn on the failure-aware and malleable-jobs runtimes (single-seed
        ``run()`` only, mutually exclusive).  ``schedule`` — ``(xi, g)``
        or ``stats.schedule_table``'s triple, each (T,) — replaces the
        per-slot ξ(t), g(t) that ESDP's statistics take; by default
        ``stats.schedule_table(T, m, δ, g_fn)`` on ``device``.
        ``scenario`` — a registered regime's name, a
        ``core.env.Scenario`` (unrolled on the host by
        ``experiments.scenarios.unroll_scenario`` from ``seed``, so a
        regime's trace is the same on every device) or an unrolled
        ``(arr_scale (T, L), speed (T, R), alive (T, R))`` trace — replaces
        ``speed_fn``/``alive_fn`` (passing both raises ``ValueError``) and
        scales the arrival streams.  ``fallback=True`` wraps the backend
        in a ``core.solvers.FallbackSolver`` degradation chain (exact
        results whichever link serves); mutually exclusive with
        ``incremental`` — wrap explicitly to compose.
        """
        self.device = resolve_device(device)
        self.inst = instance
        self.T = T
        self.tables = build_tables(instance.A, instance.c)
        self.g_fn = g_fn
        self.seed = seed
        self.solver = get_solver(solver)  # Algorithm-2 backend
        if incremental not in (None, "cache", "warm"):
            raise ValueError(
                f"unknown incremental mode {incremental!r}; choose from "
                "(None, 'cache', 'warm')")
        self.incremental = incremental
        self._warm = None
        R = instance.n_servers
        self.arr_scale = np.ones((T, instance.n_ports), np.float32)
        if scenario is not None:
            if speed_fn is not None or alive_fn is not None:
                raise ValueError("pass either scenario= or "
                                 "speed_fn/alive_fn, not both")
            arr_scale, speeds, alive = unrolled_trace(scenario, instance, T,
                                                      seed)
            self.arr_scale = arr_scale
            speed_fn = lambda t: speeds[t]  # noqa: E731 — row t ↔ slot t+1
            alive_fn = lambda t: alive[t]  # noqa: E731
        self.speed_fn = speed_fn or (lambda t: np.ones(R, np.float32))
        self.alive_fn = alive_fn or (lambda t: np.ones(R, bool))
        self.m = instance.m
        self.s_cap = stats_mod.s_cap_for_horizon(T, self.m)
        self.u_max = stats_mod.u_max_for_horizon(T, self.m)
        if schedule is None:
            schedule = stats_mod.schedule_table(
                T, self.m, stats_mod.delta_default, g_fn, self.device)
        self.xi_tab, self.g_tab = (torch.as_tensor(a, device=self.device)
                                   for a in tuple(schedule)[:2])
        self.failures = failures
        if failures is not None and malleable is not None:
            raise ValueError(
                "failures= and malleable= are mutually exclusive: both "
                "settle in-flight work host-side per slot")
        self.malleable = malleable
        if fallback:
            if incremental is not None:
                raise ValueError(
                    "fallback=True and incremental= both wrap the backend "
                    "host-side; compose explicitly (pass a preassembled "
                    "wrapper via solver=) instead of stacking them here")
            self.solver = FallbackSolver(self.solver)
        if incremental == "cache":
            self.solver = CachedSolver(self.solver, cache=solve_cache)
        elif incremental == "warm":
            if self.solver.name not in ("cuda", "auto"):
                raise ValueError(
                    'incremental="warm" drives the CUDA carried-plane path; '
                    f"got backend {self.solver.name!r}. Use "
                    'incremental="cache" (any backend) or the '
                    'cache="warm" policy mode in core.esdp instead.')
            from ..kernels.budgeted_dp.ops import WarmCudaSolver
            self._warm = WarmCudaSolver(
                self.tables, self.s_cap, u_max=self.u_max,
                checkpoint_every=warm_checkpoint_every, device=self.device)

    def _solve_stats(self) -> "dict | None":
        if self.incremental == "cache":
            return self.solver.stats.as_dict()
        if self.incremental == "warm":
            return dict(self._warm.stats, edge_skip_rate=self._warm.skip_rate)
        if isinstance(self.solver, FallbackSolver):
            # a detached copy: later solves never mutate a returned record
            return self.solver.stats_dict()
        return None

    # ------------------------------------------------------------------
    def _streams(self, seed: int | None = None):
        """Arrival/noise streams for one seed (default: the sim's own),
        numpy-seeded as in the JAX package, so a seed gives the same
        streams in both packages and in ``run``/``run_batch``."""
        rng = np.random.default_rng(self.seed if seed is None else seed)
        inst = self.inst
        rho_t = np.clip(inst.rho[None, :] * self.arr_scale, 0.0, 1.0)
        arrivals = rng.random((self.T, inst.n_ports)) < rho_t
        noise = rng.normal(0.0, 1.0, (self.T, inst.n_edges)).astype(np.float32)
        return arrivals, noise

    def _z(self, t, noise_t):
        """Realized net valuations under the speed schedule."""
        inst = self.inst
        speed = self.speed_fn(t)[inst.edges[:, 1]]
        mean = inst.mu * speed - inst.cost
        return np.clip(mean + inst.sigma * noise_t, 0.0, 1.0)

    def _v_true(self, t):
        """The oracle's instantaneous means (clipped means: exact enough
        for regret trends, as in the JAX package)."""
        inst = self.inst
        speed = self.speed_fn(t)[inst.edges[:, 1]]
        return np.clip(inst.mu * speed - inst.cost, 0.0, 1.0).astype(np.float32)

    def _check_horizon(self, policy: str) -> None:
        """ESDP solves the DP every slot: before the first, raise the
        solves' ``ValueError`` if the horizon's schedule lets a DP value
        reach ``VALUE_BOUND`` on any device (``ops.
        check_horizon_value_bound``); the baselines solve none."""
        if policy == "esdp":
            from ..kernels.budgeted_dp.ops import check_horizon_value_bound
            check_horizon_value_bound(self.tables, self.m, self.xi_tab,
                                      self.g_tab)

    # ------------------------------------------------------------------
    def run(self, policy: str = "esdp", tiebreak: float = 1e-4) -> SimOutput:
        """The lockstep loop (``sched.engine.lockstep_run``)."""
        from .engine import lockstep_run

        self._check_horizon(policy)
        return lockstep_run(self, policy, tiebreak)

    def engine(self, config=None):
        """A :class:`sched.engine.DispatchEngine` sharing this sim's
        instance, horizon, schedule (already unrolled, with its arrival
        scaling), ξ(t)/g(t) table, g, seed, failure model and device: the
        streaming counterpart of :meth:`run` (admission control, a
        bounded queue with backpressure, weighted A/B policy variants)."""
        from .engine import DispatchEngine

        return DispatchEngine(
            self.inst, self.T, config,
            speed_fn=self.speed_fn, alive_fn=self.alive_fn,
            arr_scale=self.arr_scale, g_fn=self.g_fn, seed=self.seed,
            failures=self.failures, device=self.device,
            schedule=(self.xi_tab, self.g_tab))

    # ------------------------------------------------------------------
    def run_batch(
        self, seeds, policy: str = "esdp", tiebreak: float = 1e-4
    ) -> "list[SimOutput]":
        """One paired simulation per seed, fleet-batched per slot.

        Every seed replays the same cluster schedule against its own
        arrival/noise streams and bandit state, as ``ClusterSim(...,
        seed=s).run(policy)`` would: ``run_batch([s])`` reproduces that
        run bit for bit.  ESDP solves all seeds of a slot in one batched
        solve (one forward launch on the card, K2's counterpart).  Returns
        one :class:`SimOutput` per seed, in seed order.
        """
        if self.incremental == "warm":
            raise NotImplementedError(
                'incremental="warm" carries one value-plane chain and so '
                "runs single-seed only (run()); use incremental=\"cache\" "
                "for fleet batches — its keys are per instance row")
        if self.failures is not None:
            raise NotImplementedError(
                "the failure-aware runtime settles crashes per seed "
                "host-side and so runs single-seed only (run()); loop "
                "run() over seeds for a failure-aware fleet")
        if self.malleable is not None:
            raise NotImplementedError(
                "the malleable-jobs runtime tracks per-seed in-flight "
                "jobs host-side and so runs single-seed only (run()); "
                "loop run() over seeds for a malleable fleet")
        from .engine import lockstep_run_batch

        self._check_horizon(policy)
        return lockstep_run_batch(self, seeds, policy, tiebreak)
