"""Cluster model (counterpart of ``repro.sched.cluster``): TPU slices of a
simulated fleet as the paper's servers, training/serving jobs as
multi-server job types (ports), device inventories as the K device types.

A job gang-requests chips + hosts + interconnect-domain units across a
slice — dispatching its components is all-or-nothing (the paper's Gang
property).  Host numpy, bit-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graph import Instance, clipped_normal_mean

__all__ = ["Slice", "JobType", "build_instance", "validate_jobs"]

# device types (K = 3): accelerator chips, host CPUs, ICI domains
K_CHIPS, K_HOSTS, K_ICI = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Slice:
    name: str
    accel: str  # "v5e" | "v5p" | "trn2" — service locality
    chips: int  # e.g. 256 = one pod slice
    hosts: int
    ici_domains: int
    # a divisible slice can grant a malleable job its shrunk gang (a
    # sub-mesh); an indivisible one is all-or-nothing and gets only
    # full-gang edges
    divisible: bool = True


@dataclasses.dataclass(frozen=True)
class JobType:
    name: str  # e.g. "qwen2.5-32b:train_4k"
    arch: str
    shape: str
    accel_ok: tuple[str, ...]  # service-locality set
    chips: int  # gang requirement
    hosts: int
    ici_domains: int
    value_rate: float  # $-value per unit normalized throughput
    arrival_p: float = 0.9
    # malleable jobs (malleable MPI-style scheduling) can run on
    # a shrunk gang mid-execution: ``build_instance`` emits a second edge
    # per feasible (job, divisible slice) pair at the min-gang shape, and
    # ``sched.dispatcher.MalleableRuntime`` shrinks/regrows running jobs
    # between the two configs.  min_* of 0 default to the full gang.
    malleable: bool = False
    min_chips: int = 0
    min_hosts: int = 0
    min_ici_domains: int = 0

    def min_gang(self) -> tuple[int, int, int]:
        """The shrunk-config gang (falling back to the full gang)."""
        return (self.min_chips or self.chips,
                self.min_hosts or self.hosts,
                self.min_ici_domains or self.ici_domains)


def validate_jobs(slices: list[Slice], jobs: list[JobType]) -> dict:
    """Fail-fast admission preflight: job types that can NEVER run here.

    The validate-then-queue side of the JAX package's streaming engine
    (``repro.sched.engine``; not ported yet): an arrival whose job type
    appears in this map is dead-lettered at admission.  Returns
    ``{job name: human-readable reason}`` for every job type with no
    solely-servable slice — wrong accelerator family everywhere, or a
    gang (chips/hosts/ICI domains) larger than every matching slice.
    Job types absent from the map have at least one feasible edge.
    """
    reasons: dict[str, str] = {}
    for job in jobs:
        matching = [s for s in slices if s.accel in job.accel_ok]
        if not matching:
            accels = sorted({s.accel for s in slices})
            reasons[job.name] = (
                f"no slice with accelerator in {job.accel_ok} "
                f"(fleet has {accels})")
            continue
        if not any(s.chips >= job.chips and s.hosts >= job.hosts
                   and s.ici_domains >= job.ici_domains for s in matching):
            reasons[job.name] = (
                f"gang {job.chips}c/{job.hosts}h/{job.ici_domains}i "
                "exceeds every matching slice "
                f"(largest: {max(s.chips for s in matching)}c)")
    return reasons


def build_instance(
    slices: list[Slice],
    jobs: list[JobType],
    mean_rates: np.ndarray,
    *,
    alpha: float = 0.5,
    seed: int = 0,
) -> tuple[Instance, np.ndarray]:
    """Map (jobs × slices) onto the paper's bipartite Instance.

    mean_rates[l, r]: expected normalized throughput of job l on slice r
    (from the roofline model — sched/ratemodel.py); <= 0 means no edge
    (service locality violated or capacity insufficient).

    Malleable jobs (``JobType.malleable``) additionally get a *shrunk*
    edge per feasible (job, divisible slice) pair — same (port, server),
    min-gang requirement column, throughput scaled by the chip fraction
    (linear scaling; roofline-aware sublinear scaling is a refinement the
    rate model can supply via ``mean_rates``).  ``MalleableRuntime``
    groups such same-(port, server) edges into a config family and moves
    running jobs between them.

    Returns (instance, edge_rate) where edge_rate aligns with instance.edges.
    """
    L, R = len(jobs), len(slices)
    edges, A_cols, mu, rate = [], [], [], []
    for li, job in enumerate(jobs):
        for r, sl in enumerate(slices):
            if sl.accel not in job.accel_ok:
                continue
            if (sl.chips < job.chips or sl.hosts < job.hosts
                    or sl.ici_domains < job.ici_domains):
                continue  # not solely-servable (Sec 2.1)
            if mean_rates[li, r] <= 0:
                continue
            edges.append((li, r))
            A_cols.append([job.chips, job.hosts, job.ici_domains])
            mu.append(job.value_rate * mean_rates[li, r])
            rate.append(mean_rates[li, r])
            mg = job.min_gang()
            full = (job.chips, job.hosts, job.ici_domains)
            if (job.malleable and sl.divisible
                    and all(a <= b for a, b in zip(mg, full)) and mg != full):
                frac = mg[0] / job.chips
                edges.append((li, r))
                A_cols.append(list(mg))
                mu.append(job.value_rate * mean_rates[li, r] * frac)
                rate.append(mean_rates[li, r] * frac)
    edges = np.asarray(edges, np.int32)
    A = np.asarray(A_cols, np.int64).T.astype(np.int32)  # (K, E)

    # cluster-wide capacities (constraint (1)): totals over the fleet
    c = np.asarray([sum(s.chips for s in slices),
                    sum(s.hosts for s in slices),
                    sum(s.ici_domains for s in slices)], np.int64)
    # normalize requirement units so the DP capacity state space stays small:
    # express chips/hosts/ici in slice-granularity units
    unit = np.maximum(A.min(axis=1), 1)
    A_u = (A + unit[:, None] - 1) // unit[:, None]
    c_u = np.minimum(c // unit, 12).astype(np.int32)

    mu = np.asarray(mu, np.float32)
    mu = 0.1 + 0.9 * mu / max(float(mu.max()), 1e-9)  # into [0.1, 1]
    sigma = mu / 2.0
    cost = np.full(len(edges), 0.15, np.float32)  # supply cost
    v = np.asarray([clipped_normal_mean(float(m - co), float(s))
                    for m, s, co in zip(mu, sigma, cost)], np.float32)

    inst = Instance(
        n_ports=L, n_servers=R, edges=edges,
        A=A_u.astype(np.int32), c=c_u, cost=cost, mu=mu, sigma=sigma, v=v,
        rho=np.asarray([j.arrival_p for j in jobs], np.float32),
        alpha=alpha)
    return inst, np.asarray(rate, np.float32)
