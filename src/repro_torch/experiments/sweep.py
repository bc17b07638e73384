"""Batched scenario-sweep engine: (policy × scenario × grid-point) → stats
(counterpart of ``repro.experiments.sweep``).

For every grid point and policy the whole horizon runs as one seed fleet
(``core.env.simulate_batch``: ESDP solves the fleet's slot in one kernel
launch); a scenario-parameter grid runs as one batch of grid points ×
seeds (:func:`sweep_scenario_param`, ``core.env.simulate_grid``).

A sweep is declared, not scripted::

    spec = SweepSpec(
        name="fig6", T=1500, seeds=(11, 12),
        policies={"esdp": esdp_factory(), "hswf": hswf_factory()},
        grid=tuple(GridPoint(f"c_hi{c}", instance_kwargs={"seed": 2, "c_hi": c})
                   for c in (1, 2, 4, 6)),
    )
    rows = run_spec(spec)            # on the card; run_spec(spec, "cpu")
    write_csv(rows, "results/fig6.csv")

Each :class:`SweepRow` carries the stacked per-seed traces plus mean/CI
aggregates; ``write_csv``/``write_json`` sink the aggregates.
:func:`engine_variant_records` flattens a streaming-engine output
(``sched.engine.EngineOutput``) into one record per A/B variant.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
import pathlib
from typing import Mapping, Sequence

import numpy as np

from ..core import (build_tables, generate_instance, simulate_batch,
                    simulate_grid)
from ..core.baselines import (hswf_factory, lcf_factory, lwtf_factory,
                              msr_greedy_factory, msr_index_factory)
from ..core.dp import DPTables
from ..core.env import Scenario, SimResult
from ..core.esdp import PolicyFactory, esdp_factory
from ..core.graph import Instance
from .scenarios import get_scenario

__all__ = [
    "GridPoint", "SweepSpec", "SweepRow",
    "run_spec", "summarize", "sweep_scenario_param", "engine_variant_records",
    "write_csv", "write_json", "POLICY_FACTORIES", "default_policies",
]

# name -> factory constructor with that policy's defaults
POLICY_FACTORIES = {
    "esdp": esdp_factory,
    "hswf": hswf_factory,
    "lcf": lcf_factory,
    "lwtf": lwtf_factory,
    "msr_greedy": msr_greedy_factory,
    "msr_index": msr_index_factory,
}


def default_policies(
    g_fn=None,
    tiebreak: float = 1e-4,
    names: Sequence[str] = ("esdp", "hswf", "lcf", "lwtf", "msr_greedy", "msr_index"),
    solver=None,
) -> dict[str, PolicyFactory]:
    """The full policy lineup as a sweep-ready dict: the paper's four
    (Fig. 2–4) plus the two Markovian-service-rate baselines.

    Unknown names raise ``ValueError`` listing the registry.  ``solver``
    pins ESDP's Algorithm-2 backend (see ``core.solvers``)."""
    out: dict[str, PolicyFactory] = {}
    for n in names:
        if n not in POLICY_FACTORIES:
            raise ValueError(
                f"unknown policy {n!r}; registered policies: "
                f"{', '.join(sorted(POLICY_FACTORIES))}")
        if n == "esdp":
            kw = {"g_fn": g_fn} if g_fn else {}
            if solver is not None:
                kw["solver"] = solver
            out[n] = esdp_factory(**kw)
        else:
            out[n] = POLICY_FACTORIES[n](tiebreak=tiebreak)
    return out


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One cell of a sweep grid: overrides applied on top of the spec."""

    label: str
    instance_kwargs: Mapping = dataclasses.field(default_factory=dict)
    scenario_params: Mapping = dataclasses.field(default_factory=dict)
    T: int | None = None


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Declarative description of one figure/table's worth of runs."""

    name: str
    T: int
    seeds: tuple[int, ...]
    policies: Mapping[str, PolicyFactory]
    scenario: str | Scenario = "iid"
    scenario_params: Mapping = dataclasses.field(default_factory=dict)
    instance_kwargs: Mapping = dataclasses.field(default_factory=dict)
    grid: tuple[GridPoint, ...] = (GridPoint("default"),)
    # Algorithm-2 backend for solver-aware policies: a core.solvers name or
    # a preassembled wrapper (e.g. a FallbackSolver chain, whose counters
    # then surface as fallback_* record columns); None keeps each
    # factory's own default
    solver: "str | object | None" = None
    # incremental re-solve mode for cache-aware policies (None | "memo" |
    # "warm", see core.esdp); its counters surface as record columns
    cache: str | None = None

    def smoke(self, T: int = 120, seeds: tuple[int, ...] = (0,)) -> "SweepSpec":
        """A cheap variant for smoke runs: shrink horizon and seed batch."""
        grid = tuple(
            dataclasses.replace(p, T=min(p.T, T) if p.T else None)
            for p in self.grid)
        return dataclasses.replace(self, T=min(self.T, T), seeds=seeds,
                                   grid=grid)


@dataclasses.dataclass(frozen=True)
class SweepRow:
    """One (grid-point × policy) cell: aggregates + full per-seed traces."""

    spec: str
    point: str
    policy: str
    scenario: str
    T: int
    seeds: tuple[int, ...]
    asw_mean: float  # mean over seeds of ASW(T)
    asw_ci95: float  # 1.96·σ/√S (0 for a single seed)
    regret_mean: float  # mean over seeds of cumulative regret(T)
    regret_ci95: float
    oracle_asw_mean: float  # mean over seeds of Σ_t ṽᵀx*(t)
    n_dispatched_mean: float  # mean ‖x(t)‖₁ per slot
    result: SimResult  # stacked (S, T) traces
    instance: Instance
    tables: DPTables
    # Algorithm-2 backend requested by the spec (name or wrapper object)
    solver: "str | object | None" = None
    # incremental-solve counters averaged over the seed batch by
    # Policy.finalize, plus fallback_* degradation counters when the
    # spec's solver is a FallbackSolver chain; None otherwise
    solve_stats: Mapping | None = None
    # the A/B rollout arm of a streaming-engine record, "" for a sweep
    variant: str = ""

    def to_record(self) -> dict:
        """Sink-friendly flat record (drops the arrays)."""
        rec = {
            "spec": self.spec, "point": self.point, "policy": self.policy,
            "variant": self.variant,
            "scenario": self.scenario, "T": self.T,
            "solver": getattr(self.solver, "name", self.solver) or "default",
            "seeds": ";".join(str(s) for s in self.seeds),
            "asw_mean": self.asw_mean, "asw_ci95": self.asw_ci95,
            "regret_mean": self.regret_mean, "regret_ci95": self.regret_ci95,
            "oracle_asw_mean": self.oracle_asw_mean,
            "n_dispatched_mean": self.n_dispatched_mean,
            "n_edges": self.instance.n_edges,
            "n_states": self.tables.n_states,
        }
        if self.solve_stats:
            rec.update(self.solve_stats)
        return rec


def _ci95(x: np.ndarray) -> float:
    if x.size <= 1:
        return 0.0
    return float(1.96 * x.std(ddof=1) / math.sqrt(x.size))


def summarize(res: SimResult) -> dict:
    """Mean/CI aggregates over the leading seed axis of a batched result."""
    asw = res.asw[..., -1]
    creg = res.cum_regret[..., -1]
    return {
        "asw_mean": float(asw.mean()),
        "asw_ci95": _ci95(asw),
        "regret_mean": float(creg.mean()),
        "regret_ci95": _ci95(creg),
        "oracle_asw_mean": float(res.sw_oracle.sum(axis=-1).mean()),
        "n_dispatched_mean": float(res.n_dispatched.mean()),
    }


def engine_variant_records(
    out, spec: str = "engine", point: str = "default"
) -> list[dict]:
    """Per-variant flat records of a ``sched.engine.EngineOutput``: one
    record per A/B arm (``variant`` and ``policy`` carry its name) with
    its routed and dispatched volume, realized welfare and cumulative
    regret, under the keys ``SweepRow.to_record`` uses where they
    overlap, so arms sit next to sweep rows in one table."""
    recs = []
    routed = np.asarray(out.routed_variant).sum(axis=0)
    for i, name in enumerate(out.variants):
        recs.append({
            "spec": spec, "point": point, "policy": name, "variant": name,
            "T": int(np.asarray(out.sw).shape[0]),
            "asw_mean": float(np.asarray(out.sw_variant)[:, i].sum()),
            "regret_mean": float(np.asarray(out.regret_variant)[:, i].sum()),
            "routed": int(routed[i]),
            "dispatched": int(np.asarray(out.dispatched_variant)[:, i].sum()),
            "mode": out.mode,
        })
    return recs


def _resolve_scenario(
    scenario, base_params: Mapping, point_params: Mapping
) -> Scenario:
    params = {**base_params, **point_params}
    if isinstance(scenario, str):
        return get_scenario(scenario, **params)
    if params:
        return dataclasses.replace(scenario,
                                   params={**scenario.params, **params})
    return scenario


def _batch_solve_stats(policy, res: SimResult) -> "dict | None":
    """Seed-batch mean of ``Policy.finalize`` counters: each run's stats
    dict (``finalize(policy_final, row=i)``), averaged value by value (hit
    and skip rates are per-seed ratios, so the mean is the per-seed mean,
    not a pooled ratio)."""
    if getattr(policy, "finalize", None) is None or res.policy_final is None:
        return None
    S = res.sw.shape[0]
    dicts = [policy.finalize(res.policy_final, row=i) for i in range(S)]
    return {k: float(np.mean([d[k] for d in dicts])) for k in dicts[0]}


def run_spec(spec: SweepSpec, device=None) -> list[SweepRow]:
    """Execute a sweep on ``device`` (``None`` is the card): one seed fleet
    per (grid-point × policy)."""
    rows: list[SweepRow] = []
    for point in spec.grid:
        inst_kwargs = {**spec.instance_kwargs, **point.instance_kwargs}
        instance = generate_instance(**inst_kwargs)
        tables = build_tables(instance.A, instance.c)
        T = point.T if point.T is not None else spec.T
        scenario = _resolve_scenario(spec.scenario, spec.scenario_params,
                                     point.scenario_params)
        for pname, factory in spec.policies.items():
            kw = {}
            if spec.solver is not None and getattr(factory, "accepts_solver",
                                                   False):
                kw["solver"] = spec.solver
            if spec.cache is not None and getattr(factory, "accepts_cache",
                                                  False):
                kw["cache"] = spec.cache
            policy = factory(instance, T, tables, **kw)
            res = simulate_batch(instance, policy, T, spec.seeds,
                                 tables=tables, scenario=scenario,
                                 device=device)
            stats = _batch_solve_stats(policy, res)
            fb = getattr(spec.solver, "stats", None)
            if isinstance(fb, dict):
                # FallbackSolver counters as record columns; they are the
                # wrapper's running totals over every run it served
                stats = {**(stats or {}),
                         **{f"fallback_{k}": v for k, v in fb.items()
                            if isinstance(v, (int, float))}}
            rows.append(SweepRow(
                spec=spec.name, point=point.label, policy=pname,
                scenario=scenario.name, T=T, seeds=tuple(spec.seeds),
                result=res, instance=instance, tables=tables,
                solver=spec.solver,
                solve_stats=stats,
                **summarize(res)))
    return rows


def sweep_scenario_param(
    instance: Instance,
    factory: PolicyFactory,
    T: int,
    seeds,
    scenario_name: str,
    param: str,
    values,
    tables: DPTables | None = None,
    device=None,
    **scenario_kwargs,
) -> SimResult:
    """Sweep ONE scenario parameter over a value grid as one batch of
    len(values) × len(seeds) runs (``core.env.simulate_grid``: with ESDP
    one forward and one epilogue launch a slot for the whole grid).

    Returns a SimResult with shape (len(values), len(seeds), T)."""
    scenario = get_scenario(scenario_name, **scenario_kwargs)
    if tables is None:
        tables = build_tables(instance.A, instance.c)
    if param not in scenario.params:
        raise KeyError(f"scenario {scenario.name!r} has no parameter "
                       f"{param!r}; available: {sorted(scenario.params)}")
    G = len(values)
    stacked = {k: (list(values) if k == param else [v] * G)
               for k, v in scenario.params.items()}
    policy = factory(instance, T, tables)
    return simulate_grid(instance, policy, T, seeds, scenario, stacked,
                         tables=tables, device=device)


# ---------------------------------------------------------------------------
# result sinks
# ---------------------------------------------------------------------------

def _records(rows: Sequence[SweepRow]) -> list[dict]:
    return [r.to_record() for r in rows]


def write_csv(rows: Sequence[SweepRow], path) -> pathlib.Path:
    """Write aggregate records as CSV (one row per grid-point × policy)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    recs = _records(rows)
    with path.open("w", newline="") as f:
        if recs:
            # the union of the keys: cache- and fallback-aware rows carry
            # columns other rows lack
            fieldnames = list(dict.fromkeys(k for r in recs for k in r))
            w = csv.DictWriter(f, fieldnames=fieldnames, restval="")
            w.writeheader()
            w.writerows(recs)
    return path


def write_json(rows: Sequence[SweepRow], path) -> pathlib.Path:
    """Write aggregate records as a JSON array."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(_records(rows), indent=2))
    return path
