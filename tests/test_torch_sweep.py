"""The port's sweep engine (``repro_torch.experiments.sweep``) and its
command-line sweep (``repro_torch.launch.scenario_sweep``) against the JAX
package's (``repro.experiments.sweep``, ``examples/scenario_sweep.py``),
on the CPU.

``run_spec`` is held to the JAX ``run_spec`` on the same spec with the
port's ``simulate_batch`` fed the JAX draws, the JAX scenario draws and
the JAX schedule: every record's keys in the same order, its labels,
counts and incremental-solve columns equal, its float aggregates within
rtol 1e-5 (float32 sums whose reduction order differs between XLA and
PyTorch).  ``summarize`` and ``SweepRow.to_record`` on the same result
arrays, and the CSV and JSON sinks' columns, are equal exactly.
"""
import contextlib
import csv
import dataclasses
import io
import json

import numpy as np
import pytest

from repro.core import SimResult as JaxSimResult
from repro.core import stats as jax_stats
from repro.core.baselines import hswf_factory as jax_hswf_factory
from repro.core.esdp import esdp_factory as jax_esdp_factory
from repro.experiments import GridPoint as JaxGridPoint
from repro.experiments import SweepSpec as JaxSweepSpec
from repro.experiments import run_spec as jax_run_spec
from repro.experiments import summarize as jax_summarize
from repro.experiments import write_csv as jax_write_csv
from repro.experiments import write_json as jax_write_json
from repro.experiments.sweep import POLICY_FACTORIES as JAX_FACTORIES
from repro_torch.core import SimResult
from repro_torch.core.baselines import hswf_factory
from repro_torch.core.esdp import esdp_factory
from repro_torch.experiments import (POLICY_FACTORIES, GridPoint, SweepSpec,
                                     default_policies, run_spec, summarize,
                                     write_csv, write_json)
from repro_torch.experiments import sweep
from repro_torch.launch import scenario_sweep
from test_torch_env import _jax_draws, _jax_schedule
from test_torch_scenarios import jax_scenario_draws

SMALL = {"seed": 3, "n_ports": 4, "n_servers": 10, "edge_prob": 0.3}
LABELS = ("spec", "point", "policy", "variant", "scenario", "T", "solver",
          "seeds", "n_edges", "n_states")


def test_policy_registry_and_factory_flags():
    assert list(POLICY_FACTORIES) == list(JAX_FACTORIES)
    pols = default_policies(solver="reference")
    assert list(pols) == list(JAX_FACTORIES)
    assert pols["esdp"].accepts_solver and pols["esdp"].accepts_cache
    assert not getattr(pols["hswf"], "accepts_solver", False)
    with pytest.raises(ValueError, match="msr_greedy"):
        default_policies(names=("esdp", "not_a_policy"))


def test_sweep_spec_smoke_matches_jax():
    kw = dict(name="s", T=500, seeds=(1, 2, 3), policies={},
              grid=(GridPoint("a", T=300), GridPoint("b")))
    jkw = dict(kw, grid=(JaxGridPoint("a", T=300), JaxGridPoint("b")))
    ours, theirs = SweepSpec(**kw).smoke(T=90), JaxSweepSpec(**jkw).smoke(
        T=90)
    assert (ours.T, ours.seeds) == (theirs.T, theirs.seeds) == (90, (0,))
    assert [p.T for p in ours.grid] == [p.T for p in theirs.grid] == [90,
                                                                       None]


def _arrays(seed=0, S=3, T=40, E=5):
    rng = np.random.default_rng(seed)
    return dict(sw=rng.random((S, T)).astype(np.float32),
                sw_oracle=rng.random((S, T)).astype(np.float32) + 1,
                regret=rng.random((S, T)).astype(np.float32),
                n_dispatched=rng.integers(0, 4, (S, T)).astype(np.int32)), E


def test_summarize_and_records_equal_jax_on_same_arrays():
    arrays, E = _arrays()
    ours = summarize(SimResult(**arrays, x=np.zeros((3, 40, E), np.int32)))
    theirs = jax_summarize(JaxSimResult(**arrays))
    assert ours == theirs
    one, _ = _arrays(S=1)
    assert summarize(SimResult(**one, x=None))["asw_ci95"] == 0.0


@pytest.fixture(scope="module")
def spec_pair():
    """A power_coupled sweep over two grid points (the second shrinks the
    horizon), ESDP with the memo cache and HSWF, seeds (1, 2), in both
    packages."""
    common = dict(name="mini", T=60, seeds=(1, 2), scenario="power_coupled",
                  cache="memo", instance_kwargs=SMALL)
    ours = SweepSpec(policies={"esdp": esdp_factory(),
                               "hswf": hswf_factory()},
                     grid=(GridPoint("a"), GridPoint("b", T=40)), **common)
    theirs = JaxSweepSpec(policies={"esdp": jax_esdp_factory(),
                                    "hswf": jax_hswf_factory()},
                          grid=(JaxGridPoint("a"), JaxGridPoint("b", T=40)),
                          **common)
    return ours, theirs


def _injected(monkeypatch):
    """Point the sweep's ``simulate_batch`` at the JAX draws, scenario
    draws and schedule of the same seeds."""
    real = sweep.simulate_batch

    def fed(instance, policy, T, seeds, tables=None, scenario=None, device=None):
        return real(instance, policy, T, seeds, tables=tables,
                    scenario=scenario, device=device,
                    draws=_jax_draws(seeds, T, instance.n_ports,
                                     instance.n_edges),
                    scenario_draws=jax_scenario_draws(
                        scenario.name, seeds, T, instance.n_servers),
                    schedule=_jax_schedule(
                        T, instance.m,
                        getattr(jax_stats, policy.delta_fn.__name__),
                        getattr(jax_stats, policy.g_fn.__name__)))
    monkeypatch.setattr(sweep, "simulate_batch", fed)


def test_run_spec_matches_jax_on_injected_draws(spec_pair, monkeypatch, tmp_path):
    ours, theirs = spec_pair
    _injected(monkeypatch)
    rows, jrows = run_spec(ours, device="cpu"), jax_run_spec(theirs)
    recs, jrecs = ([r.to_record() for r in rs] for rs in (rows, jrows))
    assert len(recs) == len(jrecs) == 4
    for got, want in zip(recs, jrecs):
        assert list(got) == list(want)
        for k in want:
            if k in LABELS or k.startswith("cache_") or k == (
                    "n_dispatched_mean"):
                assert got[k] == want[k], k
            else:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert recs[0]["cache_solves"] == 60 and recs[2]["T"] == 40
    for r, jr in zip(rows, jrows):
        np.testing.assert_array_equal(r.result.n_dispatched,
                                      jr.result.n_dispatched)
    # the sinks: the same columns, the same labels
    paths = (write_csv(rows, tmp_path / "ours.csv"),
             jax_write_csv(jrows, tmp_path / "theirs.csv"))
    heads = [next(csv.reader(p.open())) for p in paths]
    assert heads[0] == heads[1] and "cache_hit_rate" in heads[0]
    jsons = (write_json(rows, tmp_path / "ours.json"),
             jax_write_json(jrows, tmp_path / "theirs.json"))
    a, b = (json.loads(p.read_text()) for p in jsons)
    assert [list(r) for r in a] == [list(r) for r in b]
    assert [[r[k] for k in LABELS] for r in a] == [[r[k] for k in LABELS]
                                                   for r in b]


def test_run_spec_rejects_unknown_scenario():
    spec = SweepSpec(name="bad", T=10, seeds=(0,),
                     policies=default_policies(names=("hswf",)),
                     scenario="not_a_regime", instance_kwargs=SMALL)
    with pytest.raises(ValueError, match="registered scenarios"):
        run_spec(spec, device="cpu")


def test_run_spec_takes_a_scenario_object_with_overrides():
    """A Scenario object (not a name) takes the spec's and the point's
    parameters on top of its own."""
    from repro_torch.experiments import get_scenario
    spec = SweepSpec(name="obj", T=20, seeds=(0,),
                     policies={"hswf": hswf_factory()},
                     scenario=get_scenario("markov_dvfs"),
                     scenario_params={"p_slow": 0.5},
                     grid=(GridPoint("slow", scenario_params={
                         "slow_speed": 0.2}),),
                     instance_kwargs=SMALL)
    (row,) = run_spec(spec, device="cpu")
    assert row.scenario == "markov_dvfs" and row.solve_stats is None
    assert row.result.sw.shape == (1, 20)
    assert sweep._resolve_scenario(spec.scenario, spec.scenario_params,
                                   spec.grid[0].scenario_params).params == {
        "slow_speed": 0.2, "p_slow": 0.5, "p_fast": 0.25}


def test_launch_scenario_sweep_prints_the_examples_table(tmp_path):
    """``python -m repro_torch.launch.scenario_sweep --device cpu``, cut to
    T 20 and one seed: a table row for each of the eight regimes, the
    CSV with one row per (regime × policy), and the five-point severity
    grid."""
    out = io.StringIO()
    path = tmp_path / "sweep.csv"
    with contextlib.redirect_stdout(out):
        res = scenario_sweep.main(["--device", "cpu", "--T", "20",
                                   "--seeds", "0", "--out", str(path)])
    lines = out.getvalue().splitlines()
    assert lines[0].split() == ["scenario", "esdp", "ASW", "hswf", "ASW",
                                "winner"]
    regimes = [ln.split()[0] for ln in lines[1:9]]
    assert regimes == sorted(regimes) and len(set(regimes)) == 8
    with path.open() as f:
        recs = list(csv.DictReader(f))
    assert len(recs) == 16 and {r["policy"] for r in recs} == {"esdp",
                                                              "hswf"}
    assert res["grid_asw"].shape == (5, 1)
    assert sum("straggler_speed=" in ln for ln in lines) == 5
    assert dataclasses.is_dataclass(res["rows"][0])
