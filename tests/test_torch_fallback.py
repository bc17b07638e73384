"""The port's degradation chain (``core.solvers.FallbackSolver``) and
``ClusterSim(fallback=True)`` against the JAX package's, on the CPU.

The cases of the JAX package's ``tests/test_robustness.py`` (chain
construction, exactness under faults, accounting, the final link's
failure, the dispatcher's bit-identity under faults, per-output stats
copies), and:

* the counters equal the JAX wrapper's on the same fault plan for a
  two-link chain (JAX ``pallas_interpret`` → ``reference``, the port
  ``cuda`` → ``reference``; on CPU tensors the ``cuda`` link runs the
  kernels' plain versions): ``runtime.fault.planned_fault`` is pure in
  (seed, call, attempt), so both walk the same faults;
* the poison: the JAX wrapper corrupts a row with 2**24, which the port's
  int32 validator (values up to 2**29) would accept; the port writes
  2**29, which it rejects.

Integer outputs and counters must be equal (tolerance 0); ``sw`` and
``regret`` of the dispatcher within rtol 1e-6.
"""
import copy

import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.core import build_tables as jax_build_tables
from repro.core.solvers import FallbackSolver as JaxFallbackSolver
from repro.kernels.budgeted_dp.ops import VALUE_BOUND as JAX_BOUND
from repro.kernels.budgeted_dp.ops import validate_value_row as jax_validate
from repro_torch import sched
from repro_torch.core import build_tables, esdp, get_solver, simulate_batch
from repro_torch.core.solvers import POISON, FallbackSolver
from repro_torch.experiments import SweepSpec, run_spec
from repro_torch.kernels.budgeted_dp.ops import (VALUE_BOUND,
                                                 validate_value_row)
from repro_torch.runtime.fault import FAULT_RATE_ENV
from test_torch_sched import _assert_same, _instances, _jax_schedule

REF = get_solver("reference")
CUDA = get_solver("cuda")


def _problem():
    """The JAX tests' ``_fallback_problem``: E 6, two resources."""
    rng = np.random.default_rng(1)
    A = rng.integers(1, 3, size=(2, 6))
    c = rng.integers(2, 4, size=2)
    A = np.minimum(A, c[:, None])
    ups = rng.integers(1, 5, size=6).astype(np.int32)
    sig = rng.integers(1, 5000, size=6).astype(np.int32)
    return (A, c), build_tables(A, c), ups, sig, int(ups.sum())


def _solve(solver, tables, ups, sig, s_cap, **kw):
    return solver(torch.from_numpy(ups), torch.from_numpy(sig), tables,
                  s_cap, torch.tensor(s_cap), **kw)


def test_chain_construction():
    fb = FallbackSolver("cuda")
    assert fb.name == "fallback:cuda->reference"
    assert fb.chain == (CUDA, REF) and fb.base is CUDA and fb.accepts_batch
    assert FallbackSolver("reference").chain == (REF,)
    assert not FallbackSolver("reference").accepts_batch
    assert get_solver(fb) is fb  # solver-shaped wrappers pass through
    assert fb.stats["served_by"] == {"cuda": 0, "reference": 0}
    with pytest.raises(ValueError, match="non-empty"):
        FallbackSolver(chain=())
    scoped = FallbackSolver("cuda", scope="arm-a")
    d = scoped.stats_dict()
    assert d["scope"] == "arm-a" and d is not scoped.stats
    d["served_by"]["cuda"] = 99
    assert scoped.stats["served_by"]["cuda"] == 0


def test_matches_plain_backend():
    _, tables, ups, sig, s_cap = _problem()
    fb = FallbackSolver("cuda", fault_rate=0.0)
    x, info = _solve(fb, tables, ups, sig, s_cap)
    xr, infor = _solve(REF, tables, ups, sig, s_cap)
    assert torch.equal(x, xr) and torch.equal(info["s_star"],
                                              infor["s_star"])
    assert torch.equal(info["value_row"], infor["value_row"])
    st = fb.stats
    assert st["calls"] == 1 and st["served_by"] == {"cuda": 1,
                                                    "reference": 0}
    assert st["degraded_calls"] == 0 and st["events"] == []
    assert st["bypasses"] == 0


def test_every_attempt_faulted_still_exact():
    """fault_rate 1.0 kills every non-final attempt — both kinds occur and
    are caught; the final link always serves, the answers never change."""
    _, tables, ups, sig, s_cap = _problem()
    fb = FallbackSolver(chain=("cuda", "reference"), fault_rate=1.0,
                        fault_seed=0)
    xr, infor = _solve(REF, tables, ups, sig, s_cap)
    for _ in range(8):
        x, info = _solve(fb, tables, ups, sig, s_cap)
        assert torch.equal(x, xr)
        assert torch.equal(info["value_row"], infor["value_row"])
        assert validate_value_row(info["value_row"]) is None
    st = fb.stats
    assert st["calls"] == 8 == st["degraded_calls"] == st["faults_injected"]
    assert st["served_by"] == {"cuda": 0, "reference": 8}
    assert st["launch_failures"] + st["validation_failures"] == 8
    assert st["launch_failures"] > 0 and st["validation_failures"] > 0
    assert {e["kind"] for e in st["events"]} == {"launch", "validate"}
    assert all(e["injected"] for e in st["events"])
    assert all("value-bound" in e["error"] for e in st["events"]
               if e["kind"] == "validate")


def test_counters_equal_jax_on_the_same_fault_plan():
    """A two-link chain at fault rate 0.5, 24 calls: the port's counters
    and events equal the JAX wrapper's, link for link (the JAX links are
    ``pallas_interpret`` → ``reference``), and the answers are equal."""
    (A, c), tables, ups, sig, s_cap = _problem()
    jfb = JaxFallbackSolver(chain=("pallas_interpret", "reference"),
                            fault_rate=0.5, fault_seed=3)
    fb = FallbackSolver(chain=("cuda", "reference"), fault_rate=0.5,
                        fault_seed=3)
    jtables = jax_build_tables(A, c)
    rng = np.random.default_rng(5)
    for _ in range(24):
        u = rng.integers(0, 5, size=6).astype(np.int32)
        s = rng.integers(1, 5000, size=6).astype(np.int32)
        want_x, want = jfb(u, s, jtables, s_cap, s_cap)
        x, info = _solve(fb, tables, u, s, s_cap)
        np.testing.assert_array_equal(x.numpy(), want_x)
        np.testing.assert_array_equal(info["value_row"].numpy(),
                                      want["value_row"])
    names = {"pallas_interpret": "cuda", "reference": "reference"}
    got, want = fb.stats, jfb.stats
    for k in ("calls", "bypasses", "degraded_calls", "launch_failures",
              "validation_failures", "faults_injected"):
        assert got[k] == want[k], k
    assert got["served_by"] == {names[k]: v
                                for k, v in want["served_by"].items()}
    assert got["degraded_calls"] > 0 and got["served_by"]["cuda"] > 0
    assert [(e["call"], e["attempt"], names[e["backend"]], e["kind"],
             e["injected"]) for e in want["events"]] == [
        (e["call"], e["attempt"], e["backend"], e["kind"], e["injected"])
        for e in got["events"]]


def test_the_poison_is_one_the_int32_validator_rejects():
    """The JAX package's poison (2**24, its f32-exact bound) passes the
    port's validator, whose int32 plane is exact to 2**29; the port's
    poison is that bound and fails it."""
    _, tables, ups, sig, s_cap = _problem()
    _, info = _solve(REF, tables, ups, sig, s_cap)
    row = info["value_row"].numpy().copy()
    assert validate_value_row(row) is None
    jax_poisoned, poisoned = row.copy(), row.copy()
    jax_poisoned[0], poisoned[0] = 2 ** 24, POISON
    assert validate_value_row(jax_poisoned) is None  # the trap
    assert JAX_BOUND == 2 ** 24 and "value-bound" in jax_validate(
        jax_poisoned)
    assert POISON == VALUE_BOUND
    assert "value-bound" in validate_value_row(poisoned)
    assert "row 1" in validate_value_row(np.stack([row, poisoned]))


def test_final_link_failure_propagates():
    """A chain that cannot serve at all is an outage, not a degradation."""
    _, tables, ups, sig, s_cap = _problem()

    class Dead:
        name = "dead"
        accepts_batch = False

        def __call__(self, *a, **k):
            raise RuntimeError("backend gone")

    with pytest.raises(RuntimeError, match="backend gone"):
        _solve(FallbackSolver(chain=(Dead(),)), tables, ups, sig, s_cap)
    fb = FallbackSolver(chain=(Dead(), "reference"))
    x, _ = _solve(fb, tables, ups, sig, s_cap)
    assert fb.stats["launch_failures"] == 1 == fb.stats["degraded_calls"]
    assert fb.stats["events"][0]["injected"] is False
    assert "backend gone" in fb.stats["events"][0]["error"]


def test_fault_rate_from_the_environment(monkeypatch):
    _, tables, ups, sig, s_cap = _problem()
    monkeypatch.setenv(FAULT_RATE_ENV, "1.0")
    fb = FallbackSolver("cuda")
    assert fb.fault_rate == 1.0
    _solve(fb, tables, ups, sig, s_cap)
    assert fb.stats["served_by"]["reference"] == 1
    assert FallbackSolver("cuda", fault_rate=0.0).fault_rate == 0.0


def test_event_log_is_capped():
    _, tables, ups, sig, s_cap = _problem()
    fb = FallbackSolver(chain=("cuda", "reference"), fault_rate=1.0)
    for _ in range(FallbackSolver._MAX_EVENTS + 4):
        _solve(fb, tables, ups, sig, s_cap)
    assert len(fb.stats["events"]) == FallbackSolver._MAX_EVENTS
    assert fb.stats["degraded_calls"] == FallbackSolver._MAX_EVENTS + 4


def test_batched_rows_validated_and_exact_in_simulate_batch():
    """ESDP's fleet solve through the chain under faults: ``simulate_batch``
    x bit-equal to the plain backend's; each slot one call."""
    from repro_torch.core import generate_instance
    inst = generate_instance(seed=3, n_ports=4, n_servers=10, edge_prob=0.3)
    tables = build_tables(inst.A, inst.c)
    T, seeds = 40, [1, 2, 3]
    fb = FallbackSolver(chain=("cuda", "reference"), fault_rate=0.3,
                        fault_seed=2)
    plain = simulate_batch(inst, esdp.make_esdp_policy(inst, T,
                                                       tables=tables),
                           T, seeds, tables=tables, device="cpu")
    got = simulate_batch(inst, esdp.make_esdp_policy(inst, T, tables=tables,
                                                     solver=fb),
                         T, seeds, tables=tables, device="cpu")
    np.testing.assert_array_equal(got.x, plain.x)
    st = fb.stats
    assert st["calls"] == T and st["degraded_calls"] > 0
    assert sum(st["served_by"].values()) == T


def test_run_spec_reports_fallback_columns():
    """A sweep with a FallbackSolver as its solver: the chain's counters
    become ``fallback_*`` record columns (the port walks the chain every
    solve: calls = slots, no bypasses)."""
    fb = FallbackSolver(chain=("cuda", "reference"), fault_rate=0.25,
                        fault_seed=4)
    spec = SweepSpec(name="fb", T=30, seeds=(0, 1),
                     policies={"esdp": esdp.esdp_factory()},
                     scenario="power_coupled", solver=fb,
                     instance_kwargs={"seed": 3, "n_ports": 4,
                                      "n_servers": 10, "edge_prob": 0.3})
    (row,) = run_spec(spec, device="cpu")
    rec = row.to_record()
    assert rec["solver"] == "fallback:cuda->reference"
    assert rec["fallback_calls"] == 30 and rec["fallback_bypasses"] == 0
    assert rec["fallback_degraded_calls"] > 0
    assert not any(k.startswith("fallback_served") for k in rec)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    _, (jinst, _), _, (inst, _) = _instances("robustness")
    return jinst, inst


def test_cluster_sim_fallback_matches_jax(cluster):
    """``fallback=True`` over the reference backend, T 60: outputs and the
    chain's counters equal the JAX run's."""
    jinst, inst = cluster
    T = 60
    want = jsched.ClusterSim(jinst, T, seed=7, solver="reference",
                             fallback=True).run("esdp")
    got = sched.ClusterSim(inst, T, seed=7, device="cpu", solver="reference",
                           fallback=True,
                           schedule=_jax_schedule(T, inst.m)).run("esdp")
    _assert_same(got, want)
    assert got.solve_stats["calls"] == T
    assert got.solve_stats["served_by"] == {"reference": T}


def test_cluster_sim_fallback_bit_identical_under_faults(cluster):
    """A full ESDP run with faults at 20% gives the fault-free run's x,
    welfare and regret, every degradation accounted in solve_stats."""
    _, inst = cluster
    T = 60
    plain = sched.ClusterSim(inst, T, seed=7, device="cpu",
                             solver="cuda").run("esdp")
    fb = FallbackSolver(chain=("cuda", "reference"), fault_rate=0.2,
                        fault_seed=1)
    out = sched.ClusterSim(inst, T, seed=7, device="cpu",
                           solver=fb).run("esdp")
    np.testing.assert_array_equal(plain.x, out.x)
    np.testing.assert_array_equal(plain.sw, out.sw)
    np.testing.assert_array_equal(plain.regret, out.regret)
    st = out.solve_stats
    assert st["calls"] == T and st["faults_injected"] > 0
    assert st["degraded_calls"] == len(st["events"]) > 0
    assert sum(st["served_by"].values()) == T
    quiet = sched.ClusterSim(inst, T, seed=7, device="cpu", solver="cuda",
                             fallback=True).run("esdp")
    np.testing.assert_array_equal(plain.x, quiet.x)
    assert quiet.solve_stats["degraded_calls"] == 0
    assert quiet.solve_stats["events"] == []
    assert quiet.solve_stats["served_by"] == {"cuda": T, "reference": 0}
    # the returned record is detached from the live counters
    quiet.solve_stats["calls"] = -1
    assert sched.ClusterSim(inst, 5, seed=7, device="cpu", solver="cuda",
                            fallback=True).run("esdp").solve_stats[
        "calls"] == 5


def test_cluster_sim_fallback_excludes_incremental(cluster):
    _, inst = cluster
    with pytest.raises(ValueError, match="incremental"):
        sched.ClusterSim(inst, 10, device="cpu", fallback=True,
                         incremental="cache")


def test_run_batch_stats_are_per_output_copies(cluster):
    """Every SimOutput owns its own solve_stats, nested counters included
    (the JAX package's ``test_run_batch_fallback_stats_copied``)."""
    _, inst = cluster
    fb = FallbackSolver("cuda", fault_rate=0.0)
    outs = sched.ClusterSim(inst, 20, device="cpu",
                            solver=fb).run_batch((0, 1))
    a, b = outs[0].solve_stats, outs[1].solve_stats
    assert a is not b and a["served_by"] is not b["served_by"]
    assert a == b and a["scope"] == "fleet" and a["calls"] == 20
    original = copy.deepcopy(b)
    a["served_by"]["cuda"] = 10 ** 6
    assert b == original
    cached = sched.ClusterSim(inst, 20, device="cpu",
                              incremental="cache").run_batch((0, 1, 2))
    stats = [o.solve_stats for o in cached]
    assert stats[0] == stats[1] and stats[0] is not stats[1]
    stats[0]["scope"] = "tampered"
    assert stats[1]["scope"] == "fleet"
