"""``simulate_grid`` (a scenario's parameter grid × seeds as one batch)
against the JAX package's, on the JAX draws, the JAX scenario draws and
the JAX schedule — the parity rules of ``tests/test_torch_scenarios.py``,
whose helpers it uses.

A file of its own: it is the slowest case of those parity tests, and the
tier-1 command spreads whole files over its workers.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_tables as jax_build_tables
from repro.core import generate_instance as jax_generate_instance
from repro.core import simulate_grid as jax_simulate_grid
from repro.core import esdp as jax_esdp
from repro.core import stats as jax_stats
from repro.experiments import get_scenario as jax_get_scenario
from repro_torch.core import (Solver, build_tables, get_solver,
                              instance_from_arrays, simulate_batch,
                              simulate_grid)
from repro_torch.core import esdp
from repro_torch.experiments import get_scenario

from test_torch_env import _jax_draws, _jax_schedule, _recording
from test_torch_scenarios import ORACLE_TOL, TOL, jax_scenario_draws


@pytest.fixture(scope="module")
def table2():
    jinst = jax_generate_instance(seed=0)
    inst = instance_from_arrays(**dataclasses.asdict(jinst))
    return (jinst, jax_build_tables(jinst.A, jinst.c), inst,
            build_tables(inst.A, inst.c))


def test_simulate_grid_matches_jax_and_per_point_batches(table2):
    """``chronic_straggler`` over three straggler speeds × two seeds, ESDP
    on Table 2, T 80: rows bit-equal in x to the JAX ``simulate_grid`` on
    the same draws, to the port's per-point ``simulate_batch`` — and the
    whole grid solves in ONE solver call a slot."""
    jinst, jtables, inst, tables = table2
    T, seeds, speeds = 80, [1, 2], [0.3, 0.6, 1.0]
    calls = []
    ref = get_solver("reference")

    def counting(*args):
        calls.append(args[0].shape)
        return ref(*args[:5], allowed=args[5], u_max=args[6])

    tp = esdp.make_esdp_policy(inst, T, tables=tables,
                               solver=Solver("counting", counting,
                                             accepts_batch=True))
    jscn = jax_get_scenario("chronic_straggler")
    jp = jax_esdp.make_esdp_policy(jinst, T, tables=jtables)
    stacked = {"frac": jnp.full(3, 0.25, jnp.float32),
               "straggler_speed": jnp.asarray(speeds, jnp.float32)}
    want = jax_simulate_grid(jinst, _recording(jp, T, inst.n_edges), T,
                             seeds, jscn, stacked, tables=jtables)
    draws = _jax_draws(seeds, T, inst.n_ports, inst.n_edges)
    sdraws = jax_scenario_draws("chronic_straggler", seeds, T,
                                inst.n_servers)
    schedule = _jax_schedule(T, inst.m, jax_stats.delta_default,
                             jax_stats.g_default)
    got = simulate_grid(inst, tp, T, seeds, get_scenario("chronic_straggler"),
                        {"frac": [0.25] * 3, "straggler_speed": speeds},
                        tables=tables, device="cpu", draws=draws,
                        schedule=schedule, scenario_draws=sdraws)
    assert got.x.shape == (3, 2, T, inst.n_edges)
    assert len(calls) == T and set(calls) == {(6, inst.n_edges)}
    np.testing.assert_array_equal(got.x, want.policy_final[1])
    np.testing.assert_allclose(got.sw, want.sw, **TOL)
    np.testing.assert_allclose(got.regret, want.regret, **ORACLE_TOL)
    for g, v in enumerate(speeds):
        point = simulate_batch(
            inst, tp, T, seeds, tables=tables, device="cpu", draws=draws,
            schedule=schedule, scenario_draws=sdraws,
            scenario=get_scenario("chronic_straggler", straggler_speed=v))
        np.testing.assert_array_equal(got.x[g], point.x)
        np.testing.assert_array_equal(got.sw_oracle[g], point.sw_oracle)
    assert not np.array_equal(got.x[0], got.x[2])
