"""``sweep_scenario_param`` on the port's own draws against per-point
``simulate_batch`` runs, and its errors.

A file of its own: it is one of the slowest cases of the scenario tests
(``tests/test_torch_scenarios.py``), and the tier-1 command spreads whole
files over its workers.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import generate_instance as jax_generate_instance
from repro_torch.core import (build_tables, instance_from_arrays,
                              simulate_batch, simulate_grid)
from repro_torch.core import esdp
from repro_torch.experiments import get_scenario, sweep_scenario_param


@pytest.fixture(scope="module")
def inst_tables():
    """The paper's Table-2 instance (the JAX generator's arrays) and its
    tables."""
    inst = instance_from_arrays(**dataclasses.asdict(
        jax_generate_instance(seed=0)))
    return inst, build_tables(inst.A, inst.c)


def test_sweep_scenario_param_grid(inst_tables):
    """``sweep_scenario_param`` on the port's own draws: (G, S, T) rows
    equal to per-point ``simulate_batch`` runs; an unknown parameter is a
    ``KeyError``, an unknown regime a ``ValueError``."""
    inst, tables = inst_tables
    T, seeds = 40, (0, 1)
    factory = esdp.esdp_factory()
    grid = sweep_scenario_param(inst, factory, T, seeds, "markov_dvfs",
                                "slow_speed", (0.3, 0.9), tables=tables,
                                device="cpu")
    assert grid.sw.shape == (2, 2, T) and grid.x.shape[:3] == (2, 2, T)
    for g, v in enumerate((0.3, 0.9)):
        point = simulate_batch(inst, factory(inst, T, tables), T, seeds,
                               tables=tables, device="cpu",
                               scenario=get_scenario("markov_dvfs",
                                                     slow_speed=v))
        np.testing.assert_array_equal(grid.x[g], point.x)
    with pytest.raises(KeyError, match="slow_speed"):
        sweep_scenario_param(inst, factory, T, seeds, "markov_dvfs", "bogus",
                             (1.0,), tables=tables, device="cpu")
    with pytest.raises(ValueError, match="registered scenarios"):
        sweep_scenario_param(inst, factory, T, seeds, "bogus", "x", (1.0,),
                             tables=tables, device="cpu")
    with pytest.raises(ValueError, match="stacked_params"):
        simulate_grid(inst, factory(inst, T, tables), T, seeds,
                      get_scenario("markov_dvfs"), {"slow_speed": [0.5]},
                      tables=tables, device="cpu")
