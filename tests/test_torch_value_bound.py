"""The DP's value bound, checked once for a whole horizon before the first
slot of every run that solves the DP, on any device (the CPU here; the
same raise on CUDA tensors is a card test in ``tests/test_torch_cuda.py``).

The int32 plane is exact while every DP value stays below
``VALUE_BOUND`` = 2^29.  A solve checks its own Σ̂² only for CPU tensors
(a CUDA one is not read back); the runs check the horizon's worst Σ̂²,
an unexplored channel's (m+1)·⌈ξ²g/2⌉ at its largest over the schedule,
on the host.  An m-37 instance (``generate_instance`` with ``edge_prob``
0.22: E = 74, m = ⌈0.5 E⌉ = 37) at T 4515, whose capacities (4, 4, 3) let
11 edges be selected, reaches 11 x 93,101,292 ≥ 2^29 and must raise;
Table 2 (m 17, T 2000), fig-6 c_hi = 6 (m 16, T 1500) and the dispatch
fleet (m 8, T 800) stay far below and must pass.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (build_tables, esdp, generate_instance,
                              make_hswf_policy, simulate, simulate_batch,
                              simulate_grid, stats)
from repro_torch.experiments.scenarios import get_scenario
from repro_torch.kernels.budgeted_dp import (VALUE_BOUND,
                                             check_horizon_value_bound,
                                             max_achievable_value)
from repro_torch.launch.dispatch import T as TD
from repro_torch.launch.dispatch import dispatch_instance
from repro_torch.sched import ClusterSim

T_BREAK = 4515
REFUSED = "2\\^29 over this horizon"


@pytest.fixture(scope="module")
def m37():
    inst = generate_instance(seed=2, edge_prob=0.22, c_lo=3, c_hi=4)
    assert (inst.n_edges, inst.m) == (74, 37)
    assert int(inst.c.sum()) == 11
    return inst


def _counting(policy):
    """``policy`` with its step counted: a raise before the first slot
    leaves the count at 0."""
    calls = [0]
    real = policy.step

    def step(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    return esdp.Policy(name=policy.name, init=policy.init, step=step,
                       delta_fn=policy.delta_fn, g_fn=policy.g_fn,
                       finalize=policy.finalize), calls


def test_the_horizon_bound_is_the_unexplored_statistic_at_its_worst(m37):
    """``stats.sigma2_bound`` is the largest Σ̂² that ``scale_statistics``
    gives over the schedule (every channel unexplored, every slot), and
    the bound gives it to each of the 11 edges the capacities admit."""
    xi, g, _ = stats.schedule_table(T_BREAK, m37.m, device="cpu")
    E = m37.n_edges
    _, sig, _ = stats.scale_statistics(
        torch.zeros((T_BREAK, E)), torch.zeros((T_BREAK, E), dtype=torch.int32),
        xi[:, None], g[:, None], m37.m)
    worst = stats.sigma2_bound(xi, g, m37.m)
    assert worst == int(sig.max()) == 93_101_292
    tables = build_tables(m37.A, m37.c)
    assert max_achievable_value(np.full(E, worst), tables) == 11 * worst
    with pytest.raises(ValueError, match=f"reach {11 * worst} ≥ 2\\^29"):
        check_horizon_value_bound(tables, m37.m, xi, g)


def test_simulate_refuses_the_m37_horizon_before_the_first_slot(m37):
    """``simulate``, ``simulate_batch`` and ``simulate_grid`` raise before
    their policy takes a step; the same horizon's HSWF, which solves no
    DP, runs (at T 100, a horizon whose ESDP is refused too)."""
    policy, calls = _counting(esdp.make_esdp_policy(m37, T_BREAK))
    with pytest.raises(ValueError, match=REFUSED):
        simulate(m37, policy, T_BREAK, device="cpu")
    with pytest.raises(ValueError, match=REFUSED):
        simulate_batch(m37, policy, T_BREAK, [0, 1], device="cpu")
    with pytest.raises(ValueError, match=REFUSED):
        simulate_grid(m37, policy, T_BREAK, [0], get_scenario(
            "chronic_straggler"), {"frac": [0.25, 0.25],
                                    "straggler_speed": [0.2, 0.6]},
            device="cpu")
    assert calls[0] == 0
    with pytest.raises(ValueError, match=REFUSED):
        simulate(m37, esdp.make_esdp_policy(m37, 100), 100, device="cpu")
    out = simulate(m37, make_hswf_policy(m37, 100), 100, device="cpu")
    assert out.x.shape == (100, m37.n_edges)


def test_cluster_sim_and_engine_refuse_the_m37_horizon(m37):
    """``ClusterSim.run`` / ``run_batch`` with ESDP and a
    ``DispatchEngine`` with an ESDP variant raise before the first slot
    (g = the paper's default; the dispatcher's own ln t keeps this
    instance under the bound); HSWF through ``ClusterSim`` runs."""
    sim = ClusterSim(m37, T_BREAK, g_fn=stats.g_default, device="cpu")
    with pytest.raises(ValueError, match=REFUSED):
        sim.run()
    with pytest.raises(ValueError, match=REFUSED):
        sim.run_batch([0, 1])
    with pytest.raises(ValueError, match=REFUSED):
        sim.engine()
    short = ClusterSim(m37, 100, g_fn=stats.g_default, device="cpu")
    with pytest.raises(ValueError, match=REFUSED):
        short.run()
    assert short.run("hswf").x.shape == (100, m37.n_edges)
    assert check_horizon_value_bound(
        build_tables(m37.A, m37.c), m37.m, *stats.schedule_table(
            T_BREAK, m37.m, g_fn=stats.g_logt_only, device="cpu")[:2]
    ) < VALUE_BOUND


@pytest.mark.parametrize("case", ["table2", "fig6_c_hi6", "dispatch",
                                  "dispatch_g_default"])
def test_shipped_horizons_pass_the_check(case):
    """The check itself on the shipped configurations' horizons: each
    bound far under 2^29 (no horizon is run)."""
    g_fn = stats.g_default
    if case == "table2":
        inst, T = generate_instance(seed=0), 2000
    elif case == "fig6_c_hi6":
        inst, T = generate_instance(seed=2, c_lo=1, c_hi=6), 1500
    else:
        inst, T = dispatch_instance(), TD
        if case == "dispatch":
            g_fn = stats.g_logt_only  # ClusterSim's own
    xi, g, _ = stats.schedule_table(T, inst.m, g_fn=g_fn, device="cpu")
    bound = check_horizon_value_bound(build_tables(inst.A, inst.c), inst.m,
                                      xi, g)
    assert 0 < bound < VALUE_BOUND // 8, bound  # 13.6x under at fig-6
