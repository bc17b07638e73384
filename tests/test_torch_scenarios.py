"""The port's scenario regimes and scenario-driven simulator against the
JAX package's (``repro.experiments.scenarios``, ``repro.core.env``), on
the CPU.

The JAX regimes draw from ``jax.random`` inside their steps; the port's
regimes are pure transitions on declared draws.  :func:`jax_scenario_draws`
replays the JAX key chain (``fold_in(PRNGKey(seed), 0x5CE)``, then each
regime's own splits) and hands the port the same uniforms and server
permutations.  On those, every regime's unrolled trace must equal the JAX
``unroll_scenario``'s: bit for bit for every bool, int, arrival scale and
``where``-chosen speed; ``power_coupled``'s computed speeds within 2e-7
absolute (~3 ulp at speeds ≤ 1: a ``pow`` of XLA's and of PyTorch may
round apart; on this host they agree bit for bit).

The whole-run parity tests inject the JAX draws of ``_run_impl`` and the
JAX schedule (``test_torch_env``), and the JAX regime's trace — replayed
(``replay_scenario``) or regenerated by the port's regime from the JAX
scenario draws — so a speed's ulp never reaches ESDP's ceilings.  ``x``
must be bit-equal; ``sw`` within 1e-5; the oracle under a fluctuating
regime takes float32 ``erf`` clipped means, so ``sw_oracle`` and
``regret`` within rtol 1e-5, atol 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_tables as jax_build_tables
from repro.core import env as jax_env
from repro.core import generate_instance as jax_generate_instance
from repro.core import simulate_batch as jax_simulate_batch
from repro.core import baselines as jax_baselines
from repro.core import esdp as jax_esdp
from repro.core import stats as jax_stats
from repro.experiments import get_scenario as jax_get_scenario
from repro.experiments import scenario_names as jax_scenario_names
from repro.experiments import unroll_scenario as jax_unroll
from repro.experiments.scenarios import power_allocation as jax_power
from repro_torch.core import (ScenarioDraws, build_tables,
                              instance_from_arrays, make_scenario_draws,
                              replay_scenario, simulate, simulate_batch)
from repro_torch.core import baselines, esdp
from repro_torch.core.env import Scenario
from repro_torch.experiments import (SCENARIOS, get_scenario,
                                     power_allocation, register_scenario,
                                     scenario_names, unroll_scenario)
from test_torch_env import _jax_draws, _jax_schedule, _recording

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAS_HYPOTHESIS = True
except ImportError:  # hypothesis is optional
    HAS_HYPOTHESIS = False

REGIMES = tuple(jax_scenario_names())
POWER_ATOL = 2e-7
TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = dict(rtol=1e-5, atol=2e-5)

# regimes with non-default parameters: non-dyadic speeds (μ·speed rounds),
# racks and lemon hosts, a tighter power budget, windows inside T
CASES = [(r, {}) for r in REGIMES] + [
    ("markov_dvfs", dict(slow_speed=0.37)),
    ("server_failures", dict(n_racks=3, p_rack=0.1, lemon_frac=0.25,
                             lemon_mult=4.0, arr_scale=0.8)),
    ("power_coupled", dict(budget=0.9, burst_mult=2.5, alpha=0.7)),
    ("chronic_straggler", dict(frac=0.5, straggler_speed=0.3)),
    ("transient_brownout", dict(t_start=20.0, t_end=90.0,
                                brownout_speed=0.3)),
    ("elastic_outage", dict(frac=0.34, t_down=40.0, t_up=80.0)),
]


def jax_scenario_draws(name, seeds, T, R) -> ScenarioDraws:
    """The uniforms and permutations the JAX regime ``name`` draws for each
    seed (``experiments/scenarios.py``'s key chain), as port draws."""
    def one(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(int(seed)),
                                 jax_env._SCENARIO_SALT)
        perms, slots = {}, {}
        if name in ("chronic_straggler", "elastic_outage"):
            perms["perm"] = jax.random.permutation(key, R)
        elif name == "server_failures":
            key, k_lemon = jax.random.split(key)
            perms["perm"] = jax.random.permutation(k_lemon, R)

            def body(key, _):
                key, k_rep, k_crash, k_rack = jax.random.split(key, 4)
                return key, tuple(jax.random.uniform(k, (R,))
                                  for k in (k_rep, k_crash, k_rack))
            us = jax.lax.scan(body, key, None, length=T)[1]
            slots.update(zip(("repair", "crash", "rack"), us))
        elif name in ("markov_dvfs", "mmpp_arrivals", "power_coupled"):
            shape = () if name == "mmpp_arrivals" else (R,)

            def body(key, _):
                key, k = jax.random.split(key)
                return key, jax.random.uniform(k, shape)
            slots["u"] = jax.lax.scan(body, key, None,
                                      length=T)[1].reshape(T, -1)
        return perms, slots

    outs = [one(s) for s in seeds]

    def stack(i, k, dtype):
        return torch.from_numpy(np.stack([np.array(o[i][k]) for o in outs])
                                ).to(dtype)
    return ScenarioDraws(
        {k: stack(0, k, torch.int64) for k in outs[0][0]},
        {k: stack(1, k, torch.float32) for k in outs[0][1]})


def _assert_trace(regime, got, want):
    for field, a, b in zip(("arr_scale", "speed", "alive"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (field, a.dtype)
        if field == "speed" and regime == "power_coupled":
            np.testing.assert_allclose(a, b, rtol=0, atol=POWER_ATOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    """The same eight names, and each regime's defaults, flags, speed
    bounds and description equal the JAX regime's."""
    assert scenario_names() == REGIMES and len(REGIMES) == 8
    for name in REGIMES:
        ours, theirs = get_scenario(name), jax_get_scenario(name)
        assert ours.name == theirs.name == name
        assert ours.params == theirs.params, name
        assert ours.fluctuates == theirs.fluctuates, name
        assert ours.speed_bounds == theirs.speed_bounds, name
        assert ours.description == theirs.description, name
    assert get_scenario("markov_dvfs", slow_speed=0.3).speed_bounds == (
        0.3, 1.0)


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="power_coupled"):
        get_scenario("not_a_regime")
    with pytest.raises(ValueError, match="burst_mult"):
        get_scenario("power_coupled", burst_mult=0.5)
    with pytest.raises(TypeError):
        get_scenario("markov_dvfs", bogus=1.0)


def test_register_scenario_adds_a_regime():
    @register_scenario("_test_slow")
    def slow(speed: float = 0.5):
        return dataclasses.replace(get_scenario("transient_brownout",
                                                t_start=0.0, t_end=1e9,
                                                brownout_speed=speed),
                                   name="_test_slow")
    try:
        assert "_test_slow" in scenario_names()
        _, speed, _ = unroll_scenario(get_scenario("_test_slow", speed=0.25),
                                      5, 3, device="cpu")
        assert (speed == 0.25).all()
    finally:
        SCENARIOS.pop("_test_slow")


# ---------------------------------------------------------------------------
# transitions on the JAX key chain's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime,kw", CASES,
                         ids=[f"{r}-{i}" for i, (r, _) in enumerate(CASES)])
def test_transitions_match_jax_on_its_draws(regime, kw):
    """Every regime, default and non-default parameters: the port's
    unrolled trace on the draws of the JAX key chain equals the JAX
    ``unroll_scenario`` (T 150, R 12, 4 ports, seed 3)."""
    T, R, L, seed = 150, 12, 4, 3
    want = jax_unroll(jax_get_scenario(regime, **kw), T, R, seed=seed,
                      n_ports=L)
    got = unroll_scenario(get_scenario(regime, **kw), T, R, seed=seed,
                          n_ports=L, device="cpu",
                          draws=jax_scenario_draws(regime, [seed], T, R))
    _assert_trace(regime, got, want)


@pytest.mark.parametrize("regime", REGIMES)
def test_own_unroll_contracts(regime):
    """The port's own draws: speeds inside the declared bounds, shapes,
    bool aliveness, non-negative arrival scales; the same seed replays the
    same trace, and every stochastic regime's trace moves with the seed."""
    scn = get_scenario(regime)
    lo, hi = scn.speed_bounds
    assert 0.0 <= lo <= hi
    traces = {}
    for seed in (0, 7):
        arr, speed, alive = traces[seed] = unroll_scenario(
            scn, 200, 12, seed=seed, n_ports=4, device="cpu")
        assert arr.shape == (200, 4) and speed.shape == alive.shape == (
            200, 12)
        assert speed.dtype == np.float32 and alive.dtype == bool
        assert np.isfinite(speed).all()
        assert (speed >= lo - 1e-6).all() and (speed <= hi + 1e-6).all()
        assert (arr >= 0).all()
    again = unroll_scenario(scn, 200, 12, seed=7, n_ports=4, device="cpu")
    for a, b in zip(again, traces[7]):
        np.testing.assert_array_equal(a, b)
    if scn.draws:
        assert any(not np.array_equal(a, b)
                   for a, b in zip(traces[0], traces[7])), regime


def test_scenario_draws_are_seeded_and_shaped():
    scn = get_scenario("server_failures")
    a = make_scenario_draws(scn, 30, 5, [1, 2])
    b = make_scenario_draws(scn, 30, 5, [1, 2])
    assert set(a.perms) == {"perm"}
    assert set(a.slots) == {"repair", "crash", "rack"}
    assert a.perms["perm"].shape == (2, 5)
    assert a.slots["crash"].shape == (2, 30, 5)
    for k in a.slots:
        assert torch.equal(a.slots[k], b.slots[k])
        assert not torch.equal(a.slots[k][0], a.slots[k][1])
    assert sorted(a.perms["perm"][0].tolist()) == list(range(5))
    mmpp = make_scenario_draws(get_scenario("mmpp_arrivals"), 30, 5, [1])
    assert mmpp.slots["u"].shape == (1, 30, 1)
    assert make_scenario_draws(get_scenario("iid"), 30, 5, [1]).slots == {}


def test_per_port_and_scalar_arr_scale():
    """A regime may emit a scalar or a per-port arrival scale; the unroll
    broadcasts both to (T, n_ports)."""
    def step(params, state, t, n_servers, u):
        return (state, torch.tensor([1.0, 0.5, 0.0]),
                torch.ones(n_servers), torch.ones(n_servers, dtype=bool))

    scn = Scenario(name="per_port", init=lambda *a: (), step=step)
    arr, speed, _ = unroll_scenario(scn, 5, 4, n_ports=3, device="cpu")
    assert arr.shape == (5, 3) and speed.shape == (5, 4)
    np.testing.assert_allclose(arr[0], [1.0, 0.5, 0.0])
    arr2, _, _ = unroll_scenario(get_scenario("mmpp_arrivals"), 5, 4,
                                 n_ports=3, device="cpu")
    assert arr2.shape == (5, 3) and (arr2 == arr2[:, :1]).all()


# ---------------------------------------------------------------------------
# power_allocation: budget and monotonicity (hypothesis when installed)
# ---------------------------------------------------------------------------

def _check_power_allocation(demand, budget):
    d = np.asarray(demand, np.float32)
    p = power_allocation(torch.from_numpy(d), budget).numpy()
    assert (p >= -1e-6).all()
    assert (p <= d + 1e-6).all()
    assert p.sum() <= budget + 1e-4 * max(budget, 1.0)
    np.testing.assert_allclose(p, np.asarray(jax_power(jnp.asarray(d),
                                                       budget)),
                               rtol=1e-6, atol=1e-6)


def _check_power_monotone(demand, b_lo, b_hi):
    d = torch.as_tensor(np.asarray(demand, np.float32))
    assert (power_allocation(d, b_hi) >= power_allocation(d, b_lo)
            - 1e-5).all()


if HAS_HYPOTHESIS:

    @settings(deadline=None, max_examples=50)
    @given(st.lists(st.floats(0.0, 10.0), min_size=1, max_size=16),
           st.floats(0.0, 50.0))
    def test_power_allocation_respects_budget(demand, budget):
        _check_power_allocation(demand, budget)

    @settings(deadline=None, max_examples=50)
    @given(st.lists(st.floats(0.0, 10.0), min_size=1, max_size=16),
           st.floats(0.0, 30.0), st.floats(0.0, 30.0))
    def test_power_allocation_monotone_in_budget(demand, b1, b2):
        _check_power_monotone(demand, min(b1, b2), max(b1, b2))

else:

    def test_power_allocation_respects_budget():
        rng = np.random.default_rng(0)
        for _ in range(50):
            d = rng.uniform(0.0, 10.0, rng.integers(1, 17))
            _check_power_allocation(d, float(rng.uniform(0.0, 50.0)))

    def test_power_allocation_monotone_in_budget():
        rng = np.random.default_rng(1)
        for _ in range(50):
            d = rng.uniform(0.0, 10.0, rng.integers(1, 17))
            b = sorted(rng.uniform(0.0, 30.0, 2))
            _check_power_monotone(d, float(b[0]), float(b[1]))


def test_power_allocation_is_batch_first():
    """A (B, R) demand rations each row against its own budget."""
    d = torch.tensor([[1.0, 3.0, 1.0], [1.0, 1.0, 1.0]])
    p = power_allocation(d, torch.tensor([[2.5], [10.0]]))
    np.testing.assert_allclose(p.sum(dim=1).numpy(), [2.5, 3.0], rtol=1e-6)


# ---------------------------------------------------------------------------
# whole runs against the JAX simulator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table2():
    jinst = jax_generate_instance(seed=0)
    inst = instance_from_arrays(**dataclasses.asdict(jinst))
    return (jinst, jax_build_tables(jinst.A, jinst.c), inst,
            build_tables(inst.A, inst.c))


RUN_REGIMES = {"markov_dvfs": dict(slow_speed=0.37),
               "mmpp_arrivals": {},
               "server_failures": dict(n_racks=2, p_rack=0.05,
                                       lemon_frac=0.3, lemon_mult=3.0),
               "power_coupled": {}}


def _pair(name, jinst, jtables, inst, tables, T):
    if name == "esdp":
        return (jax_esdp.make_esdp_policy(jinst, T, tables=jtables),
                esdp.make_esdp_policy(inst, T, tables=tables))
    return (jax_baselines.make_hswf_policy(jinst),
            baselines.make_hswf_policy(inst))


def _assert_run(got, want_x, want):
    np.testing.assert_array_equal(got.x, want_x)
    np.testing.assert_array_equal(got.n_dispatched, want.n_dispatched)
    np.testing.assert_allclose(got.sw, want.sw, **TOL)
    np.testing.assert_allclose(got.sw_oracle, want.sw_oracle, **ORACLE_TOL)
    np.testing.assert_allclose(got.regret, want.regret, **ORACLE_TOL)


@pytest.mark.parametrize("policy", ["esdp", "hswf"])
@pytest.mark.parametrize("regime", list(RUN_REGIMES))
def test_simulate_matches_jax_under_regime(table2, policy, regime):
    """Table 2, T 60, seeds (5, 6): the JAX batch under the regime against
    the port's ``simulate_batch`` with the regime's own steps on the JAX
    scenario draws, and the port's ``simulate`` replaying the JAX trace of
    seed 5 (JAX's batch row i makes ``simulate(seed_i)``'s decisions)."""
    jinst, jtables, inst, tables = table2
    T, seeds = 60, [5, 6]
    kw = RUN_REGIMES[regime]
    jscn = jax_get_scenario(regime, **kw)
    jp, tp = _pair(policy, jinst, jtables, inst, tables, T)
    want = jax_simulate_batch(jinst, _recording(jp, T, inst.n_edges), T,
                              seeds, tables=jtables, scenario=jscn)
    want_x = want.policy_final[1]
    draws = _jax_draws(seeds, T, inst.n_ports, inst.n_edges)
    schedule = _jax_schedule(T, inst.m, jax_stats.delta_default,
                             jax_stats.g_default)
    got = simulate_batch(
        inst, tp, T, seeds, tables=tables, device="cpu", draws=draws,
        schedule=schedule, scenario=get_scenario(regime, **kw),
        scenario_draws=jax_scenario_draws(regime, seeds, T,
                                          inst.n_servers))
    _assert_run(got, want_x, want)
    trace = jax_unroll(jscn, T, inst.n_servers, seed=seeds[0],
                       n_ports=inst.n_ports)
    one = simulate(inst, tp, T, tables=tables, device="cpu",
                   draws=dataclasses.replace(
                       draws, **{k: getattr(draws, k)[:1]
                                 for k in ("arr_u", "val_n", "pol_u")}),
                   schedule=schedule,
                   scenario=replay_scenario(*trace,
                                            fluctuates=jscn.fluctuates))
    np.testing.assert_array_equal(one.x, want_x[0])
    np.testing.assert_allclose(one.sw_oracle, want.sw_oracle[0],
                               **ORACLE_TOL)
    assert got.x.sum() > T  # more than one channel a slot on average


def test_own_regime_run_equals_its_replay(table2):
    """``simulate`` under a regime equals ``simulate`` replaying that
    regime's own unrolled trace (same seed, same scenario generator)."""
    _, _, inst, tables = table2
    T = 60
    policy = esdp.make_esdp_policy(inst, T, tables=tables)
    for regime in ("power_coupled", "server_failures"):
        scn = get_scenario(regime)
        a = simulate(inst, policy, T, seed=4, tables=tables, scenario=scn,
                     device="cpu")
        trace = unroll_scenario(scn, T, inst.n_servers, seed=4,
                                n_ports=inst.n_ports, device="cpu")
        b = simulate(inst, policy, T, seed=4, tables=tables, device="cpu",
                     scenario=replay_scenario(*trace,
                                              fluctuates=scn.fluctuates))
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.sw, b.sw)
        np.testing.assert_array_equal(a.sw_oracle, b.sw_oracle)


def test_replay_takes_per_run_traces(table2):
    """A replayed trace with a leading run axis gives each run its own."""
    _, _, inst, tables = table2
    T, R, L = 40, inst.n_servers, inst.n_ports
    policy = baselines.make_hswf_policy(inst)
    scn = get_scenario("elastic_outage", frac=0.5, t_down=5.0, t_up=30.0)
    traces = [unroll_scenario(scn, T, R, seed=s, n_ports=L, device="cpu")
              for s in (1, 2)]
    stacked = [np.stack([tr[k] for tr in traces]) for k in range(3)]
    batch = simulate_batch(inst, policy, T, [8, 9], tables=tables,
                           device="cpu", scenario=replay_scenario(*stacked))
    for i, s in enumerate((8, 9)):
        one = simulate(inst, policy, T, seed=s, tables=tables, device="cpu",
                       scenario=replay_scenario(*traces[i]))
        np.testing.assert_array_equal(batch.x[i], one.x)
    dead = ~traces[0][2]
    server = inst.edges[:, 1]
    assert dead.any() and batch.x[0][dead[:, server]].sum() == 0


def test_misshaped_scenario_draws_raise(table2):
    _, _, inst, tables = table2
    scn = get_scenario("markov_dvfs")
    draws = make_scenario_draws(scn, 10, inst.n_servers, [0])
    with pytest.raises(ValueError, match="scenario_draws"):
        simulate(inst, baselines.make_hswf_policy(inst), 12, tables=tables,
                 device="cpu", scenario=scn, scenario_draws=draws)
