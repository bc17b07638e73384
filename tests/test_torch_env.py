"""End-to-end parity of the port's slot simulator with the JAX package.

The JAX simulator draws inside its horizon scan (``core/env.py::_run_impl``
splits the key four ways per slot); these tests replay that key schedule
with ``jax.random`` and inject the same arrival uniforms, valuation
normals and policy uniforms into ``repro_torch``, together with the
per-slot schedule ξ(t), g(t), log(t+1) evaluated in a JAX ``lax.scan``
(XLA's and PyTorch's float32 ``log`` differ by an ulp at some t, which
would move a ceiling in Σ̂²).  A recording wrapper around the JAX policy
keeps its per-slot dispatch vectors.

Per-slot ``x`` and ``n_dispatched`` must be bit-equal; the float traces
``sw``, ``sw_oracle`` and ``regret`` agree within rtol = atol = 1e-5 —
per-slot float32 sums over at most 33 edges, whose reduction order may
differ between XLA and PyTorch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_tables as jax_build_tables
from repro.core import generate_instance as jax_generate_instance
from repro.core import simulate as jax_simulate
from repro.core import simulate_batch as jax_simulate_batch
from repro.core import baselines as jax_baselines
from repro.core import esdp as jax_esdp
from repro.core import stats as jax_stats
from repro.core.env import _clipped_normal_mean_jnp
from repro.core.env import crash_events as jax_crash_events
from repro_torch.core import (Draws, build_tables, instance_from_arrays,
                              make_draws, simulate, simulate_batch)
from repro_torch.core import baselines, esdp
from repro_torch.core import stats
from repro_torch.core.env import _clipped_normal_mean, crash_events

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def table2():
    """The paper's Table-2 instance in both packages, with tables."""
    jinst = jax_generate_instance(seed=0)
    inst = instance_from_arrays(**dataclasses.asdict(jinst))
    return (jinst, jax_build_tables(jinst.A, jinst.c), inst,
            build_tables(inst.A, inst.c))


def _recording(policy, T, E):
    """Wrap a JAX policy so its final state holds the (T, E) dispatch
    vectors it chose (after the eligibility mask the simulator applies)."""
    def init():
        return policy.init(), jnp.zeros((T, E), jnp.int32)

    def step(state, t, eligible, arrived, vhat, n, key):
        inner, xs = state
        x, inner = policy.step(inner, t, eligible, arrived, vhat, n, key)
        xs = xs.at[t.astype(jnp.int32) - 1].set(x * eligible)
        return x, (inner, xs)

    return jax_esdp.Policy(name=policy.name, init=init, step=step)


def _jax_draws(seeds, T, L, E):
    """The per-slot draws of ``_run_impl`` for each seed, as a port Draws."""
    def one(key):
        def body(key, _):
            key, k_arr, k_val, k_pol = jax.random.split(key, 4)
            return key, (jax.random.uniform(k_arr, (L,)),
                         jax.random.normal(k_val, (E,)),
                         jax.random.uniform(k_pol, (E,)))
        return jax.lax.scan(body, key, None, length=T)[1]

    outs = [one(jax.random.PRNGKey(int(s))) for s in seeds]
    return Draws(*(torch.from_numpy(np.stack([np.array(o[k]) for o in outs]))
                   for k in range(3)))


def _jax_schedule(T, m, delta_fn, g_fn):
    def body(carry, t):
        tf = t.astype(jnp.float32)
        return carry, (jax_stats.xi_of(tf, m, delta_fn), g_fn(tf, m),
                       jnp.log(tf + 1.0))
    _, out = jax.lax.scan(body, 0, jnp.arange(1, T + 1))
    return tuple(torch.from_numpy(np.array(a)) for a in out)


def _policies(name, jinst, jtables, inst, tables, T):
    """(JAX policy, port policy, (δ, g) of the JAX schedule) by name."""
    if name == "esdp":
        return (jax_esdp.make_esdp_policy(jinst, T, tables=jtables),
                esdp.make_esdp_policy(inst, T, tables=tables),
                (jax_stats.delta_default, jax_stats.g_default))
    tiebreak = 0.0 if name.endswith("_tb0") else 1e-4
    base = name.removesuffix("_tb0")
    make = f"make_{base}_policy"
    return (getattr(jax_baselines, make)(jinst, tiebreak=tiebreak),
            getattr(baselines, make)(inst, tiebreak=tiebreak),
            (jax_stats.delta_default, jax_stats.g_default))


def _assert_parity(got, want_x, want):
    np.testing.assert_array_equal(got.x, want_x)
    np.testing.assert_array_equal(got.n_dispatched, want.n_dispatched)
    np.testing.assert_allclose(got.sw, want.sw, **TOL)
    np.testing.assert_allclose(got.sw_oracle, want.sw_oracle, **TOL)
    np.testing.assert_allclose(got.regret, want.regret, **TOL)


@pytest.mark.parametrize("name", [
    "esdp", "hswf", "lcf", "lwtf", "msr_greedy", "msr_index",
    "hswf_tb0", "lcf_tb0", "lwtf_tb0"])
def test_policies_match_jax_slot_for_slot(table2, name):
    """All six policies at T = 300 on Table 2 (and the quickstart's
    deterministic baselines, tiebreak = 0): same decisions every slot."""
    jinst, jtables, inst, tables = table2
    T, seed = 300, 42
    jp, tp, (d, g) = _policies(name, jinst, jtables, inst, tables, T)
    want = jax_simulate(jinst, _recording(jp, T, inst.n_edges), T,
                        seed=seed, tables=jtables)
    got = simulate(inst, tp, T, tables=tables, device="cpu",
                   draws=_jax_draws([seed], T, inst.n_ports, inst.n_edges),
                   schedule=_jax_schedule(T, inst.m, d, g))
    _assert_parity(got, want.policy_final[1], want)


def test_esdp_quickstart_horizon_matches_jax(table2):
    """The quickstart milestone: ESDP with the paper's default g over
    T = 2000 slots, seed 42 — same decisions every slot, and the final
    accumulated welfare and regret within 1e-5 relative."""
    jinst, jtables, inst, tables = table2
    T, seed = 2000, 42
    jp, tp, (d, g) = _policies("esdp", jinst, jtables, inst, tables, T)
    want = jax_simulate(jinst, _recording(jp, T, inst.n_edges), T,
                        seed=seed, tables=jtables)
    got = simulate(inst, tp, T, tables=tables, device="cpu",
                   draws=_jax_draws([seed], T, inst.n_ports, inst.n_edges),
                   schedule=_jax_schedule(T, inst.m, d, g))
    _assert_parity(got, want.policy_final[1], want)
    np.testing.assert_allclose(got.asw[-1], want.asw[-1], rtol=1e-5)
    np.testing.assert_allclose(got.cum_regret[-1], want.cum_regret[-1],
                               rtol=1e-5)


@pytest.fixture(scope="module")
def jax_esdp_batch(table2):
    """The JAX ESDP ``simulate_batch`` on Table 2 (T 150, seeds 3, 11,
    42) that both solver cases compare against: (T, seeds, result)."""
    jinst, jtables, inst, _ = table2
    T, seeds = 150, [3, 11, 42]
    jp = jax_esdp.make_esdp_policy(jinst, T, tables=jtables)
    return T, seeds, jax_simulate_batch(jinst, _recording(jp, T, inst.n_edges),
                                        T, seeds, tables=jtables)


@pytest.mark.parametrize("solver", ["reference", "cuda"])
def test_esdp_batch_matches_jax_simulate_batch(table2, jax_esdp_batch, solver):
    """B = 3 seeds through ``simulate_batch``: every row equals the JAX
    batch row slot for slot.  ``cuda`` runs the kernel wrappers' plain
    versions here (CPU tensors), ``reference`` the int32 edge fold."""
    _, _, inst, tables = table2
    T, seeds, want = jax_esdp_batch
    tp = esdp.make_esdp_policy(inst, T, tables=tables, solver=solver)
    got = simulate_batch(inst, tp, T, seeds, tables=tables, device="cpu",
                         draws=_jax_draws(seeds, T, inst.n_ports,
                                          inst.n_edges),
                         schedule=_jax_schedule(T, inst.m,
                                                jax_stats.delta_default,
                                                jax_stats.g_default))
    assert got.x.shape == (3, T, inst.n_edges)
    _assert_parity(got, want.policy_final[1], want)


# ---------------------------------------------------------------------------
# the port's own draws and schedule, the device rule, helpers
# ---------------------------------------------------------------------------

def test_batch_rows_equal_single_runs_on_own_draws(table2):
    """``simulate_batch`` row i makes the decisions of ``simulate(seed_i)``
    with the port's own generator and schedule (bit-equal x)."""
    _, _, inst, tables = table2
    T, seeds = 40, [1, 2, 3]
    policy = esdp.make_esdp_policy(inst, T, tables=tables)
    batch = simulate_batch(inst, policy, T, seeds, tables=tables,
                           device="cpu")
    for i, s in enumerate(seeds):
        one = simulate(inst, policy, T, seed=s, tables=tables, device="cpu")
        np.testing.assert_array_equal(batch.x[i], one.x)
        np.testing.assert_allclose(batch.sw[i], one.sw, **TOL)
    assert not np.array_equal(batch.x[0], batch.x[1])


def test_make_draws_is_seeded_and_shaped(table2):
    _, _, inst, _ = table2
    a = make_draws(inst, 25, 7, device="cpu")
    b = make_draws(inst, 25, 7, device="cpu")
    c = make_draws(inst, 25, 8, device="cpu")
    assert a.arr_u.shape == (1, 25, inst.n_ports)
    assert a.val_n.shape == a.pol_u.shape == (1, 25, inst.n_edges)
    for k in ("arr_u", "val_n", "pol_u"):
        assert torch.equal(getattr(a, k), getattr(b, k))
        assert not torch.equal(getattr(a, k), getattr(c, k))
    assert 0.0 <= float(a.arr_u.min()) and float(a.arr_u.max()) < 1.0


def test_simulate_rejects_misshaped_draws(table2):
    _, _, inst, tables = table2
    policy = baselines.make_hswf_policy(inst)
    draws = make_draws(inst, 10, 0, device="cpu")
    with pytest.raises(ValueError, match="arr_u"):
        simulate(inst, policy, 12, tables=tables, device="cpu", draws=draws)


def test_device_none_raises_without_cuda(table2, monkeypatch):
    _, _, inst, tables = table2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    policy = esdp.make_esdp_policy(inst, 10, tables=tables)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(inst, policy, 10, tables=tables)
    with pytest.raises(RuntimeError):
        simulate_batch(inst, policy, 10, [0, 1], tables=tables)
    with pytest.raises(RuntimeError):
        make_draws(inst, 10, 0)


@pytest.fixture(scope="module")
def small():
    """The JAX incremental tests' instance (``tests/test_incremental.py``)
    in both packages, with tables."""
    jinst = jax_generate_instance(seed=3, n_ports=4, n_servers=10,
                                  edge_prob=0.3)
    inst = instance_from_arrays(**dataclasses.asdict(jinst))
    return (jinst, jax_build_tables(jinst.A, jinst.c), inst,
            build_tables(inst.A, inst.c))


# g(t): the paper's default, which moves Σ̂² every slot (so the memo
# never hits), and a constant g, under which the statistics repeat
G_CASES = {"g_default": (jax_stats.g_default, stats.g_default),
           "g_constant": (lambda t, m: jnp.full_like(t, 2.0),
                          lambda t, m: torch.full_like(t, 2.0))}


def _cache_policies(small, T, mode, g):
    jinst, jtables, inst, tables = small
    jg, tg = G_CASES[g]
    return (jax_esdp.make_esdp_policy(jinst, T, tables=jtables, g_fn=jg,
                                      solver="reference", cache=mode),
            esdp.make_esdp_policy(inst, T, tables=tables, g_fn=tg,
                                  solver="reference", cache=mode),
            _jax_schedule(T, inst.m, jax_stats.delta_default, jg))


@pytest.mark.parametrize("g", list(G_CASES))
@pytest.mark.parametrize("mode", ["memo", "warm"])
def test_esdp_cache_modes_match_jax_simulate(small, mode, g):
    """``cache="memo"``/``"warm"`` through ``simulate`` on injected draws
    and schedule: per-slot x bit-equal to the JAX run with the same mode,
    and the ``finalize`` dicts (hits or folded edges, solves, rates)
    equal — nonzero under the constant g."""
    jinst, jtables, inst, tables = small
    T, seed = 120, 4  # a seed whose draws make the memo hit 10 times
    jp, tp, schedule = _cache_policies(small, T, mode, g)
    want = jax_simulate(jinst, _recording(jp, T, inst.n_edges), T,
                        seed=seed, tables=jtables)
    got = simulate(inst, tp, T, tables=tables, device="cpu",
                   draws=_jax_draws([seed], T, inst.n_ports, inst.n_edges),
                   schedule=schedule)
    _assert_parity(got, want.policy_final[1], want)
    stats_got = tp.finalize(got.policy_final)
    assert stats_got == jp.finalize(want.policy_final[0])
    assert stats_got["cache_solves"] == T
    if g == "g_constant":
        assert stats_got.get("cache_hits", 1) > 0
        assert stats_got.get("edge_skip_rate", 1) > 0


@pytest.mark.parametrize("g", list(G_CASES))
@pytest.mark.parametrize("mode", ["memo", "warm"])
def test_esdp_cache_modes_match_jax_simulate_batch(small, mode, g):
    """The same through ``simulate_batch`` over three seeds: every run's
    x bit-equal to the JAX fleet's row and each run's ``finalize`` equal
    to the JAX one of that row (the counters are per run)."""
    jinst, jtables, inst, tables = small
    T, seeds = 80, (3, 4, 5)
    jp, tp, schedule = _cache_policies(small, T, mode, g)
    want = jax_simulate_batch(jinst, _recording(jp, T, inst.n_edges), T,
                              seeds, tables=jtables)
    got = simulate_batch(inst, tp, T, seeds, tables=tables, device="cpu",
                         draws=_jax_draws(seeds, T, inst.n_ports,
                                          inst.n_edges),
                         schedule=schedule)
    _assert_parity(got, want.policy_final[1], want)
    for i in range(len(seeds)):
        row = jax.tree.map(lambda a: np.asarray(a)[i], want.policy_final[0])
        assert tp.finalize(got.policy_final, row=i) == jp.finalize(row)


def test_esdp_cache_mode_validation(table2):
    """Unknown modes raise; ``cache="warm"`` takes the reference backend
    only, as in the JAX package; factories keep their overrides."""
    _, _, inst, tables = table2
    with pytest.raises(ValueError, match="cache mode"):
        esdp.make_esdp_policy(inst, 10, tables=tables, cache="bogus")
    for solver in ("cuda", "auto"):
        with pytest.raises(ValueError, match="reference"):
            esdp.make_esdp_policy(inst, 10, tables=tables, solver=solver,
                                  cache="warm")
    assert esdp.make_esdp_policy(inst, 10, tables=tables,
                                 solver="cuda", cache="memo").finalize
    assert esdp.make_esdp_policy(inst, 10, tables=tables).finalize is None
    factory = esdp.esdp_factory(g_fn=stats.g_logt_only)
    assert factory(inst, 10, tables).g_fn is stats.g_logt_only
    assert factory(inst, 10, tables, cache="memo").finalize is not None


def test_fluctuated_mean_rounds_once_as_xla(table2):
    """The fluctuated valuation mean μ_e·speed_r − cost_e: XLA fuses it into
    one multiply-add (one rounding), inside the horizon scan as in a bare
    jit.  Under a non-dyadic speed a multiply and then a subtract round
    twice and split the valuations z̃, and so the running means v̂ that
    every policy reads, from the JAX package's.  HSWF on Table 2 under
    ``power_coupled`` (speeds p^α, non-dyadic), T 200, on injected draws
    and the JAX trace: v̂ must be bit-equal every slot, and so must the
    realized welfare of every slot that dispatches one channel (its z̃)."""
    from repro.experiments import get_scenario as jax_get_scenario
    from repro.experiments import unroll_scenario as jax_unroll
    from repro_torch.core import replay_scenario
    from repro_torch.core.esdp import Policy

    jinst, jtables, inst, tables = table2
    T, seed, E = 200, 9, inst.n_edges
    jscn = jax_get_scenario("power_coupled")
    jp = jax_baselines.make_hswf_policy(jinst)

    def jinit():
        return jp.init(), jnp.zeros((T, E), jnp.float32)

    def jstep(state, t, eligible, arrived, vhat, n, key):
        inner, seen = state
        x, inner = jp.step(inner, t, eligible, arrived, vhat, n, key)
        return x, (inner, seen.at[t.astype(jnp.int32) - 1].set(vhat))

    want = jax_simulate(jinst, jax_esdp.Policy(name="hswf", init=jinit,
                                               step=jstep),
                        T, seed=seed, tables=jtables, scenario=jscn)
    tp = baselines.make_hswf_policy(inst)
    seen = []

    def step(state, slot, eligible, arrived, vhat, n, pol_u):
        seen.append(vhat[0].clone())
        return tp.step(state, slot, eligible, arrived, vhat, n, pol_u)

    trace = jax_unroll(jscn, T, inst.n_servers, seed=seed,
                       n_ports=inst.n_ports)
    assert (trace[1] < 1.0).mean() > 0.5
    got = simulate(inst, Policy(name="hswf", init=tp.init, step=step), T,
                   tables=tables, device="cpu",
                   draws=_jax_draws([seed], T, inst.n_ports, E),
                   scenario=replay_scenario(*trace, fluctuates=True))
    np.testing.assert_array_equal(torch.stack(seen).numpy(),
                                  np.asarray(want.policy_final[1]))
    one = got.n_dispatched == 1
    assert one.sum() > T // 2
    np.testing.assert_array_equal(got.sw[one], want.sw[one])


def test_clipped_normal_mean_matches_jax():
    """Per-slot oracle means of fluctuating regimes: float32 erf in both
    packages, within atol 1e-6."""
    rng = np.random.default_rng(3)
    m = rng.uniform(-1.5, 1.5, 500).astype(np.float32)
    s = rng.uniform(0.0, 1.0, 500).astype(np.float32)
    want = np.asarray(_clipped_normal_mean_jnp(jnp.asarray(m),
                                               jnp.asarray(s)))
    got = _clipped_normal_mean(torch.from_numpy(m), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_crash_events_equal():
    alive = np.random.default_rng(4).random((30, 6)) < 0.8
    np.testing.assert_array_equal(crash_events(alive),
                                  jax_crash_events(alive))
