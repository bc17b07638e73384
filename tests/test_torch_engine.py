"""The port's streaming dispatch engine (``repro_torch.sched.engine``)
against the JAX package's (``repro.sched.engine``), on the CPU.

Both engines run the same instance, seeds and schedules: the arrival,
noise and tie-break streams are numpy-seeded in both, and ESDP's per-slot
ξ(t), g(t) are injected into the port as the JAX engine's scan evaluates
them.  The JAX side runs as ``tests/test_engine.py`` runs it (its
default backend); the port's ESDP variants run the ``cuda`` backend,
whose kernel wrappers take their plain versions on CPU tensors.

Bitwise (tolerance 0): the queue lengths, every ledger array and total,
``routed_variant``, ``dispatched_variant``, the bandit statistics ``n``
and ``sumz``, and each slot's dispatch vector.  Within rtol 1e-6, atol
1e-5 (their reductions run in another order): ``sw``, ``regret``,
``dispatch_share``, ``sw_variant``, ``regret_variant`` and ``asw``.
Within the port, stream and lockstep agree bitwise on every field, and
``run_batch([s, ...])`` equals ``run(seed=s)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.core import stats as jax_stats
from repro.core.graph import generate_instance as jax_generate_instance
from repro.core.solvers import CachedSolver as JaxCachedSolver
from repro.core.solvers import get_solver as jax_get_solver
from repro.experiments import engine_variant_records as jax_records
from repro.experiments import get_scenario as jax_get_scenario
from repro.experiments import unroll_scenario as jax_unroll
from repro.sched import engine as jax_engine
from repro_torch import sched
from repro_torch.core import CachedSolver, SolveCache, get_solver
from repro_torch.core.graph import generate_instance
from repro_torch.experiments import engine_variant_records, scenario_names
from repro_torch.sched import engine

T = 60
ENGINE_FIELDS = ("sw", "regret", "dispatch_share", "sw_variant",
                 "regret_variant", "dispatched_variant", "routed_variant",
                 "n", "sumz", "queue_len")
EXACT = ("dispatched_variant", "routed_variant", "n", "sumz", "queue_len")
CLOSE = ("sw", "regret", "dispatch_share", "sw_variant", "regret_variant")
TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(m):
    """The engine configurations of the tests, built from package ``m``."""
    E, V = m.EngineConfig, m.VariantSpec
    ab = (V("esdp", weight=0.9), V("challenger", kind="hswf", weight=0.1))
    return {
        "single": E(),
        "ab": E(variants=ab),
        "drop_oldest": E(queue_capacity=1, backpressure="drop_oldest",
                         variants=(V("esdp", weight=0.5),
                                   V("lwtf", kind="lwtf", weight=0.5))),
        "drop_global": E(queue_capacity=2, backpressure="drop_oldest",
                         total_capacity=3,
                         variants=(V("esdp", weight=0.7),
                                   V("lcf", kind="lcf", weight=0.3))),
        "block": E(queue_capacity=1, backpressure="block", total_capacity=3,
                   variants=(V("lcf", kind="lcf", weight=0.5),
                             V("hswf", kind="hswf", weight=0.5))),
        "shed_by_utility": E(queue_capacity=1,
                             backpressure="shed_by_utility",
                             variants=(V("esdp", weight=0.6),
                                       V("hswf", kind="hswf", weight=0.4))),
        "salted": E(variants=ab, route_salt=0xBEEF),
    }


JAX_CFG, CFG = _configs(jsched), _configs(sched)


def jax_schedule(T_, m):
    """ξ(t), g(t) as the JAX engine's scan evaluates them (t = 1..T as
    float32, g = ``g_logt_only``)."""
    def body(carry, t):
        tf = t.astype(jnp.float32)
        return carry, (jax_stats.xi_of(tf, m), jax_stats.g_logt_only(tf, m))
    _, out = jax.lax.scan(body, 0, jnp.arange(1, T_ + 1))
    return tuple(np.array(a) for a in out)


@pytest.fixture(scope="module")
def insts():
    return jax_generate_instance(seed=0), generate_instance(seed=0)


@pytest.fixture(scope="module")
def sch(insts):
    return jax_schedule(T, insts[0].m)


def dead_port(inst):
    """The instance with port 0 made never-feasible (every edge of it
    asks for more than the cluster has)."""
    A2 = inst.A.copy()
    A2[:, inst.port_of_edge == 0] = int(inst.c.max()) + 5
    return dataclasses.replace(inst, A=A2)


def injected(name, jinst, seed=3):
    """A JAX regime's unrolled trace as ``speed_fn``/``alive_fn``/
    ``arr_scale`` keywords of both engines."""
    arr, speed, alive = (np.asarray(a) for a in jax_unroll(
        jax_get_scenario(name), T, jinst.n_servers, seed,
        n_ports=jinst.n_ports))
    return dict(speed_fn=lambda t: speed[t], alive_fn=lambda t: alive[t],
                arr_scale=np.broadcast_to(arr.reshape(T, -1),
                                          (T, jinst.n_ports)))


CASES = {  # name: (config, keywords of both engines, dead port?)
    "single": ("single", {}, False),
    "ab": ("ab", {}, False),
    "drop_oldest": ("drop_oldest", dict(arr_scale=3.0), False),
    "drop_oldest_global": ("drop_global", dict(arr_scale=3.0), False),
    "block": ("block", dict(arr_scale=3.0), False),
    "shed_by_utility": ("shed_by_utility", dict(arr_scale=3.0), False),
    "dead_port": ("ab", {}, True),
    "route_salt": ("salted", {}, False),
    "power_coupled": ("ab", "power_coupled", False),
    "server_failures": ("ab", "server_failures", False),
}


def capture_jax_x(monkeypatch):
    """Wrap the JAX engine's lockstep dispatch jit to record each slot's
    per-variant dispatch vector (JAX's stream and lockstep agree bitwise,
    ``tests/test_engine.py``)."""
    seen = []
    real = jax_engine.DispatchEngine._lockstep_jits

    def jits(self):
        j = real(self)
        if not getattr(j["dispatch"], "_recording", False):
            inner = j["dispatch"]

            def dispatch(*a):
                out = inner(*a)
                seen.append(np.asarray(out[0]))
                return out
            dispatch._recording = True
            j["dispatch"] = dispatch
        return j
    monkeypatch.setattr(jax_engine.DispatchEngine, "_lockstep_jits", jits)
    return seen


@pytest.fixture(scope="module")
def runs(insts, sch):
    """Every case through the JAX engine (stream) and the port (stream and
    lockstep), and the JAX dispatch vectors of two cases (lockstep)."""
    jinst, inst = insts
    out = {}
    for case, (cfg, kw, dead) in CASES.items():
        ji, ti = (dead_port(jinst), dead_port(inst)) if dead else (jinst,
                                                                   inst)
        if isinstance(kw, str):
            kw = injected(kw, jinst)
        want = jsched.DispatchEngine(ji, T, JAX_CFG[cfg], seed=3,
                                     **kw).run(mode="stream")
        eng = sched.DispatchEngine(ti, T, CFG[cfg], seed=3, device="cpu",
                                   schedule=sch, **kw)
        out[case] = (want, eng.run(mode="stream"), eng.run(mode="lockstep"))
    mp = pytest.MonkeyPatch()
    try:
        seen = capture_jax_x(mp)
        xs = {}
        for case in ("single", "ab"):
            seen.clear()
            jsched.DispatchEngine(jinst, T, JAX_CFG[case],
                                  seed=3).run(mode="lockstep")
            xs[case] = np.stack(seen)
    finally:
        mp.undo()
    return out, xs


def assert_conserves(out):
    led = out.ledger
    assert led["total_arrivals"] == (led["total_rejected"]
                                     + led["total_blocked"]
                                     + led["total_admitted"])
    assert led["total_admitted"] == (led["total_dispatched"]
                                     + led["total_dropped"]
                                     + led["total_shed"]
                                     + led["final_queue"])


def assert_matches_jax(got, want):
    """The port's output against the JAX engine's: the exact fields and
    the ledger bitwise, the welfare and regret fields within TOL."""
    assert got.variants == want.variants
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert set(got.ledger) == set(want.ledger)
    for k, v in want.ledger.items():
        np.testing.assert_array_equal(np.asarray(got.ledger[k]),
                                      np.asarray(v), err_msg=k)
    for f in CLOSE:
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)
    assert got.asw == pytest.approx(want.asw, rel=1e-6, abs=1e-5)


def assert_same(a, b):
    """Two of the port's outputs bitwise on every field."""
    for f in ENGINE_FIELDS + ("x",):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert a.ledger.keys() == b.ledger.keys()
    for k in a.ledger:
        np.testing.assert_array_equal(np.asarray(a.ledger[k]),
                                      np.asarray(b.ledger[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_stream_matches_jax(runs, case):
    want, got, _ = runs[0][case]
    assert got.mode == "stream"
    assert_matches_jax(got, want)
    assert_conserves(got)


@pytest.mark.parametrize("case", list(CASES))
def test_lockstep_equals_stream_bitwise(runs, case):
    _, stream, lock = runs[0][case]
    assert lock.mode == "lockstep"
    assert_same(stream, lock)


@pytest.mark.parametrize("case", ["single", "ab"])
def test_dispatch_vectors_match_jax(runs, case):
    """Each slot's per-variant dispatch vector (T, V, E), bitwise."""
    got = runs[0][case][1].x
    want = runs[1][case]
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("policy", engine.BACKPRESSURE_POLICIES)
def test_only_the_configured_channel_fires(runs, policy):
    led = runs[0][policy][1].ledger
    active = {"drop_oldest": "dropped", "block": "blocked",
              "shed_by_utility": "shed"}[policy]
    assert led[f"total_{active}"] > 0
    for ch in ("dropped", "blocked", "shed"):
        if ch != active:
            assert led[f"total_{ch}"] == 0


def test_dead_port_is_dead_lettered(runs, insts):
    out = runs[0]["dead_port"][1]
    ok = engine.feasible_ports(dead_port(insts[1]))
    assert not ok[0] and ok[1:].all()
    assert out.ledger["total_rejected"] > 0
    bad = ~ok[insts[1].port_of_edge]
    assert out.n[:, bad].sum() == 0 and out.sumz[:, bad].sum() == 0


def test_route_salt_moves_the_split(runs):
    base, salted = runs[0]["ab"][1], runs[0]["route_salt"][1]
    assert not np.array_equal(base.routed_variant, salted.routed_variant)


def test_run_batch_matches_jax_and_each_run(insts, sch):
    """One batch-first pass for three seeds: each seed equals the JAX
    engine's ``run_batch`` row and the port's own ``run(seed=s)``."""
    jinst, inst = insts
    seeds = [11, 12, 13]
    want = jsched.DispatchEngine(jinst, T, JAX_CFG["ab"],
                                 seed=0).run_batch(seeds)
    eng = sched.DispatchEngine(inst, T, CFG["ab"], seed=0, device="cpu",
                               schedule=sch)
    got = eng.run_batch(seeds)
    for s, g, w in zip(seeds, got, want):
        assert_matches_jax(g, w)
        assert_same(g, eng.run(mode="stream", seed=s))
    with pytest.raises(NotImplementedError, match="lockstep"):
        eng.run_batch(seeds, mode="lockstep")


def test_failure_lockstep_matches_jax(insts, sch):
    """A failure run (lockstep, settled on the host in numpy with two
    roundings per valuation): bitwise n, sumz and every ledger, per-variant
    crash ledgers conserving; each ESDP variant's CachedSolver scoped by
    its name, its counters read through ``solve_stats``."""
    jinst, inst = insts
    E, V = jsched.EngineConfig, jsched.VariantSpec
    jcfg = E(variants=(V("esdp", weight=0.9,
                         solver=JaxCachedSolver(jax_get_solver("reference"))),
                       V("challenger", kind="hswf", weight=0.1)))
    tcfg = sched.EngineConfig(variants=(
        sched.VariantSpec("esdp", weight=0.9,
                          solver=CachedSolver(get_solver("cuda"))),
        sched.VariantSpec("challenger", kind="hswf", weight=0.1)))
    want = jsched.DispatchEngine(
        jinst, T, jcfg, seed=3,
        failures=jsched.FailureModel(p_crash=0.1, redundancy=2)).run()
    got = sched.DispatchEngine(
        inst, T, tcfg, seed=3, device="cpu", schedule=sch,
        failures=sched.FailureModel(p_crash=0.1, redundancy=2)).run()
    assert got.mode == "lockstep"
    assert_matches_jax(got, want)
    assert got.solve_stats == want.solve_stats
    assert got.solve_stats["esdp"]["scope"] == "esdp"
    assert got.solve_stats["esdp"]["launches_saved"] + \
        got.solve_stats["esdp"]["misses"] == T
    fv, jfv = got.failures["per_variant"], want.failures["per_variant"]
    for name in got.variants:
        for k, v in jfv[name].items():
            np.testing.assert_array_equal(np.asarray(fv[name][k]),
                                          np.asarray(v), err_msg=k)
        np.testing.assert_allclose(
            fv[name]["dispatched"], fv[name]["completed"]
            + fv[name]["lost"] + fv[name]["salvaged"], rtol=1e-6, atol=1e-6)
    for k in ("dispatched", "completed", "lost", "salvaged", "crashes",
              "replicas", "restarts"):
        np.testing.assert_array_equal(np.asarray(got.failures[k]),
                                      np.asarray(want.failures[k]))
    assert got.failures["total_lost"] > 0


# ---------------------------------------------------------------------------
# the roundings and tie rules the engine must share with XLA
# ---------------------------------------------------------------------------

def test_route_u01_bitwise():
    """The uint32 hash on int64 tensors: equal to the JAX function on
    400,000 (id, salt) pairs, negative ids (empty queue heads) and the
    route salts of many seeds among them."""
    rng = np.random.default_rng(0)
    n = 400_000
    ids = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    ids[:1000] = np.arange(-500, 500)
    eng = sched.DispatchEngine(generate_instance(seed=0), 5, device="cpu")
    salts = np.array([eng._route_salt(s) for s in range(2000)], np.int64)
    salt = np.concatenate([salts, rng.integers(0, 2 ** 32, n - 2000)])
    want = np.asarray(jax.jit(jax_engine._route_u01)(
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(salt.astype(np.uint32))))
    got = engine.route_u01(torch.as_tensor(ids), torch.as_tensor(salt))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    jeng = jsched.DispatchEngine(jax_generate_instance(seed=0), 5)
    assert [eng._route_salt(s) for s in range(50)] == \
        [jeng._route_salt(s) for s in range(50)]


def test_lexsort_order_keeps_index_order_on_ties():
    """``jnp.lexsort((arange, load, -age, -vhat))`` with most v̂ 0 (so −v̂
    is −0.0 for unpulled edges, equal to 0.0) and many equal loads and
    ages: the port's successive stable sorts give the same order."""
    rng = np.random.default_rng(1)
    B, E = 64, 33
    vhat = np.where(rng.random((B, E)) < 0.7, 0.0,
                    rng.integers(0, 4, (B, E)) / 4).astype(np.float32)
    age = rng.integers(0, 3, (B, E)).astype(np.int32)
    load = rng.integers(0, 3, (B, E)).astype(np.int32)
    want = np.stack([np.asarray(jnp.lexsort((
        jnp.arange(E), jnp.asarray(load[b]),
        -jnp.asarray(age[b]).astype(jnp.float32), -jnp.asarray(vhat[b]))))
        for b in range(B)])
    assert (np.signbit(-vhat) & (vhat == 0)).any()
    got = engine.lexsort_order(
        [torch.as_tensor(load), torch.as_tensor(age), torch.as_tensor(vhat)],
        [False, True, True])
    np.testing.assert_array_equal(got.numpy(), want)


def test_valuations_round_as_xla_fuses_them(insts):
    """The slot's z̃ = clip(μ·speed − cost + σ·noise): the JAX engine's
    jitted ``_slot_account`` rounds each multiply-add once (XLA fuses
    both on the CPU).  With every edge dispatched once from zero sums its
    ``sumz`` is z̃ itself; the port's (two ``addcmul``s over the horizon
    before the loop) equals it on 300 slots × E edges at speeds uniform
    in [0.3, 1], while a multiply then an add (numpy's rounding, which
    the failure path keeps) differs in many entries."""
    jinst, inst = insts
    S, E, R = 300, inst.n_edges, inst.n_servers
    rng = np.random.default_rng(2)
    speed = rng.uniform(0.3, 1.0, (S, R)).astype(np.float32)
    noise = rng.normal(0.0, 1.0, (S, E)).astype(np.float32)
    jeng = jsched.DispatchEngine(jinst, 10)
    acc = jax.jit(jeng._slot_account)
    ones = jnp.ones((1, E), jnp.int32)
    want = np.stack([np.asarray(acc(
        jnp.zeros((1, E), jnp.int32), jnp.zeros((1, E), jnp.float32),
        ones, jnp.ones((1, E), bool), jnp.asarray(noise[t]),
        jnp.asarray(speed[t]))[1])[0] for t in range(S)])
    eng = sched.DispatchEngine(inst, S, device="cpu",
                               speed_fn=lambda t: speed[t])
    streams = (np.zeros((S, inst.n_ports), bool), noise,
               np.zeros((S, E), np.float32))
    got = eng._inputs([streams], [0])["z"][0].numpy()
    np.testing.assert_array_equal(got, want)
    server = inst.edges[:, 1]
    twice = np.clip(inst.mu * speed[:, server] - inst.cost
                    + inst.sigma * noise, 0.0, 1.0)
    assert (twice != want).sum() > 100


@pytest.mark.parametrize("kind", ["hswf", "lcf", "lwtf"])
def test_greedy_scores_round_as_xla_fuses_them(insts, monkeypatch, kind):
    """Each greedy variant's score (tie-break term fused into the add, as
    XLA does inside the JAX engine's jitted ``_variant_x``): both engines'
    packers swapped for one that returns the score, bitwise on 500
    slots."""
    jinst, inst = insts
    E, P, S = inst.n_edges, inst.n_ports, 500
    rng = np.random.default_rng(3)
    vhat = (rng.random((S, E)) * (rng.random((S, E)) < 0.6)).astype(
        np.float32)
    tb = rng.random((S, E)).astype(np.float32)
    age = rng.integers(0, 800, (S, P)).astype(np.int32)
    monkeypatch.setattr(jax_engine, "greedy_pack", lambda s, e, A, c: s)
    monkeypatch.setattr(engine, "greedy_pack", lambda s, e, A, c: s)
    jcfg = jsched.EngineConfig(variants=(jsched.VariantSpec("g", kind=kind),))
    jeng = jsched.DispatchEngine(jinst, 10, jcfg)
    fn = jax.jit(lambda e, vh, a, t, t0: jeng._variant_x(0, e, vh, None, a,
                                                         t, t0))
    elig = jnp.ones(E, bool)
    want = np.stack([np.asarray(fn(elig, jnp.asarray(vhat[i]),
                                   jnp.asarray(age[i]), jnp.asarray(tb[i]),
                                   jnp.int32(i))) for i in range(S)])
    eng = sched.DispatchEngine(inst, 10, sched.EngineConfig(
        variants=(sched.VariantSpec("g", kind=kind),)), device="cpu")
    got = eng._variant_x(eng._consts(), 0, torch.ones((S, E), dtype=bool),
                         torch.as_tensor(vhat), None, torch.as_tensor(age),
                         torch.as_tensor(tb), 0)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", scenario_names())
def test_stream_equals_lockstep_for_every_regime(insts, regime):
    """Every registered regime (unrolled by the port from the seed), A/B
    with ESDP and the challenger: lockstep replays stream bitwise."""
    eng = sched.DispatchEngine(insts[1], 40, CFG["ab"], scenario=regime,
                               seed=4, device="cpu")
    stream = eng.run(mode="stream")
    assert_same(stream, eng.run(mode="lockstep"))
    assert_conserves(stream)


def test_cluster_sim_engine_and_solve_cache(insts, sch):
    """``ClusterSim(solve_cache=)`` hands the cache to its CachedSolver;
    ``ClusterSim.engine()`` shares the sim's instance, schedule, seed and
    device, and a CachedSolver variant without a scope takes the
    variant's name, its ``stats_dict()`` read through ``solve_stats``."""
    inst = insts[1]
    cache = SolveCache()
    sim = sched.ClusterSim(inst, T, seed=3, device="cpu", schedule=sch,
                           incremental="cache", solve_cache=cache)
    assert sim.solver.cache is cache
    sim.run("esdp")
    assert cache.stats.misses > 0
    assert sim.solver.stats_dict() == cache.stats.as_dict()
    scoped = CachedSolver(get_solver("cuda"), scope="mine")
    assert scoped.stats_dict()["scope"] == "mine"

    cached = CachedSolver(get_solver("cuda"))
    cfg = sched.EngineConfig(variants=(sched.VariantSpec("esdp-cached",
                                                         solver=cached),))
    eng = sim.engine(cfg)
    assert isinstance(eng, sched.DispatchEngine)
    assert (eng.inst, eng.T, eng.seed, eng.device) == (inst, T, 3,
                                                        sim.device)
    assert torch.equal(eng.xi_tab, sim.xi_tab)
    assert cached.scope == "esdp-cached"
    out = eng.run(mode="lockstep")
    stats = out.solve_stats["esdp-cached"]
    assert stats == cached.stats_dict() and stats["scope"] == "esdp-cached"
    assert stats["hits"] + stats["misses"] == T
    direct = sched.DispatchEngine(inst, T, sched.EngineConfig(), seed=3,
                                  device="cpu", schedule=sch).run()
    np.testing.assert_array_equal(out.x, direct.x)


def test_engine_variant_records_match_jax(runs):
    """The port's records of an output equal the JAX function's on the
    same output, and the other way round."""
    want, got, _ = runs[0]["ab"]
    for out in (want, got):
        assert engine_variant_records(out, "s", "p") == jax_records(
            out, "s", "p")
    recs = engine_variant_records(got)
    assert [r["variant"] for r in recs] == ["esdp", "challenger"]
    assert sum(r["dispatched"] for r in recs) == \
        got.ledger["total_dispatched"]


def test_validation_messages_match_jax(insts):
    bad = [dict(backpressure="bogus"), dict(queue_capacity=0),
           dict(variants=()),
           dict(variants=("a", "a"))]
    for kw in bad:
        msgs = []
        for m in (jsched, sched):
            if kw.get("variants") == ("a", "a"):
                kw = dict(variants=(m.VariantSpec("a"), m.VariantSpec("a")))
            with pytest.raises(ValueError) as err:
                m.EngineConfig(**kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    for kw in (dict(kind="bogus"), dict(weight=0.0)):
        msgs = []
        for m in (jsched, sched):
            with pytest.raises(ValueError) as err:
                m.VariantSpec("x", **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_refusals(insts):
    inst = insts[1]
    eng = sched.DispatchEngine(inst, 10, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        eng.run(mode="bogus")
    with pytest.raises(ValueError, match="not both"):
        sched.DispatchEngine(inst, 10, scenario="iid", device="cpu",
                             speed_fn=lambda t: np.ones(inst.n_servers))
    failing = sched.DispatchEngine(inst, 10, device="cpu",
                                   failures=sched.FailureModel(p_crash=0.1))
    with pytest.raises(ValueError, match="lockstep"):
        failing.run(mode="stream")
    with pytest.raises(NotImplementedError, match="single-seed"):
        failing.run_batch([0, 1])


def test_device_none_means_the_card(insts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sched.DispatchEngine(insts[1], 10)
