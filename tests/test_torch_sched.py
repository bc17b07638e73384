"""The port's cluster dispatcher (``repro_torch.sched``) against the JAX
package's (``repro.sched``), on the CPU.

The rate model and the instance builder are numpy and must be bit-equal.
``ClusterSim.run`` is held against the JAX ``ClusterSim.run`` on the same
instance, seed and schedules: the arrival and noise streams are numpy-
seeded in both, and the per-slot ξ(t), g(t) of ESDP's statistics are
injected as the JAX loop evaluates them (XLA's and PyTorch's float32
``log`` differ by an ulp at some t).  The JAX side runs its ``reference``
backend; the port its ``"cuda"`` backend, whose kernel wrappers take
their plain versions on CPU tensors.  Dispatch shares (derived from x)
and the solve, failure and malleable records must be equal; ``sw`` and
``regret`` within rtol 1e-6 (both packages sum the same numpy arrays, so
they are expected bit-equal).
"""
import contextlib
import dataclasses
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.core import stats as jax_stats
from repro.core.solvers import get_solver as jax_get_solver
from repro.sched.engine import feasible_ports as jax_feasible_ports
from repro_torch import sched
from repro_torch.configs import SHAPES, shape_applicable
from repro_torch.launch import dispatch
from repro_torch.sched.engine import feasible_ports
from test_torch_incremental import jax_warm_stats

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_REF = jax_get_solver("reference")
TOL = dict(rtol=1e-6, atol=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleets():
    """(slices, jobs, slice_speed) of the fleets the tests use, by name:
    ``tests/test_sched.py``'s cluster (a chronic straggler),
    ``tests/test_robustness.py``'s, the malleable one of
    ``tests/test_scenario_contracts.py`` and ``examples/
    dispatch_cluster.py``'s, each built with the module ``m``."""
    def build(m):
        S, J = m.Slice, m.JobType
        small = [S("pod-a", "v5e", 256, 32, 4), S("pod-b", "v5e", 256, 32, 4),
                 S("pod-c", "v5p", 256, 32, 4)]
        return {
            "cluster": ([S("pod-a", "v5e", 256, 32, 4),
                         S("pod-b", "v5e", 256, 32, 4),
                         S("pod-c", "v5e", 256, 32, 4),
                         S("pod-d", "v5p", 256, 32, 4)],
                        [J("qwen-train", "qwen2.5-32b", "train_4k",
                           ("v5e", "v5p"), 256, 32, 4, value_rate=1.0),
                         J("mamba-train", "mamba2-2.7b", "train_4k", ("v5e",),
                           256, 32, 4, value_rate=0.6),
                         J("ds-decode", "deepseek-v3-671b", "decode_32k",
                           ("v5e", "v5p"), 256, 32, 4, value_rate=1.4),
                         J("whisper", "whisper-medium", "train_4k", ("v5p",),
                           256, 32, 4, value_rate=0.5)],
                        {"pod-b": 0.55}),
            "robustness": (small,
                           [J("train", "qwen2.5-32b", "train_4k",
                              ("v5e", "v5p"), 256, 32, 4, value_rate=1.0),
                            J("decode", "deepseek-v3-671b", "decode_32k",
                              ("v5e",), 256, 32, 4, value_rate=1.2)], None),
            "malleable": (small,
                          [J("train", "qwen2.5-32b", "train_4k",
                             ("v5e", "v5p"), 256, 32, 4, value_rate=1.0,
                             malleable=True, min_chips=128, min_hosts=16,
                             min_ici_domains=2),
                           J("decode", "deepseek-v3-671b", "decode_32k",
                             ("v5e",), 256, 32, 4, value_rate=1.2,
                             malleable=True, min_chips=64, min_hosts=8,
                             min_ici_domains=1)], None),
            "dispatch": ([S("pod-a", "v5e", 256, 32, 4),
                          S("pod-b", "v5e", 256, 32, 4),
                          S("pod-c", "v5e", 512, 64, 8),
                          S("pod-d", "v5p", 256, 32, 4)],
                         [J("qwen2.5:train", "qwen2.5-32b", "train_4k",
                            ("v5e", "v5p"), 256, 32, 4, value_rate=1.0),
                          J("deepseek:decode", "deepseek-v3-671b",
                            "decode_32k", ("v5e", "v5p"), 256, 32, 4,
                            value_rate=1.5),
                          J("mamba2:long", "mamba2-2.7b", "long_500k",
                            ("v5e",), 256, 32, 4, value_rate=0.8),
                          J("gemma3:prefill", "gemma3-27b", "prefill_32k",
                            ("v5e",), 256, 32, 4, value_rate=0.9),
                          J("whisper:train", "whisper-medium", "train_4k",
                            ("v5p",), 256, 32, 4, value_rate=0.4)], None),
        }
    return build(jsched), build(sched)


def _instances(name):
    jf, tf = _fleets()
    js, jj, speed = jf[name]
    ts, tj, _ = tf[name]
    jr = jsched.rate_matrix(jj, js, slice_speed=speed)
    tr = sched.rate_matrix(tj, ts, slice_speed=speed)
    return (jr, jsched.build_instance(js, jj, jr, seed=0),
            tr, sched.build_instance(ts, tj, tr, seed=0))


def _jax_schedule(T, m):
    """ξ(t), g(t) as the JAX lockstep loop evaluates them, one eager call
    per slot (``stats.scale_statistics`` at ``jnp.float32(t)``,
    g = ``g_logt_only``)."""
    xi = [np.asarray(jax_stats.xi_of(jnp.float32(t), m))
          for t in range(1, T + 1)]
    g = [np.asarray(jax_stats.g_logt_only(jnp.float32(t), m))
         for t in range(1, T + 1)]
    return np.stack(xi), np.stack(g)


# ---------------------------------------------------------------------------
# rate model, instance builder, admission preflight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cluster", "robustness", "malleable",
                                  "dispatch"])
def test_rate_matrix_and_build_instance_bit_equal(name):
    jr, (jinst, jrate), tr, (inst, rate) = _instances(name)
    np.testing.assert_array_equal(tr, jr)
    assert tr.dtype == jr.dtype
    np.testing.assert_array_equal(rate, jrate)
    for f in dataclasses.fields(jinst):
        a, b = getattr(inst, f.name), getattr(jinst, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
    assert inst.m == jinst.m
    np.testing.assert_array_equal(feasible_ports(inst),
                                  jax_feasible_ports(jinst))
    if name == "dispatch":  # the dispatch path's shape (PERF.md §4)
        assert (inst.n_edges, tuple(inst.c), inst.m) == (15, (5, 5, 5), 8)


def test_roofline_rate_bit_equal_for_every_arch_and_shape():
    for arch in ("qwen2.5-32b", "gemma3-27b", "gemma-7b", "qwen1.5-32b",
                 "zamba2-7b", "dbrx-132b", "deepseek-v3-671b",
                 "whisper-medium", "mamba2-2.7b", "qwen2-vl-72b", "other"):
        for shape in JAX_SHAPES:
            assert sched.roofline_rate(arch, shape) == \
                jsched.roofline_rate(arch, shape), (arch, shape)


def test_shapes_and_shape_applicable_equal():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    from repro_torch.configs import get_config
    cfg, jcfg = get_config("zamba2-7b"), jax_get_config("zamba2-7b")
    for name in SHAPES:
        assert shape_applicable(cfg, SHAPES[name]) == \
            jax_shape_applicable(jcfg, JAX_SHAPES[name])
    dense = cfg.replace(family="dense", name="dense-x")
    jdense = dataclasses.replace(jcfg, family="dense", name="dense-x")
    assert shape_applicable(dense, SHAPES["long_500k"]) == \
        jax_shape_applicable(jdense, JAX_SHAPES["long_500k"])
    assert not shape_applicable(dense, SHAPES["long_500k"])[0]


def test_validate_jobs_refuses_the_same_inputs():
    def jobs(m):
        J = m.JobType
        return [J("ok", "gemma-7b", "train_4k", ("v5e",), 256, 32, 4, 1.0),
                J("wrong-accel", "gemma-7b", "train_4k", ("trn2",), 256, 32,
                  4, 1.0),
                J("too-big", "gemma-7b", "train_4k", ("v5e", "v5p"), 1024,
                  32, 4, 1.0),
                J("too-many-hosts", "gemma-7b", "train_4k", ("v5p",), 256,
                  64, 4, 1.0)]

    def slices(m):
        S = m.Slice
        return [S("a", "v5e", 256, 32, 4), S("b", "v5p", 512, 32, 8)]

    got = sched.validate_jobs(slices(sched), jobs(sched))
    assert got == jsched.validate_jobs(slices(jsched), jobs(jsched))
    assert set(got) == {"wrong-accel", "too-big", "too-many-hosts"}


# ---------------------------------------------------------------------------
# ClusterSim.run against the JAX ClusterSim.run
# ---------------------------------------------------------------------------

def _assert_same(got, want):
    np.testing.assert_array_equal(got.dispatch_share, want.dispatch_share)
    np.testing.assert_allclose(got.sw, want.sw, **TOL)
    np.testing.assert_allclose(got.regret, want.regret, **TOL)
    assert got.asw == pytest.approx(want.asw, rel=1e-6)
    for field in ("solve_stats", "failures", "malleable"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        assert set(a) == set(b), field
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a[k].dtype == b[k].dtype, k
            else:
                assert a[k] == b[k], (field, k)


def _pair(name, T, seed, policy="esdp", tiebreak=1e-4, jax_kw=None, **kw):
    """(port, JAX) outputs of ``ClusterSim(...).run(policy, tiebreak)``."""
    _, (jinst, _), _, (inst, _) = _instances(name)
    want = jsched.ClusterSim(jinst, T, seed=seed, solver="reference",
                             **(jax_kw if jax_kw is not None else kw)).run(
        policy, tiebreak)
    got = sched.ClusterSim(inst, T, seed=seed, device="cpu", solver="cuda",
                           schedule=_jax_schedule(T, inst.m), **kw).run(
        policy, tiebreak)
    return got, want


@pytest.mark.parametrize("policy", ["esdp", "hswf", "lcf", "lwtf"])
def test_cluster_sim_policies_match_jax(policy):
    got, want = _pair("cluster", 150, 3, policy)
    _assert_same(got, want)
    assert got.x.shape == (150, 12) and got.x.sum() > 0
    np.testing.assert_array_equal(
        got.x.sum(axis=1) > 0, got.dispatch_share.sum(axis=1) > 0)


def test_cluster_sim_brownout_matches_jax():
    """A straggler brownout (``speed_fn``) on pod-a after slot 50."""
    def speed(t):
        s = np.ones(4, np.float32)
        if t > 50:
            s[0] = 0.3
        return s
    got, want = _pair("cluster", 150, 1, speed_fn=speed)
    _assert_same(got, want)


def test_cluster_sim_slice_loss_matches_jax():
    """pod-b dead in slots [40, 90): no share while dead, traffic after."""
    def alive(t):
        a = np.ones(4, bool)
        if 40 <= t < 90:
            a[1] = False
        return a
    got, want = _pair("cluster", 150, 2, alive_fn=alive)
    _assert_same(got, want)
    assert got.dispatch_share[40:90, 1].sum() == 0.0
    assert got.dispatch_share[90:, 1].sum() > 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_sim_failures_match_jax_and_conserve(seed):
    """Crashes with 2-way redundancy, checkpoints and detection, racks,
    on the dispatch fleet (where ESDP leaves room for replicas): the
    ledger equal to JAX's array for array, and conserving — dispatched =
    completed + lost + salvaged per slot, sw = completed + salvaged −
    checkpoint costs."""
    model = dict(p_crash=0.15, n_racks=2, p_rack=0.05, redundancy=2,
                 checkpoints=2, checkpoint_cost=0.003, detect=True)
    got, want = _pair("dispatch", 100, seed,
                      failures=sched.FailureModel(**model),
                      jax_kw=dict(failures=jsched.FailureModel(**model)))
    _assert_same(got, want)
    led = got.failures
    np.testing.assert_allclose(
        led["dispatched"], led["completed"] + led["lost"] + led["salvaged"],
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.sw, led["completed"] + led["salvaged"] - led["ckpt_cost"],
        rtol=1e-5, atol=1e-5)
    assert led["total_dispatched"] > 0 and led["restarts"] > 0
    assert led["replicas"].sum() > 0


@pytest.mark.parametrize("preempt", [False, True])
def test_cluster_sim_malleable_matches_jax(preempt):
    """Malleable jobs: the work-units ledger and its counts equal to
    JAX's, conserving (dispatched = done + lost + residual)."""
    got, want = _pair(
        "malleable", 120, 2,
        malleable=sched.MalleableModel(duration=4, preempt=preempt),
        jax_kw=dict(malleable=jsched.MalleableModel(duration=4,
                                                    preempt=preempt)))
    _assert_same(got, want)
    mal = got.malleable
    assert mal["total_dispatched"] == pytest.approx(
        mal["total_done"] + mal["total_lost"] + mal["residual_units"],
        abs=1e-9)
    assert mal["transitions"] > 0


class _Recording:
    """A JAX solver-shaped wrapper that records each slot's inputs (its
    host loop hands it concrete arrays)."""

    name, accepts_batch = "recording", False

    def __init__(self):
        self.inputs = []
        self._solve = None

    def __call__(self, u, s, tables, s_cap, lim, allowed=None, u_max=None):
        self.inputs.append((np.asarray(u), np.asarray(s),
                            np.asarray(allowed, bool)))
        if self._solve is None:
            self._solve = jax.jit(lambda u, s, lim, al: JAX_REF(
                u, s, tables, s_cap, lim, allowed=al, u_max=u_max))
        return self._solve(jnp.asarray(u), jnp.asarray(s), jnp.int32(lim),
                           jnp.asarray(allowed))


@pytest.mark.parametrize("mode", ["cache", "warm"])
def test_cluster_sim_incremental_modes_match_jax(mode):
    """``incremental="cache"``: the JAX run with the same mode, counters
    included.  ``incremental="warm"``: the JAX cold run's outputs (the JAX
    warm driver is Pallas-only), and its counters equal to the JAX warm
    driver's over the same solve sequence, derived from the JAX
    delta-mask helpers."""
    T, seed = 250, 7  # long enough for repeated statistics (17 hits)
    _, (jinst, _), _, (inst, _) = _instances("cluster")
    got = sched.ClusterSim(inst, T, seed=seed, device="cpu", solver="cuda",
                           incremental=mode, warm_checkpoint_every=5,
                           schedule=_jax_schedule(T, inst.m)).run("esdp")
    if mode == "cache":
        want = jsched.ClusterSim(jinst, T, seed=seed, solver="reference",
                                 incremental="cache").run("esdp")
        _assert_same(got, want)
        assert got.solve_stats["hits"] > 0
        return
    rec = _Recording()
    want = jsched.ClusterSim(jinst, T, seed=seed, solver=rec).run("esdp")
    _assert_same(dataclasses.replace(got, solve_stats=None), want)
    assert got.solve_stats == jax_warm_stats(rec.inputs, inst.n_edges, 5)
    assert got.solve_stats["segments_skipped"] > 0


def test_run_batch_equals_run_per_seed_and_jax():
    """``run_batch`` over 3 seeds: one batched solve a slot, each seed's
    output equal to its own ``run()`` (x included) and to the JAX fleet's;
    with ``incremental="cache"`` the fleet-scoped counters too."""
    T, seeds = 100, (5, 6, 7)
    _, (jinst, _), _, (inst, _) = _instances("cluster")
    sch = _jax_schedule(T, inst.m)
    for pol in ("esdp", "lwtf"):
        outs = sched.ClusterSim(inst, T, device="cpu", solver="cuda",
                                schedule=sch).run_batch(seeds, pol)
        want = jsched.ClusterSim(jinst, T, solver="reference").run_batch(
            seeds, pol)
        for s, o, w in zip(seeds, outs, want):
            one = sched.ClusterSim(inst, T, seed=s, device="cpu",
                                   solver="cuda", schedule=sch).run(pol)
            np.testing.assert_array_equal(o.x, one.x)
            np.testing.assert_array_equal(o.sw, one.sw)
            np.testing.assert_array_equal(o.regret, one.regret)
            _assert_same(o, w)
    sim = sched.ClusterSim(inst, T, device="cpu", incremental="cache",
                           schedule=sch)
    outs = sim.run_batch(seeds)
    want = jsched.ClusterSim(jinst, T, solver="reference",
                             incremental="cache").run_batch(seeds)
    for o, w in zip(outs, want):
        _assert_same(o, w)
        assert o.solve_stats["scope"] == "fleet"
    outs[0].solve_stats["hits"] = -1  # each output holds its own copy
    assert outs[1].solve_stats["hits"] != -1


@pytest.mark.parametrize("regime,fleet", [
    ("power_coupled", "dispatch"), ("server_failures", "dispatch"),
    ("mmpp_arrivals", "cluster")])
def test_cluster_sim_scenario_matches_jax(regime, fleet):
    """``ClusterSim(scenario=...)``: the JAX sim unrolls the regime from its
    seed; the port replays that unrolled trace (``scenario=(arr_scale,
    speed, alive)``) — the same outputs.  ``server_failures`` runs
    failure-aware (crashes at the trace's up→down transitions) and
    conserves its ledger.  The port's own unroll (``scenario=`` the name)
    runs too."""
    from repro.experiments import get_scenario as jax_get_scenario
    from repro.experiments import unroll_scenario as jax_unroll
    _, (jinst, _), _, (inst, _) = _instances(fleet)
    T, seed = 100, 3
    jscn = jax_get_scenario(regime)
    kw, jkw = {}, {}
    if regime == "server_failures":
        kw = dict(failures=sched.FailureModel(redundancy=2))
        jkw = dict(failures=jsched.FailureModel(redundancy=2))
    want = jsched.ClusterSim(jinst, T, seed=seed, solver="reference",
                             scenario=jscn, **jkw).run("esdp")
    trace = jax_unroll(jscn, T, inst.n_servers, seed=seed,
                       n_ports=inst.n_ports)
    got = sched.ClusterSim(inst, T, seed=seed, device="cpu", solver="cuda",
                           schedule=_jax_schedule(T, inst.m), scenario=trace,
                           **kw).run("esdp")
    _assert_same(got, want)
    if regime == "server_failures":
        led = got.failures
        assert led["total_lost"] > 0 or led["replicas"].sum() > 0
        np.testing.assert_allclose(
            led["dispatched"],
            led["completed"] + led["lost"] + led["salvaged"],
            rtol=1e-6, atol=1e-6)
    own = sched.ClusterSim(inst, T, seed=seed, device="cpu", scenario=regime,
                           **kw)
    from repro_torch.experiments import get_scenario, unroll_scenario
    arr, speed, alive = unroll_scenario(get_scenario(regime), T,
                                        inst.n_servers, seed,
                                        n_ports=inst.n_ports, device="cpu")
    np.testing.assert_array_equal(own.arr_scale, arr)
    assert all(np.array_equal(own.speed_fn(t), speed[t])
               and np.array_equal(own.alive_fn(t), alive[t])
               for t in range(T))
    assert np.isfinite(own.run("esdp").sw).all()


def test_refusals():
    """The JAX package's own refusals; ``engine()`` builds the streaming
    engine on the sim (``tests/test_torch_engine.py`` runs it)."""
    _, _, _, (inst, _) = _instances("cluster")
    with pytest.raises(ValueError, match="not both"):
        sched.ClusterSim(inst, 10, device="cpu", scenario="iid",
                         speed_fn=lambda t: np.ones(inst.n_servers))
    with pytest.raises(ValueError, match="incremental"):
        sched.ClusterSim(inst, 10, device="cpu", fallback=True,
                         incremental="cache")
    with pytest.raises(ValueError, match="registered scenarios"):
        sched.ClusterSim(inst, 10, device="cpu", scenario="bogus")
    with pytest.raises(ValueError, match="speed"):
        sched.ClusterSim(inst, 10, device="cpu",
                         scenario=(np.ones((10, 1)), np.ones((9, 4)),
                                   np.ones((10, 4), bool)))
    assert isinstance(sched.ClusterSim(inst, 10, device="cpu").engine(),
                      sched.DispatchEngine)
    with pytest.raises(ValueError, match="incremental mode"):
        sched.ClusterSim(inst, 10, device="cpu", incremental="bogus")
    with pytest.raises(ValueError, match="carried-plane"):
        sched.ClusterSim(inst, 10, device="cpu", solver="reference",
                         incremental="warm")
    with pytest.raises(ValueError, match="mutually exclusive"):
        sched.ClusterSim(inst, 10, device="cpu",
                         failures=sched.FailureModel(),
                         malleable=sched.MalleableModel())
    with pytest.raises(ValueError, match="unknown policy"):
        sched.ClusterSim(inst, 5, device="cpu").run("bogus")
    for kw in (dict(incremental="warm", solver="cuda"),
               dict(failures=sched.FailureModel(p_crash=0.1)),
               dict(malleable=sched.MalleableModel())):
        with pytest.raises(NotImplementedError):
            sched.ClusterSim(inst, 5, device="cpu", **kw).run_batch((0, 1))
    with pytest.raises(ValueError, match="redundancy"):
        sched.FailureModel(redundancy=0)
    with pytest.raises(ValueError, match="duration"):
        sched.MalleableModel(duration=0)


def test_device_none_means_the_card(monkeypatch):
    _, _, _, (inst, _) = _instances("cluster")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sched.ClusterSim(inst, 10)


# ---------------------------------------------------------------------------
# the dispatch launcher against examples/dispatch_cluster.py
# ---------------------------------------------------------------------------

def test_launch_dispatch_prints_what_the_jax_example_prints(monkeypatch):
    """``python -m repro_torch.launch.dispatch --device cpu`` on the JAX
    schedule prints the JAX example's lines (``REPRO_DP_SOLVER=
    reference``): ASW and regret of the four policies and pod-b's share.
    On the port's own schedule ξ(t) equals the JAX one at every slot and
    g(t) is at most 1 ulp from it wherever the two differ (how many slots
    differ follows the host's vectorised ``log``); ESDP's decisions do not
    move, so its numbers are the same too."""
    monkeypatch.setenv("REPRO_DP_SOLVER", "reference")
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    import dispatch_cluster
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        dispatch_cluster.main()
    monkeypatch.delenv("REPRO_DP_SOLVER")
    sch = _jax_schedule(800, 8)
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        res = dispatch.main(["--device", "cpu"], schedule=sch)
    assert got.getvalue() == want.getvalue()

    from repro_torch.core import stats
    own = stats.schedule_table(800, 8, stats.delta_default,
                               stats.g_logt_only, "cpu")
    assert (own[0].numpy() != sch[0]).sum() == 0
    g_ulps = np.abs(own[1].numpy().view(np.int32).astype(np.int64)
                    - np.asarray(sch[1], np.float32).view(np.int32))
    assert g_ulps.max() <= 1
    inst = dispatch.dispatch_instance()
    speed = dispatch.brownout(800)
    out = sched.ClusterSim(inst, 800, speed_fn=speed, seed=7,
                           device="cpu").run("esdp", tiebreak=0.0)
    assert (out.asw, float(out.cum_regret[-1])) == res["esdp"]
