"""The port's core modules held against the JAX package on the CPU.

Instances, DP tables, the schedules, scaled statistics, the int32
reference DP, the oracle knapsack and the solver registry of
``repro_torch.core`` against ``repro.core``.  Inputs come from numpy
seeds and reach both packages as numpy arrays.  Integer outputs must be
bit-equal (tolerance 0); each float comparison states its tolerance.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_tables as jax_build_tables
from repro.core import generate_instance as jax_generate_instance
from repro.core import stats as jax_stats
from repro.core.dp import oracle_knapsack as jax_oracle_knapsack
from repro.core.graph import clipped_normal_mean as jax_clipped_normal_mean
from repro.core.solvers import get_solver as jax_get_solver
from repro_torch import resolve_device
from repro_torch.core import (build_tables, generate_instance,
                              instance_from_arrays, oracle_knapsack,
                              solve_budgeted_dp, stats)
from repro_torch.core.dp import NEG, oracle_value
from repro_torch.core.graph import clipped_normal_mean
from repro_torch.core.dp import initial_plane
from repro_torch.core.solvers import SOLVER_ENV_VAR, get_solver

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_REF = jax_get_solver("reference")

INSTANCE_KWARGS = [
    dict(seed=0),  # paper Table 2
    dict(seed=2, c_lo=1, c_hi=4),  # fig-6 sweep point
    dict(seed=3, n_ports=4, n_servers=10, edge_prob=0.3),
    dict(seed=7, n_device_types=2, a_hi=3, c_hi=3, rho=0.5, alpha=0.3),
]

DELTAS = [("fast", jax_stats.delta_fast, stats.delta_fast),
          ("default", jax_stats.delta_default, stats.delta_default),
          ("slow", jax_stats.delta_slow, stats.delta_slow)]
GS = [("default", jax_stats.g_default, stats.g_default),
      ("no_logt", jax_stats.g_no_logt, stats.g_no_logt),
      ("logt_only", jax_stats.g_logt_only, stats.g_logt_only)]


def _ulps(a, b):
    """Distance in float32 units in the last place (same-sign values)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def _jax_schedule(T, m, delta_fn, g_fn):
    """ξ(t), g(t) and log(t+1) as the JAX simulator evaluates them: inside
    a ``lax.scan`` over t = 1..T with t cast to float32."""
    def body(carry, t):
        tf = t.astype(jnp.float32)
        return carry, (jax_stats.xi_of(tf, m, delta_fn), g_fn(tf, m),
                       jnp.log(tf + 1.0))
    _, out = jax.lax.scan(body, 0, jnp.arange(1, T + 1))
    return tuple(np.array(a) for a in out)


# ---------------------------------------------------------------------------
# graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", INSTANCE_KWARGS)
def test_generate_instance_bit_equal(kw):
    """numpy-seeded generator: every field equal, dtype included (tol 0)."""
    want = jax_generate_instance(**kw)
    got = generate_instance(**kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.m == want.m and got.n_edges == want.n_edges


def test_instance_from_arrays_carries_jax_instance():
    want = jax_generate_instance(seed=5)
    got = instance_from_arrays(**dataclasses.asdict(want))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    with pytest.raises(ValueError, match="missing"):
        fields = dataclasses.asdict(want)
        del fields["rho"]
        instance_from_arrays(**fields)


@pytest.mark.parametrize("m,s", [(0.3, 0.2), (-0.4, 0.5), (1.2, 0.1),
                                 (0.5, 0.0)])
def test_clipped_normal_mean_equal(m, s):
    assert clipped_normal_mean(m, s) == jax_clipped_normal_mean(m, s)


@pytest.mark.parametrize("kw", INSTANCE_KWARGS)
def test_build_tables_bit_equal(kw):
    inst = generate_instance(**kw)
    want = jax_build_tables(inst.A, inst.c)
    got = build_tables(inst.A, inst.c)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# stats: the port's own schedule, and scaled statistics on an injected one
# ---------------------------------------------------------------------------

def _jax_scan(fn, T):
    _, out = jax.lax.scan(lambda c, t: (c, fn(t.astype(jnp.float32))), 0,
                          jnp.arange(1, T + 1))
    return np.array(out)


@pytest.mark.parametrize("dname,jd,td", DELTAS)
def test_own_schedule_xi_exact_delta_within_two_ulps(dname, jd, td):
    """ξ(t) must match exactly over t ≤ 5000.  XLA's and PyTorch's float32
    ``log`` differ by up to 1 ulp (checked below), and 1/(log(·)+1)
    can turn that into 2 ulps of δ: δ within 2 ulps."""
    T, m = 5000, 17
    xi, _, _ = _jax_schedule(T, m, jd, jax_stats.g_logt_only)
    got_xi, _, _ = stats.schedule_table(T, m, td, stats.g_logt_only, "cpu")
    np.testing.assert_array_equal(got_xi.numpy(), xi)
    t = torch.arange(1, T + 1).to(torch.float32)
    assert _ulps(td(t).numpy(), _jax_scan(jd, T)).max() <= 2


@pytest.mark.parametrize("gname,jg,tg", GS)
def test_own_schedule_log_within_one_ulp_g_within_two(gname, jg, tg):
    """log(t+1) within 1 ulp of XLA's; g, a sum over logs, within 2."""
    T, m = 5000, 17
    _, g, log1p = _jax_schedule(T, m, jax_stats.delta_default, jg)
    _, got_g, got_log = stats.schedule_table(T, m, stats.delta_default, tg,
                                             "cpu")
    assert _ulps(got_log.numpy(), log1p).max() <= 1
    assert _ulps(got_g.numpy(), g).max() <= 2


@pytest.mark.parametrize("gname,jg,tg", GS)
def test_scale_statistics_bit_equal_on_injected_schedule(gname, jg, tg):
    """Υ̂, Σ̂² and s_limit bit-equal (tol 0) when both packages read ξ(t) and
    g(t) from the same scan-evaluated schedule, over 4000 slots with
    random statistics (unexplored channels included)."""
    T, E = 4000, 33
    inst = generate_instance(seed=0)
    m = inst.m
    rng = np.random.default_rng(11)
    vhat = rng.random((T, E)).astype(np.float32)
    n = rng.integers(0, 40, (T, E)).astype(np.int32)

    def body(carry, inp):
        t, vh, nn = inp
        ups, sig, _, slim = jax_stats.scale_statistics(
            vh, nn, t.astype(jnp.float32), m, g_fn=jg)
        return carry, (ups, sig, slim)

    _, (ups, sig, slim) = jax.lax.scan(
        body, 0, (jnp.arange(1, T + 1), jnp.asarray(vhat), jnp.asarray(n)))
    xi, g, _ = _jax_schedule(T, m, jax_stats.delta_default, jg)
    got = stats.scale_statistics(torch.from_numpy(vhat), torch.from_numpy(n),
                                 torch.from_numpy(xi)[:, None],
                                 torch.from_numpy(g)[:, None], m)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ups))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(sig))
    np.testing.assert_array_equal(got[2][:, 0].numpy(), np.asarray(slim))


@pytest.mark.parametrize("dname,jd,td", DELTAS)
@pytest.mark.parametrize("m", [1, 4, 17, 60])
def test_host_sizing_helpers_equal(dname, jd, td, m):
    for T in (1, 2, 300, 2000, 10 ** 5, 2 ** 24 + 3, 10 ** 9):
        assert stats.s_cap_for_horizon(T, m, td) == \
            jax_stats.s_cap_for_horizon(T, m, jd)
        assert stats.u_max_for_horizon(T, m, td) == \
            jax_stats.u_max_for_horizon(T, m, jd)
    for s_cap in (m, 5 * m, 919, 4096, 10 ** 7):
        assert stats.horizon_for_s_cap(s_cap, m, td) == \
            jax_stats.horizon_for_s_cap(s_cap, m, jd)


def test_custom_delta_sizing_runs_in_float64():
    """A δ outside the registry is evaluated on a float64 tensor; a copy of
    the default schedule must size exactly like the registered one."""
    def custom(t):
        return 1.0 / (torch.log(torch.log(t + 1.0) + 1.0) + 1.0)

    for T in (7, 2000, 2 ** 24 + 1, 10 ** 11):
        assert stats.s_cap_for_horizon(T, 17, custom) == \
            stats.s_cap_for_horizon(T, 17, stats.delta_default)
    assert stats.horizon_for_s_cap(4096, 60, custom) == \
        stats.horizon_for_s_cap(4096, 60, stats.delta_default)


# ---------------------------------------------------------------------------
# the int32 reference DP and the oracle
# ---------------------------------------------------------------------------

def _rand_problem(rng, E, K, c_hi=3, u_hi=5, sig_lo=1, sig_hi=5000):
    A = rng.integers(1, 3, size=(K, E))
    c = rng.integers(1, c_hi + 1, size=K)
    A = np.minimum(A, c[:, None])
    ups = rng.integers(0, u_hi + 1, size=E).astype(np.int32)
    sig = rng.integers(sig_lo, sig_hi + 1, size=E).astype(np.int32)
    return A, c, ups, sig


def _jax_solve(ups, sig, A, c, s_cap, s_limit, allowed):
    x, info = JAX_REF(jnp.asarray(ups), jnp.asarray(sig),
                      jax_build_tables(A, c), s_cap, jnp.int32(s_limit),
                      None if allowed is None else jnp.asarray(allowed))
    return (np.asarray(x), int(info["s_star"]),
            np.asarray(info["value_row"]))


def _enumerate_row(ups, sig, A, c, s_cap, allowed=None):
    """Ground truth: max Σ̂²ᵀx over all 2^E feasible subsets with Υ̂ᵀx ≥ s,
    for every s ≤ s_cap; NEG where no subset reaches s."""
    E = len(ups)
    bits = ((np.arange(2 ** E)[:, None] >> np.arange(E)[None, :]) & 1)
    if allowed is not None:
        bits = bits[(bits <= np.asarray(allowed, np.int64)).all(axis=1)]
    bits = bits[(bits @ np.asarray(A, np.int64).T
                 <= np.asarray(c, np.int64)).all(axis=1)]
    u = bits @ np.asarray(ups, np.int64)
    v = bits @ np.asarray(sig, np.int64)
    row = np.full(s_cap + 1, NEG, np.int64)
    for uu, vv in zip(u, v):
        hi = min(int(uu), s_cap)
        row[:hi + 1] = np.maximum(row[:hi + 1], vv)
    return row


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("large", [False, True], ids=["small", "2^24-2^29"])
def test_reference_solve_bit_equal_to_jax_reference(seed, large):
    """x, s* and the NEG-normalized value row bit-equal (tol 0) to the JAX
    int32 reference, with and without masks; ``large`` puts DP sums in
    [2²⁴, 2²⁹), where only int32 solvers are exact."""
    rng = np.random.default_rng(100 + seed)
    E, K = int(rng.integers(4, 12)), int(rng.integers(1, 4))
    A, c, ups, sig = _rand_problem(
        rng, E, K, sig_lo=2 ** 22 if large else 1,
        sig_hi=2 ** 25 if large else 5000)
    allowed = rng.random(E) < 0.7 if seed % 2 else None
    s_cap = int(ups.sum())
    s_limit = int(rng.integers(s_cap // 2, s_cap + 1))
    want = _jax_solve(ups, sig, A, c, s_cap, s_limit, allowed)
    solver = get_solver("reference")
    x, info = solver(torch.from_numpy(ups), torch.from_numpy(sig),
                     build_tables(A, c), s_cap, s_limit,
                     None if allowed is None else torch.from_numpy(allowed))
    np.testing.assert_array_equal(x.numpy(), want[0])
    assert int(info["s_star"]) == want[1]
    np.testing.assert_array_equal(info["value_row"].numpy(), want[2])
    if large:
        assert info["value_row"].max() >= 2 ** 24


@pytest.mark.parametrize("seed", range(4))
def test_reference_value_row_matches_bruteforce(seed):
    rng = np.random.default_rng(200 + seed)
    E, K = int(rng.integers(3, 10)), int(rng.integers(1, 4))
    A, c, ups, sig = _rand_problem(rng, E, K)
    allowed = rng.random(E) < 0.8
    s_cap = int(ups.sum())
    _, info = solve_budgeted_dp(torch.from_numpy(ups), torch.from_numpy(sig),
                                build_tables(A, c), s_cap, s_cap,
                                torch.from_numpy(allowed))
    row = info["value_row"].numpy()
    want = _enumerate_row(ups, sig, A, c, s_cap, allowed)
    np.testing.assert_array_equal(np.where(row >= 0, row, NEG), want)


def test_reference_solve_batch_rows_equal_single_solves():
    rng = np.random.default_rng(5)
    A, c, _, _ = _rand_problem(rng, 9, 3)
    tables = build_tables(A, c)
    B = 4
    ups = rng.integers(0, 6, (B, 9)).astype(np.int32)
    sig = rng.integers(1, 5000, (B, 9)).astype(np.int32)
    alw = rng.random((B, 9)) < 0.7
    s_cap = int(ups.sum(axis=1).max())
    slim = rng.integers(0, s_cap + 1, B).astype(np.int32)
    xb, ib = solve_budgeted_dp(torch.from_numpy(ups), torch.from_numpy(sig),
                               tables, s_cap, torch.from_numpy(slim),
                               torch.from_numpy(alw))
    for b in range(B):
        x, info = solve_budgeted_dp(torch.from_numpy(ups[b]),
                                    torch.from_numpy(sig[b]), tables, s_cap,
                                    int(slim[b]), torch.from_numpy(alw[b]))
        assert torch.equal(xb[b], x)
        assert int(ib["s_star"][b]) == int(info["s_star"])
        assert torch.equal(ib["value_row"][b], info["value_row"])


@pytest.mark.parametrize("kw", INSTANCE_KWARGS[:3])
def test_oracle_knapsack_equal(kw):
    """Same float32 fold order in both packages: x and the value bit-equal
    (tol 0), over 20 random arrival masks."""
    inst = generate_instance(**kw)
    jt, tt = jax_build_tables(inst.A, inst.c), build_tables(inst.A, inst.c)
    rng = np.random.default_rng(9)
    masks = rng.random((20, inst.n_edges)) < 0.6
    jf = jax.jit(lambda m: jax_oracle_knapsack(jnp.asarray(inst.v), jt, m))
    xs, vals = oracle_knapsack(torch.from_numpy(inst.v), tt,
                               torch.from_numpy(masks))
    assert torch.equal(oracle_value(torch.from_numpy(inst.v), tt,
                                    torch.from_numpy(masks)), vals)
    for i, mask in enumerate(masks):
        x, val = jf(jnp.asarray(mask))
        np.testing.assert_array_equal(xs[i].numpy(), np.asarray(x))
        assert float(vals[i]) == float(val)


# ---------------------------------------------------------------------------
# solver registry, device rule, import guard
# ---------------------------------------------------------------------------

def test_backend_resolution(monkeypatch):
    monkeypatch.delenv(SOLVER_ENV_VAR, raising=False)
    assert get_solver(None).name == "auto"
    assert get_solver("auto").name == "auto"
    assert get_solver("reference").name == "reference"
    assert get_solver("cuda").accepts_batch
    assert get_solver("auto").accepts_batch  # CUDA (B, E) calls: one launch
    assert not get_solver("reference").accepts_batch
    assert get_solver("reference") is get_solver("reference")
    solver = get_solver("cuda")
    assert get_solver(solver) is solver
    with pytest.raises(ValueError, match="bogus"):
        get_solver("bogus")


def test_env_var_overrides_auto_but_not_explicit(monkeypatch):
    monkeypatch.setenv(SOLVER_ENV_VAR, "reference")
    assert get_solver(None).name == "reference"
    assert get_solver("auto").name == "reference"
    assert get_solver("cuda").name == "cuda"


def test_invalid_env_var_warns_and_falls_back_to_auto(monkeypatch):
    monkeypatch.setenv(SOLVER_ENV_VAR, "pallas")
    with pytest.warns(RuntimeWarning, match="pallas"):
        assert get_solver("auto").name == "auto"
    with pytest.warns(RuntimeWarning):
        assert get_solver(None).name == "auto"


def test_reference_backend_refuses_tensors_off_the_cpu(monkeypatch):
    """No solver setting sends tensors off the CPU to the plain DP: the
    reference backend raises (meta tensors stand in for the card's)."""
    monkeypatch.setenv(SOLVER_ENV_VAR, "reference")
    E = 4
    tables = build_tables(np.ones((1, E), np.int32), np.array([2], np.int32))
    ups = torch.zeros(E, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        get_solver(None)(ups, ups, tables, 3, 3)


def test_auto_solver_uses_reference_for_cpu_tensors(monkeypatch):
    monkeypatch.delenv(SOLVER_ENV_VAR, raising=False)
    from repro_torch.kernels.budgeted_dp import LAUNCHES
    before = dict(LAUNCHES)
    rng = np.random.default_rng(1)
    A, c, ups, sig = _rand_problem(rng, 6, 2)
    tables = build_tables(A, c)
    s_cap = int(ups.sum())
    x, info = get_solver("auto")(torch.from_numpy(ups), torch.from_numpy(sig),
                                 tables, s_cap, s_cap)
    want = _jax_solve(ups, sig, A, c, s_cap, s_cap, None)
    np.testing.assert_array_equal(x.numpy(), want[0])
    assert LAUNCHES == before


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_device_helpers_none_means_cuda_and_raise_without_it(monkeypatch):
    """The schedule table and the cold plane follow the device rule too:
    ``device=None`` is the card, never a silent CPU tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stats.schedule_table(10, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initial_plane(5, 4)
    assert stats.schedule_table(10, 3, device="cpu")[0].device.type == "cpu"
    assert initial_plane(5, 4, "cpu").device.type == "cpu"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        roots = set(_imported_roots(path))
        bad = roots & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"

