"""The port's budgeted-DP kernel module on the CPU.

``kernels/budgeted_dp``: the plain whole-plane forward (``ref.py``)
against the JAX package's Pallas kernels K1/K2 run with
``interpret=True`` and against the JAX int32 reference plane; the solve
wrapper (forward + epilogue) against the JAX ``reference`` backend and
2^E brute force; the wrappers' checks, the shared-memory limit, the value
bound and the nvcc command line.  On the CPU every wrapper runs its plain
version.  Integer outputs must be bit-equal (tolerance 0).  The tiled
pipelines are tested in ``test_torch_tiling.py``.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_tables as jax_build_tables
from repro.core.dp import _dp_forward as jax_dp_forward_int32
from repro.core.solvers import get_solver as jax_get_solver
from repro.kernels.budgeted_dp.kernel import (dp_forward_pallas,
                                              dp_forward_pallas_batched)
from repro.kernels.budgeted_dp.ops import prepare_tables as jax_prepare
from repro_torch.core import build_tables, generate_instance, stats
from repro_torch.core.dp import NEG, initial_plane
from repro_torch.kernels import nvcc
from repro_torch.kernels.budgeted_dp import build, kernel, ops, ref, tiling

JAX_REF = jax_get_solver("reference")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _problem(seed, E, K=2, c_hi=3, u_hi=6, sig_lo=1, sig_hi=5000, B=None):
    """Random instance with E edges and statistics (B, E) when B is set."""
    rng = np.random.default_rng(seed)
    A = rng.integers(1, 3, size=(K, E))
    c = rng.integers(1, c_hi + 1, size=K)
    A = np.minimum(A, c[:, None])
    shape = (E,) if B is None else (B, E)
    ups = rng.integers(0, u_hi + 1, size=shape).astype(np.int32)
    sig = rng.integers(sig_lo, sig_hi + 1, size=shape).astype(np.int32)
    alw = rng.random(shape) < 0.7
    return rng, A, c, ups, sig, alw


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# plain forward vs the Pallas kernels (interpret mode) and the int32 plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E", [33, 40])
def test_forward_ref_matches_pallas_k1_and_int32_plane(E):
    """The batched forward at B = 1 with ``allowed`` masked in the kernel
    (K1 takes it folded into the feasibility plane): words bit-equal to
    K1's; the plane bit-equal to the JAX int32 reference plane, and equal
    to K1's f32 plane wherever K1's is ≥ 0 (K1 seeds infeasible cells with
    −2²⁴, the port with −2²⁹)."""
    _, A, c, ups, sig, alw = _problem(E, E)
    jt = jax_build_tables(A, c)
    S = 24
    feas_f, offs = jax_prepare(jt)
    feas_f = feas_f * alw.astype(np.float32)[:, None]
    v0f = np.full((S, jt.n_states), -2.0 ** 24, np.float32)
    v0f[0] = 0
    Vj, Wj = dp_forward_pallas(
        jnp.asarray(ups), jnp.asarray(sig), jnp.asarray(feas_f),
        jnp.asarray(offs), jnp.asarray(v0f), n_edges=E,
        u_max=int(ups.max()) + 1, off_max=int(offs.max()), interpret=True)
    Vj, Wj = np.asarray(Vj), np.asarray(Wj)

    feas_i, offs_t = ops.prepare_tables(build_tables(A, c))
    V, W = kernel.dp_forward_batched(
        _t(ups[None]), _t(sig[None]), _t(alw[None].astype(np.int32)),
        _t(feas_i), _t(offs_t), initial_plane(S - 1, jt.n_states, "cpu"))
    np.testing.assert_array_equal(W[0].numpy(), Wj)
    V = V[0].numpy()
    np.testing.assert_array_equal(V >= 0, Vj >= 0)
    np.testing.assert_array_equal(V[V >= 0], Vj[V >= 0].astype(np.int32))

    feas_b = np.asarray(jt.feasible) & alw[None, :]
    Vi, _ = jax_dp_forward_int32(jnp.asarray(ups), jnp.asarray(sig),
                                 jnp.asarray(feas_b),
                                 jnp.asarray(jt.next_state), S - 1)
    np.testing.assert_array_equal(V, np.asarray(Vi))


@pytest.mark.parametrize("E,B", [(33, 3), (40, 2)])
def test_forward_ref_batched_matches_pallas_k2(E, B):
    """(B, E) statistics and ``allowed`` masked in the kernel: words
    bit-equal to K2's, planes equal on K2's non-negative cells."""
    _, A, c, ups, sig, alw = _problem(E + B, E, B=B)
    jt = jax_build_tables(A, c)
    S = 20
    feas_f, offs = jax_prepare(jt)
    v0f = np.full((S, jt.n_states), -2.0 ** 24, np.float32)
    v0f[0] = 0
    Vj, Wj = dp_forward_pallas_batched(
        jnp.asarray(ups), jnp.asarray(sig), jnp.asarray(alw),
        jnp.asarray(feas_f), jnp.asarray(offs), jnp.asarray(v0f), n_edges=E,
        u_max=int(ups.max()) + 1, off_max=int(offs.max()), interpret=True)
    Vj, Wj = np.asarray(Vj), np.asarray(Wj)
    feas_i, offs_t = ops.prepare_tables(build_tables(A, c))
    V, W = kernel.dp_forward_batched(_t(ups), _t(sig),
                                     _t(alw.astype(np.int32)), _t(feas_i),
                                     _t(offs_t),
                                     initial_plane(S - 1, jt.n_states, "cpu"))
    np.testing.assert_array_equal(W.numpy(), Wj)
    V = V.numpy()
    np.testing.assert_array_equal(V >= 0, Vj >= 0)
    np.testing.assert_array_equal(V[V >= 0], Vj[V >= 0].astype(np.int32))


def test_forward_ref_allowed_none_equals_all_allowed():
    _, A, c, ups, sig, _ = _problem(4, 12, B=2)
    feas, offs = ops.prepare_tables(build_tables(A, c))
    v0 = initial_plane(15, feas.shape[1], "cpu")
    a = ref.dp_forward_ref(_t(ups), _t(sig), None, _t(feas), _t(offs), v0)
    b = ref.dp_forward_ref(_t(ups), _t(sig), torch.ones(2, 12,
                                                        dtype=torch.int32),
                           _t(feas), _t(offs), v0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# solves (forward + epilogue) vs the JAX reference backend and brute force
# ---------------------------------------------------------------------------

def _jax_solve(ups, sig, A, c, s_cap, s_limit, allowed):
    x, info = JAX_REF(jnp.asarray(ups), jnp.asarray(sig),
                      jax_build_tables(A, c), s_cap, jnp.int32(s_limit),
                      None if allowed is None else jnp.asarray(allowed))
    return (np.asarray(x), int(info["s_star"]),
            np.asarray(info["value_row"]))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("large", [False, True], ids=["small", "2^24-2^29"])
def test_kernel_solve_bit_equal_to_jax_reference(seed, large):
    """``solve_budgeted_dp_batched`` at B = 1 (the K1 path) on CPU
    tensors: x, s* and the value row bit-equal to the JAX int32 reference;
    ``large`` puts the DP sums in [2²⁴, 2²⁹), beyond the Pallas kernel's
    f32 domain."""
    E = 6 + 2 * seed
    _, A, c, ups, sig, alw = _problem(300 + seed, E, K=3,
                                      sig_lo=2 ** 22 if large else 1,
                                      sig_hi=2 ** 25 if large else 5000)
    allowed = alw if seed % 2 else None
    s_cap = int(ups.sum())
    s_limit = s_cap - seed
    want = _jax_solve(ups, sig, A, c, s_cap, s_limit, allowed)
    x, info = ops.solve_budgeted_dp_batched(
        _t(ups[None]), _t(sig[None]), build_tables(A, c), s_cap, s_limit,
        allowed=None if allowed is None else _t(allowed[None]))
    np.testing.assert_array_equal(x[0].numpy(), want[0])
    assert int(info["s_star"][0]) == want[1]
    np.testing.assert_array_equal(info["value_row"][0].numpy(), want[2])


@pytest.mark.parametrize("seed", range(3))
def test_batched_solve_bit_equal_to_jax_reference_per_row(seed):
    """``solve_budgeted_dp_batched`` (K2 path): each row bit-equal to the
    JAX reference on that row's statistics, mask and s_limit."""
    B, E = 4, 10
    rng, A, c, ups, sig, alw = _problem(400 + seed, E, K=3, B=B,
                                        sig_hi=2 ** 26)
    s_cap = int(ups.sum(axis=1).max())
    slim = rng.integers(s_cap // 2, s_cap + 1, B).astype(np.int32)
    x, info = ops.solve_budgeted_dp_batched(_t(ups), _t(sig),
                                            build_tables(A, c), s_cap,
                                            _t(slim), allowed=_t(alw))
    for b in range(B):
        want = _jax_solve(ups[b], sig[b], A, c, s_cap, int(slim[b]), alw[b])
        np.testing.assert_array_equal(x[b].numpy(), want[0])
        assert int(info["s_star"][b]) == want[1]
        np.testing.assert_array_equal(info["value_row"][b].numpy(), want[2])


@pytest.mark.parametrize("seed", range(3))
def test_kernel_solve_value_row_matches_bruteforce(seed):
    E = 7 + seed
    _, A, c, ups, sig, alw = _problem(500 + seed, E, K=2)
    s_cap = int(ups.sum())
    _, info = ops.solve_budgeted_dp_batched(_t(ups[None]), _t(sig[None]),
                                            build_tables(A, c), s_cap, s_cap,
                                            allowed=_t(alw[None]))
    bits = (np.arange(2 ** E)[:, None] >> np.arange(E)[None, :]) & 1
    bits = bits[(bits <= alw.astype(np.int64)).all(axis=1)]
    bits = bits[(bits @ A.T <= c).all(axis=1)]
    want = np.full(s_cap + 1, NEG, np.int64)
    for uu, vv in zip(bits @ ups.astype(np.int64),
                      bits @ sig.astype(np.int64)):
        want[:min(int(uu), s_cap) + 1] = np.maximum(
            want[:min(int(uu), s_cap) + 1], vv)
    np.testing.assert_array_equal(info["value_row"][0].numpy(), want)


def test_epilogue_no_feasible_budget_picks_zero():
    """An all-infeasible row (never produced by the DP, which keeps s = 0
    feasible) still yields s* = 0, like ``argmax`` over −inf scores."""
    V = torch.full((1, 5, 3), NEG, dtype=torch.int32)
    W = torch.zeros((1, 1, 5, 3), dtype=torch.int32)
    x, s_star, row = kernel.dp_epilogue(V, W, torch.zeros((1, 4),
                                                          dtype=torch.int32),
                                        torch.zeros(4, dtype=torch.int32),
                                        torch.tensor([4], dtype=torch.int32),
                                        2)
    assert int(s_star[0]) == 0 and not x.any() and (row == NEG).all()


# ---------------------------------------------------------------------------
# the epilogue where its look-ahead windows make a walk risky
# ---------------------------------------------------------------------------

def _clamps(x, s_star, ups):
    """Whether the walk of ``x`` from ``s_star`` takes an edge whose Υ̂
    exceeds the walk's budget (the clamp at 0)."""
    s, hit = s_star, False
    for e in np.flatnonzero(x):
        hit |= int(ups[e]) > s
        s = max(s - int(ups[e]), 0)
    return hit


@pytest.mark.parametrize("E", [1, 5, 6, 31, 32, 33, 64, 65])
def test_epilogue_bit_equal_to_jax_at_window_and_word_edges(E):
    """E at and around the look-ahead windows (5 and 8 edges) and the
    32-edge word: the solve (forward + epilogue, B = 3) bit-equal, row by
    row, to the JAX reference; Υ̂ up to s_cap + 1, so some walk takes an
    edge with Υ̂ above its budget (the clamp at 0)."""
    B, s_cap = 3, 12
    rng, A, c, ups, sig, alw = _problem(600 + E, E, K=2, c_hi=4,
                                        u_hi=s_cap + 1, B=B)
    slim = rng.integers(1, s_cap // 2, B).astype(np.int32)
    x, info = ops.solve_budgeted_dp_batched(_t(ups), _t(sig),
                                            build_tables(A, c), s_cap,
                                            _t(slim), allowed=_t(alw))
    clamped = False
    for b in range(B):
        want = _jax_solve(ups[b], sig[b], A, c, s_cap, int(slim[b]), alw[b])
        np.testing.assert_array_equal(x[b].numpy(), want[0])
        assert int(info["s_star"][b]) == want[1]
        np.testing.assert_array_equal(info["value_row"][b].numpy(), want[2])
        clamped |= _clamps(want[0], want[1], ups[b])
    assert clamped or E == 1


@pytest.mark.parametrize("E", [2, 6, 33])
def test_epilogue_tied_scores_bit_equal_to_jax(E):
    """Two budgets tie on the eq.-17 score, 0 + √9 = 1 + √4 exactly in f32
    (one unit of capacity; the last two edges: Υ̂ 1, Σ̂² 4 and Υ̂ 0, Σ̂² 9;
    the others not allowed): s* is the first, as in the JAX reference, and
    the walk over all E edges is its walk."""
    A, c = np.ones((1, E), np.int64), np.array([1])
    ups = np.zeros(E, np.int32)
    sig = np.arange(1, E + 1, dtype=np.int32)
    ups[E - 2], sig[E - 2], sig[E - 1] = 1, 4, 9
    alw = np.zeros(E, bool)
    alw[E - 2:] = True
    s_cap = 3
    want = _jax_solve(ups, sig, A, c, s_cap, s_cap, alw)
    assert want[2][0] == 9 and want[2][1] == 4 and want[1] == 0
    x, info = ops.solve_budgeted_dp_batched(
        _t(ups[None]), _t(sig[None]), build_tables(A, c), s_cap, s_cap,
        allowed=_t(alw[None]))
    np.testing.assert_array_equal(x[0].numpy(), want[0])
    assert int(info["s_star"][0]) == want[1]
    np.testing.assert_array_equal(info["value_row"][0].numpy(), want[2])


@pytest.mark.parametrize("E", [6, 33])
def test_epilogue_no_feasible_budget_bit_equal_to_jax(E):
    """s_limit = −1 admits no budget: s* = 0 (argmax over an all-masked
    score row) and the walk from (0, full_state), as in the JAX
    reference."""
    _, A, c, ups, sig, alw = _problem(700 + E, E, K=2, c_hi=3)
    s_cap = int(ups.sum())
    want = _jax_solve(ups, sig, A, c, s_cap, -1, alw)
    x, info = ops.solve_budgeted_dp_batched(
        _t(ups[None]), _t(sig[None]), build_tables(A, c), s_cap, -1,
        allowed=_t(alw[None]))
    assert want[1] == 0
    np.testing.assert_array_equal(x[0].numpy(), want[0])
    assert int(info["s_star"][0]) == 0
    np.testing.assert_array_equal(info["value_row"][0].numpy(), want[2])


# ---------------------------------------------------------------------------
# wrappers: checks, gate, counters, value bound
# ---------------------------------------------------------------------------

def test_wrappers_check_dtype_shape_contiguity_and_count_no_cpu_launches():
    _, A, c, ups, sig, _ = _problem(7, 8)
    feas, offs = ops.prepare_tables(build_tables(A, c))
    v0 = initial_plane(9, feas.shape[1], "cpu")
    ups, sig = _t(ups[None]), _t(sig[None])
    before = dict(kernel.LAUNCHES)
    kernel.dp_forward_batched(ups, sig, None, _t(feas), _t(offs), v0)
    assert kernel.LAUNCHES == before  # the plain version counts nothing
    with pytest.raises(TypeError, match="int32"):
        kernel.dp_forward_batched(ups.long(), sig, None, _t(feas), _t(offs),
                                  v0)
    with pytest.raises(ValueError, match="shape"):
        kernel.dp_forward_batched(ups[:, :-1], sig, None, _t(feas),
                                  _t(offs), v0)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.dp_forward_batched(ups, sig, None, _t(feas.T).T, _t(offs),
                                  v0)


@pytest.mark.parametrize("c_hi,fits", [(2, True), (4, True), (6, False)])
def test_shared_memory_gate_on_fig6_planes(c_hi, fits):
    """Fig.-6 capacity sweep at T = 2000: c_hi = 4 is a 160 KB plane that
    fits one block and solves whole; c_hi = 6 (402 KB) solves on the
    auto-tiled path, and a forced whole-plane solve of it
    (``block_c=None``) raises."""
    inst = generate_instance(seed=2, c_lo=1, c_hi=c_hi)
    tables = build_tables(inst.A, inst.c)
    s_cap = stats.s_cap_for_horizon(2000, inst.m)
    S, C = s_cap + 1, tables.n_states
    assert (tiling.whole_plane_smem_bytes(S, C)
            <= tiling.SMEM_LIMIT_BYTES) == fits
    E = inst.n_edges
    ups = torch.zeros((1, E), dtype=torch.int32)
    sig = torch.ones((1, E), dtype=torch.int32)
    x, info = ops.solve_budgeted_dp_batched(ups, sig, tables, s_cap, s_cap)
    assert x.shape == (1, E) and int(info["value_row"][0, 0]) >= 0
    if fits:
        ops.solve_budgeted_dp_batched(ups, sig, tables, s_cap, s_cap,
                                      block_c=None)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            ops.solve_budgeted_dp_batched(ups, sig, tables, s_cap, s_cap,
                                          block_c=None)


def test_default_schedules_stay_under_value_bound():
    """The card path skips the value-bound check (it would sync), so the
    default schedules are pinned under 2²⁹ here: worst explored statistics
    (n = 1) at T = 1500, 2000 and 10⁵, and every channel unexplored at
    t = 1, on the Table-2 instance."""
    inst = generate_instance(seed=0)
    tables = build_tables(inst.A, inst.c)
    E, m = inst.n_edges, inst.m
    for T in (1500, 2000, 10 ** 5):
        xi, g, _ = stats.schedule_table(T, m, device="cpu")
        _, sig, _ = stats.scale_statistics(torch.ones(E), torch.ones(
            E, dtype=torch.int32), xi[-1], g[-1], m)
        assert ops.max_achievable_value(sig.numpy(), tables) < \
            ops.VALUE_BOUND
    xi, g, _ = stats.schedule_table(1, m, device="cpu")
    _, sig0, _ = stats.scale_statistics(torch.zeros(E), torch.zeros(
        E, dtype=torch.int32), xi[0], g[0], m)
    assert ops.max_achievable_value(sig0.numpy(), tables) < ops.VALUE_BOUND


def test_value_bound_overflow_raises_for_cpu_inputs():
    _, A, c, ups, sig, _ = _problem(8, 6)
    sig[0] = ops.VALUE_BOUND
    with pytest.raises(ValueError, match="2\\^29"):
        ops.solve_budgeted_dp_batched(_t(ups[None]), _t(sig[None]),
                                      build_tables(A, c), int(ups.sum()),
                                      int(ups.sum()))


def test_max_achievable_value_topk():
    E = 5
    tables = build_tables(np.ones((1, E), np.int64), np.array([2]))
    sig = np.array([10, 50, 20, 40, 30])
    assert ops.max_achievable_value(sig, tables) == 90


def test_validate_value_row_catches_each_violation():
    assert ops.validate_value_row(np.array([9, 7, 7, NEG, NEG])) is None
    bad = {
        "source": [NEG, 3, NEG],
        "neg-contract": [9, -4, NEG],
        "value-bound": [2 ** 29, 5, NEG],
        "feasible-prefix": [9, NEG, 4],
        "monotone": [4, 9, NEG],
    }
    for name, row in bad.items():
        assert ops.validate_value_row(np.array(row)).startswith(name)
    assert ops.validate_value_row(
        np.array([[9, 7], [4, 9]])).startswith("row 1: monotone")


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_nvcc_argv_targets_sm90a_without_fast_math():
    argv = nvcc.nvcc_argv("nvcc", build.SOURCE, pathlib.Path("out.so"))
    joined = " ".join(argv)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "fast_math" not in joined and "fast-math" not in joined
    assert "-shared" in argv and argv[-1] == str(build.SOURCE)
    lib = build.library_path()
    assert lib.parent == ROOT / "build" / "repro_torch"
    assert lib.name.startswith("budgeted_dp-") and lib.suffix == ".so"


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(nvcc, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    assert not list(tmp_path.iterdir())  # no half-written library left
    monkeypatch.undo()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc._nvcc()
