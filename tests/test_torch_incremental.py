"""The port's incremental re-solves against the JAX package's, on the CPU.

``core/incremental.py`` (solve keys, the solve cache, the warm-started
reference fold), ``core/solvers.py::CachedSolver`` and
``kernels/budgeted_dp/ops.py::WarmCudaSolver`` (on CPU tensors its kernel
wrappers run their plain versions).  The same numpy-seeded statistics go
through both packages; the JAX side is its ``reference`` backend, its own
warm reference fold, or the host-side counters of its warm Pallas driver
derived from its delta-mask helpers.  Every integer output and every
hit, miss, skip and launch counter must be bit-equal (tolerance 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_tables as jax_build_tables
from repro.core import incremental as jax_inc
from repro.core.solvers import CachedSolver as JaxCachedSolver
from repro.core.solvers import get_solver as jax_get_solver
from repro.kernels.budgeted_dp.ops import WarmPallasSolver
from repro_torch.core import build_tables, get_solver
from repro_torch.core import incremental as inc
from repro_torch.core.dp import initial_plane
from repro_torch.core.solvers import CachedSolver
from repro_torch.kernels.budgeted_dp import LAUNCHES, kernel, ops, ref

JAX_REF = jax_get_solver("reference")
CUDA = get_solver("cuda")


def _problem(seed=0, E=10, K=2, c_hi=3, u_hi=5, sig_hi=5000):
    """The JAX tests' problem (``tests/test_incremental.py::_problem``) in
    both packages."""
    rng = np.random.default_rng(seed)
    A = rng.integers(1, 3, size=(K, E))
    c = rng.integers(1, c_hi + 1, size=K)
    A = np.minimum(A, c[:, None])
    ups = rng.integers(0, u_hi + 1, size=E).astype(np.int32)
    sig = rng.integers(1, sig_hi + 1, size=E).astype(np.int32)
    return jax_build_tables(A, c), build_tables(A, c), ups, sig


def _drift_seq(rng, ups, sig, s_cap, n_steps, u_hi=5, sig_hi=5000):
    """A seeded slot sequence over every delta-mask regime (the JAX tests'
    ``_drift_seq``): late-fold ("suffix") and first-fold ("head") changes,
    s_limit-only changes, eligibility flips and exact repeats.  Yields
    (ups, sig, alw, s_limit)."""
    E = len(ups)
    ups, sig = ups.copy(), sig.copy()
    alw = np.ones(E, bool)
    s_limit = s_cap
    kinds = ["head", "suffix", "slim", "repeat", "suffix", "alw",
             "repeat", "slim", "suffix", "head"]
    out = [(ups.copy(), sig.copy(), alw.copy(), s_limit)]
    for i in range(n_steps - 1):
        kind = kinds[i % len(kinds)]
        if kind == "suffix":
            e = int(rng.integers(0, max(1, E // 4)))
            ups[e] = rng.integers(0, u_hi + 1)
            sig[e] = rng.integers(1, sig_hi + 1)
        elif kind == "head":
            sig[E - 1] = rng.integers(1, sig_hi + 1)
        elif kind == "alw":
            e = int(rng.integers(0, E))
            alw[e] = ~alw[e]
        elif kind == "slim":
            s_limit = int(rng.integers(0, s_cap + 1))
        out.append((ups.copy(), sig.copy(), alw.copy(), s_limit))
    return out


def _jax_cold(ups, sig, jtables, s_cap, s_limit, alw):
    x, info = JAX_REF(jnp.asarray(ups, jnp.int32), jnp.asarray(sig, jnp.int32),
                      jtables, s_cap, jnp.int32(s_limit),
                      None if alw is None else jnp.asarray(alw))
    return (np.asarray(x), int(info["s_star"]),
            np.asarray(info["value_row"]))


def _assert_solve(got, want):
    x, info = got
    np.testing.assert_array_equal(np.asarray(x), want[0])
    assert int(info["s_star"]) == want[1]
    np.testing.assert_array_equal(np.asarray(info["value_row"]), want[2])


# ---------------------------------------------------------------------------
# solve keys and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_ups,q_sig", [(1, 1), (8, 1), (1, 64), (3, 17)])
def test_solve_key_bytes_equal_jax(q_ups, q_sig):
    """The same bytes for the same inputs, from numpy arrays and from
    tensors, with and without an eligibility mask, at every quantum."""
    rng = np.random.default_rng(q_ups * 100 + q_sig)
    for E in (1, 7, 8, 33):
        ups = rng.integers(0, 40, E).astype(np.int32)
        sig = rng.integers(0, 2 ** 24, E).astype(np.int32)
        alw = rng.random(E) < 0.6
        for a in (None, alw):
            lim = int(rng.integers(0, 500))
            want = jax_inc.solve_key(ups, sig, a, lim, q_ups, q_sig)
            assert inc.solve_key(ups, sig, a, lim, q_ups, q_sig) == want
            assert inc.solve_key(
                torch.from_numpy(ups), torch.from_numpy(sig),
                None if a is None else torch.from_numpy(a),
                torch.tensor(lim, dtype=torch.int32), q_ups, q_sig) == want


def _cache_run(module, trajectory, **kw):
    """Replay a solve trajectory through one package's SolveCache (get,
    put on a miss, one tick a solve); returns the per-step trace and the
    final ``as_dict()``."""
    cache = module.SolveCache(**kw)
    trace = []
    for i, (ups, sig, alw, lim) in enumerate(trajectory):
        cache.tick()
        key = cache.key(ups, sig, alw, lim)
        hit = cache.get(key)
        if hit is None:
            cache.put(key, i)
        trace.append((hit, cache.stats.hits, cache.stats.misses,
                      cache.stats.evictions, cache.stats.stale_rejects,
                      len(cache)))
    return trace, cache.stats.as_dict()


def _esdp_trajectory(T=160, seed=5):
    """The (Υ̂, Σ̂², eligibility, s_limit) of each slot of a port ESDP run
    on a small instance: statistics that drift as ESDP's do."""
    from repro_torch.core import esdp, generate_instance, simulate
    inst = generate_instance(seed=3, n_ports=4, n_servers=10, edge_prob=0.3)
    tables = build_tables(inst.A, inst.c)
    seen = []

    def record(ups, sig, tables, s_cap, s_limit, allowed=None, u_max=None):
        seen.append((ups[0].numpy().copy(), sig[0].numpy().copy(),
                     allowed[0].numpy().copy(), int(s_limit[0])))
        return get_solver("reference")(ups, sig, tables, s_cap, s_limit,
                                       allowed, u_max)

    from repro_torch.core.solvers import Solver
    policy = esdp.make_esdp_policy(inst, T, tables=tables,
                                   solver=Solver("record", record))
    simulate(inst, policy, T, seed=seed, tables=tables, device="cpu")
    return seen


@pytest.mark.parametrize("kw", [
    dict(),
    dict(capacity=4),
    dict(q_ups=2, q_sig=4096),
    dict(q_ups=2, q_sig=4096, max_stale=3, capacity=8),
], ids=["exact", "exact_lru4", "quantized", "quantized_stale3"])
def test_solve_cache_trace_equals_jax_over_an_esdp_trajectory(kw):
    """Hit/miss/eviction/stale-refusal sequences and ``as_dict()`` equal
    to the JAX cache's over a drifting ESDP trajectory, exact and
    quantized, so ``max_stale`` refuses at the same ticks.  The
    trajectory's last 60 slots are replayed, so the exact cache hits too
    (arrivals change eligibility nearly every slot)."""
    traj = _esdp_trajectory(T=200)
    traj = traj + traj[-60:]
    got = _cache_run(inc, traj, **kw)
    want = _cache_run(jax_inc, traj, **kw)
    assert got == want
    if "max_stale" in kw:
        assert got[1]["stale_rejects"] > 0
    if kw.get("capacity") == 4:
        assert got[1]["evictions"] > 0
    else:
        assert got[1]["hits"] >= 60


def test_solve_cache_units_as_in_jax():
    assert inc.SolveCache().exact and not inc.SolveCache(q_sig=4).exact
    for bad in (dict(capacity=0), dict(q_ups=0), dict(q_sig=0)):
        with pytest.raises(ValueError):
            inc.SolveCache(**bad)
    c = inc.SolveCache(capacity=2)
    for k in (b"a", b"b"):
        c.put(k, k)
    assert c.get(b"a") == b"a"
    c.put(b"c", b"c")  # LRU: b goes, a was refreshed
    assert c.get(b"b") is None and c.get(b"a") == b"a"
    assert set(inc.CacheStats().as_dict()) == set(
        jax_inc.CacheStats().as_dict())


# ---------------------------------------------------------------------------
# CachedSolver around the port's "cuda" backend (plain versions on the CPU)
# ---------------------------------------------------------------------------

def test_cached_solver_single_matches_jax_reference_and_counters():
    """B = 1 over a drift sequence run twice: every solve bit-equal to the
    JAX reference solve, and the counters equal to the JAX
    ``CachedSolver``'s over the same calls."""
    jt, tt, ups, sig = _problem(seed=1)
    s_cap = int(ups.sum())
    seq = _drift_seq(np.random.default_rng(2), ups, sig, s_cap, 12)
    ours, theirs = CachedSolver(CUDA), JaxCachedSolver(JAX_REF)
    assert ours.name == "cached:cuda" and ours.exact and ours.accepts_batch
    before = dict(LAUNCHES)
    for u, s, a, lim in seq + seq:
        want = _jax_cold(u, s, jt, s_cap, lim, a)
        _assert_solve(ours(torch.from_numpy(u), torch.from_numpy(s), tt,
                           s_cap, lim, allowed=torch.from_numpy(a)), want)
        theirs(u, s, jt, s_cap, lim, allowed=a)
    assert LAUNCHES == before  # plain versions: no launch counted
    assert ours.stats.as_dict() == theirs.stats.as_dict()
    assert ours.stats.launches_saved == ours.stats.hits >= len(seq)
    assert ours.stats.bypasses == 0


def test_cached_solver_batches_match_jax_including_a_partial_miss():
    """B = 4: rows bit-equal to per-row JAX reference solves; a full-hit
    replay skips the solve; one changed row makes one batched solve of
    the whole batch and every row refreshes — counters equal to JAX's."""
    jt, tt, ups, sig = _problem(seed=3, E=8)
    E, s_cap = len(ups), int(ups.sum())
    rng = np.random.default_rng(4)
    B = 4
    ups_b = np.stack([rng.integers(0, 6, E) for _ in range(B)]).astype(
        np.int32)
    sig_b = np.stack([sig] * B).astype(np.int32)
    alw_b = rng.random((B, E)) < 0.8
    lim_b = rng.integers(0, s_cap + 1, B)
    ours, theirs = CachedSolver(CUDA), JaxCachedSolver(JAX_REF)
    calls = 0

    def solve_base(*args, **kw):
        nonlocal calls
        calls += 1
        return CUDA(*args, **kw)

    from repro_torch.core.solvers import Solver
    counted = CachedSolver(Solver("cuda", solve_base, accepts_batch=True))
    for step in range(3):
        if step == 2:  # one row changes: a partial miss
            ups_b = ups_b.copy()
            ups_b[1, 0] = (ups_b[1, 0] + 1) % 6
        args = (torch.from_numpy(ups_b), torch.from_numpy(sig_b), tt, s_cap,
                torch.from_numpy(lim_b))
        x, info = ours(*args, allowed=torch.from_numpy(alw_b))
        counted(*args, allowed=torch.from_numpy(alw_b))
        theirs(ups_b, sig_b, jt, s_cap, lim_b, allowed=alw_b)
        for b in range(B):
            want = _jax_cold(ups_b[b], sig_b[b], jt, s_cap, lim_b[b],
                             alw_b[b])
            _assert_solve((x[b], {k: v[b] for k, v in info.items()}), want)
        assert ours.stats.as_dict() == theirs.stats.as_dict()
    assert calls == 2  # the first call and the partial miss, one each
    assert ours.stats.launches_saved == 1


# ---------------------------------------------------------------------------
# the warm-started reference fold
# ---------------------------------------------------------------------------

def _jax_warm_fn(jtables, s_cap, k):
    @jax.jit
    def warm(u, s, lim, a, carry):
        return jax_inc.solve_budgeted_dp_warm(u, s, jtables, s_cap, lim,
                                              carry, allowed=a,
                                              checkpoint_every=k)
    return warm


@pytest.mark.parametrize("k", [1, 3, 8])
def test_warm_reference_bit_equal_to_jax_over_drift(k):
    """x, s*, the value row and ``edges_folded`` equal to the JAX warm
    fold's, solve for solve, including s_limit-only steps (zero folds)."""
    jt, tt, ups, sig = _problem(seed=8)
    E, s_cap = len(ups), int(ups.sum())
    seq = _drift_seq(np.random.default_rng(9), ups, sig, s_cap, 14)
    jwarm = _jax_warm_fn(jt, s_cap, k)
    jcarry = jax_inc.warm_carry_init(E, s_cap, jt.n_states, k)
    carry = inc.warm_carry_init(E, s_cap, tt.n_states, k, device="cpu")
    folded = []
    for u, s, a, lim in seq:
        jx, jinfo, jcarry = jwarm(jnp.asarray(u), jnp.asarray(s),
                                  jnp.int32(lim), jnp.asarray(a), jcarry)
        x, info, carry = inc.solve_budgeted_dp_warm(
            torch.from_numpy(u), torch.from_numpy(s), tt, s_cap, lim, carry,
            allowed=torch.from_numpy(a), checkpoint_every=k)
        _assert_solve((x, info), (np.asarray(jx), int(jinfo["s_star"]),
                                  np.asarray(jinfo["value_row"])))
        assert int(info["edges_folded"]) == int(jinfo["edges_folded"])
        folded.append(int(info["edges_folded"]))
    assert folded[0] == E and 0 in folded and sum(folded) < len(seq) * E


def test_delta_mask_helpers_equal_jax():
    jt, tt, ups, sig = _problem(seed=13, E=6)
    E, s_cap = len(ups), int(ups.sum())
    carry = inc.warm_carry_init(E, s_cap, tt.n_states, 4, device="cpu")
    m = inc.changed_edge_mask(carry, torch.from_numpy(ups),
                              torch.from_numpy(sig), None)
    assert bool(m.all()) and inc.unchanged_fold_prefix(m) == 0
    carry = carry._replace(ups_f=torch.from_numpy(ups[::-1].copy()),
                           sig_f=torch.from_numpy(sig[::-1].copy()),
                           alw_f=torch.ones(E, dtype=torch.bool), valid=True)
    for e in range(E):
        u2 = ups.copy()
        u2[e] += 1
        got = inc.changed_edge_mask(carry, torch.from_numpy(u2),
                                    torch.from_numpy(sig), None)
        assert inc.unchanged_fold_prefix(got) == E - 1 - e
        jcarry = jax_inc.WarmCarry(
            ups_f=jnp.asarray(ups[::-1]), sig_f=jnp.asarray(sig[::-1]),
            alw_f=jnp.ones(E, bool), ckpts=None, v_final=None,
            decisions=None, valid=jnp.asarray(True))
        jm = jax_inc.changed_edge_mask(jcarry, jnp.asarray(u2),
                                       jnp.asarray(sig), None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jm))
    for k in (1, 3, 4, 8):
        assert inc.n_checkpoints(E, k) == jax_inc.n_checkpoints(E, k)


# ---------------------------------------------------------------------------
# WarmCudaSolver on the CPU (the kernel wrappers' plain versions)
# ---------------------------------------------------------------------------

def jax_warm_stats(inputs, E, k):
    """The counters of the JAX ``WarmPallasSolver`` over a sequence of
    (Υ̂, Σ̂², allowed) inputs, derived with its delta-mask helpers (its
    host driver resumes at the segment of the first changed fold step,
    ``ops.py:750-775``), with ``edge_skip_rate``."""
    n_seg = max(1, -(-E // k))
    st = {"solves": 0, "segments_launched": 0, "segments_skipped": 0,
          "edges_folded": 0, "edges_skipped": 0, "full_hits": 0}
    carry = None
    for u, s, a in inputs:
        p = 0 if carry is None else int(jax_inc.unchanged_fold_prefix(
            jax_inc.changed_edge_mask(carry, jnp.asarray(u), jnp.asarray(s),
                                      jnp.asarray(a))))
        si_r = n_seg if p >= E else p // k
        folded = sum(E - si * k - max(E - (si + 1) * k, 0)
                     for si in range(si_r, n_seg))
        st["solves"] += 1
        st["segments_skipped"] += si_r
        st["segments_launched"] += n_seg - si_r
        st["edges_folded"] += folded
        st["edges_skipped"] += E - folded
        st["full_hits"] += si_r == n_seg
        if si_r < n_seg:
            carry = jax_inc.WarmCarry(
                ups_f=jnp.asarray(u[::-1]), sig_f=jnp.asarray(s[::-1]),
                alw_f=jnp.asarray(a[::-1]), ckpts=None, v_final=None,
                decisions=None, valid=jnp.asarray(True))
    st["edge_skip_rate"] = st["edges_skipped"] / (E * st["solves"])
    return st


def _forced(pipeline):
    """A ``choose_tiling`` that sends every segment to ``pipeline``."""
    def choose(S, C, n_edges, u_max, off_max):
        if pipeline == "fused":
            return min(32, max(n_edges, 1)), None, C
        return None, None, C
    return choose


@pytest.mark.parametrize("pipeline", ["whole", "fused", "per_edge"])
@pytest.mark.parametrize("k", [3, 8])
def test_warm_cuda_solver_bit_equal_to_jax_cold_and_counts_as_jax(
    monkeypatch, k, pipeline
):
    """Every warm solve bit-equal to a cold JAX reference solve, and
    ``stats`` equal to the JAX warm driver's over the same sequence, on a
    whole plane and on planes forced to the tiled pipelines."""
    if pipeline != "whole":
        monkeypatch.setattr(ops, "choose_tiling", _forced(pipeline))
    jt, tt, ups, sig = _problem(seed=14)
    E, s_cap = len(ups), int(ups.sum())
    seq = _drift_seq(np.random.default_rng(15), ups, sig, s_cap, 12)
    warm = ops.WarmCudaSolver(tt, s_cap, checkpoint_every=k, device="cpu")
    assert warm.name == "warm:cuda" and not warm.accepts_batch
    for u, s, a, lim in seq:
        want = _jax_cold(u, s, jt, s_cap, lim, a)
        x, info = warm(torch.from_numpy(u), torch.from_numpy(s), tt, s_cap,
                       lim, allowed=torch.from_numpy(a))
        _assert_solve((x, info), want)
    want = jax_warm_stats([q[:3] for q in seq], E, k)
    assert dict(warm.stats, edge_skip_rate=warm.skip_rate) == want
    assert warm.stats["full_hits"] >= 2 and 0 < warm.skip_rate < 1


def test_warm_cuda_solver_counts_equal_jax_warm_pallas_in_interpret_mode():
    """A tiny instance through the JAX warm driver itself (Pallas
    interpret mode): the same solves and the same ``stats``."""
    jt, tt, ups, sig = _problem(seed=16, E=6)
    s_cap = int(ups.sum())
    seq = _drift_seq(np.random.default_rng(17), ups, sig, s_cap, 6)
    theirs = WarmPallasSolver(jt, s_cap, checkpoint_every=3, interpret=True)
    ours = ops.WarmCudaSolver(tt, s_cap, checkpoint_every=3, device="cpu")
    for u, s, a, lim in seq:
        jx, jinfo = theirs(u, s, jt, s_cap, lim, allowed=a)
        x, info = ours(u, s, tt, s_cap, lim, allowed=a)
        _assert_solve((x, info), (np.asarray(jx), int(jinfo["s_star"]),
                                  np.asarray(jinfo["value_row"])))
        assert info["edges_folded"] == jinfo["edges_folded"]
    assert ours.stats == theirs.stats
    assert ours.skip_rate == theirs.skip_rate


def test_warm_cuda_solver_s_limit_only_launches_no_forward(monkeypatch):
    jt, tt, ups, sig = _problem(seed=16)
    s_cap = int(ups.sum())
    calls = []
    for name in ("dp_forward_batched", "dp_epilogue"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    warm = ops.WarmCudaSolver(tt, s_cap, checkpoint_every=4, device="cpu")
    warm(ups, sig, tt, s_cap, s_cap)
    n_seg = -(-len(ups) // 4)
    assert calls.count("dp_forward_batched") == n_seg
    for lim in (0, s_cap // 3, s_cap):
        x, info = warm(ups, sig, tt, s_cap, lim)
        assert info["edges_folded"] == 0
        _assert_solve((x, info), _jax_cold(ups, sig, jt, s_cap, lim, None))
    assert calls.count("dp_forward_batched") == n_seg
    assert calls.count("dp_epilogue") == 4
    warm.reset()
    _, info = warm(ups, sig, tt, s_cap, s_cap)
    assert info["edges_folded"] == len(ups)
    other = build_tables(np.ones((1, 6), np.int64), np.array([2], np.int64))
    with pytest.raises(ValueError, match="bound to one"):
        warm(ups, sig, other, s_cap, s_cap)


@pytest.mark.parametrize("E,k", [(40, 8), (40, 40), (70, 20), (9, 2)])
def test_tabled_epilogue_equals_the_default_one(E, k):
    """The epilogue reading a segmented packing through a (word row, bit)
    table equals the default epilogue on the global packing of the same
    forward: each instance folded in segments of k edges chained through
    its plane, each segment packed from bit 0 of its own words, against
    one forward packed by global edge id."""
    rng = np.random.default_rng(E + k)
    A = rng.integers(1, 3, (2, E))
    c = rng.integers(2, 4, 2)
    tt = build_tables(np.minimum(A, c[:, None]), c)
    feas, offs = (torch.from_numpy(a) for a in ops.prepare_tables(tt))
    B, s_cap = 2, 30
    ups = torch.from_numpy(rng.integers(0, 4, (B, E)).astype(np.int32))
    sig = torch.from_numpy(rng.integers(1, 900, (B, E)).astype(np.int32))
    alw = torch.from_numpy((rng.random((B, E)) < 0.8).astype(np.int32))
    slim = torch.from_numpy(rng.integers(0, s_cap + 1, B).astype(np.int32))
    v0 = initial_plane(s_cap, tt.n_states, "cpu")
    V, words = ref.dp_forward_ref(ups, sig, alw, feas, offs, v0)
    want = kernel.dp_epilogue(V, words, ups, offs, slim, tt.full_state)
    bounds = [(max(E - (si + 1) * k, 0), E - si * k)
              for si in range(-(-E // k))]
    rows, bits = np.zeros(E, np.int32), np.zeros(E, np.int32)
    w_off = 0
    for lo, hi in bounds:
        local = np.arange(hi - lo)
        rows[lo:hi] = w_off + local // 32
        bits[lo:hi] = local % 32
        w_off += -(-(hi - lo) // 32)
    per_row = []
    for b in range(B):
        vin, ws = v0, []
        for lo, hi in bounds:
            Vs, Ws = ref.dp_forward_ref(*(
                t[b:b + 1, lo:hi].contiguous() for t in (ups, sig, alw)),
                feas[lo:hi].contiguous(), offs[lo:hi].contiguous(), vin)
            vin = Vs[0]
            ws.append(Ws)
        assert torch.equal(vin, V[b])  # chaining is bit-invisible
        per_row.append(torch.cat(ws, dim=1))
    words_seg = torch.cat(per_row)
    assert words_seg.shape[1] == w_off
    got = kernel.dp_epilogue(V, words_seg, ups, offs, slim, tt.full_state,
                             torch.from_numpy(rows), torch.from_numpy(bits))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the table that spells out the global packing is the default epilogue
    e_ids = np.arange(E)
    same = ref.dp_epilogue_ref(V, words, ups, offs, slim, tt.full_state,
                               (e_ids // 32).astype(np.int32),
                               (e_ids % 32).astype(np.int32))
    for a, b in zip(same, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="go together"):
        kernel.dp_epilogue(V, words, ups, offs, slim, tt.full_state,
                           torch.from_numpy(rows), None)
    with pytest.raises(ValueError, match="outside"):  # a row past W
        kernel.dp_epilogue(V, words_seg, ups, offs, slim, tt.full_state,
                           torch.from_numpy(rows + w_off),
                           torch.from_numpy(bits))
    with pytest.raises(ValueError, match="outside"):  # a bit past 31
        kernel.dp_epilogue(V, words_seg, ups, offs, slim, tt.full_state,
                           torch.from_numpy(rows),
                           torch.from_numpy(bits + 32))


@pytest.mark.parametrize("E,k", [(5, 3), (6, 2), (31, 16), (32, 11), (33, 17),
                                 (64, 32), (65, 22)])
def test_warm_tabled_epilogue_bit_equal_to_jax_at_window_edges(E, k):
    """``WarmCudaSolver`` on the CPU, its forward in two or three segments
    of k edges and its tabled epilogue, at E around the look-ahead windows
    (5 and 8 edges) and the 32-edge word: every solve of a drift sequence
    bit-equal to a cold JAX reference solve.  Υ̂ reaches s_cap + 1 and one
    step's s_limit is 2, so walks take edges above their budget (the clamp
    at 0); one step admits no budget (s_limit = −1: s* = 0)."""
    jt, tt, ups, sig = _problem(seed=E + k, E=E, K=2, c_hi=4, u_hi=9)
    s_cap = 8
    seq = _drift_seq(np.random.default_rng(E), ups, sig, s_cap, 4, u_hi=9)
    seq[1] = seq[1][:3] + (2,)  # a small budget: walks clamp
    seq[2] = seq[2][:3] + (-1,)
    warm = ops.WarmCudaSolver(tt, s_cap, checkpoint_every=k, device="cpu")
    assert warm._n_seg == (2 if -(-E // k) == 2 else 3)
    clamped = False
    for u, s, a, lim in seq:
        want = _jax_cold(u, s, jt, s_cap, lim, a)
        x, info = warm(torch.from_numpy(u), torch.from_numpy(s), tt, s_cap,
                       lim, allowed=torch.from_numpy(a))
        _assert_solve((x, info), want)
        walk = want[1]
        for e in np.flatnonzero(want[0]):
            clamped |= int(u[e]) > walk
            walk = max(walk - int(u[e]), 0)
    assert clamped


def test_epilogue_table_checked_once_on_the_host():
    """``kernel.epilogue_table`` checks the table's host arrays once; the
    wrapper then checks the table's host copy against the words and reads
    nothing back from the table's device (here the meta device, which
    holds no data, so any read would raise): a bad table raises before any
    launch, a good one reaches the device check.  A table changed in place
    is checked anew."""
    rows = np.array([0, 0, 1, 1, 2], np.int32)
    bits = np.array([0, 1, 0, 31, 3], np.int32)
    for bad_rows, bad_bits in ((rows - 1, bits), (rows, bits + 1)):
        with pytest.raises(ValueError, match="outside"):
            kernel.epilogue_table(bad_rows, bad_bits, "cpu")
    r, b = kernel.epilogue_table(rows, bits, "meta")
    assert r.dtype == b.dtype == torch.int32 and r.device.type == "meta"
    E, S, C = 5, 4, 3

    def call(W, r=r, b=b):
        return kernel.dp_epilogue(
            torch.empty((1, S, C), dtype=torch.int32, device="meta"),
            torch.empty((1, W, S, C), dtype=torch.int32, device="meta"),
            torch.empty((1, E), dtype=torch.int32, device="meta"),
            torch.empty((E,), dtype=torch.int32, device="meta"),
            torch.empty((1,), dtype=torch.int32, device="meta"), 0, r, b)

    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="outside"):  # needs 3 word rows
        call(2)
    with pytest.raises(ValueError, match="unsupported device"):
        call(3)
    r.add_(0)  # an in-place change: the next call reads the table anew
    with pytest.raises(NotImplementedError):
        call(3)
    assert LAUNCHES == before
