"""The port's tiled budgeted-DP forwards on the CPU.

``kernels/budgeted_dp``: the host loops of the per-edge and fused
pipelines (``kernel.dp_forward_blocked``/``dp_forward_fused``), which on
the CPU run the plain versions ``ref.dp_edge_ref``/``dp_chunk_ref`` in
place of the launches, against the JAX package's Pallas pipelines K3
(``_edge_tile_kernel``/``_edge_stile_kernel``), K4
(``_fused_chunk_kernel``) and K5 (``_batched_fused_kernel``) run with
``interpret=True``; the solve wrapper under every forced tiling against
the JAX int32 reference; ``tiling.choose_tiling`` and the legality checks
against the JAX package's messages; the ``u_max`` contract.  Words and
solves must be bit-equal (tolerance 0); planes equal wherever the JAX
f32 plane is ≥ 0 (the JAX kernels seed infeasible cells with −2²⁴, the
port with −2²⁹).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_tables as jax_build_tables
from repro.core.solvers import get_solver as jax_get_solver
from repro.kernels.budgeted_dp.kernel import (dp_forward_pallas,
                                              dp_forward_pallas_batched)
from repro.kernels.budgeted_dp.ops import prepare_tables as jax_prepare
from repro.kernels.budgeted_dp.ops import \
    solve_budgeted_dp_batched as jax_solve_batched
from repro.kernels.budgeted_dp.ops import \
    solve_budgeted_dp_pallas as jax_solve_single
from repro_torch.core import build_tables, generate_instance, stats
from repro_torch.core.dp import initial_plane
from repro_torch.kernels.budgeted_dp import kernel, ops, tiling

JAX_REF = jax_get_solver("reference")
LIMIT = tiling.SMEM_LIMIT_BYTES


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(seed, E, B, c=(3, 3), u_hi=5):
    """A small plane: K = len(c) resources, C = Π(c_k + 1) states."""
    rng = np.random.default_rng(seed)
    c = np.asarray(c)
    A = np.minimum(rng.integers(1, 3, (len(c), E)), c[:, None])
    ups = rng.integers(0, u_hi + 1, (B, E)).astype(np.int32)
    sig = rng.integers(1, 5000, (B, E)).astype(np.int32)
    alw = rng.random((B, E)) < 0.75
    return rng, A, c, ups, sig, alw


def _operands(A, c, S):
    tables = build_tables(A, c)
    feas, offs = ops.prepare_tables(tables)
    return (tables, _t(feas), _t(offs), initial_plane(S - 1, tables.n_states,
                                                      "cpu"))


def _v0_f32(S, C):
    v0 = np.full((S, C), -2.0 ** 24, np.float32)
    v0[0] = 0
    return jnp.asarray(v0)


def _assert_plane_and_words(V, W, Vj, Wj):
    np.testing.assert_array_equal(W.numpy(), np.asarray(Wj))
    V, Vj = V.numpy(), np.asarray(Vj)
    np.testing.assert_array_equal(V >= 0, Vj >= 0)
    np.testing.assert_array_equal(V[V >= 0], Vj[V >= 0].astype(np.int32))


# tile geometries: (block_s, block_c) from (u_max, off_max, C)
TILES = {
    "full_height": lambda u, o, C: (None, o),
    "s_tiled": lambda u, o, C: (u, o),
    "padded_2d": lambda u, o, C: (u + 3, o + 5),
    "full_width": lambda u, o, C: (u + 1, C),
}


# ---------------------------------------------------------------------------
# host loops with plain versions vs the Pallas pipelines (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", list(TILES))
@pytest.mark.parametrize("block_e", [None, 3, 10],
                         ids=["K3_per_edge", "K4_block_e3", "K4_block_e10"])
def test_single_pipelines_match_pallas_k3_k4(tile, block_e):
    """B = 1, E = 10, S = 32: the per-edge host loop against K3 and the
    fused one against K4 (block_e = 3 does not divide E), on full-height,
    S-tiled, padded and full-width tiles (K3's tiles; the port's per-edge
    grid has none).  ``allowed`` is masked in the port's kernels and
    folded into K3/K4's feasibility plane."""
    E, S = 10, 32
    _, A, c, ups, sig, alw = _problem(7, E, 1)
    tables, feas, offs, v0 = _operands(A, c, S)
    u_max, off_max = int(ups.max()) + 1, ops._off_max(tables)
    block_s, block_c = TILES[tile](u_max, off_max, tables.n_states)
    feas_f, offs_j = jax_prepare(jax_build_tables(A, c))
    Vj, Wj = dp_forward_pallas(
        jnp.asarray(ups[0]), jnp.asarray(sig[0]),
        jnp.asarray(feas_f * alw[0].astype(np.float32)[:, None]),
        jnp.asarray(offs_j), _v0_f32(S, tables.n_states), n_edges=E,
        u_max=u_max, off_max=off_max, interpret=True, block_c=block_c,
        block_s=block_s, block_e=block_e)
    args = (_t(ups), _t(sig), _t(alw.astype(np.int32)), feas, offs, v0)
    tiles = dict(u_max=u_max, off_max=off_max, block_s=block_s,
                 block_c=block_c)
    if block_e is None:  # the per-edge grid does not depend on the tile
        V, W = kernel.dp_forward_blocked(*args)
    else:
        V, W = kernel.dp_forward_fused(*args, block_e=block_e, **tiles)
    _assert_plane_and_words(V[0], W[0], Vj, Wj)


@pytest.mark.parametrize("tile", ["full_height", "s_tiled", "padded_2d"])
def test_batched_fused_loop_matches_pallas_k5(tile):
    """B = 3 instances with per-instance ``allowed``: the fused host loop
    against K5 (``dp_forward_pallas_batched`` with block_b = 1), E = 12
    in chunks of 5."""
    E, S, B = 12, 28, 3
    _, A, c, ups, sig, alw = _problem(11, E, B, c=(2, 3))
    tables, feas, offs, v0 = _operands(A, c, S)
    u_max, off_max = int(ups.max()) + 1, ops._off_max(tables)
    block_s, block_c = TILES[tile](u_max, off_max, tables.n_states)
    feas_f, offs_j = jax_prepare(jax_build_tables(A, c))
    Vj, Wj = dp_forward_pallas_batched(
        jnp.asarray(ups), jnp.asarray(sig), jnp.asarray(alw),
        jnp.asarray(feas_f), jnp.asarray(offs_j),
        _v0_f32(S, tables.n_states), n_edges=E, u_max=u_max,
        off_max=off_max, interpret=True, block_b=1, block_c=block_c,
        block_s=block_s, block_e=5)
    V, W = kernel.dp_forward_fused(
        _t(ups), _t(sig), _t(alw.astype(np.int32)), feas, offs, v0,
        u_max=u_max, off_max=off_max, block_e=5, block_s=block_s,
        block_c=block_c)
    _assert_plane_and_words(V, W, Vj, Wj)


def test_fused_chunk_straddling_word_boundary_matches_pallas_k4():
    """E = 40 in chunks of 7: the chunk of edges 34 … 28 writes words 1
    and 0 straight (no word masks), bit 31 included."""
    E, S = 40, 24
    _, A, c, ups, sig, alw = _problem(29, E, 1, c=(2, 2), u_hi=3)
    tables, feas, offs, v0 = _operands(A, c, S)
    u_max, off_max = int(ups.max()) + 1, ops._off_max(tables)
    feas_f, offs_j = jax_prepare(jax_build_tables(A, c))
    Vj, Wj = dp_forward_pallas(
        jnp.asarray(ups[0]), jnp.asarray(sig[0]), jnp.asarray(feas_f),
        jnp.asarray(offs_j), _v0_f32(S, tables.n_states), n_edges=E,
        u_max=u_max, off_max=off_max, interpret=True, block_c=off_max,
        block_s=u_max + 1, block_e=7)
    V, W = kernel.dp_forward_fused(_t(ups), _t(sig), None, feas, offs, v0,
                                   u_max=u_max, off_max=off_max, block_e=7,
                                   block_s=u_max + 1, block_c=off_max)
    assert W.shape[1] == 2 and (W[0, 1] != 0).any()
    _assert_plane_and_words(V[0], W[0], Vj, Wj)


# ---------------------------------------------------------------------------
# the solve wrapper under every forced tiling vs the JAX int32 reference
# ---------------------------------------------------------------------------

def _forced_tilings(u_max, off_max, C):
    """The forced set ``chip_smoke.py`` runs on the card, for a plane with
    these halo floors: (name, block_e, block_s, block_c, B)."""
    up = -(-u_max // 8) * 8
    oc = -(-off_max // 32) * 32 if off_max else 32
    return [
        ("per-edge full-height", None, None, C, 1),
        ("per-edge 2-D", None, up, off_max, 1),
        ("fused full-height", 32, None, off_max, 3),
        ("fused C tiles", 7, None, min(oc, C), 3),
        ("fused 2-D e=1", 1, up, off_max, 3),
        ("fused 2-D e=7", 7, up + 1, off_max + 2, 3),
        ("fused 2-D e=32", 32, u_max, off_max, 1),
        ("fused full-width", 7, up, C, 3),
    ]


def _jax_solve_rows(ups, sig, A, c, s_cap, slim, alw):
    tables = jax_build_tables(A, c)
    out = []
    for b in range(ups.shape[0]):
        x, info = JAX_REF(jnp.asarray(ups[b]), jnp.asarray(sig[b]), tables,
                          s_cap, jnp.int32(slim[b]), jnp.asarray(alw[b]))
        out.append((np.asarray(x), int(info["s_star"]),
                    np.asarray(info["value_row"])))
    return out


@pytest.mark.parametrize("E,seed", [(12, 3), (40, 4)], ids=["E12", "E40"])
def test_solve_every_forced_tiling_bit_equal_to_jax_reference(E, seed):
    """x, s* and the value row of ``solve_budgeted_dp_batched`` under each
    forced tiling (per-edge at B = 1, fused at B = 1 and 3; E = 40 has
    chunks across the word boundary) equal the JAX int32 reference per
    row, and auto picks the whole plane for these small planes."""
    B = 3
    rng, A, c, ups, sig, alw = _problem(seed, E, B, c=(3, 2, 1), u_hi=4)
    tables = build_tables(A, c)
    s_cap = int(ups.sum(axis=1).max()) // 2
    slim = rng.integers(s_cap // 2, s_cap + 1, B).astype(np.int32)
    u_max = int(ups.max()) + 1
    off_max = ops._off_max(tables)
    want = _jax_solve_rows(ups, sig, A, c, s_cap, slim, alw)
    assert tiling.choose_tiling(s_cap + 1, tables.n_states, E, u_max,
                                off_max) == (None, None, None)
    cases = [("auto", "auto", None, None, B)] + [
        (name, bc, be, bs, nb) for name, be, bs, bc, nb in
        _forced_tilings(u_max, off_max, tables.n_states)]
    for name, bc, be, bs, nb in cases:
        x, info = ops.solve_budgeted_dp_batched(
            _t(ups[:nb]), _t(sig[:nb]), tables, s_cap, _t(slim[:nb]),
            u_max=u_max, allowed=_t(alw[:nb]), block_c=bc, block_s=bs,
            block_e=be)
        for b in range(nb):
            np.testing.assert_array_equal(x[b].numpy(), want[b][0],
                                          err_msg=name)
            assert int(info["s_star"][b]) == want[b][1], name
            np.testing.assert_array_equal(info["value_row"][b].numpy(),
                                          want[b][2], err_msg=name)


def test_fig6_c_hi6_plane_solves_tiled_like_the_reference():
    """The fig-6 c_hi = 6 plane at T = 1500 (403,704 bytes) on the
    auto-tiled path — the fused pipeline, one chunk of all 31 edges —
    equals the int32 reference for B = 2 rows with real statistics."""
    inst = generate_instance(seed=2, c_lo=1, c_hi=6)
    tables = build_tables(inst.A, inst.c)
    T, m, E = 1500, inst.m, inst.n_edges
    s_cap = stats.s_cap_for_horizon(T, m)
    u_max = stats.u_max_for_horizon(T, m)
    be, bs, bc = tiling.choose_tiling(s_cap + 1, tables.n_states, E, u_max,
                                      ops._off_max(tables))
    assert (be, bc) == (E, tables.n_states) and bs is not None
    rng = np.random.default_rng(6)
    xi, g, _ = stats.schedule_table(T, m, device="cpu")
    t = torch.as_tensor([700, 1499])
    vhat = torch.as_tensor(rng.random((2, E)), dtype=torch.float32)
    n = torch.as_tensor(rng.integers(1, 40, (2, E)), dtype=torch.int32)
    ups, sig, slim = stats.scale_statistics(vhat, n, xi[t][:, None],
                                            g[t][:, None], m)
    alw = rng.random((2, E)) < 0.8
    x, info = ops.solve_budgeted_dp_batched(ups, sig, tables, s_cap,
                                            slim[:, 0], u_max=u_max,
                                            allowed=_t(alw))
    want = _jax_solve_rows(ups.numpy(), sig.numpy(), inst.A, inst.c, s_cap,
                           slim[:, 0].numpy(), alw)
    for b in range(2):
        np.testing.assert_array_equal(x[b].numpy(), want[b][0])
        assert int(info["s_star"][b]) == want[b][1]
        np.testing.assert_array_equal(info["value_row"][b].numpy(),
                                      want[b][2])


# ---------------------------------------------------------------------------
# choose_tiling and the legality checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,C", [(919, 12), (801, 72), (817, 72), (817, 71),
                                 (4096, 512), (58112, 1), (1, 58113)])
def test_whole_plane_exactly_when_it_fits(S, C):
    fits = tiling.whole_plane_smem_bytes(S, C) <= LIMIT
    got = tiling.choose_tiling(S, C, 31, 52, max(C // 3, 0))
    assert (got == (None, None, None)) == fits


@pytest.mark.parametrize("T,tiled", [(1500, False), (2000, True)])
def test_fig6_c_hi5_switches_to_tiles_between_t1500_and_t2000(T, tiled):
    """The fig-6 c_hi = 5 plane: 230,688 bytes at T = 1500 (whole plane),
    235,296 at T = 2000 (fused, full-width tiles, one launch per slot)."""
    inst = generate_instance(seed=2, c_lo=1, c_hi=5)
    tables = build_tables(inst.A, inst.c)
    S = stats.s_cap_for_horizon(T, inst.m) + 1
    C = tables.n_states
    assert tiling.whole_plane_smem_bytes(S, C) == (235296 if tiled
                                                   else 230688)
    got = tiling.choose_tiling(S, C, inst.n_edges,
                               stats.u_max_for_horizon(T, inst.m),
                               ops._off_max(tables))
    if tiled:
        assert got[0] == inst.n_edges and got[2] == C and got[1] < S
    else:
        assert got == (None, None, None)


@pytest.mark.parametrize("S,C,E,u_max,off_max", [
    (801, 126, 31, 51, 100), (817, 72, 31, 52, 50), (4096, 512, 16, 4, 73),
    (8192, 512, 16, 4, 73), (2000, 300, 40, 9, 250), (5000, 40, 12, 300, 39),
    (801, 126, 31, 802, 100), (3000, 2000, 8, 30, 1500)])
def test_chosen_tiles_respect_floors_and_fit(S, C, E, u_max, off_max):
    """Every returned tile is legal (``check_tiling`` passes), keeps the
    halo floors and, on the fused pipeline, fits the modelled shared
    memory; the per-edge pipeline comes only when no fused tile fits."""
    be, bs, bc = tiling.choose_tiling(S, C, E, u_max, off_max)
    assert bc >= off_max and (bs is None or u_max <= bs < S)
    tiling.check_tiling(S, C, u_max, off_max, be, bs, bc)
    if be is not None:
        assert be == min(E, 32)
        assert tiling.fused_smem_bytes(S, C, u_max, off_max, bs,
                                       bc) <= LIMIT
    else:
        for bc2 in range(max(off_max, 1), C + 1):
            assert tiling.fused_smem_bytes(S, C, u_max, off_max,
                                           max(u_max, 1), bc2) > LIMIT


def _illegal_calls():
    """(name, JAX-package call kwargs or None, port kwargs, B) — each
    must raise ``ValueError``; where the JAX package has the check, with
    its message."""
    return [
        ("block_s needs block_c", dict(block_c=None, block_s=8),
         dict(block_c=None, block_s=8), 1),
        ("block_e needs block_c", dict(block_c=None, block_e=4),
         dict(block_c=None, block_e=4), 1),
        ("left halo floor", dict(block_c="OFF-1", block_e=4),
         dict(block_c="OFF-1", block_e=4), 1),
        ("up halo floor", dict(block_c="OFF", block_s="U-1", block_e=4),
         dict(block_c="OFF", block_s="U-1", block_e=4), 1),
        ("block_e range", dict(block_c="OFF", block_e=33),
         dict(block_c="OFF", block_e=33), 1),
        ("block_e zero", dict(block_c="OFF", block_e=0),
         dict(block_c="OFF", block_e=0), 1),
        ("forced but auto", dict(block_e=4), dict(block_e=4), 2),
        ("block_s forced but auto", dict(block_s=8), dict(block_s=8), 1),
        ("batched per-edge", dict(block_c="OFF"), dict(block_c="OFF"), 2),
        ("batched left halo floor", dict(block_c="OFF-1", block_e=4),
         dict(block_c="OFF-1", block_e=4), 2),
        ("batched up halo floor",
         dict(block_c="OFF", block_s="U-1", block_e=4),
         dict(block_c="OFF", block_s="U-1", block_e=4), 2),
        ("fused tile over shared memory", None,
         dict(block_c="C", block_e=4), 1),
    ]


@pytest.mark.parametrize("case", _illegal_calls(), ids=lambda c: c[0])
def test_illegal_tilings_raise_like_the_jax_package(case):
    name, jax_kw, kw, B = case
    _, A, c, ups, sig, _ = _problem(13, 8, B)
    tables = build_tables(A, c)
    u_max = int(ups.max()) + 1
    off_max = ops._off_max(tables)
    s_cap = 4000  # a (4001, 16) plane: 256,064 bytes as one tile

    def fill(d):
        sub = {"OFF": off_max, "OFF-1": off_max - 1, "U-1": u_max - 1,
               "C": tables.n_states}
        return {k: sub.get(v, v) if isinstance(v, str) and v != "auto"
                else v for k, v in d.items()}

    with pytest.raises(ValueError) as port:
        ops.solve_budgeted_dp_batched(_t(ups), _t(sig), tables, s_cap, s_cap,
                                      u_max=u_max, **fill(kw))
    if jax_kw is None:
        assert "shared memory" in str(port.value)
        return
    with pytest.raises(ValueError) as ref:
        jax_solve_batched(jnp.asarray(ups), jnp.asarray(sig),
                          jax_build_tables(A, c), s_cap, s_cap, u_max=u_max,
                          interpret=True, **fill(jax_kw))
    # the reason after ": " or " — " may name the card instead of the TPU
    head = re.compile(r": | — ")
    assert head.split(str(port.value))[0] == head.split(str(ref.value))[0]


# ---------------------------------------------------------------------------
# the u_max contract
# ---------------------------------------------------------------------------

def test_upsilon_over_u_max_raises_for_cpu_inputs():
    _, A, c, ups, sig, _ = _problem(17, 8, 2)
    tables = build_tables(A, c)
    top = int(ups.max())
    with pytest.raises(ValueError, match=f"max Υ̂ = {top} exceeds u_max"):
        ops.solve_budgeted_dp_batched(_t(ups), _t(sig), tables, 40, 40,
                                      u_max=top - 1)
    ops.solve_budgeted_dp_batched(_t(ups), _t(sig), tables, 40, 40,
                                  u_max=top)
    with pytest.raises(ValueError, match="exceeds u_max"):  # None: s_cap + 1
        ops.solve_budgeted_dp_batched(_t(ups), _t(sig), tables, top - 2,
                                      top - 2)


@pytest.mark.parametrize("T", [150, 1500, 2000])
def test_u_max_for_horizon_bounds_upsilon_on_default_schedule(T):
    """The card does not read Υ̂ back, so the bound is pinned here: with
    the largest valuation (v̂ = 1) Υ̂ = ξ(t) ≤ u_max − 1 at every t ≤ T, on
    the fig-6 c_hi = 6 instance."""
    inst = generate_instance(seed=2, c_lo=1, c_hi=6)
    xi, g, _ = stats.schedule_table(T, inst.m, device="cpu")
    E = inst.n_edges
    ups, _, _ = stats.scale_statistics(
        torch.ones((T, E)), torch.ones((T, E), dtype=torch.int32),
        xi[:, None], g[:, None], inst.m)
    assert int(ups.max()) <= stats.u_max_for_horizon(T, inst.m) - 1


@pytest.mark.parametrize("tile", ["auto", "fused", "per_edge"])
def test_u_max_passed_like_the_jax_esdp(tile):
    """With u_max = ``u_max_for_horizon`` (what both ESDPs pass) the port's
    solve at B = 1 equals the JAX package's single-instance Pallas solve
    (interpret mode) under the same tiling knobs."""
    E, T = 9, 40
    rng, A, c, _, _, alw = _problem(19, E, 1, c=(2, 3))
    m = 3
    s_cap = stats.s_cap_for_horizon(T, m)
    u_max = stats.u_max_for_horizon(T, m)
    ups = rng.integers(0, u_max, (1, E)).astype(np.int32)
    sig = rng.integers(1, 4000, (1, E)).astype(np.int32)
    tables = build_tables(A, c)
    off_max = ops._off_max(tables)
    kw = {"auto": {}, "fused": dict(block_c=off_max, block_s=u_max,
                                    block_e=4),
          "per_edge": dict(block_c=off_max, block_s=u_max)}[tile]
    want = jax_solve_single(jnp.asarray(ups[0]), jnp.asarray(sig[0]),
                            jax_build_tables(A, c), s_cap, s_cap - 2,
                            u_max=u_max, allowed=jnp.asarray(alw[0]),
                            interpret=True, **kw)
    got = ops.solve_budgeted_dp_batched(_t(ups), _t(sig), tables, s_cap,
                                        s_cap - 2, u_max=u_max,
                                        allowed=_t(alw), **kw)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    assert int(got[1]["s_star"][0]) == int(want[1]["s_star"])
    row = np.asarray(want[1]["value_row"])
    feas = row >= 0
    np.testing.assert_array_equal(got[1]["value_row"][0].numpy()[feas],
                                  row[feas].astype(np.int32))
