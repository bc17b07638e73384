"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and nvcc; without a card they skip.  They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch for CUDA:

    python -m pytest -q tests/test_torch_cuda.py

Integer outputs must be bit-equal (tolerance 0).  The float kernels
(attention K6, SSD K7) are held to their plain versions run on the same
card: 2e-5 in f32 attention and 1e-4 in f32 SSD, where the two differ in
summation order only (the f32 attention kernel runs each product as
three TF32 products, ~2^-21 relative); 2e-2 in bf16 attention, where the
plain version rounds q·k and p to bf16 and the kernels do not.  The bf16
attention kernel is also held to the plain version run in f64 on the same
inputs: no farther from it than 1.25 times the CUDA-core kernel (the
f32-FMA referee, launched raw), which runs both products in f32; the SSD
scan at N = 128 and over several
slabs is held to the f64 plain version too: within 1e-4, or twice the
f32 plain version's distance.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (build_tables, esdp, generate_instance,
                              get_solver, make_draws, simulate, stats)
from repro_torch.core.dp import initial_plane
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd
from repro_torch.kernels.budgeted_dp import (LAUNCHES, build, kernel, ops,
                                             ref)
from repro_torch.models import build_model, init_params


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernels have "
                    "no CPU mode; chip_smoke.py runs the same checks)")
    return torch.device("cuda")


@pytest.mark.parametrize("c_hi,seed,B", [(2, 0, 7), (4, 2, 3)])
def test_cuda_solves_bit_equal_to_plain_versions(c_hi, seed, B):
    """Table 2 and the fig-6 c_hi = 4 plane at T = 2000: the batched
    forward + epilogue equal the plain versions run on the CPU, for the
    fleet in one launch and for each instance as a batch of one."""
    dev = _card()
    inst = generate_instance(seed=seed, c_lo=1, c_hi=c_hi)
    tables = build_tables(inst.A, inst.c)
    s_cap = stats.s_cap_for_horizon(2000, inst.m)
    rng = np.random.default_rng(c_hi)
    E = inst.n_edges
    ups = torch.as_tensor(rng.integers(0, s_cap // inst.m + 1, (B, E)),
                          dtype=torch.int32)
    sig = torch.as_tensor(rng.integers(0, 2 ** 25, (B, E)), dtype=torch.int32)
    alw = torch.as_tensor(rng.random((B, E)) < 0.7)
    slim = torch.as_tensor(rng.integers(0, s_cap + 1, B), dtype=torch.int32)
    want = ops.solve_budgeted_dp_batched(ups, sig, tables, s_cap, slim,
                                         allowed=alw)
    before = dict(LAUNCHES)
    got = ops.solve_budgeted_dp_batched(ups.to(dev), sig.to(dev), tables,
                                        s_cap, slim.to(dev),
                                        allowed=alw.to(dev))
    torch.cuda.synchronize()
    assert LAUNCHES["dp_forward_batched"] == before["dp_forward_batched"] + 1
    assert torch.equal(got[0].cpu(), want[0])
    for k in ("s_star", "value_row"):
        assert torch.equal(got[1][k].cpu(), want[1][k])
    for b in range(B):
        x, info = ops.solve_budgeted_dp_batched(
            ups[b:b + 1].to(dev), sig[b:b + 1].to(dev), tables, s_cap,
            slim[b].to(dev), allowed=alw[b:b + 1].to(dev))
        assert torch.equal(x[0].cpu(), want[0][b])
        assert int(info["s_star"][0]) == int(want[1]["s_star"][b])
        assert torch.equal(info["value_row"][0].cpu(),
                           want[1]["value_row"][b])
    assert LAUNCHES["dp_forward_batched"] == \
        before["dp_forward_batched"] + 1 + B


def _plane(name):
    """(tables, S) of a whole plane: Table 2 at T = 2000 (the register-held
    forward), the largest plane the gate admits (its tiled sweep, one
    capacity column a thread), 40 edges across the 32-bit word boundary,
    one resource of C = 101 (the one-column sweep with 14 threads that own
    no cell, and offsets small enough that a stray thread would reach cells
    updated the same edge), and C = 216 and C = 1331 (a capacity column a
    cell)."""
    rng = np.random.default_rng(len(name))
    if name in ("table2", "largest"):
        inst = generate_instance(seed=0)
        tables = build_tables(inst.A, inst.c)
        S = stats.s_cap_for_horizon(2000, inst.m) + 1
        if name == "largest":
            S = 232448 // 4 // tables.n_states
        return tables, S
    A, c, S = {"e40_word_boundary": (rng.integers(1, 3, (3, 40)),
                                     (2, 2, 2), 2000),
               "c101_one_resource": (rng.integers(1, 6, (1, 20)),
                                     (100,), 200),
               "c216_cell_columns": (rng.integers(1, 3, (3, 20)),
                                     (5, 5, 5), 250),
               "c1331_cell_columns": (rng.integers(1, 4, (3, 12)),
                                      (10, 10, 10), 43)}[name]
    return build_tables(np.minimum(A, np.asarray(c)[:, None]),
                        np.asarray(c)), S


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("plane", ["table2", "largest", "e40_word_boundary",
                                   "c101_one_resource", "c216_cell_columns",
                                   "c1331_cell_columns"])
def test_cuda_whole_plane_forward_bit_equal_to_plain_version(plane, B):
    """The whole-plane forward (K1 at B = 1, K2 beyond) on each of its cell
    layouts: planes and words bit-equal to ``dp_forward_ref`` with
    ``allowed`` masks and without, one launch each."""
    dev = _card()
    tables, S = _plane(plane)
    assert 4 * S * tables.n_states <= 232448
    feas, offs = (torch.as_tensor(a, device=dev)
                  for a in ops.prepare_tables(tables))
    v0 = initial_plane(S - 1, tables.n_states, dev)
    E = offs.shape[0]
    rng = np.random.default_rng(B)
    ups = torch.as_tensor(rng.integers(0, S // 8 + 1, (B, E)),
                          dtype=torch.int32, device=dev)
    sig = torch.as_tensor(rng.integers(0, 2 ** 22, (B, E)),
                          dtype=torch.int32, device=dev)
    for alw in (torch.as_tensor(rng.random((B, E)) < 0.7, device=dev).int(),
                None):
        Vp, Wp = ref.dp_forward_ref(ups, sig, alw, feas, offs, v0)
        before = dict(LAUNCHES)
        V, W = kernel.dp_forward_batched(ups, sig, alw, feas, offs, v0)
        torch.cuda.synchronize()
        assert LAUNCHES == dict(before, dp_forward_batched=before[
            "dp_forward_batched"] + 1)
        assert torch.equal(V, Vp) and torch.equal(W, Wp)


@pytest.mark.parametrize("one_col", [1, 0], ids=["column_a_thread",
                                                 "column_a_cell"])
@pytest.mark.parametrize("plane", ["largest", "c101_one_resource"])
def test_cuda_forward_sweep_layouts_bit_equal_to_plain_version(plane, one_col):
    """The tiled sweep with each cell layout forced through its C entry
    point, on planes where both apply: bit-equal to ``dp_forward_ref``,
    with a quarter of the edges at Υ̂ = 0."""
    dev = _card()
    tables, S = _plane(plane)
    C = tables.n_states
    feas, offs = (torch.as_tensor(a, device=dev)
                  for a in ops.prepare_tables(tables))
    v0 = initial_plane(S - 1, C, dev)
    B, E = 7, offs.shape[0]
    rng = np.random.default_rng(one_col)
    ups = torch.as_tensor(rng.integers(0, S // 8 + 1, (B, E))
                          * (rng.random((B, E)) > 0.25),
                          dtype=torch.int32, device=dev)
    sig = torch.as_tensor(rng.integers(0, 2 ** 22, (B, E)),
                          dtype=torch.int32, device=dev)
    alw = torch.as_tensor(rng.random((B, E)) < 0.7, device=dev).int()
    Vp, Wp = ref.dp_forward_ref(ups, sig, alw, feas, offs, v0)
    V = torch.empty((B, S, C), dtype=torch.int32, device=dev)
    W = torch.empty((B, kernel.packed_words(E), S, C), dtype=torch.int32,
                    device=dev)
    lib = build.load()
    err = lib.dp_forward_sweep_launch(
        ups.data_ptr(), sig.data_ptr(), alw.data_ptr(), feas.data_ptr(),
        offs.data_ptr(), v0.data_ptr(), V.data_ptr(), W.data_ptr(), B, E, S,
        C, one_col, torch.cuda.current_stream().cuda_stream)
    build.LIBRARY.check(err, "dp_forward_sweep")
    torch.cuda.synchronize()
    assert torch.equal(V, Vp) and torch.equal(W, Wp)


@pytest.mark.parametrize("pipeline,B", [("per_edge", 1), ("fused", 1),
                                         ("fused", 7)],
                         ids=["K3_dp_edge", "K4_dp_chunk", "K5_dp_chunk"])
def test_cuda_tiled_forwards_bit_equal_to_plain_versions(pipeline, B):
    """The fig-6 c_hi = 6 plane at T = 1500: the per-edge forward, and the
    fused one on a small forced 2-D tiling (two C-tiles, S-tiles that do
    not divide S) in chunks of 7 edges.  Their planes and words equal the
    plain whole forward on the same inputs, and each wrapper counts its
    launches."""
    dev = _card()
    inst = generate_instance(seed=2, c_lo=1, c_hi=6)
    tables = build_tables(inst.A, inst.c)
    s_cap = stats.s_cap_for_horizon(1500, inst.m)
    u_max = stats.u_max_for_horizon(1500, inst.m)
    feas, offs = (torch.as_tensor(a, device=dev)
                  for a in ops.prepare_tables(tables))
    v0 = initial_plane(s_cap, tables.n_states, dev)
    off_max = int(offs.max())
    rng = np.random.default_rng(B)
    E = inst.n_edges
    ups = torch.as_tensor(rng.integers(0, u_max, (B, E)), dtype=torch.int32,
                          device=dev)
    sig = torch.as_tensor(rng.integers(0, 2 ** 20, (B, E)),
                          dtype=torch.int32, device=dev)
    alw = torch.as_tensor(rng.random((B, E)) < 0.7, device=dev).int()
    Vp, Wp = ref.dp_forward_ref(ups, sig, alw, feas, offs, v0)
    tiles = dict(u_max=u_max, off_max=off_max, block_s=u_max + 5,
                 block_c=off_max)
    before = dict(LAUNCHES)
    if pipeline == "per_edge":
        V, W = kernel.dp_forward_blocked(ups, sig, alw, feas, offs, v0)
        name, launches = "dp_edge", E
    else:
        V, W = kernel.dp_forward_fused(ups, sig, alw, feas, offs, v0,
                                       block_e=7, **tiles)
        name, launches = "dp_chunk", -(-E // 7)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before[name] + launches
    assert torch.equal(V, Vp) and torch.equal(W, Wp)


def test_cuda_esdp_decisions_equal_cpu_reference():
    """ESDP on the card (CUDA kernels) and on the CPU (int32 reference)
    make the same decisions on the same draws and schedule."""
    dev = _card()
    inst = generate_instance(seed=0)
    tables = build_tables(inst.A, inst.c)
    T = 50
    policy = esdp.make_esdp_policy(inst, T, tables=tables)
    draws = make_draws(inst, T, 3, dev)
    sched = stats.schedule_table(T, inst.m, device="cpu")
    on_card = simulate(inst, policy, T, tables=tables, draws=draws,
                       schedule=sched)
    on_cpu = simulate(inst, policy, T, tables=tables, device="cpu",
                      draws=type(draws)(draws.arr_u.cpu(), draws.val_n.cpu(),
                                        draws.pol_u.cpu()),
                      schedule=sched)
    np.testing.assert_array_equal(on_card.x, on_cpu.x)
    np.testing.assert_allclose(on_card.sw, on_cpu.sw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,B,Sq,Sk,H,KH,hd,causal,window", [
    ("float32", 2, 256, 256, 4, 4, 64, True, 0),
    ("float32", 1, 200, 200, 8, 2, 112, True, 0),  # GQA, ragged, hd 112
    ("float32", 1, 77, 300, 4, 4, 256, True, 50),  # Sq < Sk, a window
    ("bfloat16", 2, 130, 130, 4, 1, 64, False, 0),  # MQA, bidirectional
    ("bfloat16", 1, 256, 256, 2, 2, 112, True, 0),
])
def test_cuda_flash_attention_matches_plain_version(
    dtype, B, Sq, Sk, H, KH, hd, causal, window
):
    dev = _card()
    g = torch.Generator().manual_seed(Sq)
    q, k, v = (torch.randn(shape, generator=g).to(dev, getattr(torch, dtype))
               for shape in ((B, Sq, H, hd), (B, Sk, KH, hd),
                             (B, Sk, KH, hd)))
    want = fa.flash_attention_ref(q, k, v, scale=hd ** -0.5, causal=causal,
                                  window=window)
    name = fa.kernel_for(q.dtype, hd)
    before = fa.LAUNCHES[name]
    got = fa.flash_attention(q, k, v, scale=hd ** -0.5, causal=causal,
                             window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _cuda_core_attention(q, k, v, scale, causal, window):
    """The CUDA-core kernel (flash_fwd_kernel, the f32-FMA referee that no
    input is routed to) on the same inputs: a raw launch, for comparison."""
    B, Sq, H, hd = q.shape
    _, Sk, KH, _ = k.shape
    out = torch.empty_like(q)
    err = fa.LIBRARY.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KH, hd, scale,
        int(causal), window, torch.cuda.current_stream().cuda_stream)
    fa.LIBRARY.check(err, "flash_attention")
    return out


def _rel(got, want):
    return float(((got.double() - want).abs() / (1 + want.abs())).max())


@pytest.mark.parametrize("B,Sq,Sk,H,KH,hd,causal,window", [
    (2, 256, 256, 4, 4, 64, True, 0),
    (2, 256, 256, 4, 4, 64, False, 0),  # bidirectional
    (1, 200, 200, 8, 2, 112, True, 0),  # GQA g = 4, ragged rows and keys
    (1, 200, 200, 8, 2, 112, False, 0),
    (1, 77, 300, 4, 4, 128, True, 50),  # Sq < Sk, a window
    (2, 130, 130, 8, 2, 128, False, 0),  # GQA, a ragged key tile
    (1, 333, 1000, 8, 2, 112, True, 0),  # the prefill tail
    (1, 96, 96, 2, 2, 32, True, 0),  # hd under one 64-column box
    (1, 200, 200, 8, 2, 136, True, 0),  # three boxes, the third mostly zeros
    (1, 77, 300, 4, 2, 192, True, 50),  # deepseek-v3's q/k, Sq < Sk, window
    (2, 130, 130, 4, 4, 192, False, 0),
    (1, 150, 333, 8, 2, 200, True, 0),  # four boxes, ragged GQA Sq < Sk
    (1, 200, 200, 4, 4, 256, True, 0),  # gemma-7b's hd
    (1, 96, 260, 4, 1, 256, True, 70),  # MQA, a window
    # whisper-medium: cross-attention in decode (one query row folded
    # into a 128-row block) and in prefill (Sq < Sk, no mask), and the
    # encoder over 1500 frames (a ragged last key tile: 23 · 64 + 28);
    # qwen2-vl-72b's GQA 64:8 at D 128
    (4, 1, 1500, 16, 16, 64, False, 0),
    (4, 416, 1500, 16, 16, 64, False, 0),
    (2, 1500, 1500, 16, 16, 64, False, 0),
    (1, 200, 200, 64, 8, 128, True, 0),
])
def test_cuda_flash_wgmma_matches_plain_version(B, Sq, Sk, H, KH, hd, causal, window):
    """bf16 goes to the wgmma kernel at every hd up to 256 (one to four
    64-column boxes): within 2e-2 of the bf16 plain version, and no
    farther from the f64 plain version than 1.25 times the CUDA-core
    kernel on the same inputs."""
    dev = _card()
    g = torch.Generator().manual_seed(Sq + hd)
    q, k, v = (torch.randn(shape, generator=g).to(dev, torch.bfloat16)
               for shape in ((B, Sq, H, hd), (B, Sk, KH, hd),
                             (B, Sk, KH, hd)))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window)
    assert fa.kernel_for(q.dtype, hd) == "flash_attention_wgmma"
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict(before, flash_attention_wgmma=before[
        "flash_attention_wgmma"] + 1)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    exact = fa.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    core = _cuda_core_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _rel(got, exact) <= 1.25 * _rel(core, exact)


def test_cuda_flash_bf16_hd_256_takes_the_wgmma_kernel():
    dev = _card()
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 70, 2, 256), generator=g).to(dev,
                                                            torch.bfloat16)
               for _ in range(3))
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, scale=0.0625)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict(before, flash_attention_wgmma=before[
        "flash_attention_wgmma"] + 1)
    want = fa.flash_attention_ref(q, k, v, scale=0.0625)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("B,Sq,Sk,H,KH,hd,causal,window", [
    (1, 40, 40, 4, 4, 8, True, 0),  # the narrowest head
    (2, 256, 256, 4, 4, 64, False, 0),  # bidirectional
    (1, 200, 200, 8, 2, 112, True, 0),  # GQA g = 4, ragged rows and keys
    (1, 333, 1000, 8, 2, 112, True, 0),  # the prefill tail
    (1, 77, 300, 4, 4, 128, True, 50),  # Sq < Sk, a window
    (1, 130, 130, 4, 1, 136, True, 0),  # MQA, the D = 256 instance
    (1, 150, 333, 8, 2, 200, True, 40),
    (1, 77, 300, 4, 4, 256, True, 50),
    (2, 100, 100, 2, 2, 256, False, 0),
    # whisper-medium's and qwen2-vl-72b's shapes, as for the wgmma kernel
    (4, 1, 1500, 16, 16, 64, False, 0),
    (4, 416, 1500, 16, 16, 64, False, 0),
    (2, 1500, 1500, 16, 16, 64, False, 0),
    (1, 200, 200, 64, 8, 128, True, 0),
])
def test_cuda_flash_tf32_matches_plain_version(B, Sq, Sk, H, KH, hd, causal, window):
    """f32 goes to the split-TF32 kernel at every hd up to 256: one launch,
    within 2e-5 of the f32 plain version, and no farther from the f64
    plain version than the CUDA-core kernel's distance plus 2e-5."""
    dev = _card()
    g = torch.Generator().manual_seed(Sq + hd)
    q, k, v = (torch.randn(shape, generator=g).to(dev)
               for shape in ((B, Sq, H, hd), (B, Sk, KH, hd),
                             (B, Sk, KH, hd)))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict(before, flash_attention_tf32=before[
        "flash_attention_tf32"] + 1)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    exact = fa.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    core = _cuda_core_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _rel(got, exact) <= _rel(core, exact) + 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_refuses_inputs_off_a_16_byte_boundary(dtype):
    """Both kernels read rows in 16-byte pieces: a contiguous view that
    starts 8 bytes into its storage raises before any launch."""
    dev = _card()
    dt = getattr(torch, dtype)
    q = torch.randn((1, 64, 2, 64), device=dev).to(dt)
    shifted = torch.empty(q.numel() + 8, device=dev, dtype=dt)[
        8 // q.element_size():8 // q.element_size() + q.numel()].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_attention(shifted, q, q, scale=0.125)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_pv_key_order_on_distinct_keys(dtype):
    """p·V's key permutation within each group of 8 (p's fragment comes
    from S's accumulator as it is, V's from keys 2t and 2t + 1): every key
    of V holds its own values, and a sharp softmax (scale 1) puts nearly
    all of a row's weight on one key, so a key taken for its neighbour
    shows at full size.  Within the K6 tolerance of the plain version."""
    dev = _card()
    dt = getattr(torch, dtype)
    B, S, H, hd = 1, 192, 4, 64
    g = torch.Generator().manual_seed(5)
    q, k = (torch.randn((B, S, H, hd), generator=g).to(dev, dt)
            for _ in range(2))
    j = torch.arange(S, dtype=torch.float32)[:, None, None]
    d = torch.arange(hd, dtype=torch.float32)
    h = torch.arange(H, dtype=torch.float32)[:, None]
    v = ((j * hd + d + 0.5 * h) / (S * hd))[None].to(dev, dt).contiguous()
    assert torch.unique(v[0, :, 0, 0]).numel() == S
    got = fa.flash_attention(q, k, v, scale=1.0)
    want = fa.flash_attention_ref(q, k, v, scale=1.0)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("lo", [9, 20], ids=["31_edges", "20_edges"])
@pytest.mark.parametrize("seed_plane", ["shared", "own", "vin_is_vout"])
@pytest.mark.parametrize("B", [1, 3])
def test_cuda_dp_chunk_across_the_word_boundary(B, seed_plane, lo):
    """Edges 39 … lo of a 40-edge plane (bits in words 1 and 0) in one
    cooperative launch, from a shared (S, C) seed plane, an own (B, S, C)
    one, or in place (``vin is vout``), with an odd and an even number of
    edges (the ping-pong's two parities), on 2000 × 512 planes (several
    cells per thread): plane and words bit-equal to the plain version,
    words ORed into what they held."""
    dev = _card()
    rng = np.random.default_rng(B + lo)
    E, c = 40, np.array([7, 7, 7])
    A = np.minimum(rng.integers(1, 3, (3, E)), c[:, None])
    tables = build_tables(A, c)
    feas, offs = (torch.as_tensor(a, device=dev)
                  for a in ops.prepare_tables(tables))
    S, C = 2000, tables.n_states
    u_hi = 40
    ups = torch.as_tensor(rng.integers(0, u_hi + 1, (B, E)),
                          dtype=torch.int32, device=dev)
    sig = torch.as_tensor(rng.integers(1, 5000, (B, E)), dtype=torch.int32,
                          device=dev)
    alw = torch.as_tensor(rng.random((B, E)) < 0.75, device=dev).int()
    v0 = initial_plane(S - 1, C, dev)
    if seed_plane == "shared":
        vin = v0
    else:
        vin = torch.as_tensor(rng.integers(-1000, 10 ** 6, (B, S, C)),
                              dtype=torch.int32, device=dev)
    words0 = torch.as_tensor(
        rng.integers(-2 ** 31, 2 ** 31, (B, 2, S, C)), dtype=torch.int32,
        device=dev)
    Vp, Wp = ref.dp_chunk_ref(vin, words0.clone(), ups, sig, alw, feas, offs,
                              lo, E)
    vout = vin if seed_plane == "vin_is_vout" else torch.empty(
        (B, S, C), dtype=torch.int32, device=dev)
    words = words0.clone()
    before = dict(LAUNCHES)
    V, W = kernel.dp_chunk(vin, vout, words, ups, sig, alw, feas, offs, lo,
                           E, u_max=u_hi + 1, off_max=int(offs.max()),
                           block_s=u_hi + 1, block_c=C)
    torch.cuda.synchronize()
    assert LAUNCHES == dict(before, dp_chunk=before["dp_chunk"] + 1)
    assert V is vout and W is words
    assert torch.equal(V, Vp) and torch.equal(W, Wp)


@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 128, 2, 32, 16, 32),
    (2, 80, 2, 32, 16, 32),  # a ragged last chunk
    (1, 300, 3, 64, 64, 128),  # the serving chunk, ragged
    (2, 20, 3, 16, 8, 32),  # S < chunk: one chunk of S steps
])
def test_cuda_ssd_matches_plain_version(B, S, H, P, N, Q):
    dev = _card()
    g = torch.Generator().manual_seed(S)
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    xbc = torch.randn((B, S, 2 * N), generator=g)
    args = [t.to(dev) for t in (x, dt, A, xbc)]
    Bm, Cm = args[3].split([N, N], dim=-1)  # strided, as the model's split
    want = ssd.ssd_ref(args[0], args[1], args[2], Bm, Cm, Q)
    before = ssd.LAUNCHES["ssd_scan"]
    got = ssd.ssd_scan(args[0], args[1], args[2], Bm, Cm, Q)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_scan"] == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (1, 300, 3, 64, 128, 128),  # Mamba2-2.7B's state, ragged
    (2, 200, 5, 64, 128, 64),  # over two 64-wide state slabs, ragged
    (1, 150, 2, 72, 12, 128),  # P over one 64-column slab, N under 16
])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cuda_ssd_held_to_the_f64_plain_version(B, S, H, P, N, Q, seed):
    """K7 against the plain version run in f64 on the same inputs (the
    referee of ``chip_smoke.py``): within 1e-4, or no farther than twice
    the f32 plain version, which itself is ~1e-4 off at N = 128; on four
    seeds each."""
    dev = _card()
    g = torch.Generator().manual_seed(S + N + 7919 * seed)
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    xbc = torch.randn((B, S, 2 * N), generator=g)
    args = [t.to(dev) for t in (x, dt, A)] + list(
        xbc.to(dev).split([N, N], dim=-1))
    before = ssd.LAUNCHES["ssd_scan"]
    got = ssd.ssd_scan(*args, Q)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_scan"] == before + 1
    plain = ssd.ssd_ref(*args, Q)
    exact = ssd.ssd_ref(*(t.double() for t in args), Q)
    err_k = max(_rel(a, b) for a, b in zip(got, exact))
    err_p = max(_rel(a, b) for a, b in zip(plain, exact))
    assert err_k <= max(1e-4, 2 * err_p)


def test_cuda_reduced_zamba2_prefill_matches_the_cpu():
    """The reduced Zamba2 (f32) on the card, through the kernels — one
    flash launch per group and one SSD launch per Mamba2 block — against
    the same weights on the CPU through the plain versions."""
    dev = _card()
    cfg = get_config("zamba2-7b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 45),
                           generator=torch.Generator().manual_seed(1))
    want, _ = model.prefill(params, {"tokens": tokens})
    params.to(dev)
    before = (fa.LAUNCHES["flash_attention_tf32"], ssd.LAUNCHES["ssd_scan"])
    got, _ = model.prefill(params, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    assert (fa.LAUNCHES["flash_attention_tf32"] - before[0],
            ssd.LAUNCHES["ssd_scan"] - before[1]) == (3, 10)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch,flash,ssd_scans", [
    ("mamba2-2.7b", 0, 4), ("gemma-7b", 4, 0), ("gemma3-27b", 6, 0),
    ("qwen2.5-32b", 4, 0), ("dbrx-132b", 4, 0), ("deepseek-v3-671b", 5, 0)])
def test_cuda_reduced_families_prefill_match_the_cpu(arch, flash, ssd_scans):
    """The reduced ssm, dense and moe archs (f32) on the card, through the
    kernels — one SSD launch a Mamba2 block, one attention launch a dense,
    moe or MLA block (gemma3's local layers windowed: the prompt outruns
    the reduced window of 64) — against the same weights on the CPU
    through the plain versions."""
    dev = _card()
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 100),
                           generator=torch.Generator().manual_seed(1))
    want, _ = model.prefill(params, {"tokens": tokens})
    params.to(dev)
    before = (fa.LAUNCHES["flash_attention_tf32"], ssd.LAUNCHES["ssd_scan"])
    got, _ = model.prefill(params, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    assert (fa.LAUNCHES["flash_attention_tf32"] - before[0],
            ssd.LAUNCHES["ssd_scan"] - before[1]) == (flash, ssd_scans)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def test_cuda_reduced_qwen2_vl_prefill_and_decode_match_the_cpu():
    """The reduced qwen2-vl (f32) on the card, 16 patch embeddings before
    the text at distinct M-RoPE streams: one attention launch a layer in
    the prefill, none in a decode step, against the same weights and
    inputs on the CPU through the plain versions."""
    dev = _card()
    cfg = get_config("qwen2-vl-72b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    nv, S = cfg.n_vision_tokens, 60
    tokens = torch.randint(0, cfg.vocab, (2, S), generator=g)
    patches = torch.randn((2, nv, cfg.d_model), generator=g)
    r = torch.arange(nv) // 4
    vision = torch.stack([torch.zeros(nv, dtype=torch.long), r,
                          torch.arange(nv) % 4])
    pos = torch.cat([vision, torch.arange(S).expand(3, S) + 4], dim=1)
    batch = {"tokens": tokens, "patch_embeds": patches,
             "positions": pos[:, None].expand(3, 2, nv + S)}

    def serve(device):
        cache = model.alloc_cache(2, nv + S + 1, device)
        b = {k: v.to(device) for k, v in batch.items()}
        logits, cache = model.prefill(params, b, cache=cache)
        before = fa.LAUNCHES["flash_attention_tf32"]
        dec, _ = model.decode(params, {
            "token": logits.argmax(-1)[:, None], "cache": cache,
            "pos": torch.full((2,), nv + S, device=device),
            "positions": torch.full((3, 2, 1), S + 4, device=device)})
        return logits, dec, fa.LAUNCHES["flash_attention_tf32"] - before

    want, want_dec, _ = serve("cpu")
    params.to(dev)
    before = fa.LAUNCHES["flash_attention_tf32"]
    got, got_dec, decode_launches = serve(dev)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_tf32"] - before == cfg.n_layers
    assert decode_launches == 0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got_dec.cpu(), want_dec, rtol=1e-3, atol=1e-3)


def test_cuda_reduced_whisper_prefill_and_decode_match_the_cpu():
    """The reduced whisper (f32) on the card: an encoder, a self and a
    cross-attention launch a layer in the prefill (3 + 3 + 3), one
    cross-attention launch a layer (Sq = 1 against the 64 frames) in a
    decode step, against the same weights and inputs on the CPU through
    the plain versions."""
    dev = _card()
    cfg = get_config("whisper-medium", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 45), generator=g)
    frames = torch.randn((2, cfg.enc_len, cfg.d_model), generator=g)

    def serve(device):
        cache = model.alloc_cache(2, 46, device)
        logits, cache = model.prefill(params, {
            "tokens": tokens.to(device), "enc_embeds": frames.to(device)},
            cache=cache)
        before = fa.LAUNCHES["flash_attention_tf32"]
        dec, _ = model.decode(params, {
            "token": logits.argmax(-1)[:, None], "cache": cache,
            "pos": torch.full((2,), 45, device=device)})
        return logits, dec, fa.LAUNCHES["flash_attention_tf32"] - before

    want, want_dec, _ = serve("cpu")
    params.to(dev)
    before = fa.LAUNCHES["flash_attention_tf32"]
    got, got_dec, decode_launches = serve(dev)
    torch.cuda.synchronize()
    assert decode_launches == cfg.n_layers
    assert fa.LAUNCHES["flash_attention_tf32"] - before == \
        cfg.n_enc_layers + 2 * cfg.n_layers + decode_launches
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got_dec.cpu(), want_dec, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_prefill_matches_plain_version(dtype, monkeypatch):
    """deepseek-v3's MLA prefill at the reduced widths (q/k 16 + 8 = 24, v
    16: K6 at width 24, v zero-padded) on the card, one K6 launch, against
    the same layer through the plain attention on the card (the K6
    tolerances: 2e-5 f32 on the attention, 1e-4 after the projections;
    2e-2 bf16)."""
    from repro_torch.models import attention
    dev = _card()
    dt = getattr(torch, dtype)
    cfg = get_config("deepseek-v3-671b", reduced=True).replace(
        param_dtype=dtype, compute_dtype=dtype)
    p = init_params(attention.mla_specs(cfg), dt,
                    torch.Generator(dev).manual_seed(0))
    x = torch.randn((2, 150, cfg.d_model), generator=torch.Generator(
        dev).manual_seed(1), device=dev).to(dt)
    pos = torch.arange(150, device=dev)[None].expand(2, 150)
    name = fa.kernel_for(dt, 24)
    before = fa.LAUNCHES[name]
    got, (c, r) = attention.mla_train(p, cfg, x, pos)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[name] == before + 1
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda q, k, v, **kw: fa.flash_attention_ref(
                            q, k, v, scale=kw["scale"], causal=kw["causal"],
                            chunk=kw["chunk"]))
    want, (wc, wr) = attention.mla_train(p, cfg, x, pos)
    assert fa.LAUNCHES[name] == before + 1
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(c, wc) and torch.equal(r, wr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_reduced_dbrx_prefill_is_bitwise_repeatable(dtype):
    """Two prefills of the reduced dbrx-132b on the same weights and
    tokens give the same bits: the moe combine adds each token's experts
    in a fixed order, with no atomics."""
    dev = _card()
    cfg = get_config("dbrx-132b", reduced=True).replace(
        param_dtype=dtype, compute_dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (4, 256), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    a, ca = model.prefill(params, {"tokens": tokens})
    b, cb = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ca["moe"], cb["moe"]))


def _engine_pair(config, T=60, **kw):
    from repro_torch import sched
    inst = generate_instance(seed=0)
    sch = stats.schedule_table(T, inst.m, stats.delta_default,
                               stats.g_logt_only, "cpu")
    return [sched.DispatchEngine(inst, T, config, seed=3, device=dev,
                                 schedule=sch, **kw) for dev in ("cuda",
                                                                 "cpu")]


def _engine_same(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    for k in a.ledger:
        np.testing.assert_array_equal(np.asarray(a.ledger[k]),
                                      np.asarray(b.ledger[k]), err_msg=k)


ENGINE_BITWISE = ("x", "queue_len", "routed_variant", "dispatched_variant",
                  "n", "sumz")


@pytest.mark.parametrize("backpressure", ["drop_oldest", "block",
                                          "shed_by_utility"])
def test_cuda_engine_stream_lockstep_batch_and_cpu(backpressure):
    """The streaming engine on the card, A/B (ESDP 0.9 / HSWF 0.1) at
    queue capacity 1 under triple arrivals: the stream loop reads nothing
    back (``set_sync_debug_mode("error")`` around it), lockstep equals
    stream on every field, ``run_batch`` each seed's ``run``, one K1/K2
    forward and one epilogue a slot, and the CPU run (plain versions) the
    same on the bitwise fields."""
    _card()
    import warnings

    from repro_torch import sched
    cfg = sched.EngineConfig(
        queue_capacity=1, backpressure=backpressure,
        variants=(sched.VariantSpec("esdp", weight=0.9),
                  sched.VariantSpec("c", kind="hswf", weight=0.1)))
    card, cpu = _engine_pair(cfg, arr_scale=3.0)
    lock = card.run(mode="lockstep")  # also makes the device constants
    one = card._inputs([card._streams(3)], [3])
    fleet = card._inputs([card._streams(s) for s in (3, 4, 5)], [3, 4, 5])
    before = dict(LAUNCHES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, recs, _ = card._horizon(one, 1)
            card._horizon(fleet, 3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert moved == dict(dp_forward_batched=2 * card.T, dp_edge=0,
                         dp_chunk=0, dp_epilogue=2 * card.T)
    stream = card.run(mode="stream")
    np.testing.assert_array_equal(stream.x, recs["x"].cpu().numpy()[:, 0])
    fields = ENGINE_BITWISE + ("sw", "regret", "dispatch_share",
                               "sw_variant", "regret_variant")
    _engine_same(stream, lock, fields)
    for s, out in zip((3, 4, 5), card.run_batch([3, 4, 5])):
        _engine_same(out, card.run(mode="stream", seed=s), fields)
    _engine_same(stream, cpu.run(mode="stream"), ENGINE_BITWISE)


def _warm_sequence(inst, T, n, seed):
    """``n`` solves of drifting statistics at a horizon-T plane: each step
    changes one low-index edge (a late fold step), the first edge, the
    budget only, eligibility, or nothing."""
    rng = np.random.default_rng(seed)
    E, m = inst.n_edges, inst.m
    xi = stats.u_max_for_horizon(T, m) - 1
    ups = rng.integers(0, xi + 1, E).astype(np.int32)
    sig = rng.integers(1, 2 ** 16, E).astype(np.int32)
    alw = rng.random(E) < 0.8
    s_cap = stats.s_cap_for_horizon(T, m)
    lim, out = s_cap, []
    for i in range(n):
        kind = i % 5
        if kind == 0:
            e = int(rng.integers(0, E // 4))
            ups[e], sig[e] = rng.integers(0, xi + 1), rng.integers(1, 2 ** 16)
        elif kind == 1:
            sig[E - 1] = rng.integers(1, 2 ** 16)
        elif kind == 2:
            lim = int(rng.integers(0, s_cap + 1))
        elif kind == 3:
            alw[int(rng.integers(0, E))] ^= True
        out.append((ups.copy(), sig.copy(), alw.copy(), lim))
    return out


@pytest.mark.parametrize("c_hi,seed,T,k", [(2, 0, 2000, 8), (6, 2, 1500, 8),
                                           (6, 2, 1500, 20)],
                         ids=["table2_whole", "fig6_tiled", "fig6_tiled_k20"])
def test_cuda_warm_solver_bit_equal_to_cold_solves(c_hi, seed, T, k):
    """``WarmCudaSolver`` on the card: every solve bit-equal to the cold
    CUDA solve, on a whole plane (one ``dp_forward_batched`` launch a
    segment) and on the fig-6 c_hi = 6 plane (``dp_chunk`` launches);
    forward launches = ``segments_launched``, one epilogue a solve."""
    dev = _card()
    inst = generate_instance(seed=seed, c_lo=1, c_hi=c_hi)
    tables = build_tables(inst.A, inst.c)
    s_cap = stats.s_cap_for_horizon(T, inst.m)
    u_max = stats.u_max_for_horizon(T, inst.m)
    warm = ops.WarmCudaSolver(tables, s_cap, u_max=u_max,
                              checkpoint_every=k, device=dev)
    fwd = "dp_forward_batched" if c_hi == 2 else "dp_chunk"
    before = dict(LAUNCHES)
    seq = _warm_sequence(inst, T, 25, seed)
    for u, s, a, lim in seq:
        x, info = warm(torch.as_tensor(u, device=dev),
                       torch.as_tensor(s, device=dev), tables, s_cap, lim,
                       allowed=torch.as_tensor(a, device=dev))
        cx, cinfo = ops.solve_budgeted_dp_batched(
            torch.as_tensor(u[None], device=dev),
            torch.as_tensor(s[None], device=dev), tables, s_cap, lim,
            u_max=u_max, allowed=torch.as_tensor(a[None], device=dev))
        torch.cuda.synchronize()
        assert torch.equal(x, cx[0])
        assert int(info["s_star"]) == int(cinfo["s_star"][0])
        assert torch.equal(info["value_row"], cinfo["value_row"][0])
    st = warm.stats
    assert st["solves"] == len(seq) and st["segments_skipped"] > 0
    assert LAUNCHES[fwd] - before[fwd] == st["segments_launched"] + len(seq)
    assert LAUNCHES["dp_epilogue"] - before["dp_epilogue"] == 2 * len(seq)


def test_cuda_tabled_epilogue_bit_equal_to_plain_version():
    """The epilogue's tabled instance on a segmented packing — three
    instances, E = 40 folded in segments of 8 edges chained through each
    instance's plane, each segment packed from bit 0 of its own word —
    against its plain version, and against the default epilogue on the
    same forward packed by global edge id."""
    dev = _card()
    rng = np.random.default_rng(5)
    E, B, s_cap, k = 40, 3, 200, 8
    A = rng.integers(1, 3, (3, E))
    c = np.array([5, 5, 5])
    tables = build_tables(np.minimum(A, c[:, None]), c)
    feas, offs = (torch.as_tensor(a) for a in ops.prepare_tables(tables))
    ups = torch.as_tensor(rng.integers(0, 5, (B, E)), dtype=torch.int32)
    sig = torch.as_tensor(rng.integers(1, 2 ** 16, (B, E)),
                          dtype=torch.int32)
    alw = torch.as_tensor(rng.random((B, E)) < 0.8).int()
    slim = torch.as_tensor(rng.integers(0, s_cap + 1, B), dtype=torch.int32)
    v0 = initial_plane(s_cap, tables.n_states, "cpu")
    bounds = [(max(E - (si + 1) * k, 0), E - si * k)
              for si in range(-(-E // k))]
    rows = np.concatenate([np.full(hi - lo, si) for si, (lo, hi) in
                           enumerate(bounds)][::-1]).astype(np.int32)
    bits = np.concatenate([np.arange(hi - lo) for lo, hi in bounds][::-1])
    rows, bits = torch.as_tensor(rows), torch.as_tensor(bits.astype(np.int32))
    planes, packs = [], []
    for b in range(B):
        vin, ws = v0, []
        for lo, hi in bounds:
            V, W = ref.dp_forward_ref(*(t[b:b + 1, lo:hi].contiguous()
                                        for t in (ups, sig, alw)),
                                      feas[lo:hi].contiguous(),
                                      offs[lo:hi].contiguous(), vin)
            vin = V[0]
            ws.append(W)
        planes.append(vin)
        packs.append(torch.cat(ws, dim=1))
    V, words = torch.stack(planes), torch.cat(packs)
    want = ref.dp_epilogue_ref(V, words, ups, offs, slim, tables.full_state,
                               rows, bits)
    Vg, Wg = ref.dp_forward_ref(ups, sig, alw, feas, offs, v0)
    for a, b in zip(want, ref.dp_epilogue_ref(Vg, Wg, ups, offs, slim,
                                              tables.full_state)):
        assert torch.equal(a, b)
    before = LAUNCHES["dp_epilogue"]
    got = kernel.dp_epilogue(V.to(dev), words.to(dev), ups.to(dev),
                             offs.to(dev), slim.to(dev), tables.full_state,
                             rows.to(dev), bits.to(dev))
    torch.cuda.synchronize()
    assert LAUNCHES["dp_epilogue"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    # an entry outside the packing is refused before the launch
    for bad_rows, bad_bits in ((rows + words.shape[1], bits),
                               (rows, bits + 32)):
        with pytest.raises(ValueError, match="outside"):
            kernel.dp_epilogue(V.to(dev), words.to(dev), ups.to(dev),
                               offs.to(dev), slim.to(dev), tables.full_state,
                               bad_rows.to(dev), bad_bits.to(dev))
    assert LAUNCHES["dp_epilogue"] == before + 1


@pytest.mark.parametrize("dtype,hd,vh,kernel_name", [
    ("bfloat16", 192, 128, "flash_attention_wgmma"),  # deepseek-v3 MLA
    ("bfloat16", 64, 32, "flash_attention_wgmma"),
    ("float32", 24, 16, "flash_attention_tf32"),
    ("float32", 16, 24, "flash_attention_tf32"),
])
def test_cuda_flash_attention_with_v_head_dim_other_than_qk(dtype, hd, vh, kernel_name):
    """v's head dim differs from q/k's: the wrapper runs the kernel at
    max(hd, vh) on zero columns and returns (…, vh), within the K6
    tolerances of the plain version (2e-5 f32, 2e-2 bf16)."""
    dev = _card()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(hd + vh)
    q = torch.randn((2, 150, 8, hd), generator=g).to(dev, dt)
    k = torch.randn((2, 150, 2, hd), generator=g).to(dev, dt)
    v = torch.randn((2, 150, 2, vh), generator=g).to(dev, dt)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, scale=hd ** -0.5, window=64)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[kernel_name] == before[kernel_name] + 1
    assert tuple(got.shape) == (2, 150, 8, vh) and got.dtype == dt
    want = fa.flash_attention_ref(q, k, v, scale=hd ** -0.5, window=64)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _epilogue_case(case, tabled):
    """CPU operands of the epilogue: (V, words, Υ̂, offsets, s_limit,
    full_state, word_rows, bits), the words from ``ref.dp_forward_ref``.
    ``case`` is an edge count (B = 7 random instances, Υ̂ up to s_cap + 1
    and small budgets, so walks clamp at 0), "ties" (two budgets tie on
    the eq.-17 score, 0 + √9 = 1 + √4, at E = 33) or "no_feasible"
    (s_limit = −1).  ``tabled``: the forward runs in segments of
    ⌈E/3⌉ edges chained through each plane, each packed from bit 0 of its
    own words, with the (word row, bit) table that finds each edge."""
    if case == "ties":
        E, B, s_cap = 33, 2, 3
        A, c = np.ones((1, E), np.int64), np.array([1])
        ups = np.zeros((B, E), np.int32)
        sig = np.tile(np.arange(1, E + 1, dtype=np.int32), (B, 1))
        ups[:, E - 2], sig[:, E - 2], sig[:, E - 1] = 1, 4, 9
        alw = np.zeros((B, E), bool)
        alw[:, E - 2:] = True
        slim = np.full(B, s_cap, np.int32)
    else:
        E = 33 if case == "no_feasible" else case
        B, s_cap = 7, 12
        rng = np.random.default_rng(E)
        A = rng.integers(1, 3, (2, E))
        c = rng.integers(1, 5, 2)
        A = np.minimum(A, c[:, None])
        ups = rng.integers(0, s_cap + 2, (B, E)).astype(np.int32)
        sig = rng.integers(1, 5000, (B, E)).astype(np.int32)
        alw = rng.random((B, E)) < 0.7
        slim = (np.full(B, -1, np.int32) if case == "no_feasible"
                else rng.integers(1, s_cap // 2, B).astype(np.int32))
    tables = build_tables(A, c)
    feas, offs = (torch.as_tensor(a) for a in ops.prepare_tables(tables))
    ups, sig, alw, slim = (torch.as_tensor(a) for a in (ups, sig,
                                                       alw.astype(np.int32),
                                                       slim))
    v0 = initial_plane(s_cap, tables.n_states, "cpu")
    if not tabled:
        V, W = ref.dp_forward_ref(ups, sig, alw, feas, offs, v0)
        return V, W, ups, offs, slim, tables.full_state, None, None
    k = -(-E // 3)
    bounds = [(max(E - (si + 1) * k, 0), E - si * k)
              for si in range(-(-E // k))]
    rows, bits, w_off = np.zeros(E, np.int32), np.zeros(E, np.int32), 0
    for lo, hi in bounds:
        rows[lo:hi] = w_off + np.arange(hi - lo) // 32
        bits[lo:hi] = np.arange(hi - lo) % 32
        w_off += -(-(hi - lo) // 32)
    planes, packs = [], []
    for b in range(B):
        vin, ws = v0, []
        for lo, hi in bounds:
            Vs, Ws = ref.dp_forward_ref(*(t[b:b + 1, lo:hi].contiguous()
                                          for t in (ups, sig, alw)),
                                        feas[lo:hi].contiguous(),
                                        offs[lo:hi].contiguous(), vin)
            vin = Vs[0]
            ws.append(Ws)
        planes.append(vin)
        packs.append(torch.cat(ws, dim=1))
    return (torch.stack(planes), torch.cat(packs), ups, offs, slim,
            tables.full_state, torch.as_tensor(rows), torch.as_tensor(bits))


@pytest.mark.parametrize("tabled", [False, True], ids=["default", "tabled"])
@pytest.mark.parametrize("case", [1, 5, 6, 31, 32, 33, 64, 65, "ties",
                                  "no_feasible"])
def test_cuda_epilogue_bit_equal_to_plain_version_on_risky_walks(case, tabled):
    """Both epilogue instances, one counted launch each: x, s* and the
    value row bit-equal to ``ref.dp_epilogue_ref`` at E around the
    look-ahead window (5 edges) and the 32-edge word, with walks that clamp
    at 0, tied scores and no feasible budget."""
    dev = _card()
    V, W, ups, offs, slim, full, rows, bits = _epilogue_case(case, tabled)
    want = ref.dp_epilogue_ref(V, W, ups, offs, slim, full, rows, bits)
    if case == "ties":
        assert (want[1] == 0).all() and (want[2][:, :2] == torch.tensor(
            [9, 4], dtype=torch.int32)).all()
    rd, bd = ((None, None) if rows is None
              else kernel.epilogue_table(rows.numpy(), bits.numpy(), dev))
    before = LAUNCHES["dp_epilogue"]
    got = kernel.dp_epilogue(*(t.to(dev) for t in (V, W, ups, offs, slim)),
                             full, rd, bd)
    torch.cuda.synchronize()
    assert LAUNCHES["dp_epilogue"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_cuda_tabled_epilogue_reads_nothing_back():
    """The warm solver's tabled epilogue call under
    ``torch.cuda.set_sync_debug_mode("error")``: its table was checked on
    the host when the solver was built, so the call makes no synchronising
    read, and its solves equal the cold ones."""
    dev = _card()
    inst = generate_instance(seed=0)
    tables = build_tables(inst.A, inst.c)
    s_cap = stats.s_cap_for_horizon(2000, inst.m)
    warm = ops.WarmCudaSolver(tables, s_cap, checkpoint_every=8, device=dev)
    real = ops.dp_epilogue

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    ops.dp_epilogue = strict
    try:
        for u, s, a, lim in _warm_sequence(inst, 2000, 6, 3):
            x, info = warm(torch.as_tensor(u, device=dev),
                           torch.as_tensor(s, device=dev), tables, s_cap, lim,
                           allowed=torch.as_tensor(a, device=dev))
            cx, cinfo = ops.solve_budgeted_dp_batched(
                torch.as_tensor(u[None], device=dev),
                torch.as_tensor(s[None], device=dev), tables, s_cap, lim,
                allowed=torch.as_tensor(a[None], device=dev))
            assert torch.equal(x, cx[0])
            assert int(info["s_star"]) == int(cinfo["s_star"][0])
    finally:
        ops.dp_epilogue = real
    # a table made on the card by hand is read back, once, and not again
    rows, bits = warm._w_rows.clone(), warm._bits.clone()
    V = warm._planes[-1][None]
    args = (V, warm._words_cat, torch.as_tensor(u[None], device=dev),
            warm._offs, torch.full((1,), s_cap, dtype=torch.int32,
                                   device=dev), tables.full_state)
    kernel.dp_epilogue(*args, rows, bits)
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernel.dp_epilogue(*args, rows, bits)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("chained", [True, False],
                         ids=["chained", "one_launch_at_a_time"])
@pytest.mark.parametrize("plane", ["fig6_c_hi6", "E16_C512_S4096"])
def test_cuda_dp_edge_bit_equal_to_plain_version(plane, chained):
    """K3 (``dp_edge``) over every edge of the fig-6 c_hi = 6 plane at T =
    1500 and ``benchmarks/dp_bench.py``'s E16_C512_S4096 problem, each
    launch chained to the one before (programmatic dependent launch) or
    not: planes and words bit-equal to ``ref.dp_forward_ref``, one counted
    launch an edge."""
    dev = _card()
    rng = np.random.default_rng(16)
    if plane == "fig6_c_hi6":
        inst = generate_instance(seed=2, c_lo=1, c_hi=6)
        tables = build_tables(inst.A, inst.c)
        s_cap = stats.s_cap_for_horizon(1500, inst.m)
        u_hi = stats.u_max_for_horizon(1500, inst.m)
    else:  # dp_bench.py::_make_problem(16, (7, 7, 7), 3)
        A = rng.integers(0, 2, (3, 16))
        A[:, A.sum(axis=0) == 0] = 1
        tables = build_tables(A, np.array([7, 7, 7]))
        s_cap, u_hi = 4095, 3
    feas, offs = (torch.as_tensor(a, device=dev)
                  for a in ops.prepare_tables(tables))
    v0 = initial_plane(s_cap, tables.n_states, dev)
    E = offs.shape[0]
    B = 1
    ups = torch.as_tensor(rng.integers(0, u_hi + 1, (B, E)),
                          dtype=torch.int32, device=dev)
    sig = torch.as_tensor(rng.integers(1, 5000, (B, E)), dtype=torch.int32,
                          device=dev)
    alw = torch.as_tensor(rng.random((B, E)) < 0.7, device=dev).int()
    Vp, Wp = ref.dp_forward_ref(ups, sig, alw, feas, offs, v0)
    before = LAUNCHES["dp_edge"]
    if chained:
        V, W = kernel.dp_forward_blocked(ups, sig, alw, feas, offs, v0)
    else:
        W = torch.zeros_like(Wp)
        bufs = [torch.empty_like(Vp) for _ in range(2)]
        V = v0
        for n, e in enumerate(range(E - 1, -1, -1)):
            V, W = kernel.dp_edge(V, bufs[n % 2], W, ups, sig, alw, feas,
                                  offs, e)
    torch.cuda.synchronize()
    assert LAUNCHES["dp_edge"] == before + E
    assert torch.equal(V, Vp) and torch.equal(W, Wp)


def test_cuda_fallback_chain_exact_and_counted():
    """``FallbackSolver`` with the ``cuda`` link on the card and faults at
    30%: every solve equals the fault-free cuda solve, on the card; the
    ``reference`` link ran on CPU copies; the whole-plane forward launched
    once for each cuda attempt that was not refused before launching."""
    from repro_torch.core.solvers import FallbackSolver
    dev = _card()
    inst = generate_instance(seed=0)
    tables = build_tables(inst.A, inst.c)
    s_cap = stats.s_cap_for_horizon(2000, inst.m)
    rng = np.random.default_rng(3)
    E, B, n = inst.n_edges, 4, 24
    cuda = get_solver("cuda")
    fb = FallbackSolver(chain=("cuda", "reference"), fault_rate=0.3,
                        fault_seed=5)
    before = LAUNCHES["dp_forward_batched"]
    for _ in range(n):
        ups = torch.as_tensor(rng.integers(0, 60, (B, E)), dtype=torch.int32,
                              device=dev)
        sig = torch.as_tensor(rng.integers(1, 5000, (B, E)),
                              dtype=torch.int32, device=dev)
        alw = torch.as_tensor(rng.random((B, E)) < 0.7, device=dev)
        slim = torch.full((B,), s_cap, dtype=torch.int32, device=dev)
        x, info = fb(ups, sig, tables, s_cap, slim, allowed=alw)
        assert x.device.type == dev.type
        assert info["value_row"].device.type == dev.type
        xw, infow = cuda(ups, sig, tables, s_cap, slim, allowed=alw)
        assert torch.equal(x, xw)
        assert torch.equal(info["s_star"], infow["s_star"])
        assert torch.equal(info["value_row"], infow["value_row"])
    torch.cuda.synchronize()
    st = fb.stats
    assert st["calls"] == n and st["degraded_calls"] > 0
    assert st["served_by"]["reference"] == st["degraded_calls"]
    # the fault-free cuda solves above launched n times
    assert LAUNCHES["dp_forward_batched"] - before == (
        n - st["launch_failures"]) + n


def test_cuda_fluctuating_simulate_equals_cpu():
    """ESDP on Table 2 under a ``power_coupled`` trace (unrolled on the
    CPU, replayed on both), T 120, B 3: the card's decisions equal the CPU
    int32 reference's on the same draws and schedule — the fluctuated mean
    rounds once on the card (``addcmul``) as on the CPU."""
    from repro_torch.core import Draws, replay_scenario, simulate_batch
    from repro_torch.experiments import get_scenario, unroll_scenario
    dev = _card()
    inst = generate_instance(seed=0)
    tables = build_tables(inst.A, inst.c)
    T, seeds = 120, [0, 1, 2]
    scn = get_scenario("power_coupled")
    traces = [unroll_scenario(scn, T, inst.n_servers, s,
                              n_ports=inst.n_ports, device="cpu")
              for s in seeds]
    replay = replay_scenario(*(np.stack([tr[k] for tr in traces])
                               for k in range(3)), fluctuates=True)
    draws = [make_draws(inst, T, s, dev) for s in seeds]
    draws = Draws(*(torch.cat([getattr(d, k) for d in draws])
                    for k in ("arr_u", "val_n", "pol_u")))
    sched = stats.schedule_table(T, inst.m, device="cpu")
    policy = esdp.make_esdp_policy(inst, T, tables=tables)
    card = simulate_batch(inst, policy, T, seeds, tables=tables, device=dev,
                          scenario=replay, draws=draws, schedule=sched)
    cpu = simulate_batch(inst, policy, T, seeds, tables=tables,
                         device="cpu", scenario=replay, schedule=sched,
                         draws=Draws(*(getattr(draws, k).cpu() for k in (
                             "arr_u", "val_n", "pol_u"))))
    np.testing.assert_array_equal(card.x, cpu.x)
    np.testing.assert_allclose(card.sw, cpu.sw, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# training: the attention and SSD backward kernels and their autograd
# Functions.  The f32 backward kernels are held to the plain backward run in
# f64 on the same inputs: no farther than twice the f32 plain version plus
# 1e-5; the bf16 attention backward no farther than 1.5 times the bf16
# plain version plus 2e-3 (the gradients are rounded to bf16 once, ~4e-3
# relative).  Two runs of either backward give the same bits.
# ---------------------------------------------------------------------------

def _flash_case(B, Sq, Sk, H, KH, hd, vh, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to(dev, dtype)
                   for shape in ((B, Sq, H, hd), (B, Sk, KH, hd),
                                 (B, Sk, KH, vh), (B, Sq, H, vh)))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KH,hd,vh,causal,window", [
    (2, 200, 200, 8, 2, 128, 128, True, 0),  # GQA, ragged tiles
    (1, 130, 130, 4, 4, 256, 256, True, 0),  # gemma's D 256
    (1, 300, 300, 4, 2, 64, 64, True, 100),  # a window
    (2, 77, 300, 4, 4, 64, 64, False, 0),  # cross: Sq < Sk, bidirectional
    (1, 150, 150, 4, 4, 192, 128, True, 0),  # MLA: q/k 192, v 128
    (1, 96, 96, 4, 2, 112, 112, True, 0),  # zamba2's D 112
    # several key and query tiles of the tensor-core kernels (128 fixed
    # rows, 32 or 64 streamed), qwen2.5-32b's GQA ratio 5:1
    (1, 1024, 1024, 10, 2, 128, 128, True, 0),
    # S a multiple of none of those tiles, bidirectional
    (2, 421, 421, 6, 3, 64, 64, False, 0),
    (2, 256, 256, 8, 4, 64, 64, True, 0),  # tiny-100m's heads 8:4 of 64
    (1, 300, 300, 8, 2, 112, 112, True, 64),  # D 112, GQA and a window
])
def test_cuda_flash_bwd_held_to_the_f64_plain_version(
    dtype, B, Sq, Sk, H, KH, hd, vh, causal, window
):
    dev = _card()
    q, k, v, do = _flash_case(B, Sq, Sk, H, KH, hd, vh, dtype, dev,
                              Sq + hd + vh)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    # the log-sum-exp leaves the output's bits alone
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == dict(before, flash_attention_bwd=before[
        "flash_attention_bwd"] + 2)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    d64 = [t.double() for t in (q, k, v, do)]
    o64, lse64 = fa.flash_attention_ref(*d64[:3], return_lse=True, **kw)
    exact = fa.flash_attention_bwd_ref(*d64[:3], o64, lse64, d64[3], **kw)
    # both kernels form the logits in f32 from the inputs' exact products
    torch.testing.assert_close(lse.double(), lse64, rtol=1e-5, atol=1e-4)
    po, plse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    plain = fa.flash_attention_bwd_ref(q, k, v, po, plse, do, **kw)
    for a, p, e in zip(got, plain, exact):
        assert a.dtype == dtype and a.shape == e.shape
        err_k, err_p = _rel(a, e), _rel(p, e)
        if dtype == torch.float32:
            assert err_k <= 2 * err_p + 1e-5, (err_k, err_p)
        else:
            assert err_k <= 1.5 * err_p + 2e-3, (err_k, err_p)


@pytest.mark.parametrize("hd", [64, 112, 128])
def test_cuda_flash_bwd_tf32_streamed_row_order_on_distinct_rows(hd):
    """The f32 backward's fragment remap (k-position t of the split-TF32
    products is streamed row 2t and t + 4 is row 2t + 1, in P's and dS's
    A fragments as in dO's, Q's and K's B fragments): every row of dO
    (streamed in the dK/dV kernel, with Q) and of K (streamed in the dQ
    kernel) holds its own values, 1/S apart from its neighbour's, and
    neighbouring queries' probabilities differ, so a row taken for its
    neighbour moves dq, dk and dv by ~1e-3, far past the gate: no farther
    from the f64 plain backward than twice the f32 plain version + 1e-5,
    and two runs bitwise equal."""
    dev = _card()
    B, S, H, KH = 1, 192, 4, 2
    g = torch.Generator().manual_seed(hd)
    q, v = (torch.randn(shape, generator=g).to(dev)
            for shape in ((B, S, H, hd), (B, S, KH, hd)))
    i = torch.arange(S, dtype=torch.float32)[:, None, None]
    d = torch.arange(hd, dtype=torch.float32)
    k = ((i * hd + d + 0.5 * torch.arange(KH)[:, None]) / (S * hd) * 4.0
         - 2.0)[None].to(dev).contiguous()
    do = ((i * hd + d + 0.5 * torch.arange(H)[:, None]) / (S * hd)
          )[None].to(dev).contiguous()
    assert torch.unique(k[0, :, 0, 0]).numel() == S
    assert torch.unique(do[0, :, 0, 0]).numel() == S
    kw = dict(scale=hd ** -0.5, causal=True, window=0)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    d64 = [t.double() for t in (q, k, v, do)]
    o64, lse64 = fa.flash_attention_ref(*d64[:3], return_lse=True, **kw)
    exact = fa.flash_attention_bwd_ref(*d64[:3], o64, lse64, d64[3], **kw)
    po, plse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    plain = fa.flash_attention_bwd_ref(q, k, v, po, plse, do, **kw)
    for a, p, e in zip(got, plain, exact):
        err_k, err_p = _rel(a, e), _rel(p, e)
        assert err_k <= 2 * err_p + 1e-5, (err_k, err_p)


def test_cuda_esdp_runs_refuse_a_horizon_over_the_value_bound():
    """An m-37 instance at T 4515 whose capacities let 11 edges be
    selected: DP values can reach 11 x 93,101,292 ≥ 2^29.  ``simulate``,
    ``ClusterSim.run`` and ``DispatchEngine`` on the card raise the
    solves' ValueError before the first slot, reading the schedule once
    and launching no kernel; HSWF on the same instance solves no DP and
    runs."""
    from repro_torch.sched import ClusterSim
    dev = _card()
    inst = generate_instance(seed=2, edge_prob=0.22, c_lo=3, c_hi=4)
    assert inst.m == 37
    T = 4515
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="2\\^29 over this horizon"):
        simulate(inst, esdp.make_esdp_policy(inst, T), T, device=dev)
    sim = ClusterSim(inst, T, g_fn=stats.g_default, device=dev)
    with pytest.raises(ValueError, match="2\\^29 over this horizon"):
        sim.run()
    with pytest.raises(ValueError, match="2\\^29 over this horizon"):
        sim.engine()
    torch.cuda.synchronize()
    assert LAUNCHES == before
    out = ClusterSim(inst, 40, g_fn=stats.g_default, device=dev).run("hswf")
    assert out.x.shape == (40, inst.n_edges)


@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 256, 3, 64, 128, 128),  # Mamba2-2.7B's P, N and chunk
    # several head groups, the last one short (H 22 over groups of 4)
    (1, 256, 22, 64, 128, 128),
    (1, 300, 4, 64, 64, 128),  # Zamba2's N, a ragged last chunk
    (2, 90, 2, 32, 16, 32),  # small, ragged
    (1, 20, 3, 16, 8, 64),  # S < chunk
])
def test_cuda_ssd_bwd_held_to_the_f64_plain_version(B, S, H, P, N, Q):
    _check_ssd_bwd(B, S, H, P, N, Q, with_dstate=True)


def test_cuda_ssd_bwd_without_a_final_state_gradient():
    """The Mamba2 training path's call: whole chunks and no final-state
    gradient (the kernel's null-pointer branch), held as above."""
    _check_ssd_bwd(2, 512, 3, 64, 128, 128, with_dstate=False)


def _check_ssd_bwd(B, S, H, P, N, Q, with_dstate):
    dev = _card()
    g = torch.Generator().manual_seed(S + N)
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    xbc = torch.randn((B, S, 2 * N), generator=g)
    dy = torch.randn((B, S, H, P), generator=g)
    dstate = torch.randn((B, H, N, P), generator=g)
    args = [t.to(dev) for t in (x, dt, A)] + list(
        xbc.to(dev).split([N, N], dim=-1))
    dy, dstate = dy.to(dev), dstate.to(dev) if with_dstate else None
    y, st, states, cum = ssd.ssd_scan_saved(*args, Q)
    before = ssd.LAUNCHES["ssd_bwd"]
    got = ssd.ssd_bwd(*args, Q, dy, dstate, states, cum)
    again = ssd.ssd_bwd(*args, Q, dy, dstate, states, cum)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd_bwd"] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    exact = ssd.ssd_bwd_ref(*(t.double() for t in args), Q, dy.double(),
                            dstate.double() if with_dstate else None)
    plain = ssd.ssd_bwd_ref(*args, Q, dy, dstate)
    for name, a, p, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, plain,
                             exact):
        assert a.shape == e.shape, name
        scale = float(e.abs().max())  # dA sums thousands of terms
        err_k = _rel(a / scale, e / scale)
        err_p = _rel(p / scale, e / scale)
        assert err_k <= 2 * err_p + 1e-5, (name, err_k, err_p)


def test_cuda_autograd_functions_held_to_the_f64_cpu_graph():
    """FlashAttentionFn and SsdFn under autograd on the card (x, B and C as
    strided views of one tensor, as the model splits them) against the
    same graph run in f64 on the CPU (the plain versions): each gradient
    no farther from it than twice the f32 CPU graph's, plus 1e-5, over
    the gradient scaled to max |f64| = 1 (dC sums products over heads and
    steps that cancel, so an elementwise f32 tolerance does not hold)."""
    dev = _card()
    g = torch.Generator().manual_seed(5)
    B, S, H, KH, hd, P, N = 2, 96, 4, 2, 64, 32, 16
    base = [torch.randn(s, generator=g) for s in
            ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd),
             (B, S, H * P + 2 * N), (B, S, H), (H,))]
    outs = {}
    for name, d, dtype in (("card", dev, torch.float32),
                           ("cpu", "cpu", torch.float32),
                           ("f64", "cpu", torch.float64)):
        leaves = [t.to(d, dtype).requires_grad_() for t in base]
        q, k, v, xbc, dtr, Alog = leaves
        a = fa.flash_attention_op(q, k, v, scale=hd ** -0.5, causal=True,
                                  chunk=32) if dtype == torch.float32 else \
            fa.flash_attention_ref(q, k, v, scale=hd ** -0.5, causal=True,
                                   chunk=32)
        xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
        args = (xs.reshape(B, S, H, P), torch.nn.functional.softplus(dtr),
                -torch.exp(Alog), Bm, Cm)
        y = (ssd.ssd_op(*args, 32) if dtype == torch.float32
             else ssd.ssd_ref(*args, 32))[0]
        loss = (a * a).sum() + (y * y).sum()
        outs[name] = [t.detach().cpu().double() for t in
                      torch.autograd.grad(loss, leaves)]
    for c, p, e in zip(outs["card"], outs["cpu"], outs["f64"]):
        scale = float(e.abs().max())
        err_c, err_p = _rel(c / scale, e / scale), _rel(p / scale, e / scale)
        assert err_c <= 2 * err_p + 1e-5, (err_c, err_p)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "mamba2-2.7b", "zamba2-7b"])
def test_cuda_reduced_train_step_matches_the_cpu(arch):
    """One train step of the reduced config in f32 on the card (through
    the forward and backward kernels) against the same step on the CPU.
    AdamW's eps is 1e-4 and the parameters' floor 2e-6 (2e-3 of lr):
    where a gradient entry is near its own rounding noise, m/(√v + eps)
    turns the card's and the CPU's different summation orders into
    different steps (2e-5 seen at eps 1e-8; see
    ``tests/test_torch_train_step.py``)."""
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainState, make_train_step
    from repro_torch.data import SyntheticLM
    dev = _card()
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=2,
                        seed=0).batch(0)
    results = {}
    for d in ("cpu", dev):
        opt = AdamW(lr=1e-3, eps=1e-4)
        # the same draws on both: made on the CPU, then moved
        params = model.init(torch.Generator().manual_seed(0),
                            trainable=True).to(d)
        state = TrainState(params=params, opt=opt.init(params), err=None)
        step = make_train_step(model, opt, remat="full")
        tb = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
        before = (dict(fa.LAUNCHES), dict(ssd.LAUNCHES))
        state, metrics = step(state, tb)
        results[str(d)] = (float(metrics["loss"]),
                           float(metrics["grad_norm"]),
                           {n: p.detach().cpu() for n, p in
                            state.params.named_parameters()})
        if d != "cpu":
            torch.cuda.synchronize()
            bwd = (fa.LAUNCHES["flash_attention_bwd"]
                   - before[0]["flash_attention_bwd"]
                   + ssd.LAUNCHES["ssd_bwd"] - before[1]["ssd_bwd"])
            assert bwd > 0
    (lc, gc, pc), (lg, gg, pg) = results["cpu"], results["cuda"]
    assert abs(lc - lg) <= 1e-4 * abs(lc)
    assert abs(gc - gg) <= 1e-3 * abs(gc)
    for n in pc:
        torch.testing.assert_close(pg[n], pc[n], rtol=1e-4, atol=2e-6)


def test_cuda_dry_run_plans_a_reduced_training_step():
    """The dry run's plan of a REDUCED training cell on a one-device mesh
    against the step on the card: the parameters' and AdamW state's
    bytes exactly, the FLOPs as FlopCounterMode counts the real step, and
    the peak within 10% of what the step allocates (the peak over a
    second step, after cuBLAS's workspace exists, less what was live
    before it, plus the state and batch it reads)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import Shape
    from repro_torch.launch.dryrun import plan_cell
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainState, make_train_step
    dev = _card()

    class One:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}

    cfg = get_config("qwen2.5-32b", reduced=True)
    B, S = 8, 512
    rec = plan_cell(cfg, Shape("t", S, B, "train"), One())
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), trainable=True)
    opt = AdamW()
    state = TrainState(params, opt.init(params), None)
    step = make_train_step(model, opt, remat="full")
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S + 1), device=dev,
                                     dtype=torch.int32)}
    state_bytes = sum(t.nbytes for t in (*params.parameters(),
                                         state.opt.step,
                                         *state.opt.m.values(),
                                         *state.opt.v.values()))
    mem = rec["memory"]
    assert mem["params_bytes"] + mem["opt_state_bytes"] == state_bytes
    with FlopCounterMode(display=False) as fc:  # also cuBLAS's workspace
        state, _ = step(state, batch)
    assert rec["cost_global"]["flops"] == fc.get_total_flops()
    # the peak of a step outside the counting mode, which holds tensors
    # longer than the step does
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before + state_bytes + \
        batch["tokens"].nbytes
    assert abs(mem["peak_est_bytes"] - peak) <= 0.1 * peak, (
        mem["peak_est_bytes"], peak)
