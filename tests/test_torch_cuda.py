"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and nvcc; without a card they skip.  They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch for CUDA:

    python -m pytest -q tests/test_torch_cuda.py

Integer outputs must be bit-equal (tolerance 0).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (build_tables, esdp, generate_instance,
                              make_draws, simulate, stats)
from repro_torch.core.dp import initial_plane
from repro_torch.kernels.budgeted_dp import LAUNCHES, kernel, ops, ref


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
