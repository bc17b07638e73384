"""The plain backward of the port's SSD scan (``ssd_bwd_ref``, the plain
version of ``csrc/ssd_bwd.cu``) against ``jax.grad`` of the JAX package's
``models/ssm.py::ssd_chunked`` and against torch autograd through the
plain forward, on the CPU; and ``SsdFn`` (what the models call when a
gradient is wanted) against ``jax.grad`` too, with x, B and C strided
views of one tensor as the model's split gives them.

Inputs are drawn with numpy under a seed.  Cases include S that is not a
multiple of the chunk (the pad steps are no-ops) and S shorter than one
chunk.  Tolerances: 1e-4 relative to each gradient's largest entry
against JAX in f32 (summation order only; dA sums every step of every
row); 1e-10 against torch autograd in f64.

torch runs single-threaded here (see ``tests/test_torch_flash.py``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd
from repro_torch.kernels import ssd

TOL = 1e-4
NAMES = ("x", "dt", "A", "B", "C")

# (B, S, H, P, N, chunk)
CASES = [
    (2, 64, 3, 8, 4, 16),
    (1, 50, 2, 8, 8, 16),  # S % Q != 0
    (2, 37, 4, 4, 8, 8),  # S % Q != 0, many chunks
    (1, 12, 2, 8, 4, 32),  # S < chunk: one chunk of S steps
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw(case, seed=0):
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed + S * H)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dst = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy, dst


def jax_grads(case, args, dy, dst):
    def f(*a):
        y, st = jax_ssd(*a, case[-1])
        return jnp.sum(y * dy) + jnp.sum(st * dst)
    return [np.asarray(g) for g in
            jax.grad(f, tuple(range(5)))(*map(jnp.asarray, args))]


def close(got, want, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, (name, err, scale)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad(case):
    args, dy, dst = draw(case)
    want = jax_grads(case, args, dy, dst)
    got = ssd.ssd_bwd_ref(*map(torch.from_numpy, args), case[-1],
                          torch.from_numpy(dy), torch.from_numpy(dst))
    for name, a, b in zip(NAMES, got, want):
        close(a.numpy(), b, name)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_is_autograd_of_the_plain_forward(case):
    args, dy, dst = draw(case, 1)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in args]
    y, st = ssd.ssd_ref(*leaves, case[-1])
    dy, dst = torch.from_numpy(dy).double(), torch.from_numpy(dst).double()
    want = torch.autograd.grad((y, st), leaves, (dy, dst))
    with torch.no_grad():
        got = ssd.ssd_bwd_ref(*leaves, case[-1], dy, dst)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", CASES[:3])
def test_autograd_function_matches_jax_grad(case):
    """``ssd_op`` on tensors that require grad goes through ``SsdFn``; x, B
    and C are views of one (B, S, H·P + 2N) tensor, and only y is used
    (the final state's gradient is None)."""
    (x, dt, A, Bm, Cm), dy, _ = draw(case, 2)
    B, S, H, P, N, Q = case
    want = jax_grads(case, (x, dt, A, Bm, Cm), dy,
                     np.zeros((B, H, N, P), np.float32))
    xbc = torch.from_numpy(np.concatenate(
        [x.reshape(B, S, H * P), Bm, Cm], axis=-1)).requires_grad_()
    tdt, tA = (torch.from_numpy(a).requires_grad_() for a in (dt, A))
    xs, tB, tC = torch.split(xbc, [H * P, N, N], dim=-1)
    y, _ = ssd.ssd_op(xs.reshape(B, S, H, P), tdt, tA, tB, tC, Q)
    assert "SsdFn" in type(y.grad_fn).__name__
    gx, gdt, gA = torch.autograd.grad(y, (xbc, tdt, tA), torch.from_numpy(dy))
    got_x, got_B, got_C = torch.split(gx, [H * P, N, N], dim=-1)
    for name, a, b in zip(NAMES, (got_x.reshape(B, S, H, P), gdt, gA, got_B,
                                  got_C), want):
        close(a.numpy(), b, name)


def test_backward_counts_no_launch_on_the_cpu():
    case = CASES[1]
    args, dy, dst = draw(case)
    t = list(map(torch.from_numpy, args))
    before = dict(ssd.LAUNCHES)
    y, st, states, cum = ssd.ssd_scan_saved(*t, case[-1])
    assert states is None and cum is None
    ssd.ssd_bwd(*t, case[-1], torch.from_numpy(dy), torch.from_numpy(dst))
    assert ssd.LAUNCHES == before


def test_plain_scan_keeps_a_finite_gradient_where_exp_overflows():
    """Where a chunk's cum spans more than ~88 (dt·A summed over its
    steps, as at Mamba2-2.7B's full width), exp(cum_i − cum_j) above the
    diagonal overflows f32.  JAX's ``where(mask, exp(seg), 0)`` keeps the
    inf out of the value but not out of its gradient (0 · inf = nan); the
    port's plain scan masks the exponent first and its gradient, like the
    plain backward's, stays finite and equal to the f64 one."""
    B, S, H, P, N, Q = 1, 64, 2, 4, 4, 64
    (x, dt, A, Bm, Cm), dy, _ = draw((B, S, H, P, N, Q), 3)
    dt = np.full_like(dt, 2.0)  # cum falls by 2 a step: 126 over the chunk
    A = np.full_like(A, -1.0)
    args = (x, dt, A, Bm, Cm)
    want_nan = jax_grads((B, S, H, P, N, Q), args, dy,
                         np.zeros((B, H, N, P), np.float32))
    assert any(np.isnan(g).any() for g in want_nan)  # the reference's
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, _ = ssd.ssd_ref(*leaves, Q)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    l64 = [torch.from_numpy(a).double().requires_grad_() for a in args]
    y64, _ = ssd.ssd_ref(*l64, Q)
    exact = torch.autograd.grad(y64, l64, torch.from_numpy(dy).double())
    plain = ssd.ssd_bwd_ref(*map(torch.from_numpy, args), Q,
                            torch.from_numpy(dy))
    for name, a, p, e in zip(NAMES, got, plain, exact):
        assert torch.isfinite(a).all() and torch.isfinite(p).all(), name
        close(a.numpy(), e.numpy(), name)
        close(p.numpy(), e.numpy(), name)


def test_backward_head_groups_and_their_shares():
    """The wrapper's scratch for dB and dC holds one share a group of
    ``BWD_HEAD_GROUP`` heads, the last group short where the group does
    not divide H; the constant is the source's, and the kernels the
    timing reads are the source's, with their launches a call."""
    src = ssd.BWD_LIBRARY.source.read_text()
    assert f"constexpr int HEAD_GROUP = {ssd.BWD_HEAD_GROUP};" in src
    g = ssd.BWD_HEAD_GROUP
    for H, want in ((1, 1), (g, 1), (g + 1, 2), (22, -(-22 // g)),
                    (80, 80 // g), (112, 112 // g)):
        assert ssd.bwd_shares(H) == want
    assert set(ssd.BWD_LAUNCHES_PER_CALL) == set(ssd.BWD_KERNELS)
    assert sum(ssd.BWD_LAUNCHES_PER_CALL.values()) == 6
    for name in ssd.BWD_KERNELS:
        assert re.search(r"__global__ void (__launch_bounds__\([^)]*\) )?"
                         + name + r"\(", src), name
