"""The port's SSD scan (K7's plain version and the Mamba2 block) against
the JAX package, on the CPU.

Inputs are drawn with numpy under a seed and handed to both packages.
Tolerances: 1e-4 (rtol and atol) for f32 scans, as
``tests/test_kernels.py`` holds the Pallas kernel to the same math — the
packages sum the chunk products and the cumsum in different orders; the
Mamba2 blocks add the matmuls around the scan, held at 1e-4 too.

torch runs single-threaded here: on some hosts one OpenMP worker thread of
a process has computed torch's vectorized f32 ``exp`` up to 1.5e-4
relative off over its share of a tensor, which these tolerances would see.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.ssd.ops import ssd_op as jax_ssd_op
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models import ssm as jax_ssm
from repro.models.layers import SpecTree, init_params
from repro_torch.configs import get_config
from repro_torch.kernels import ssd
from repro_torch.models import ssm
from repro_torch.models.layers import ParamTree

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_kernels.py:66-71, plus a single chunk shorter than `chunk`
SHAPES = [
    (2, 128, 2, 32, 16, 32),
    (1, 96, 4, 64, 32, 32),
    (2, 80, 2, 32, 16, 32),  # a ragged last chunk
    (1, 256, 2, 64, 64, 64),
    (2, 20, 3, 16, 8, 32),  # S < chunk: one chunk of S steps
    (1, 96, 2, 32, 128, 32),  # Mamba2-2.7B's state size, N = 128
]


def make_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES)
def test_plain_ssd_matches_jax_ssd_ref(B, S, H, P, N, Q):
    """The CPU path of the wrapper (the plain version) against the JAX
    package's oracle, y and the final state."""
    arrs = make_inputs(B, S, H, P, N)
    y, st = ssd.ssd_scan(*map(torch.as_tensor, arrs), chunk=Q)
    y_want, st_want = jax_ssd_ref(*map(jnp.asarray, arrs), chunk=Q)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, N, P)
    close(y, y_want)
    close(st, st_want)


def test_plain_ssd_matches_pallas_k7_in_interpret_mode():
    """One small case against the Pallas kernel K7 itself (``ssd_op``,
    interpret mode), through the padding path."""
    arrs = make_inputs(1, 80, 2, 32, 16, seed=3)
    y, st = ssd.ssd_op(*map(torch.as_tensor, arrs), chunk=32)
    y_want, st_want = jax_ssd_op(*map(jnp.asarray, arrs), chunk=32,
                                 interpret=True)
    close(y, y_want)
    close(st, st_want)


def test_ssd_chunked_matches_jax_and_reads_strided_views():
    """``models.ssm.ssd_chunked`` on x, B and C that are strided views of
    one (B, S, H·P + 2N) tensor, as ``mamba_train`` hands them over."""
    B, S, H, P, N = 2, 70, 3, 16, 8
    rng = np.random.default_rng(4)
    xbc = rng.standard_normal((B, S, H * P + 2 * N)).astype(np.float32)
    _, dt, A, _, _ = make_inputs(B, S, H, P, N, seed=4)
    t = torch.as_tensor(xbc)
    xs, Bm, Cm = torch.split(t, [H * P, N, N], dim=-1)
    xh = xs.reshape(B, S, H, P)
    assert not xh.is_contiguous() and Bm.stride(1) == H * P + 2 * N
    y, st = ssm.ssd_chunked(xh, torch.as_tensor(dt), torch.as_tensor(A), Bm,
                            Cm, 32)
    want = jax_ssm.ssd_chunked(
        jnp.asarray(xbc[..., :H * P].reshape(B, S, H, P)), jnp.asarray(dt),
        jnp.asarray(A), jnp.asarray(xbc[..., H * P:H * P + N]),
        jnp.asarray(xbc[..., H * P + N:]), 32)
    close(y, want[0])
    close(st, want[1])


def test_pad_steps_are_no_ops_for_the_state():
    """dt = 0 steps leave the final state as it was (the reason the kernel
    may mask a ragged chunk instead of padding it)."""
    x, dt, A, Bm, Cm = map(torch.as_tensor, make_inputs(1, 40, 2, 16, 8))
    dt[:, 33:] = 0.0
    _, st_short = ssd.ssd_scan(x[:, :33], dt[:, :33], A, Bm[:, :33],
                               Cm[:, :33], chunk=16)
    _, st_long = ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    close(st_long, st_short, 1e-6)


def _mamba_params(cfg, seed):
    spec = SpecTree("float32")
    jax_ssm.ssm_specs(spec, "m", cfg)
    jp = init_params(spec, jax.random.PRNGKey(seed))["m"]
    # nonzero dt_bias / A_log / conv_b, so the test sees them
    rng = np.random.default_rng(seed)
    for k in ("dt_bias", "A_log", "conv_b"):
        jp[k] = jnp.asarray(rng.standard_normal(jp[k].shape) * 0.3,
                            jnp.float32)
    return jp, ParamTree({k: torch.as_tensor(np.array(v))
                          for k, v in jp.items()})


def test_mamba_train_and_decode_match_jax_with_carried_weights():
    """The reduced Zamba2 Mamba2 block: prefill output and the carried
    state (ssm and conv), then two decode steps from it."""
    cfg = get_config("zamba2-7b", reduced=True)
    jcfg = jax_config("zamba2-7b", reduced=True)
    jp, tp = _mamba_params(jcfg, 5)
    rng = np.random.default_rng(6)
    B, S = 2, 45  # a ragged last chunk (chunk 32)
    x = rng.standard_normal((B, S + 2, cfg.d_model)).astype(np.float32)
    out, st = ssm.mamba_train(tp, cfg, torch.as_tensor(x[:, :S]),
                              return_state=True)
    jout, jst = jax.jit(jax_ssm.mamba_train, static_argnums=1,
                        static_argnames="return_state")(
        jp, jcfg, jnp.asarray(x[:, :S]), return_state=True)
    close(out, jout)
    for k in ("ssm", "conv"):
        assert tuple(st[k].shape) == jst[k].shape
        close(st[k], jst[k])
    jax_decode = jax.jit(jax_ssm.mamba_decode, static_argnums=1)
    for i in range(S, S + 2):
        out, st = ssm.mamba_decode(tp, cfg, torch.as_tensor(x[:, i:i + 1]),
                                   st)
        jout, jst = jax_decode(jp, jcfg, jnp.asarray(x[:, i:i + 1]), jst)
        close(out, jout)
        close(st["ssm"], jst["ssm"])


def test_wrapper_checks_and_counts_no_cpu_launches():
    x, dt, A, Bm, Cm = map(torch.as_tensor, make_inputs(1, 64, 2, 16, 8))
    before = dict(ssd.LAUNCHES)
    ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    assert ssd.LAUNCHES == before  # the plain version is not a launch
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan(x.double(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="shape"):
        ssd.ssd_scan(x, dt, A, Bm[:, :10], Cm, chunk=32)
    with pytest.raises(ValueError, match="shape"):
        ssd.ssd_scan(x, dt, A[:1], Bm, Cm, chunk=32)
    # the largest block: the output kernel's 64-column tiles whatever N and
    # P, or the state kernel's (the chunk's B and x) at N = 128; either
    # way two blocks share an SM's 228 KB at Q = 128
    assert ssd.smem_bytes(64, 64, 128) == 4 * (2 * 128 * 68 + 64 * 72
                                               + 3 * 128) == 89600
    assert ssd.smem_bytes(64, 128, 128) == 4 * (
        128 * (128 + 8) + 128 * (64 + 8) + 2 * 128 + 8) == 107552
    assert ssd.smem_bytes(16, 8, 32) == 4 * (2 * 32 * 68 + 64 * 72 + 96)
    for n in (64, 128):
        assert 2 * (ssd.smem_bytes(64, n, 128) + 1024) <= 233472
    # Mamba2-2.7B's N = 128 at Q = 128 passes the wrapper's checks (and
    # runs the plain version here)
    big = torch.zeros(1, 128, 1, 64)
    bc = torch.zeros(1, 128, 128)
    y, st = ssd.ssd_scan(big, torch.zeros(1, 128, 1), torch.zeros(1), bc, bc,
                         chunk=128)
    assert y.shape == (1, 128, 1, 64) and st.shape == (1, 1, 128, 64)
    assert ssd.LAUNCHES == before
    # what the new blocks cannot take: a chunk over Q_MAX steps, or a state
    # whose chunk of B over one block's shared memory
    with pytest.raises(ValueError, match="limit of 128"):
        ssd.ssd_scan(torch.zeros(1, 256, 1, 64), torch.zeros(1, 256, 1),
                     torch.zeros(1), torch.zeros(1, 256, 64),
                     torch.zeros(1, 256, 64), chunk=256)
    huge = torch.zeros(1, 128, 512)
    with pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan(big, torch.zeros(1, 128, 1), torch.zeros(1), huge, huge,
                     chunk=128)
