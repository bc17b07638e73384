"""The plain backward of the port's attention (``flash_attention_bwd_ref``,
the plain version of ``csrc/flash_attention_bwd.cu``) against
``jax.grad`` of the JAX package's ``models/attention.py::
chunked_attention`` and against torch autograd through the plain forward,
on the CPU; and ``FlashAttentionFn`` (what the models call when a
gradient is wanted) against ``jax.grad`` too.

Inputs are drawn with numpy under a seed.  Cases: causal, bidirectional,
a sliding window, Sq < Sk, GQA and MQA, a v head dim other than q/k's,
and keys padded past Sk to a chunk multiple.  Tolerances: 2e-5 (rtol and
atol) against JAX in f32, where the two differ in summation order only;
1e-12 against torch autograd in f64, where the plain backward and
autograd compute the same expressions.

torch runs single-threaded here (see ``tests/test_torch_flash.py``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels import flash_attention as fa

F32_TOL = 2e-5

# (B, Sq, Sk, H, KH, hd, vh, causal, window, chunk)
CASES = [
    (2, 48, 48, 4, 4, 16, 16, True, 0, 16),  # causal MHA
    (2, 40, 40, 4, 4, 16, 16, False, 0, 16),  # bidirectional, padded keys
    (1, 64, 64, 4, 2, 16, 16, True, 12, 16),  # GQA, a sliding window
    (2, 24, 56, 4, 1, 8, 8, True, 0, 16),  # MQA, Sq < Sk
    (1, 30, 50, 6, 2, 24, 16, False, 0, 16),  # cross: Sq < Sk, vh < hd
    (1, 36, 36, 4, 2, 16, 24, True, 0, 12),  # vh > hd
    (1, 33, 33, 2, 2, 8, 8, False, 7, 10),  # window without causal
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw(case, seed=0):
    B, Sq, Sk, H, KH, hd, vh = case[:7]
    rng = np.random.default_rng(seed + Sq * Sk)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Sk, KH, hd), (B, Sk, KH, vh),
             (B, Sq, H, vh))]


def jax_grads(case, q, k, v, do):
    *_, hd, vh, causal, window, chunk = case

    def f(q, k, v):
        o = jax_chunked(q, k, v, scale=hd ** -0.5, causal=causal,
                        window=window or None, chunk=chunk)
        return jnp.sum(o * do)
    return [np.asarray(g) for g in jax.grad(f, (0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def kw(case):
    *_, hd, vh, causal, window, chunk = case
    return dict(scale=hd ** -0.5, causal=causal, window=window, chunk=chunk)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad(case):
    q, k, v, do = draw(case)
    want = jax_grads(case, q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_ref(tq, tk, tv, return_lse=True, **kw(case))
    got = fa.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw(case))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg="d" + name)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_is_autograd_of_the_plain_forward(case):
    q, k, v, do = (torch.from_numpy(a).double() for a in draw(case, 1))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw(case))
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        got = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw(case))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", CASES[:5])
def test_autograd_function_matches_jax_grad(case):
    """The models' path: ``flash_attention_op`` on tensors that require
    grad goes through ``FlashAttentionFn``, whose CPU backward is the
    plain one; non-contiguous inputs and output gradient included."""
    q, k, v, do = draw(case, 2)
    want = jax_grads(case, q, k, v, do)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    # strided views, as a projection's reshape and a transpose give them
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in leaves]
    *_, causal, window, chunk = case
    o = fa.flash_attention_op(*views, scale=case[5] ** -0.5, causal=causal,
                              window=window or None, chunk=chunk)
    assert o.grad_fn is not None and "FlashAttentionFn" in type(
        o.grad_fn).__name__
    tdo = torch.from_numpy(do).transpose(1, 2).contiguous().transpose(1, 2)
    got = torch.autograd.grad(o, leaves, tdo)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=F32_TOL, atol=F32_TOL)


def test_lse_is_the_rows_log_sum_exp_and_leaves_the_output_alone():
    case = CASES[2]
    q, k, v, _ = map(torch.from_numpy, draw(case))
    o0 = fa.flash_attention_ref(q, k, v, **kw(case))
    o, lse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw(case))
    assert torch.equal(o, o0)
    # the same log-sum-exp from the dense masked logits
    B, Sq, H, hd = q.shape
    g = H // k.shape[2]
    kk = k.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
    qi = torch.arange(Sq)[:, None] + (k.shape[1] - Sq)
    kj = torch.arange(k.shape[1])[None, :]
    mask = (kj <= qi) & (qi - kj < case[8])
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_backward_counts_no_launch_on_the_cpu():
    case = CASES[0]
    q, k, v, do = map(torch.from_numpy, draw(case))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw(case))
    fa.flash_attention_bwd(q, k, v, o, lse, do, **kw(case))
    assert fa.LAUNCHES == before


def test_backward_route_is_chosen_by_the_dtype_alone():
    """bf16 goes to the bf16 tensor-core kernels, f32 to the split-TF32
    tensor-core ones, through their own C entry points; the CUDA-core f32
    kernels are only the referee's, which no dtype routes to; another
    dtype raises before any launch.  Every kernel and entry point named
    stands in the source."""
    src = fa.BWD_LIBRARY.source.read_text()
    entry, kernels = fa.bwd_route(torch.bfloat16)
    assert entry == "flash_attention_bwd_bf16_launch"
    assert kernels == ("fa_bwd_pre_kernel", "fa_bwd_dkdv_mma_kernel",
                       "fa_bwd_dq_mma_kernel")
    entry32, kernels32 = fa.bwd_route(torch.float32)
    assert entry32 == "flash_attention_bwd_tf32_launch"
    assert kernels32 == ("fa_bwd_pre_kernel", "fa_bwd_dkdv_tf32_kernel",
                         "fa_bwd_dq_tf32_kernel")
    referee, referee_kernels = fa.BWD_REFEREE
    assert referee == "flash_attention_bwd_f32_launch"
    assert referee_kernels == ("fa_bwd_pre_kernel", "fa_bwd_dkdv_kernel",
                               "fa_bwd_dq_kernel")
    assert referee not in (e for e, _ in fa.BWD_ROUTES.values())
    for name in (entry, entry32, referee):
        assert f"int {name}(" in src
    for name in set(kernels) | set(kernels32) | set(referee_kernels):
        assert re.search(r"__global__ void (__launch_bounds__\([^)]*\) )?"
                         + name + r"\(", src), name
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or all bfloat16"):
            fa.bwd_route(dtype)
    # the launch counter keeps one name for both routes
    assert "flash_attention_bwd" in fa.LAUNCHES
