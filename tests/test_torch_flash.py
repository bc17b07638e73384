"""The port's attention (K6's plain version and the GQA block) against the
JAX package, on the CPU.

Inputs are drawn with numpy under a seed and handed to both packages.
Tolerances, as ``tests/test_kernels.py`` holds the Pallas kernel: 2e-5
(rtol and atol) in f32, where the packages differ only in summation
order; 2e-2 in bf16, where each rounds q·k, p and the output to bf16 at
its own places.  The GQA block adds projections and RoPE around the
attention and is held at 1e-4 in f32.

torch runs single-threaded here: on some hosts one OpenMP worker thread of
a process has computed torch's vectorized f32 ``exp`` up to 1.5e-4
relative off over its share of a tensor, which these tolerances would see.
"""
import ctypes
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.flash_attention.ops import flash_attention_op as jax_fa_op
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as jax_attn
from repro.models.layers import SpecTree, init_params
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd
from repro_torch.kernels.budgeted_dp import build
from repro_torch.models import attention
from repro_torch.models.layers import ParamTree

F32_TOL, BF16_TOL, BLOCK_TOL = 2e-5, 2e-2, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_kernels.py:28-58: (B, Sq, Sk, H, KH, hd, causal, window)
SHAPES = [
    (2, 256, 256, 4, 4, 64, True, 0),
    (1, 256, 256, 8, 2, 64, True, 0),  # GQA g = 4
    (2, 128, 128, 4, 1, 32, True, 0),  # MQA
    (1, 512, 512, 2, 2, 128, True, 128),  # sliding window
    (2, 256, 256, 4, 4, 64, False, 0),  # bidirectional
    (1, 128, 512, 4, 4, 64, True, 0),  # Sq < Sk: the prefill tail
]
# head dims over 128 (deepseek-v3's q/k 192, gemma-7b's 256), GQA and
# windowed, in the plain-version comparison only
WIDE_SHAPES = [
    (1, 128, 128, 2, 1, 192, True, 0),  # GQA g = 2
    (1, 96, 128, 2, 2, 192, True, 40),  # Sq < Sk, a window
    (1, 128, 128, 2, 1, 256, True, 0),
    (1, 128, 128, 2, 2, 256, True, 64),
]


def make_qkv(B, Sq, Sk, H, KH, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, hd)).astype(np.float32))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KH,hd,causal,window",
                         SHAPES + WIDE_SHAPES)
def test_plain_attention_matches_jax_attention_ref(
    B, Sq, Sk, H, KH, hd, causal, window, dtype
):
    """The CPU path of the wrapper (the plain version, KV chunk 128, so
    several chunks) against the JAX package's full-softmax oracle."""
    arrs = make_qkv(B, Sq, Sk, H, KH, hd)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    scale = 1.0 / np.sqrt(hd)
    got = fa.flash_attention(*(torch.as_tensor(a).to(tdt) for a in arrs),
                             scale=scale, causal=causal, window=window,
                             chunk=128)
    want = attention_ref(*(jnp.asarray(a, jdt) for a in arrs), scale=scale,
                         causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == (B, Sq, H, hd)
    close(got.float(), want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_plain_attention_matches_pallas_k6_in_interpret_mode():
    """One small GQA case against the Pallas kernel K6 itself
    (``flash_attention_op``, interpret mode)."""
    arrs = make_qkv(1, 128, 128, 4, 2, 32, seed=1)
    got = fa.flash_attention_op(*map(torch.as_tensor, arrs), scale=0.2)
    want = jax_fa_op(*map(jnp.asarray, arrs), scale=0.2, blk_q=64, blk_k=64,
                     interpret=True)
    close(got, want, F32_TOL)


@pytest.mark.parametrize("Sq,Sk,window,chunk", [
    (100, 100, None, 32),  # ragged: 100 keys in chunks of 32
    (37, 100, 0, 64),  # Sq < Sk, window 0 means none
    (100, 100, 17, 1024),  # a window, one chunk
])
def test_chunked_attention_matches_jax(Sq, Sk, window, chunk):
    """``models.attention.chunked_attention`` against the JAX function on
    ragged lengths, a q offset and a window, GQA g = 2."""
    q, k, v = make_qkv(2, Sq, Sk, 4, 2, 16, seed=2)
    got = attention.chunked_attention(
        *map(torch.as_tensor, (q, k, v)), scale=0.25, window=window,
        chunk=chunk)
    want = jax_attn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), scale=0.25, window=window, chunk=chunk)
    close(got, want, F32_TOL)


@pytest.mark.parametrize("hd,vh", [(24, 16), (16, 24)])
@pytest.mark.parametrize("window", [None, 9], ids=["causal", "windowed"])
def test_chunked_attention_with_v_head_dim_other_than_qk_matches_jax(hd, vh, window):
    """v's head dim differs from q/k's (MLA's shape, reduced): the port's
    ``chunked_attention`` returns (…, vh) and equals the JAX function, f32
    within 2e-5, GQA 4:2, causal and windowed, over several KV chunks."""
    rng = np.random.default_rng(hd + vh)
    q = rng.standard_normal((2, 40, 4, hd)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, hd)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, vh)).astype(np.float32)
    got = attention.chunked_attention(*map(torch.as_tensor, (q, k, v)),
                                      scale=0.3, window=window, chunk=16)
    want = jax_attn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                      scale=0.3, window=window, chunk=16)
    assert tuple(got.shape) == (2, 40, 4, vh) == tuple(want.shape)
    close(got, want, F32_TOL)


@pytest.mark.parametrize("hd,vh", [(24, 16), (16, 24), (192, 128)])
def test_zero_padding_to_the_kernel_width_leaves_attention_unchanged(hd, vh):
    """What the wrapper hands the kernel where vh ≠ hd: q, k and v padded
    with zero columns to max(hd, vh), the output cut back to vh.  The
    plain version on the padded inputs equals it on the unpadded ones,
    f32 within 2e-5 (the zero columns only lengthen the sums)."""
    rng = np.random.default_rng(vh)
    q, k = (torch.as_tensor(rng.standard_normal((1, 24, 4, hd)),
                            dtype=torch.float32) for _ in range(2))
    k = k[:, :, :2].contiguous()
    v = torch.as_tensor(rng.standard_normal((1, 24, 2, vh)),
                        dtype=torch.float32)
    width = max(hd, vh)
    padded = fa.zero_pad(q, k, v, width)
    assert all(t.shape[-1] == width for t in padded)
    got = fa.flash_attention_ref(*padded, scale=0.2, window=7)[..., :vh]
    close(got, fa.flash_attention_ref(q, k, v, scale=0.2, window=7), F32_TOL)
    assert fa.kernel_for(torch.bfloat16, width) == "flash_attention_wgmma"
    assert fa.kernel_for(torch.float32, width) == "flash_attention_tf32"


def test_attn_train_and_decode_match_jax_with_carried_weights():
    """The reduced Zamba2 attention block: prefill output and its post-RoPE
    (k, v), then decode steps against a cache that holds them."""
    cfg = get_config("zamba2-7b", reduced=True)
    jcfg = jax_config("zamba2-7b", reduced=True)
    spec = SpecTree("float32")
    jax_attn.attn_specs(spec, "a", jcfg)
    jp = init_params(spec, jax.random.PRNGKey(7))["a"]
    tp = ParamTree({k: torch.as_tensor(np.array(v)) for k, v in jp.items()})
    B, S, S_max = 2, 24, 28
    x = np.random.default_rng(8).standard_normal(
        (B, S + 2, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S)[None], (B, 1))
    out, (k, v) = attention.attn_train(tp, cfg, torch.as_tensor(x[:, :S]),
                                       torch.as_tensor(pos))
    jout, (jk, jv) = jax_attn.attn_train(jp, jcfg, jnp.asarray(x[:, :S]),
                                         jnp.asarray(pos))
    close(out, jout, BLOCK_TOL)
    close(k, jk, BLOCK_TOL)
    close(v, jv, BLOCK_TOL)
    kc = torch.zeros((B, S_max, cfg.n_kv_heads, cfg.head_dim))
    vc = torch.zeros_like(kc)
    kc[:, :S], vc[:, :S] = k, v
    jkc, jvc = jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy())
    for i in (S, S + 1):
        p = torch.full((B,), i)
        out, (kc2, _) = attention.attn_decode(
            tp, cfg, torch.as_tensor(x[:, i:i + 1]), p, (kc, vc))
        assert kc2 is kc  # written in place
        jout, (jkc, jvc) = jax_attn.attn_decode(
            jp, jcfg, jnp.asarray(x[:, i:i + 1]), jnp.full((B,), i), (jkc,
                                                                     jvc))
        close(out, jout, BLOCK_TOL)
        close(kc, jkc, BLOCK_TOL)


def test_wrapper_checks_and_counts_no_cpu_launches():
    q, k, v = map(torch.as_tensor, make_qkv(1, 16, 16, 4, 2, 16))
    before = dict(fa.LAUNCHES)
    fa.flash_attention(q, k, v, scale=0.25)
    assert fa.LAUNCHES == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                           v[..., :12].contiguous(), scale=0.25)
    wide = torch.zeros(1, 4, 2, 264)
    with pytest.raises(ValueError, match="up to 256"):
        fa.flash_attention(wide, wide, wide, scale=0.1)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa.flash_attention(q, k.bfloat16(), v, scale=0.25)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                           v, scale=0.25)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q[:, :, :3].contiguous(), k, v, scale=0.25)
    # the op takes any strides: it hands the wrapper contiguous copies
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    close(fa.flash_attention_op(qt, k, v, scale=0.25),
          fa.flash_attention(q, k, v, scale=0.25), 0)


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 8, "flash_attention_wgmma"),
    (torch.bfloat16, 64, "flash_attention_wgmma"),
    (torch.bfloat16, 112, "flash_attention_wgmma"),  # Zamba2-7B
    (torch.bfloat16, 128, "flash_attention_wgmma"),
    (torch.bfloat16, 136, "flash_attention_wgmma"),
    (torch.bfloat16, 192, "flash_attention_wgmma"),  # deepseek-v3 q/k
    (torch.bfloat16, 200, "flash_attention_wgmma"),
    (torch.bfloat16, 256, "flash_attention_wgmma"),  # gemma-7b
    (torch.float32, 8, "flash_attention_tf32"),
    (torch.float32, 64, "flash_attention_tf32"),
    (torch.float32, 112, "flash_attention_tf32"),
    (torch.float32, 256, "flash_attention_tf32"),
])
def test_route_rule_picks_the_kernel_from_dtype_and_head_dim(dtype, hd, kernel):
    """bf16 goes to the wgmma kernel and f32 to the split-TF32 one, at
    every head dim up to 256; nothing else decides."""
    assert fa.kernel_for(dtype, hd) == kernel


def test_no_input_routes_to_the_cuda_core_kernel():
    """The CUDA-core kernel is the f32 referee only: no (dtype, hd) the
    wrapper takes is sent to it, and every kernel the rule names has a
    launch count."""
    names = {fa.kernel_for(dtype, hd)
             for dtype in (torch.float32, torch.bfloat16)
             for hd in range(8, fa.MAX_HEAD_DIM + 1, 8)}
    assert names == {"flash_attention_wgmma", "flash_attention_tf32"}
    assert names < set(fa.LAUNCHES)


def test_route_rule_raises_for_what_neither_kernel_takes():
    for hd in (0, 4, 12, 120 + 4, 264, 512):
        with pytest.raises(ValueError, match="multiple of 8 up to 256"):
            fa.kernel_for(torch.bfloat16, hd)
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float32 or all bfloat16"):
            fa.kernel_for(dtype, 64)
    # the wrapper raises the same on CPU tensors, before the plain version
    half = torch.zeros(1, 4, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa.flash_attention(half, half, half, scale=0.125)
    odd = torch.zeros(1, 4, 2, 20, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(odd, odd, odd, scale=0.125)


def _c_params(source, fn):
    """ctypes types of the parameters of ``int fn(...)`` in a C source."""
    m = re.search(r"\bint " + fn + r"\(([^)]*)\)", source.read_text())
    kinds = []
    for param in m.group(1).split(","):
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif "long long" in param:
            kinds.append(ctypes.c_longlong)
        elif "float" in param:
            kinds.append(ctypes.c_float)
        else:
            assert param.split()[0] == "int", param
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("lib,fns", [
    ("flash_attention", ["flash_attention_launch"]),
    ("flash_attention_wgmma", ["flash_attention_wgmma_launch"]),
    ("flash_attention_tf32", ["flash_attention_tf32_launch"]),
    ("flash_attention_bwd", ["flash_attention_bwd_bf16_launch",
                             "flash_attention_bwd_tf32_launch",
                             "flash_attention_bwd_f32_launch"]),
    ("ssd", ["ssd_scan_launch"]),
    ("ssd_bwd", ["ssd_bwd_launch"]),
    ("budgeted_dp", ["dp_forward_launch", "dp_forward_sweep_launch",
                     "dp_edge_launch", "dp_edge_chain_launch",
                     "dp_chunk_launch", "dp_epilogue_launch",
                     "dp_empty_launch"]),
])
def test_ctypes_declarations_match_the_c_entry_points(lib, fns):
    """Each library's declared argtypes follow its C signatures, type for
    type: a pointer or a 64-bit stride passed as a 32-bit int would be cut
    on the card."""
    library = {"flash_attention": fa.LIBRARY,
               "flash_attention_wgmma": fa.WGMMA_LIBRARY,
               "flash_attention_tf32": fa.TF32_LIBRARY,
               "flash_attention_bwd": fa.BWD_LIBRARY, "ssd": ssd.LIBRARY,
               "ssd_bwd": ssd.BWD_LIBRARY,
               "budgeted_dp": build.LIBRARY}[lib]
    fake = types.SimpleNamespace(**{f: types.SimpleNamespace() for f in fns})
    library._declare(fake)
    for f in fns:
        assert getattr(fake, f).argtypes == _c_params(library.source, f), f
