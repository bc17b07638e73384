"""The port's dense family (gemma-7b, gemma3-27b, qwen1.5-32b,
qwen2.5-32b) against the JAX package on the CPU: the REDUCED configs in
f32, the JAX parameters carried across by ``from_jax_params``.

Each arch: prefill logits and both cache leaves (k, v after RoPE), one
decode step's logits, greedy tokens (exact) and the decode/prefill
consistency, at the tolerance ``tests/test_torch_serve.py`` states for
the hybrid (1e-4, rtol and atol: f32 in both packages, summation order
only; the differences seen are ~5e-6).  gemma3's prompt (80 tokens)
outruns its reduced window (64), so its local layers' window bites in
prefill and decode.  The FULL configs equal the JAX package's field by
field, with the same parameter count.

torch runs single-threaded here (see ``tests/test_torch_serve.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.runtime import greedy_generate as jax_greedy_generate
from repro_torch.configs import get_config
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.layers import DTYPES, Leaf
from repro_torch.models.transformer import layer_pattern
from repro_torch.runtime import greedy_generate, make_decode_step

TOL = 1e-4
B, GEN = 2, 6
ARCHS = {"gemma-7b": 32, "gemma3-27b": 80, "qwen1.5-32b": 32,
         "qwen2.5-32b": 32}  # arch: prompt length


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def serve_both(arch, S):
    """Both packages' reduced ``arch`` on the same weights and tokens: the
    prefill over S tokens, one decode step at S, greedy generation, and
    the port's prefill over S + 1 tokens."""
    jcfg = jax_config(arch, reduced=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S + 1))
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    _, axes = jmodel.cache_spec(B, S + 1)

    def pad(leaf, ax):  # the JAX decode wants the cache at S_max = S + 1
        if "cache_seq" not in ax:
            return leaf
        widths = [(0, 0)] * leaf.ndim
        widths[ax.index("cache_seq")] = (0, 1)
        return jnp.pad(leaf, widths)

    jdec, _ = jax.jit(jmodel.decode)(jparams, {
        "token": jnp.asarray(tokens[:, S:]),
        "pos": jnp.full((B,), S, jnp.int32),
        "cache": jax.tree.map(pad, jcache, axes)})
    jtoks = jax_greedy_generate(jmodel, jparams,
                                {"tokens": jnp.asarray(tokens[:, :S])},
                                steps=GEN, s_max=S + GEN)

    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    t = torch.as_tensor(tokens)
    logits, cache = model.prefill(params, {"tokens": t[:, :S]})
    dcache = model.alloc_cache(B, S + 1, "cpu")
    model.prefill(params, {"tokens": t[:, :S]}, cache=dcache)
    _, dec, _ = make_decode_step(model)(params, {
        "token": t[:, S:], "pos": torch.full((B,), S), "cache": dcache})
    toks = greedy_generate(model, params, {"tokens": t[:, :S]}, steps=GEN,
                           s_max=S + GEN)
    full, _ = model.prefill(params, {"tokens": t})
    return dict(jlogits=jlogits, jcache=jcache, jdec=jdec, jtoks=jtoks,
                logits=logits, cache=cache, dec=dec, toks=toks, full=full,
                vocab=cfg.vocab)


_RUNS = {}


@pytest.fixture(params=list(ARCHS))
def runs(request):
    arch = request.param
    if arch not in _RUNS:
        _RUNS[arch] = serve_both(arch, ARCHS[arch])
    return _RUNS[arch]


def test_prefill_logits_match_jax(runs):
    assert tuple(runs["logits"].shape) == (B, runs["vocab"])
    assert runs["logits"].dtype == torch.float32
    close(runs["logits"], runs["jlogits"])


@pytest.mark.parametrize("leaf", [0, 1], ids=["k", "v"])
def test_prefill_cache_matches_jax(runs, leaf):
    """Each layer's k and v in the JAX layout (L, B, S, KV, hd)."""
    got, want = runs["cache"]["dense"][leaf], runs["jcache"]["dense"][leaf]
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_decode_logits_match_jax(runs):
    close(runs["dec"], runs["jdec"])


def test_greedy_tokens_match_jax(runs):
    assert runs["toks"].dtype == torch.int32
    np.testing.assert_array_equal(runs["toks"].numpy(),
                                  np.asarray(runs["jtoks"]))


def test_prefill_decode_consistency(runs):
    """Decode of token S after a prefill of S gives the last logits of a
    prefill of S + 1."""
    close(runs["dec"], runs["full"])


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2.5-32b"])
def test_prefill_takes_the_callers_positions(arch):
    """A prefill given ``batch["positions"]`` rotates by them, as JAX's
    ``embed_input`` does: increasing positions with gaps, from 5, match
    JAX and move the logits away from the default 0..S-1 (an offset alone
    would not: RoPE sees only the distances)."""
    S = 24
    jcfg = jax_config(arch, reduced=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S))
    gaps = np.random.default_rng(4).integers(1, 4, (B, S))
    pos = (np.cumsum(gaps, axis=1) + 4).astype(np.int32)
    want, _ = jax.jit(jmodel.prefill)(jparams, {
        "tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos)})
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    t = torch.as_tensor(tokens)
    got, _ = model.prefill(params, {"tokens": t,
                                    "positions": torch.as_tensor(pos)})
    close(got, want)
    default, _ = model.prefill(params, {"tokens": t})
    assert np.abs(default.numpy() - np.asarray(want)).max() > 1e-3


def _count(node):
    if isinstance(node, Leaf):
        return int(np.prod(node.shape))
    return sum(map(_count, node.values() if isinstance(node, dict)
                   else node))


@pytest.mark.parametrize("arch,billions", [
    ("gemma-7b", 8.54), ("gemma3-27b", 27.0), ("qwen1.5-32b", 35.2),
    ("qwen2.5-32b", 32.76)])
def test_full_config_matches_the_jax_package(arch, billions):
    """Every field of FULL and REDUCED, the parameter count and the cache
    layout equal the JAX package's."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(arch, reduced=True)) == \
        dataclasses.asdict(jax_config(arch, reduced=True))
    n = _count(build_model(cfg).spec)
    jmodel = jax_build_model(jcfg)
    jn = sum(int(np.prod(x.shape)) for x in
             jax.tree.leaves(jmodel.abstract()))
    assert n == jn and n / 1e9 == pytest.approx(billions, rel=0.01)
    want, _ = jmodel.cache_spec(4, 2080)
    got = build_model(cfg).alloc_cache(4, 2080, "meta")
    for g, w in zip(got["dense"], want["dense"]):
        assert tuple(g.shape) == w.shape
        assert g.dtype == DTYPES[cfg.compute_dtype]


def test_gemma3_layer_pattern():
    """gemma3: 5 local : 1 global — window 1024 and θ 10⁴ locally, window
    0 and θ 10⁶ on every sixth layer, as the JAX package's pattern."""
    from repro.models.transformer import _layer_pattern
    cfg = get_config("gemma3-27b")
    windows, thetas = layer_pattern(cfg, 12)
    jw, jt = _layer_pattern(jax_config("gemma3-27b"), 12)
    assert windows == np.asarray(jw).tolist()
    assert thetas == np.asarray(jt).tolist()
    assert windows[:6] == [1024] * 5 + [0]
    assert thetas[5] == 1e6 and thetas[0] == 1e4
    assert layer_pattern(get_config("gemma-7b"), 4) == (None, None)


def test_embed_scale_rounds_the_factor_to_the_compute_dtype():
    """gemma's √d is rounded to f32 and then to the compute dtype before
    the multiply (d = 3072: bf16's factor is 55.5, f32's 55.425625)."""
    from repro_torch.models.transformer import _embed
    cfg = get_config("gemma-7b").replace(d_model=3072, vocab=4)
    params = {"embed": torch.ones((4, 3072), dtype=torch.bfloat16)}
    h = _embed(params, cfg, torch.zeros((1, 1), dtype=torch.long))
    want = jnp.ones((1, 1, 3072), jnp.bfloat16) * jnp.sqrt(
        jnp.float32(3072)).astype(jnp.bfloat16)
    assert h.dtype == torch.bfloat16
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(want, np.float32))
    assert float(h[0, 0, 0]) == 55.5


@pytest.mark.parametrize("arch", list(ARCHS) + ["mamba2-2.7b"])
def test_serve_cli_serves_the_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --device cpu``
    serves each newly ported arch at its reduced size."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert out["arch"] == arch and out["out_shape"] == [2, 3]
    assert f'"arch": "{arch}"' in capsys.readouterr().out
