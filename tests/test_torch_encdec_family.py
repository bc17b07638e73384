"""The port's encdec family — whisper-medium: an encoder of bidirectional
blocks over frame embeddings (the conv frontend is a stub in both
packages) with sinusoidal positions, a decoder with a learned position
table, causal self-attention and cross-attention to the encoder, the
token embedding tied to the head — against the JAX package on the CPU:
the REDUCED config in f32, the JAX parameters carried across by
``from_jax_params``.

``layer_norm``, ``cross_attn`` with fewer queries than encoder frames, and
the encoder's sinusoid on their own; then the model: the encoder's
output, prefill logits, the four cache leaves (self k/v, cross ck/cv), one
decode step's logits and greedy tokens, at the tolerance
``tests/test_torch_serve.py`` states (1e-4, rtol and atol: f32 in both
packages, summation order only); tokens exact.  The FULL config equals
the JAX package's field by field, with the same parameter count (0.79 B)
and cache layout.

torch runs single-threaded here (see ``tests/test_torch_serve.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jax_transformer
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.models.attention import cross_attn as jax_cross_attn
from repro.models.layers import layer_norm as jax_layer_norm
from repro.runtime import greedy_generate as jax_greedy_generate
from repro_torch.configs import get_config
from repro_torch.models import build_model, from_jax_params, init_params
from repro_torch.models.attention import cross_attn, cross_attn_specs
from repro_torch.models.layers import DTYPES, Leaf, layer_norm
from repro_torch.models.transformer import _sinusoid
from repro_torch.runtime import greedy_generate, make_decode_step

TOL = 1e-4
ARCH = "whisper-medium"
B, S, GEN = 2, 20, 6


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


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 33, 128)) * 3 + 1.5).astype(np.float32)
    w, b = (rng.standard_normal(128).astype(np.float32) for _ in range(2))
    got = layer_norm(*map(torch.as_tensor, (x, w, b)), 1e-5)
    assert got.dtype == torch.float32
    close(got, jax_layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5))


def test_layer_norm_returns_the_input_dtype():
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(0))
    got = layer_norm(x.bfloat16(), torch.ones(64), torch.zeros(64), 1e-5)
    assert got.dtype == torch.bfloat16
    want = layer_norm(x.bfloat16().float(), torch.ones(64), torch.zeros(64),
                      1e-5)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("Sq,Se", [(1, 64), (20, 64), (37, 1500)])
def test_cross_attn_matches_jax(Sq, Se):
    """Sq queries against Se encoder frames, no mask: decode (Sq = 1), a
    prompt, and whisper's 1500 frames over two KV chunks."""
    cfg = get_config(ARCH, reduced=True)
    p = init_params(cross_attn_specs(cfg), torch.float32,
                    torch.Generator().manual_seed(Sq))
    rng = np.random.default_rng(Se)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    shape = (2, Se, cfg.n_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    got = cross_attn(p, cfg, torch.as_tensor(x),
                     (torch.as_tensor(k), torch.as_tensor(v)))
    jp = {n: jnp.asarray(t.numpy()) for n, t in p.named_parameters()}
    want = jax_cross_attn(jp, jax_config(ARCH, reduced=True), jnp.asarray(x),
                          (jnp.asarray(k), jnp.asarray(v)))
    assert tuple(got.shape) == (2, Sq, cfg.d_model)
    close(got, want)


@pytest.mark.parametrize("S_,d", [(64, 128), (1500, 1024)])
def test_sinusoid_equals_the_jax_package(S_, d):
    np.testing.assert_array_equal(_sinusoid(S_, d).numpy(),
                                  np.asarray(jax_transformer._sinusoid(S_, d)))


@pytest.fixture(scope="module")
def runs():
    """Both packages' reduced whisper on the same weights, tokens and
    frames: the encoder's output (JAX's recorded where its decoder reads
    it), the prefill over S tokens, one decode step at S and greedy
    generation; and the port's prefill over S + 1 tokens."""
    jcfg = jax_config(ARCH, reduced=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, jcfg.enc_len, jcfg.d_model)).astype(
        np.float32)
    jbatch = {"tokens": jnp.asarray(tokens[:, :S]),
              "enc_embeds": jnp.asarray(frames)}
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jbatch)

    seen = []
    saved = jax_transformer.cross_kv

    def recording(p, cfg, enc_out):
        if not isinstance(enc_out, jax.core.Tracer):
            seen.append(np.asarray(enc_out))
        return saved(p, cfg, enc_out)

    jax_transformer.cross_kv = recording
    try:  # unjitted: the encoder's output reaches the decoder concrete
        jmodel.prefill(jparams, jbatch)
    finally:
        jax_transformer.cross_kv = saved
    _, axes = jmodel.cache_spec(B, S + 1)

    def pad(leaf, ax):  # the JAX decode wants the self cache at S + 1
        if "cache_seq" not in ax:
            return leaf
        widths = [(0, 0)] * leaf.ndim
        widths[ax.index("cache_seq")] = (0, 1)
        return jnp.pad(leaf, widths)

    jdec, _ = jax.jit(jmodel.decode)(jparams, {
        "token": jnp.asarray(tokens[:, S:]),
        "pos": jnp.full((B,), S, jnp.int32),
        "cache": jax.tree.map(pad, jcache, axes)})
    jtoks = jax_greedy_generate(jmodel, jparams, jbatch, steps=GEN,
                                s_max=S + GEN)

    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    t, f = torch.as_tensor(tokens), torch.as_tensor(frames)
    batch = {"tokens": t[:, :S], "enc_embeds": f}
    enc = model.encode(params, f)
    logits, cache = model.prefill(params, batch)
    dcache = model.alloc_cache(B, S + 1, "cpu")
    model.prefill(params, batch, cache=dcache)
    _, dec, _ = make_decode_step(model)(params, {
        "token": t[:, S:], "pos": torch.full((B,), S), "cache": dcache})
    toks = greedy_generate(model, params, batch, steps=GEN, s_max=S + GEN)
    full, _ = model.prefill(params, {"tokens": t, "enc_embeds": f})
    return dict(jenc=seen[0], jlogits=jlogits, jcache=jcache, jdec=jdec,
                jtoks=jtoks, enc=enc, logits=logits, cache=cache, dec=dec,
                toks=toks, full=full, vocab=cfg.vocab)


def test_encoder_output_matches_jax(runs):
    assert tuple(runs["enc"].shape) == runs["jenc"].shape
    close(runs["enc"], runs["jenc"])


def test_prefill_logits_match_jax(runs):
    assert tuple(runs["logits"].shape) == (B, runs["vocab"])
    assert runs["logits"].dtype == torch.float32
    close(runs["logits"], runs["jlogits"])


@pytest.mark.parametrize("leaf", ["k", "v", "ck", "cv"])
def test_prefill_cache_matches_jax(runs, leaf):
    """The decoder's self k/v (L, B, S, KV, hd) and its cross ck/cv over
    the encoder's frames (L, B, enc_len, H, hd), in the JAX layout."""
    got, want = runs["cache"][leaf], runs["jcache"][leaf]
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


def test_prefill_refuses_frames_the_cache_cannot_hold():
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    frames = torch.zeros((1, cfg.enc_len - 1, cfg.d_model))
    with pytest.raises(ValueError, match="enc_len"):
        model.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                               "enc_embeds": frames})


def _count(node):
    if isinstance(node, Leaf):
        return int(np.prod(node.shape))
    return sum(map(_count, node.values() if isinstance(node, dict)
                   else node))


def test_full_config_matches_the_jax_package():
    """Every field of FULL and REDUCED, the parameter count (0.79 B,
    ``tests/test_models_smoke.py``) and the cache layout equal the JAX
    package's."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(ARCH, reduced=True)) == \
        dataclasses.asdict(jax_config(ARCH, reduced=True))
    for c, jc in ((cfg, jcfg), (get_config(ARCH, reduced=True),
                                jax_config(ARCH, reduced=True))):
        n = _count(build_model(c).spec)
        jn = sum(int(np.prod(x.shape)) for x in
                 jax.tree.leaves(jax_build_model(jc).abstract()))
        assert n == jn
    assert _count(build_model(cfg).spec) / 1e9 == pytest.approx(0.79,
                                                                rel=0.02)
    want, _ = jax_build_model(jcfg).cache_spec(4, 448)
    got = build_model(cfg).alloc_cache(4, 448, "meta")
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == DTYPES[cfg.compute_dtype]


def test_from_jax_params_carries_both_stacks():
    """The stacked ``enc/...`` and ``dec/...`` leaves go to the port's
    per-layer lists — the LayerNorms' w/b pairs, cross-attention and the
    decoder's position table among them — and no leaf is left out."""
    cfg = get_config(ARCH, reduced=True)
    jparams = jax.tree.map(np.asarray, jax_build_model(jax_config(
        ARCH, reduced=True)).init(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(1)
    for stack, ln in (("enc", "ln2"), ("dec", "ln3")):  # ones and zeros
        for name in ("w", "b"):  # at init: make them tell apart
            leaf = jparams[stack][ln][name]
            jparams[stack][ln][name] = rng.standard_normal(
                leaf.shape).astype(leaf.dtype)
    params = from_jax_params(cfg, jparams)
    assert _count(build_model(cfg).spec) == sum(
        x.size for x in jax.tree.leaves(jparams))
    assert len(params["enc"]) == cfg.n_enc_layers
    assert len(params["dec"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        for path in (("enc", "ln2", "w"), ("enc", "ln2", "b"),
                     ("enc", "attn", "wq"), ("dec", "ln3", "w"),
                     ("dec", "ln3", "b"), ("dec", "xattn", "wk"),
                     ("dec", "xattn", "wo"), ("dec", "mlp", "w_down")):
            got, want = params, jparams
            for j, key in enumerate(path):
                got, want = got[key], want[key]
                if j == 0:
                    got = got[i]
            np.testing.assert_array_equal(got.numpy(), want[i])
    np.testing.assert_array_equal(params["pos_embed"].numpy(),
                                  jparams["pos_embed"])
    np.testing.assert_array_equal(params["dec_final_ln"]["b"].numpy(),
                                  jparams["dec_final_ln"]["b"])


def test_serve_cli_serves_the_arch(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch
    whisper-medium`` serves the reduced config and prints its JSON line."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert out["arch"] == ARCH and out["out_shape"] == [2, 3]
    assert f'"arch": "{ARCH}"' in capsys.readouterr().out
