"""The port's vlm family — qwen2-vl-72b: M-RoPE over three position
streams, patch embeddings before the text (the vision tower is a stub in
both packages) — against the JAX package on the CPU: the REDUCED config
in f32, the JAX parameters carried across by ``from_jax_params``.

``apply_rope`` with M-RoPE sections at both configs' head dims, on
distinct streams; identical streams reduce it to plain RoPE, and stream 0
alone gives another result, so the cases tell M-RoPE apart.  The model:
prefill logits with Qwen2-VL's grid positions (the patches on a 4 × 4
grid, t = 0, h = row, w = col; the text from the largest + 1 on all three
streams), both cache leaves, one decode step whose rotary streams differ
from its cache slot, and greedy tokens on ``launch/serve.py``'s inputs
(identical streams 0.., the decode from S0 + n_vision_tokens), at the
tolerance ``tests/test_torch_serve.py`` states (1e-4, rtol and atol: f32
in both packages, summation order only); tokens exact.  The FULL config
equals the JAX package's field by field, with the same parameter count
(72.7 B) and cache layout.

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
from repro.models.layers import apply_rope as jax_apply_rope
from repro.runtime import greedy_generate as jax_greedy_generate
from repro_torch.configs import get_config
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.layers import DTYPES, Leaf, apply_rope
from repro_torch.runtime import greedy_generate, make_decode_step

TOL = 1e-4
ARCH = "qwen2-vl-72b"
B, S, GEN = 2, 24, 6  # text tokens after the 16 patches
GRID = 4  # the reduced config's 16 patches on a 4 x 4 grid


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


def grid_positions(batch, grid, n_text):
    """(3, batch, grid² + n_text) int32: the patches at t = 0, h = row,
    w = col, then the text from the largest + 1 on all three streams."""
    r, c = np.divmod(np.arange(grid * grid), grid)
    vision = np.stack([np.zeros_like(r), r, c])
    text = np.broadcast_to(np.arange(n_text) + grid, (3, n_text))
    pos = np.concatenate([vision, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, batch, pos.shape[1])))


def _rope_case(hd, sections, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    # distinct streams: t, h and w each their own draw
    pos = rng.integers(0, 5000, (3, 2, 40)).astype(np.int32)
    return x, pos


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_mrope_matches_jax_on_distinct_streams(hd, sections):
    x, pos = _rope_case(hd, sections, hd)
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                     sections)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    close(got, want)


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_mrope_on_identical_streams_is_plain_rope(hd, sections):
    x, pos = _rope_case(hd, sections, hd + 1)
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    got = apply_rope(torch.as_tensor(x), torch.as_tensor(same), 1e6,
                     sections)
    plain = apply_rope(torch.as_tensor(x), torch.as_tensor(pos[0]), 1e6)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    close(got, jax_apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), 1e6))


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_stream_0_alone_is_not_mrope(hd, sections):
    """Without sections a (3, B, S) input rotates by stream 0, as JAX's
    does; on distinct streams that is far from M-RoPE, so the cases above
    would see a port that ignored the h and w streams."""
    x, pos = _rope_case(hd, sections, hd + 2)
    t0 = apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)
    close(t0, jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    mrope = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    assert np.abs(t0.numpy() - np.asarray(mrope)).max() > 0.5


def test_mrope_refuses_sections_that_miss_half_the_head():
    x = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="M-RoPE"):
        apply_rope(x, torch.zeros((3, 1, 4), dtype=torch.long), 1e4,
                   (4, 6, 5))
    with pytest.raises(ValueError, match="M-RoPE"):
        apply_rope(x, torch.zeros((1, 4), dtype=torch.long), 1e4, (4, 6, 6))


@pytest.fixture(scope="module")
def runs():
    """Both packages' reduced qwen2-vl on the same weights and inputs: the
    prefill over the 16 patches + S tokens at grid positions, one decode
    step at cache slot nv + S with the grid's next rotary position, the
    same prefill with the sections dropped, and greedy generation on
    ``launch/serve.py``'s inputs (identical streams)."""
    jcfg = jax_config(ARCH, reduced=True)
    nv, d = jcfg.n_vision_tokens, jcfg.d_model
    assert nv == GRID * GRID
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    patches = rng.standard_normal((B, nv, d)).astype(np.float32)
    pos = grid_positions(B, GRID, S)
    stot = nv + S
    jbatch = {"tokens": jnp.asarray(tokens[:, :S]),
              "patch_embeds": jnp.asarray(patches),
              "positions": jnp.asarray(pos)}
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jbatch)
    _, axes = jmodel.cache_spec(B, stot + 1)

    def pad(leaf, ax):  # the JAX decode wants the cache at S_max + 1
        widths = [(0, 0)] * leaf.ndim
        widths[ax.index("cache_seq")] = (0, 1)
        return jnp.pad(leaf, widths)

    nxt = GRID + S  # the text's next position on every stream
    jdec, _ = jax.jit(jmodel.decode)(jparams, {
        "token": jnp.asarray(tokens[:, S:]),
        "pos": jnp.full((B,), stot, jnp.int32),
        "positions": jnp.full((3, B, 1), nxt, jnp.int32),
        "cache": jax.tree.map(pad, jcache, axes)})
    serve_pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(stot, dtype=np.int32), (3, B, stot)))
    s_max = stot + GEN + 1
    jtoks = jax_greedy_generate(jmodel, jparams, {
        "tokens": jnp.asarray(tokens[:, :S]),
        "patch_embeds": jnp.asarray(patches),
        "positions": jnp.asarray(serve_pos)}, steps=GEN, s_max=s_max)

    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    t = torch.as_tensor(tokens)
    batch = {"tokens": t[:, :S], "patch_embeds": torch.as_tensor(patches),
             "positions": torch.as_tensor(pos)}
    logits, cache = model.prefill(params, batch)
    dcache = model.alloc_cache(B, stot + 1, "cpu")
    model.prefill(params, batch, cache=dcache)
    _, dec, _ = make_decode_step(model)(params, {
        "token": t[:, S:], "pos": torch.full((B,), stot),
        "positions": torch.full((3, B, 1), nxt), "cache": dcache})
    no_sections, _ = build_model(cfg.replace(mrope_sections=None)).prefill(
        params, batch)
    toks = greedy_generate(model, params, {
        "tokens": t[:, :S], "patch_embeds": torch.as_tensor(patches),
        "positions": torch.as_tensor(serve_pos)}, steps=GEN, s_max=s_max)
    return dict(jlogits=jlogits, jcache=jcache, jdec=jdec, jtoks=jtoks,
                logits=logits, cache=cache, dec=dec, toks=toks,
                no_sections=no_sections, stot=stot, vocab=cfg.vocab)


def test_prefill_logits_match_jax(runs):
    assert tuple(runs["logits"].shape) == (B, runs["vocab"])
    assert runs["logits"].dtype == torch.float32
    close(runs["logits"], runs["jlogits"])


def test_prefill_logits_depend_on_the_mrope_sections(runs):
    """The same weights and grid positions without the sections (stream 0
    alone) move the logits: the prefill's match above is M-RoPE's."""
    assert np.abs(runs["no_sections"].numpy()
                  - np.asarray(runs["jlogits"])).max() > 1e-2


@pytest.mark.parametrize("leaf", [0, 1], ids=["k", "v"])
def test_prefill_cache_matches_jax(runs, leaf):
    """Each layer's k (after M-RoPE) and v over the patches and the text,
    in the JAX layout (L, B, nv + S, KV, hd)."""
    got, want = runs["cache"]["dense"][leaf], runs["jcache"]["dense"][leaf]
    assert tuple(got.shape) == want.shape and want.shape[2] == runs["stot"]
    close(got, want)


def test_decode_logits_match_jax(runs):
    close(runs["dec"], runs["jdec"])


def test_greedy_tokens_match_jax(runs):
    """``launch/serve.py``'s inputs: the decode starts after the patches
    and the prompt, every stream at that position."""
    assert runs["toks"].dtype == torch.int32
    np.testing.assert_array_equal(runs["toks"].numpy(),
                                  np.asarray(runs["jtoks"]))


def test_greedy_generate_counts_the_patches_in_s_max():
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    nv = cfg.n_vision_tokens
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "patch_embeds": torch.zeros((1, nv, cfg.d_model)),
             "positions": torch.arange(nv + 8).expand(3, 1, nv + 8)}
    with pytest.raises(ValueError, match="s_max"):
        greedy_generate(model, params, batch, steps=4, s_max=8 + 3)
    out = greedy_generate(model, params, batch, steps=4, s_max=nv + 8 + 3)
    assert tuple(out.shape) == (1, 4)


def _count(node):
    if isinstance(node, Leaf):
        return int(np.prod(node.shape))
    return sum(map(_count, node.values() if isinstance(node, dict)
                   else node))


def test_full_config_matches_the_jax_package():
    """Every field of FULL and REDUCED, the parameter count (72.7 B,
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
    assert _count(build_model(cfg).spec) / 1e9 == pytest.approx(72.7,
                                                                rel=0.02)
    want, _ = jax_build_model(jcfg).cache_spec(4, 3104)
    got = build_model(cfg).alloc_cache(4, 3104, "meta")
    assert set(got) == set(want)
    for g, w in zip(got["dense"], want["dense"]):
        assert tuple(g.shape) == w.shape
        assert g.dtype == DTYPES[cfg.compute_dtype]


def test_from_jax_params_carries_the_qkv_bias():
    """qwen2-vl's attention biases bq/bk/bv go across with the stacked
    blocks, layer by layer, and no leaf is left out."""
    cfg = get_config(ARCH, reduced=True)
    jparams = jax.tree.map(np.asarray, jax_build_model(jax_config(
        ARCH, reduced=True)).init(jax.random.PRNGKey(7)))
    for name in ("bq", "bk", "bv"):  # zeros at init: make them tell apart
        leaf = jparams["blocks"]["attn"][name]
        jparams["blocks"]["attn"][name] = np.random.default_rng(
            len(name)).standard_normal(leaf.shape).astype(leaf.dtype)
    params = from_jax_params(cfg, jparams)
    assert _count(build_model(cfg).spec) == sum(
        x.size for x in jax.tree.leaves(jparams))
    for i in range(cfg.n_layers):
        for name in ("bq", "bk", "bv", "wq"):
            np.testing.assert_array_equal(
                params["blocks"][i]["attn"][name].numpy(),
                jparams["blocks"]["attn"][name][i])


def test_serve_cli_serves_the_arch(capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch
    qwen2-vl-72b`` serves the reduced config and prints its JSON line."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert out["arch"] == ARCH and out["out_shape"] == [2, 3]
    assert f'"arch": "{ARCH}"' in capsys.readouterr().out
