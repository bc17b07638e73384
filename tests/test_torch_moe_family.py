"""The port's moe family — dbrx-132b (GQA + 16 experts top-4) and
deepseek-v3-671b (MLA, 3 dense layers then 1 shared + 256 routed top-8,
the multi-token-prediction head) — against the JAX package on the CPU:
the REDUCED configs in f32, the JAX parameters carried across by
``from_jax_params``.

Each arch: prefill logits, every cache leaf (dbrx's k/v after RoPE,
deepseek's c_kv and k_rope of its dense and its moe layers), one decode
step's logits and greedy tokens (exact), at the tolerance
``tests/test_torch_serve.py`` states for the hybrid (1e-4, rtol and atol:
f32 in both packages, summation order only).  deepseek runs at
``examples/serve_batched.py``'s setting (batch 4, prompt 48, 16 tokens,
the JAX ``launch/serve.py`` weights and prompts), so its greedy tokens
are that milestone's.  The FULL configs equal the JAX package's field by
field, with the same parameter count and cache layout.

A prefill over S + 1 tokens drops tokens at capacity that a decode step
(one token a group, C = 1) keeps, in JAX too, so the two agree only where
nothing is dropped: at ``capacity_factor`` = E/k.

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
from repro_torch.runtime import greedy_generate, make_decode_step

TOL = 1e-4
# arch: (batch, prompt length, tokens generated, drawn as launch/serve.py
# draws them?)
RUNS = {"dbrx-132b": (2, 32, 6, False),
        "deepseek-v3-671b": (4, 48, 16, True)}


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


def serve_both(arch):
    """Both packages' reduced ``arch`` on the same weights and tokens: the
    prefill over S tokens, one decode step at S and greedy generation.
    deepseek's weights and prompts are the JAX ``launch/serve.py``'s at
    seed 0, as ``examples/serve_batched.py`` runs it."""
    B, S, GEN, as_serve = RUNS[arch]
    jcfg = jax_config(arch, reduced=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if as_serve:
        prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                               (B, S), 0, jcfg.vocab))
        nxt = np.random.default_rng(0).integers(0, jcfg.vocab, (B, 1))
        tokens = np.concatenate([prompt, nxt], axis=1)
    else:
        tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S + 1))
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    _, axes = jmodel.cache_spec(B, S + 1)

    def pad(leaf, ax):  # the JAX decode wants the cache at S_max = S + 1
        widths = [(0, 0)] * leaf.ndim
        widths[ax.index("cache_seq")] = (0, 1)
        return jnp.pad(leaf, widths)

    jdec, _ = jax.jit(jmodel.decode)(jparams, {
        "token": jnp.asarray(tokens[:, S:]),
        "pos": jnp.full((B,), S, jnp.int32),
        "cache": jax.tree.map(pad, jcache, axes)})
    s_max = S + GEN + 1
    jtoks = jax_greedy_generate(jmodel, jparams,
                                {"tokens": jnp.asarray(tokens[:, :S])},
                                steps=GEN, s_max=s_max)

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
                           s_max=s_max)
    return dict(jlogits=jlogits, jcache=jcache, jdec=jdec, jtoks=jtoks,
                logits=logits, cache=cache, dec=dec, toks=toks, B=B,
                vocab=cfg.vocab)


_RUNS = {}


@pytest.fixture(params=list(RUNS))
def runs(request):
    arch = request.param
    if arch not in _RUNS:
        _RUNS[arch] = serve_both(arch)
    return _RUNS[arch]


def test_prefill_logits_match_jax(runs):
    assert tuple(runs["logits"].shape) == (runs["B"], runs["vocab"])
    assert runs["logits"].dtype == torch.float32
    close(runs["logits"], runs["jlogits"])


def test_prefill_cache_matches_jax(runs):
    """Every leaf in the JAX layout: ``dense`` only where the config has
    dense layers, (k, v) (L, B, S, KV, hd) or, under MLA, (c_kv (L, B, S,
    kv_lora), k_rope (L, B, S, rope_hd))."""
    assert set(runs["cache"]) == set(runs["jcache"])
    for key in runs["jcache"]:
        for got, want in zip(runs["cache"][key], runs["jcache"][key]):
            assert tuple(got.shape) == want.shape
            close(got, want)


def test_decode_logits_match_jax(runs):
    close(runs["dec"], runs["jdec"])


def test_greedy_tokens_match_jax(runs):
    assert runs["toks"].dtype == torch.int32
    np.testing.assert_array_equal(runs["toks"].numpy(),
                                  np.asarray(runs["jtoks"]))


@pytest.mark.parametrize("runs", ["deepseek-v3-671b"], indirect=True)
def test_serve_batched_deepseek_tokens_match_jax(runs):
    """The milestone: ``examples/serve_batched.py``'s deepseek-v3-671b
    (reduced; batch 4, prompt 48, 16 tokens; the JAX ``launch/serve.py``
    weights and prompts at seed 0) gives the JAX package's greedy tokens
    through the port, on the carried weights."""
    assert tuple(runs["toks"].shape) == (4, 16)
    np.testing.assert_array_equal(runs["toks"].numpy(),
                                  np.asarray(runs["jtoks"]))


@pytest.mark.parametrize("arch", list(RUNS))
def test_prefill_decode_consistency_when_nothing_is_dropped(arch):
    """At ``capacity_factor`` = E/k no expert drops a token, so a decode
    of token S after a prefill of S gives the last logits of a prefill of
    S + 1."""
    cfg = get_config(arch, reduced=True)
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    B, S = 2, 20
    t = torch.randint(0, cfg.vocab, (B, S + 1),
                      generator=torch.Generator().manual_seed(3))
    cache = model.alloc_cache(B, S + 1, "cpu")
    model.prefill(params, {"tokens": t[:, :S]}, cache=cache)
    dec, cache = model.decode(params, {"token": t[:, S:],
                                       "pos": torch.full((B,), S),
                                       "cache": cache})
    full, fcache = model.prefill(params, {"tokens": t})
    close(dec, full)
    for key in fcache:
        for got, want in zip(cache[key], fcache[key]):
            close(got, want)


def _count(node):
    if isinstance(node, Leaf):
        return int(np.prod(node.shape))
    return sum(map(_count, node.values() if isinstance(node, dict)
                   else node))


@pytest.mark.parametrize("arch,billions", [("dbrx-132b", 131.6),
                                           ("deepseek-v3-671b", 671.0)])
def test_full_config_matches_the_jax_package(arch, billions):
    """Every field of FULL and REDUCED, the parameter count (the mtp head
    included) and the cache layout equal the JAX package's."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config(arch, reduced=True)) == \
        dataclasses.asdict(jax_config(arch, reduced=True))
    for c, jc in ((cfg, jcfg), (get_config(arch, reduced=True),
                                jax_config(arch, reduced=True))):
        n = _count(build_model(c).spec)
        jn = sum(int(np.prod(x.shape)) for x in
                 jax.tree.leaves(jax_build_model(jc).abstract()))
        assert n == jn
    assert _count(build_model(cfg).spec) / 1e9 == pytest.approx(
        billions, rel=0.01)
    want, _ = jax_build_model(jcfg).cache_spec(4, 2080)
    got = build_model(cfg).alloc_cache(4, 2080, "meta")
    assert set(got) == set(want)
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert tuple(g.shape) == w.shape
            assert g.dtype == DTYPES[cfg.compute_dtype]


def test_from_jax_params_carries_moe_blocks_and_the_mtp_head():
    """The stacked ``moe_blocks/...`` leaves (n_moe, ...) go to the port's
    per-layer list, and the unstacked ``mtp/block/...`` subtree whole."""
    cfg = get_config("deepseek-v3-671b", reduced=True)
    jparams = jax.tree.map(np.asarray, jax_build_model(jax_config(
        "deepseek-v3-671b", reduced=True)).init(jax.random.PRNGKey(7)))
    params = from_jax_params(cfg, jparams)
    assert len(params["blocks"]) == 2 and len(params["moe_blocks"]) == 3
    for i in range(3):
        np.testing.assert_array_equal(
            params["moe_blocks"][i]["moe"]["w_gate"].numpy(),
            jparams["moe_blocks"]["moe"]["w_gate"][i])
        np.testing.assert_array_equal(
            params["moe_blocks"][i]["moe"]["shared"]["w_down"].numpy(),
            jparams["moe_blocks"]["moe"]["shared"]["w_down"][i])
    np.testing.assert_array_equal(
        params["mtp"]["block"]["attn"]["wkv_a"].numpy(),
        jparams["mtp"]["block"]["attn"]["wkv_a"])
    np.testing.assert_array_equal(params["mtp"]["proj"].numpy(),
                                  jparams["mtp"]["proj"])


@pytest.mark.parametrize("arch", list(RUNS))
def test_serve_cli_serves_the_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch <arch>``
    serves each moe arch at its reduced size and prints its JSON line."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    assert out["arch"] == arch and out["out_shape"] == [2, 3]
    assert f'"arch": "{arch}"' in capsys.readouterr().out
