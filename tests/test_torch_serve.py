"""The port's serving path (reduced Zamba2: prefill, decode, greedy
generation) against the JAX package on the CPU, with the JAX parameters
carried across by ``from_jax_params``.

Tolerance 1e-4 (rtol and atol) on logits and cache leaves: both packages
compute in f32 and differ in the summation order of every matmul, the SSD
chunk products and the attention chunks over 13 layers; the differences
seen are ~1e-5.  Greedy tokens must be equal.

torch runs single-threaded here: on some hosts one OpenMP worker thread of
a process has computed torch's vectorized f32 ``exp`` up to 1.5e-4
relative off over its share of a tensor, which these tolerances would see.
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
from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.layers import Leaf, init_params
from repro_torch.models.transformer import hybrid_layout
from repro_torch.runtime import greedy_generate, make_decode_step

TOL = 1e-4
B, S, GEN = 2, 32, 8


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


@pytest.fixture(scope="module")
def runs():
    """Both packages' reduced Zamba2 on the same weights and tokens: the
    prefill over S tokens, one decode step at S, greedy generation."""
    jcfg = jax_config("zamba2-7b", reduced=True)
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

    cfg = get_config("zamba2-7b", reduced=True)
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
                logits=logits, cache=cache, dec=dec, toks=toks, full=full)


def test_prefill_logits_match_jax(runs):
    assert tuple(runs["logits"].shape) == (B, 512)
    assert runs["logits"].dtype == torch.float32
    close(runs["logits"], runs["jlogits"])


@pytest.mark.parametrize("leaf", ["g_ssm", "g_conv", "k", "v", "t_ssm",
                                  "t_conv"])
def test_prefill_cache_matches_jax(runs, leaf):
    """Every cache leaf in the JAX layout (allocated at S_max = S)."""
    got, want = runs["cache"][leaf], runs["jcache"][leaf]
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_decode_logits_match_jax(runs):
    close(runs["dec"], runs["jdec"])


def test_greedy_tokens_match_jax(runs):
    """B = 2, prompt 32, 8 tokens; the port's cache is allocated at s_max
    and the prefill writes into its head."""
    assert runs["toks"].dtype == torch.int32
    np.testing.assert_array_equal(runs["toks"].numpy(),
                                  np.asarray(runs["jtoks"]))


def test_prefill_decode_consistency(runs):
    """Decode of token S after a prefill of S tokens gives the last logits
    of a prefill of S + 1 (cache layout, masks, RoPE positions and the
    state hand-off), as ``tests/test_models_smoke.py`` checks the JAX
    package."""
    close(runs["dec"], runs["full"])


def test_alloc_cache_has_the_jax_layout():
    jmodel = jax_build_model(jax_config("zamba2-7b"))
    model = build_model(get_config("zamba2-7b"))
    want, _ = jmodel.cache_spec(4, 2080)
    got = model.alloc_cache(4, 2080, "meta")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16


def test_full_config_matches_the_jax_package():
    """Zamba2-7B: the same config, parameter count (5.7 B) and layout — 13
    groups of 5 Mamba2 blocks and one shared attention block, 3 tail
    blocks: 68 SSD scans and 13 attention applications per prefill."""
    cfg, jcfg = get_config("zamba2-7b"), jax_config("zamba2-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config("zamba2-7b", reduced=True)) == \
        dataclasses.asdict(jax_config("zamba2-7b", reduced=True))

    def count(node):
        if isinstance(node, Leaf):
            return int(np.prod(node.shape))
        return sum(map(count, node.values() if isinstance(node, dict)
                       else node))

    n = count(build_model(cfg).spec)
    jn = sum(int(np.prod(x.shape)) for x in
             jax.tree.leaves(jax_build_model(jcfg).abstract()))
    assert n == jn and n / 1e9 == pytest.approx(5.7, rel=0.02)
    G, M, T = hybrid_layout(cfg)
    assert (G, M, T, G * M + T) == (13, 5, 3, 68)


def test_init_draws_each_kind_on_the_generators_device():
    spec = {"z": Leaf((64,), "zeros"), "o": Leaf((64,), "ones"),
            "n": Leaf((256, 256), "normal"), "f": Leaf((400, 300)),
            "s": Leaf((300, 10), "normal", 0.1)}
    p = init_params(spec, torch.bfloat16, torch.Generator().manual_seed(3))
    assert p["z"].dtype == torch.bfloat16 and not p["z"].requires_grad
    assert torch.all(p["z"] == 0) and torch.all(p["o"] == 1)
    assert float(p["n"].float().std()) == pytest.approx(0.02, rel=0.05)
    assert float(p["f"].float().std()) == pytest.approx(400 ** -0.5,
                                                        rel=0.05)
    assert float(p["s"].float().std()) == pytest.approx(0.1, rel=0.05)
    q = init_params(spec, torch.bfloat16, torch.Generator().manual_seed(3))
    assert torch.equal(p["f"], q["f"])  # a seed gives the same weights


def test_from_jax_params_rejects_a_foreign_tree():
    cfg = get_config("zamba2-7b", reduced=True)
    tree = jax.tree.map(np.asarray, jax_build_model(
        jax_config("zamba2-7b", reduced=True)).init(jax.random.PRNGKey(1)))
    wq = tree["shared_attn"]["attn"]["wq"]
    tree["shared_attn"]["attn"]["wq"] = wq[1:]
    with pytest.raises(ValueError, match="shared_attn/attn/wq"):
        from_jax_params(cfg, tree)
    tree["shared_attn"]["attn"]["wq"] = wq
    del tree["tail"]
    with pytest.raises(ValueError, match="no leaf"):
        from_jax_params(cfg, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_of_the_registry_builds(arch):
    """Every arch of the JAX package's registry has a config and a model
    in the port, FULL and REDUCED, with a cache that allocates."""
    for reduced in (False, True):
        cfg = get_config(arch, reduced=reduced)
        model = build_model(cfg)
        assert model.config is cfg and model.spec
        cache = model.alloc_cache(2, 16, "meta")
        leaves = [t for v in cache.values()
                  for t in (v if isinstance(v, tuple) else (v,))]
        assert leaves and all(t.device.type == "meta" for t in leaves)


def test_unknown_arch_and_family_raise():
    with pytest.raises(KeyError):
        get_config("llama-9000")
    with pytest.raises(ValueError, match="retnet"):
        build_model(get_config("zamba2-7b").replace(family="retnet"))


def test_device_none_means_the_card(monkeypatch):
    """Entry points run on the card unless the caller names the CPU; with
    no card they raise rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--gen", "2"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--seed", "1"])
    assert out["out_shape"] == [2, 4] and out["device"] == "cpu"
    assert '"arch": "zamba2-7b"' in capsys.readouterr().out


def test_greedy_generate_needs_room_in_the_cache():
    cfg = get_config("zamba2-7b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="s_max"):
        greedy_generate(model, params, {"tokens": torch.zeros(1, 8,
                                                              dtype=int)},
                        steps=4, s_max=10)
