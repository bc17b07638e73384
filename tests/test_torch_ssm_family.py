"""The port's ssm family (mamba2-2.7b) against the JAX package on the
CPU: the REDUCED config in f32, the JAX parameters carried across by
``from_jax_params``.

Prefill logits and both cache leaves (each layer's final SSD state and
conv window), one decode step's logits, greedy tokens (exact) and the
decode/prefill consistency, at the tolerance ``tests/test_torch_serve.py``
states for the hybrid (1e-4, rtol and atol; the differences seen are
~5e-6).  The prompt (80 tokens) spans three SSD chunks of the reduced
config (32).  The FULL config equals the JAX package's field by field,
with the same parameter count and cache layout.

torch runs single-threaded here (see ``tests/test_torch_serve.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.layers import Leaf
from repro_torch.runtime import greedy_generate
from test_torch_dense_family import B, GEN, close, serve_both

S = 80


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    return serve_both("mamba2-2.7b", S)


def test_prefill_logits_match_jax(runs):
    assert tuple(runs["logits"].shape) == (B, runs["vocab"])
    assert runs["logits"].dtype == torch.float32
    close(runs["logits"], runs["jlogits"])


@pytest.mark.parametrize("leaf", ["ssm", "conv"])
def test_prefill_cache_matches_jax(runs, leaf):
    """ssm (L, B, H, P, N) and conv (L, B, W-1, conv_dim)."""
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
    close(runs["dec"], runs["full"])


def test_full_config_matches_the_jax_package():
    """Mamba2-2.7B: the same config, 2.83 B parameters, 64 blocks of 80
    heads (P 64, N 128), the JAX cache layout."""
    cfg, jcfg = get_config("mamba2-2.7b"), jax_config("mamba2-2.7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(get_config("mamba2-2.7b", reduced=True)) == \
        dataclasses.asdict(jax_config("mamba2-2.7b", reduced=True))

    def count(node):
        if isinstance(node, Leaf):
            return int(np.prod(node.shape))
        return sum(map(count, node.values() if isinstance(node, dict)
                       else node))

    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    n = count(model.spec)
    jn = sum(int(np.prod(x.shape)) for x in
             jax.tree.leaves(jmodel.abstract()))
    assert n == jn and n / 1e9 == pytest.approx(2.83, rel=0.01)
    assert (cfg.n_layers, cfg.n_ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state) == (64, 80, 64, 128)
    want, _ = jmodel.cache_spec(4, 2080)
    got = model.alloc_cache(4, 2080, "meta")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16


def test_greedy_generate_allocates_no_sequence_axis():
    """The recurrent cache has no sequence axis: a long s_max costs
    nothing, and the prefill writes every layer's state in place."""
    cfg = get_config("mamba2-2.7b", reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.alloc_cache(1, 10 ** 6, "cpu")
    assert cache["ssm"].shape[0] == cfg.n_layers
    tokens = torch.zeros((1, 8), dtype=torch.long)
    _, out = model.prefill(params, {"tokens": tokens}, cache=cache)
    assert out is cache and bool(cache["ssm"].abs().sum() > 0)
    toks = greedy_generate(model, params, {"tokens": tokens}, steps=3,
                           s_max=11)
    assert tuple(toks.shape) == (1, 3)
