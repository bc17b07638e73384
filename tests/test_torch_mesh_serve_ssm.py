"""The port's serving across ranks for the moe, ssm and hybrid families
on a 2 × 2 (data, model) gloo mesh of the CPU, as
``tests/test_torch_mesh_serve.py`` holds the attention families:
deepseek-v3-671b under ``decode`` (MLA's absorbed decode over a
sequence-sharded c_kv cache; one dense and one moe layer, whose decode
dispatches the batch's two tokens in two groups over data),
mamba2-2.7b under ``long`` (batch 1: its states' heads over model, the
conv window's channels too) and zamba2-7b under ``decode`` (one group of
a Mamba2 layer and the shared attention block, then a trailing Mamba2
layer).  For each: the sharded tokens equal the unsharded ones, every
step's logits within 1e-5 of the step's largest |logit| plus 1e-5; each
cache leaf's local shape is ``Rules.local_shape``; K6 and K7 received
the local batch rows and head counts; no decode step's collective
gathers a cache leaf.  mamba2-2.7b is also held to the JAX package's
``greedy_generate(..., rules=make_rules(mesh, "long"))`` on forced host
devices: equal tokens, logits within 1e-4.
"""
import numpy as np
import pytest
import torch

from test_torch_mesh_serve import (JAX_TOL, STEPS, check_attention_calls,
                                   run_module)
from test_torch_ranks import (check_cache_shapes, check_decode_collectives,
                              check_serving_against_plain)

CASES = {
    "deepseek-v3-671b/decode": ("deepseek-v3-671b", "decode", 2, 48,
                                {"n_layers": 2, "moe_layer_start": 1}),
    "mamba2-2.7b/long": ("mamba2-2.7b", "long", 1, 24, {"n_layers": 2}),
    "zamba2-7b/decode": ("zamba2-7b", "decode", 2, 24,
                         {"n_layers": 3, "hybrid_every": 2}),
}
JAX_CASES = ("mamba2-2.7b/long",)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_module(CASES, tmp_path_factory.mktemp("mesh_serve_ssm"),
                      jax_cases=JAX_CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_generation_matches_the_unsharded_one(results, name):
    check_serving_against_plain(results[0][name])


@pytest.mark.parametrize("name", list(CASES))
def test_every_cache_leaf_has_its_rules_local_shape(results, name):
    check_cache_shapes(results[0][name])


@pytest.mark.parametrize("name", list(CASES))
def test_the_kernels_received_local_rows_and_heads(results, name):
    _, preset, B, _, _ = CASES[name]
    case, cfg = results[0][name], results[1][name]
    rows = B // 2 if preset == "decode" else B
    if cfg.family in ("ssm", "hybrid"):
        ssd = case["calls"]["ssd"]
        assert ssd and set(ssd) == {(rows, cfg.n_ssm_heads // 2)}, ssd
    if cfg.family != "ssm":
        check_attention_calls(case, cfg, preset, B)


@pytest.mark.parametrize("name", list(CASES))
def test_no_decode_step_gathers_a_cache_leaf(results, name):
    check_decode_collectives(results[0][name])


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_generation_matches_jax(results, name):
    got_toks, got_logits = results[0][name]["sharded"]
    want = results[2][name]
    np.testing.assert_array_equal(got_toks.numpy(), want["tokens"])
    assert len(got_logits) == len(want["logits"])
    for got, w in zip(got_logits, want["logits"]):
        np.testing.assert_allclose(got.numpy(), w, rtol=JAX_TOL,
                                   atol=JAX_TOL)
