"""The port's serving across ranks on gloo ranks of the CPU:
``greedy_generate(..., rules=make_rules(mesh, preset))`` on a 2 × 2
(data, model) mesh, the parameters as ``DTensor``s placed by the rules
(``shard_train_state``), the cache placed by them from
``model.cache_spec``, against the port's unsharded ``greedy_generate``
from the same JAX parameters (``from_jax_params``) on the same prompt, at
REDUCED widths in f32 and two layers.  Here the attention families:
qwen2.5-32b under the ``decode`` preset (batch 2: rows over data, the
cache's sequence over model) and under ``long`` (batch 1: the sequence
over data, the kv heads over model), gemma3-27b with its window cut to 8
in both packages (the window straddles the two sequence shards and, at
the last tokens, leaves the lower one wholly masked), qwen2-vl-72b with
one kv head (the q heads shard, the kv head cannot) and whisper-medium
(K6 at Sq = 1 in the cross-attention decode).  The ssm, hybrid and moe
families are in ``test_torch_mesh_serve_ssm.py``.

Each case's ``s_max`` is even, so the cache's sequence shards, and large
enough that one layer's local k-cache shard outgrows every partial a
decode step sends (which do not grow with ``s_max``): the collective
check below can then tell a gathered cache leaf from a partial.

For each case: the sharded tokens equal the unsharded ones and every
step's logits are within 1e-5 of the step's largest |logit| plus 1e-5
(f32, summation order only); each cache leaf's local shape is
``Rules.local_shape``, sharded along ``cache_seq``; every K6 call
received the local batch rows and head counts; no decode step's
collective gathers a cache leaf (``test_torch_ranks.
check_decode_collectives``).  qwen2.5-32b under ``decode`` is also held to
the JAX package's ``greedy_generate(..., rules=make_rules(mesh,
"decode"))`` on a 2 × 2 mesh of forced host devices, in a subprocess
while the ranks work: equal tokens, and each step's logits (those its
greedy token is taken from, read at its ``jnp.argmax``) within 1e-4
(``tests/test_torch_serve.py``'s tolerance).  Units on the same ranks
(``test_torch_ranks.serve_units``): the greedy token of vocab-sharded
logits with planted ties, the sequence-sharded decode attention with
wholly masked slices, and the cache writes on sequence shards.  The
four ranks are spawned once for the module.
"""
import functools
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build_model
from test_torch_loss_dense import configs, make_batch
from test_torch_ranks import (check_cache_shapes, check_decode_collectives,
                              check_serving_against_plain, run_ranks,
                              serve_cases_on_ranks, serve_units)

ROOT = pathlib.Path(__file__).resolve().parents[1]
S, STEPS = 16, 6  # prompt, generated tokens
# name: (arch, preset, batch, s_max, config fields changed in both
# packages: two layers, as tests/test_torch_mesh_train.py cuts them)
CASES = {
    "qwen2.5-32b/decode": ("qwen2.5-32b", "decode", 2, 48,
                           {"n_layers": 2}),
    "qwen2.5-32b/long": ("qwen2.5-32b", "long", 1, 48, {"n_layers": 2}),
    "gemma3-27b/decode": ("gemma3-27b", "decode", 2, 24,
                          {"n_layers": 2, "window": 8}),
    "qwen2-vl-72b/decode": ("qwen2-vl-72b", "decode", 2, 48,
                            {"n_layers": 2, "n_kv_heads": 1}),
    "whisper-medium/decode": ("whisper-medium", "decode", 2, 24,
                              {"n_layers": 2, "n_enc_layers": 2}),
}
JAX_CASES = ("qwen2.5-32b/decode",)
JAX_TOL = 1e-4

_JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    import repro.runtime.serve_step as serve_step
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh_shape
    from repro.models import build_model
    from repro.runtime.sharding import make_rules

    class Argmax:  # greedy_generate's jnp, keeping each logits it reads
        def __init__(self):
            self.seen = []

        def __getattr__(self, name):
            return getattr(jnp, name)

        def argmax(self, x, *args, **kwargs):
            self.seen.append(np.asarray(x))
            return jnp.argmax(x, *args, **kwargs)
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    mesh = make_mesh_shape((2, 2), ("data", "model"))
    out = {}
    for name, (arch, fields, preset, params, batch, steps, s_max) in \\
            cases.items():
        cfg = dataclasses.replace(get_config(arch, reduced=True), **fields)
        serve_step.jnp = Argmax()
        toks = serve_step.greedy_generate(
            build_model(cfg), jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()}, steps, s_max,
            rules=make_rules(mesh, preset))
        out[name] = {"tokens": np.asarray(toks),
                     "logits": serve_step.jnp.seen}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def serve_inputs(arch, B, fields, seed=0):
    """(JAX config, port config, JAX parameters as numpy, a numpy prompt
    of B rows of S tokens with the family's extras)."""
    jcfg, cfg = configs(arch, **fields)
    full = make_batch(cfg, S, seed=seed)
    batch = {"tokens": full["tokens"][:B, :S]}
    if "patch_embeds" in full:
        batch["patch_embeds"] = full["patch_embeds"][:B]
        batch["positions"] = full["positions"][:, :B]
    if "enc_embeds" in full:
        batch["enc_embeds"] = full["enc_embeds"][:B]
    params = jax.device_get(jax.jit(jax_build_model(jcfg).init)(
        jax.random.PRNGKey(seed)))
    return jcfg, cfg, jax.tree.map(np.asarray, params), batch


def run_module(cases, tmp_path, jax_cases=(), extra=None):
    """Every case of ``cases`` on four ranks in one spawn, the cases of
    ``jax_cases`` also through the JAX package's ``greedy_generate`` in a
    subprocess meanwhile.  (rank 0's results, the configs, the JAX runs)."""
    rank_cases, cfgs, jax_in = [], {}, {}
    for name, (arch, preset, B, s_max, fields) in cases.items():
        _, cfg, params, batch = serve_inputs(arch, B, fields)
        cfgs[name] = cfg
        rank_cases.append((name, (cfg, params, batch, preset, STEPS, s_max)))
        if name in jax_cases:
            jax_in[name] = (arch, fields, preset, params, batch, STEPS, s_max)
    torch.save(rank_cases, tmp_path / "cases.pt")
    with open(tmp_path / "jax_in.pkl", "wb") as f:
        pickle.dump(jax_in, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp_path / "jax_in.pkl"),
         str(tmp_path / "jax_out.pkl")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) \
        if jax_in else None
    try:
        ranks = run_ranks(functools.partial(
            serve_cases_on_ranks, str(tmp_path / "cases.pt"), extra=extra),
            4, tmp_path / "ranks")
    finally:
        if jax_run is not None:
            _, err = jax_run.communicate(timeout=600)
    jax_out = {}
    if jax_run is not None:
        assert jax_run.returncode == 0, err[-3000:]
        with open(tmp_path / "jax_out.pkl", "rb") as f:
            jax_out = pickle.load(f)
    for r in ranks[1:]:  # every rank returns the same whole tokens
        for name in cases:
            assert torch.equal(r[name]["sharded"][0],
                               ranks[0][name]["sharded"][0])
    return ranks[0], cfgs, jax_out


def expected_calls(cfg, preset, B, kv):
    """(rows, q heads, kv heads) each K6 call gets on a rank of the 2 × 2
    mesh: the rows over data under ``decode`` (whole under ``long``), the
    heads over model, the kv heads over model where they divide it, else
    the kv heads the rank's q heads read."""
    rows = B // 2 if preset == "decode" else B
    h = cfg.n_heads // 2
    return (rows, h, kv // 2 if kv % 2 == 0 else max(h // (cfg.n_heads // kv),
                                                     1))


def check_attention_calls(case, cfg, preset, B):
    calls = case["calls"]["fa_fwd"]
    assert calls
    kv = cfg.n_heads if cfg.mla else cfg.n_kv_heads
    want = {expected_calls(cfg, preset, B, kv)}
    if cfg.family == "encdec":  # the encoder and the cross-attention
        want.add(expected_calls(cfg, preset, B, cfg.n_heads))
    assert set(calls) <= want, (set(calls), want)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_module(CASES, tmp_path_factory.mktemp("mesh_serve"),
                      jax_cases=JAX_CASES, extra=serve_units)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_generation_matches_the_unsharded_one(results, name):
    check_serving_against_plain(results[0][name])


@pytest.mark.parametrize("name", list(CASES))
def test_every_cache_leaf_has_its_rules_local_shape(results, name):
    check_cache_shapes(results[0][name])


@pytest.mark.parametrize("name", list(CASES))
def test_the_attention_kernel_received_local_rows_and_heads(results, name):
    _, preset, B, _, _ = CASES[name]
    check_attention_calls(results[0][name], results[1][name], preset, B)


@pytest.mark.parametrize("name", list(CASES))
def test_no_decode_step_gathers_a_cache_leaf(results, name):
    check_decode_collectives(results[0][name])


def test_whisper_cross_attention_decode_runs_k6_on_local_heads(results):
    """Each decode token's cross-attention is one K6 call a layer at Sq = 1
    with the rank's two of four heads (the call records carry no Sq, so
    the count tells the decode's calls apart: three a layer a prefill —
    the encoder, self- and cross-attention — then one a token)."""
    cfg = results[1]["whisper-medium/decode"]
    calls = results[0]["whisper-medium/decode"]["calls"]["fa_fwd"]
    n = cfg.n_enc_layers + 2 * cfg.n_layers + (STEPS - 1) * cfg.n_layers
    assert len(calls) == n, (len(calls), n)
    assert set(calls[-(STEPS - 1) * cfg.n_layers:]) == {(1, 2, 2)}


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_generation_matches_jax(results, name):
    got_toks, got_logits = results[0][name]["sharded"]
    want = results[2][name]
    np.testing.assert_array_equal(got_toks.numpy(), want["tokens"])
    assert len(got_logits) == len(want["logits"])
    for got, w in zip(got_logits, want["logits"]):
        np.testing.assert_allclose(got.numpy(), w, rtol=JAX_TOL,
                                   atol=JAX_TOL)


def test_sharded_argmax_takes_the_least_global_index_among_ties(results):
    got, want = results[0]["extra"]["argmax"]
    assert want[:3].tolist() == [3, 9, 0]
    for placements, idx in got.items():
        assert torch.equal(idx, want), (placements, idx, want)


def test_sequence_sharded_decode_attention_with_a_masked_slice(results):
    for placements, (sharded, plain) in results[0]["extra"][
            "attention"].items():
        assert torch.isfinite(sharded).all(), placements
        torch.testing.assert_close(sharded, plain, rtol=1e-6, atol=1e-6)


def test_cache_writes_on_sequence_shards_equal_the_whole_cache_writes(results):
    for placements, (sharded, whole) in results[0]["extra"][
            "writes"].items():
        assert torch.equal(sharded, whole), placements
