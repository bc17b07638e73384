"""The port's sharded train step on gloo ranks of the CPU: one step of
``make_train_step(rules=make_rules(mesh, "train"))`` with the state and
the batch as ``DTensor``s on a 2 × 2 (data, model) mesh, against the
port's unsharded step from the same JAX parameters (``from_jax_params``)
on the same batch, at REDUCED widths in f32 and two layers.  Here the attention
families: dense qwen2.5-32b, vlm qwen2-vl-72b with one kv head (GQA's
fallback: the kv heads cannot shard over the model axis while the q heads
do, so each rank takes the one kv head its four q heads read) and encdec
whisper-medium; the dense step is also held to the JAX package's
``make_train_step``.  The ssm and hybrid
families are in ``test_torch_mesh_train_ssm.py``, the moe family in
``test_torch_mesh_train_moe.py``.

For each case: the loss and the gradient norm within 1e-5 relative and
every updated parameter within 1e-5 of its leaf's largest entry plus
1e-5, each moment within 1e-4 plus 1e-12 (f32, summation order only;
AdamW's eps is 1e-4, see ``tests/test_torch_train_step.py``); each
parameter's local shape is ``Rules.local_shape``; every call of the K6
operators (forward and backward) received the local batch rows and head
counts; under ``CommDebugMode`` the step gathered or reduce-scattered and
all-reduced.  The four ranks are spawned once for the module.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.optim import AdamW as JaxAdamW
from repro.optim import linear_warmup_cosine as jax_warmup_cosine
from repro.runtime import TrainState as JaxTrainState
from repro.runtime import make_train_step as jax_make_step
from repro.models import build_model as jax_build_model
from repro_torch.models import to_jax_tree
from test_torch_ranks import (EPS, LR, cases_on_ranks, check_against_plain,
                              check_collectives, check_local_shapes,
                              jax_inputs, run_ranks)
from test_torch_train_step import check_step

MESHES = {"qwen2.5-32b": (2, 2), "qwen2-vl-72b": (2, 2),
          "whisper-medium": (2, 2)}
# config fields changed for a case, in both packages: two layers (a
# DTensor step's first run pays for every layer; a third would repeat the
# second's operations)
OVERRIDES = {"qwen2.5-32b": {"n_layers": 2},
             "qwen2-vl-72b": {"n_kv_heads": 1, "n_layers": 2},
             "whisper-medium": {"n_layers": 2, "n_enc_layers": 2}}


def jax_step(jcfg, params, batch):
    """The JAX package's step from the parameters ``params``: (loss, grad
    norm, the state in ``check_step``'s layout)."""
    jmodel = jax_build_model(jcfg)
    jopt = JaxAdamW(lr=jax_warmup_cosine(LR, 2, 10), grad_clip=1.0, eps=EPS)
    params = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(params=params, opt=jopt.init(params), err=None)
    state, m = jax.jit(jax_make_step(jmodel, jopt, remat="full"))(
        state, jax.tree.map(jnp.asarray, batch))
    h = jax.device_get(state)
    return (float(m["loss"]), float(m["grad_norm"]),
            {"params": h.params, "m": h.opt.m, "v": h.opt.v,
             "step": int(h.opt.step), "err": None})


def run_module(meshes, tmp_path, jax_archs=(), overrides=OVERRIDES):
    """Every case of ``meshes`` on four ranks in one spawn; the cases of
    ``jax_archs`` also through the JAX step.  (rank 0's results, the
    configs, the JAX steps)."""
    cases, cfgs, jax_cases, jax_runs = [], {}, {}, {}
    for name, shape in meshes.items():
        jcfg, cfg, params, batch = jax_inputs(name, **overrides.get(name, {}))
        cfgs[name] = cfg
        cases.append((name, (cfg, params, batch, shape)))
        if name in jax_archs:
            jax_cases[name] = (jcfg, params, batch)

    def jax_steps():  # while the ranks work
        for name, args in jax_cases.items():
            jax_runs[name] = jax_step(*args)
    torch.save(cases, tmp_path / "cases.pt")
    ranks = run_ranks(functools.partial(cases_on_ranks,
                                        str(tmp_path / "cases.pt")), 4,
                      tmp_path / "ranks", meanwhile=jax_steps)
    for r in ranks[1:]:  # every rank reports the same full state
        for name in meshes:
            assert r[name]["sharded"]["loss"] == ranks[0][name]["sharded"][
                "loss"]
    return ranks[0], cfgs, jax_runs


def expected_heads(cfg, mesh, kv=None):
    """(rows, q heads, kv heads) each K6 call gets on one rank: the batch
    over data, the heads over model, the kv heads over model where they
    divide it, else the kv heads the rank's q heads read."""
    dp, mp_ = mesh
    H = cfg.n_heads
    KV = H if kv is None else kv
    if KV % mp_ == 0:
        return (4 // dp, H // mp_, KV // mp_)
    g, h = H // KV, H // mp_
    return (4 // dp, h, max(h // g, 1))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_module(MESHES, tmp_path_factory.mktemp("mesh"),
                      jax_archs=("qwen2.5-32b",))


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_the_unsharded_step(results, name):
    check_against_plain(results[0][name])


@pytest.mark.parametrize("name", list(MESHES))
def test_every_parameter_has_its_rules_local_shape(results, name):
    check_local_shapes(results[0][name])


@pytest.mark.parametrize("name", list(MESHES))
def test_the_attention_kernels_received_local_heads(results, name):
    case, cfg = results[0][name], results[1][name]
    calls = case["calls"]
    assert calls["fa_fwd"] and calls["fa_bwd"]
    self_attn = expected_heads(cfg, MESHES[name], cfg.n_kv_heads)
    cross = expected_heads(cfg, MESHES[name])
    for c in calls["fa_fwd"] + calls["fa_bwd"]:
        assert c in (self_attn, cross), (c, self_attn, cross)
    if cfg.family != "encdec":
        assert set(calls["fa_fwd"]) == {self_attn}


@pytest.mark.parametrize("name", list(MESHES))
def test_the_sharded_step_ran_collectives(results, name):
    check_collectives(results[0][name])


def test_dense_sharded_step_matches_the_jax_step(results):
    case, cfg = results[0]["qwen2.5-32b"], results[1]["qwen2.5-32b"]
    s = case["sharded"]
    got = {"params": to_jax_tree(cfg, s["params"]),
           "m": to_jax_tree(cfg, s["m"]), "v": to_jax_tree(cfg, s["v"]),
           "step": s["step"], "err": None}
    check_step(results[2]["qwen2.5-32b"], (s["loss"], s["grad_norm"], got))
