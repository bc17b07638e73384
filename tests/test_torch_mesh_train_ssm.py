"""The port's sharded train step for the ssm (mamba2-2.7b) and hybrid
(zamba2-7b) families on a 2 × 2 (data, model) gloo mesh of the CPU, cut
to two and three layers, as ``tests/test_torch_mesh_train.py`` holds the
attention families: one step against the port's unsharded step within
the same tolerances, the local shapes, the collectives, and what the K7
operators (and zamba2's K6) received — the local batch rows and SSD heads
(d_inner over model).  The ssm step is also held to the JAX package's
``make_train_step``.
"""
import pytest

from repro_torch.models import to_jax_tree
from test_torch_mesh_train import expected_heads, run_module
from test_torch_ranks import (check_against_plain, check_collectives,
                              check_local_shapes)
from test_torch_train_step import check_step

MESHES = {"mamba2-2.7b": (2, 2), "zamba2-7b": (2, 2)}
# two Mamba2 layers; zamba2 as one group of a Mamba2 layer and the shared
# attention block, then a trailing Mamba2 layer
OVERRIDES = {"mamba2-2.7b": {"n_layers": 2},
             "zamba2-7b": {"n_layers": 3, "hybrid_every": 2}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_module(MESHES, tmp_path_factory.mktemp("mesh_ssm"),
                      jax_archs=("mamba2-2.7b",), overrides=OVERRIDES)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_the_unsharded_step(results, name):
    check_against_plain(results[0][name])


@pytest.mark.parametrize("name", list(MESHES))
def test_every_parameter_has_its_rules_local_shape(results, name):
    check_local_shapes(results[0][name])


@pytest.mark.parametrize("name", list(MESHES))
def test_the_kernels_received_local_heads(results, name):
    case, cfg = results[0][name], results[1][name]
    dp, mp_ = MESHES[name]
    calls = case["calls"]
    assert calls["ssd"] and calls["ssd_bwd"]
    for c in calls["ssd"] + calls["ssd_bwd"]:
        assert c == (4 // dp, cfg.n_ssm_heads // mp_), c
    if cfg.family == "hybrid":
        want = expected_heads(cfg, MESHES[name], cfg.n_kv_heads)
        assert calls["fa_fwd"] and calls["fa_bwd"]
        assert set(calls["fa_fwd"] + calls["fa_bwd"]) == {want}


@pytest.mark.parametrize("name", list(MESHES))
def test_the_sharded_step_ran_collectives(results, name):
    check_collectives(results[0][name])


def test_ssm_sharded_step_matches_the_jax_step(results):
    case, cfg = results[0]["mamba2-2.7b"], results[1]["mamba2-2.7b"]
    s = case["sharded"]
    got = {"params": to_jax_tree(cfg, s["params"]),
           "m": to_jax_tree(cfg, s["m"]), "v": to_jax_tree(cfg, s["v"]),
           "step": s["step"], "err": None}
    check_step(results[2]["mamba2-2.7b"], (s["loss"], s["grad_norm"], got))
