"""The port's sharded train step for the moe family on a 2 × 2 (data,
model) gloo mesh of the CPU, as ``tests/test_torch_mesh_train.py`` holds
the attention families: deepseek-v3-671b (MLA, one dense layer then one
moe layer, the multi-token-prediction head, whose 31
positions do not split over the model axis, so its logits shard the
vocab).  The routing, the
dispatch gather and the combine run on each rank's dispatch groups, the
expert products on expert-sharded ``DTensor``s; one step against the
port's unsharded step within the same tolerances, the local shapes, the
collectives, and the local head counts at K6 (MLA's keys and values have
a head each: they shard with the q heads).
"""
import pytest

from test_torch_mesh_train import expected_heads, run_module
from test_torch_ranks import (check_against_plain, check_collectives,
                              check_local_shapes)

MESHES = {"deepseek-v3-671b": (2, 2)}
# one dense layer and one moe layer: more would repeat their operations
OVERRIDES = {"deepseek-v3-671b": {"n_layers": 2, "moe_layer_start": 1}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_module(MESHES, tmp_path_factory.mktemp("mesh_moe"),
                      overrides=OVERRIDES)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_the_unsharded_step(results, name):
    check_against_plain(results[0][name])


@pytest.mark.parametrize("name", list(MESHES))
def test_every_parameter_has_its_rules_local_shape(results, name):
    check_local_shapes(results[0][name])


@pytest.mark.parametrize("name", list(MESHES))
def test_the_attention_kernels_received_local_heads(results, name):
    case, cfg = results[0][name], results[1][name]
    kv = cfg.n_heads if cfg.mla else cfg.n_kv_heads
    want = expected_heads(cfg, MESHES[name], kv)
    calls = case["calls"]
    assert calls["fa_fwd"] and calls["fa_bwd"]
    assert set(calls["fa_fwd"] + calls["fa_bwd"]) == {want}


@pytest.mark.parametrize("name", list(MESHES))
def test_the_sharded_step_ran_collectives(results, name):
    check_collectives(results[0][name])
