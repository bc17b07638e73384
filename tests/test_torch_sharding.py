"""The port's sharding rules and production meshes against the JAX
package's: ``Rules.spec`` for every parameter leaf of every arch at FULL
under every preset on both production meshes' axis sizes, one device's
shard shape against ``NamedSharding.shard_shape`` on the 512-device JAX
meshes, the host-side cases of ``tests/test_distribution.py``, and the
meshes built over torch's fake process group (in subprocesses: the group
is global to a process)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS, get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.layers import _leaves as jax_leaves
from repro.runtime.sharding import PRESETS as JAX_PRESETS
from repro.runtime.sharding import Rules as JaxRules
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.models.layers import spec_leaves
from repro_torch.runtime.sharding import PRESETS, Rules, make_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _fake_mesh(shape, axes):
    """Rules only consult the axis names and sizes: a stand-in suffices,
    the same object for both packages."""
    class M:
        axis_names = axes

        def __init__(self):
            self.shape = dict(zip(axes, shape))
    return M()


def _rules(preset="train", shape=(16, 16), axes=("data", "model")):
    return Rules(mesh=_fake_mesh(shape, axes), table=dict(PRESETS[preset]))


def _jax_path(name: str) -> str:
    """A port leaf's dotted name without its layer indices: the JAX
    package's stacked leaf."""
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _paired_leaves(arch):
    """(port name, port Leaf, JAX shape, JAX axes) of every port leaf."""
    jax_spec = {"/".join(p): leaf for p, leaf in jax_leaves(
        jax_build_model(jax_get_config(arch)).spec.tree)}
    for name, leaf in spec_leaves(build_model(get_config(arch)).spec):
        j = jax_spec[_jax_path(name)]
        yield name, leaf, j["shape"], tuple(j["axes"])


def test_presets_are_the_jax_packages():
    assert PRESETS == JAX_PRESETS
    assert ARCHS == JAX_ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_jax_for_every_leaf_preset_and_mesh(arch):
    meshes = {k: _fake_mesh(*v) for k, v in MESHES.items()}
    n = 0
    for name, leaf, jshape, jaxes in _paired_leaves(arch):
        stacked = len(jshape) - len(leaf.shape)
        assert jaxes[:stacked] == ("layers",) * stacked, name
        assert tuple(jshape[stacked:]) == tuple(leaf.shape), name
        assert jaxes[stacked:] == tuple(leaf.axes), name
        for preset in PRESETS:
            for mesh in meshes.values():
                want = tuple(JaxRules(mesh, dict(JAX_PRESETS[preset])).spec(
                    jshape, jaxes))
                got = Rules(mesh, dict(PRESETS[preset])).spec(leaf.shape,
                                                              leaf.axes)
                assert want[:stacked] == (None,) * stacked, name
                assert got == want[stacked:], (name, preset)
                n += 1
    assert n > 0


_SHARD_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, math, sys
    sys.path.insert(0, "tests")
    from jax.sharding import NamedSharding
    from repro.launch.mesh import make_production_mesh as jax_mesh
    from repro.runtime.sharding import make_rules as jax_rules
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import make_rules
    from test_torch_sharding import _paired_leaves

    out = {}
    # the port's meshes over the fake process group: 512 ranks first
    meshes = {"multi": (jax_mesh(multi_pod=True),
                        make_production_mesh(multi_pod=True)),
              "single": (jax_mesh(), make_production_mesh())}
    for kind, (jm, tm) in meshes.items():
        jr, tr = jax_rules(jm, "train"), make_rules(tm, "train")
        for arch in ARCHS:
            bad, jbytes, tbytes = [], 0, 0
            for name, leaf, jshape, jaxes in _paired_leaves(arch):
                stacked = len(jshape) - len(leaf.shape)
                want = NamedSharding(jm, jr.spec(jshape, jaxes)).shard_shape(
                    tuple(jshape))
                got = tr.local_shape(leaf.shape, leaf.axes)
                if (tuple(want[stacked:]) != got
                        or tuple(want[:stacked]) != tuple(jshape[:stacked])):
                    bad.append(name)
                tbytes += math.prod(got)
            seen = set()
            for name, leaf, jshape, jaxes in _paired_leaves(arch):
                path = ".".join(p for p in name.split(".")
                                if not p.isdigit())
                if path in seen:
                    continue
                seen.add(path)
                jbytes += math.prod(NamedSharding(
                    jm, jr.spec(jshape, jaxes)).shard_shape(tuple(jshape)))
            out[f"{kind}:{arch}"] = {"bad": bad[:5], "jax": jbytes,
                                     "port": tbytes}
    print(json.dumps(out))
""")


def test_local_shape_matches_jax_shard_shape_on_the_production_meshes():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _SHARD_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res) == 2 * len(ARCHS)
    for cell, r in res.items():
        assert not r["bad"], (cell, r["bad"])
        # the per-device parameter elements are equal too
        assert r["jax"] == r["port"], cell


# --- the host-side cases of tests/test_distribution.py ---------------------

def test_rules_basic_2d_weight():
    r = _rules()
    assert r.spec((5120, 5120), ("embed", "heads")) == ("data", "model")
    assert r.local_shape((5120, 5120), ("embed", "heads")) == (320, 320)


def test_rules_divisibility_fallback():
    r = _rules()
    # kv_heads=8 cannot shard over model=16 -> replicated dim
    assert r.spec((4096, 8, 128), (None, "kv_heads", None)) == (None, None,
                                                                None)
    # but the flattened 1024 column dim can
    assert r.spec((4096, 1024), ("embed", "kv_heads")) == ("data", "model")


def test_rules_no_axis_reuse():
    r = _rules()
    # vocab and seq_sp both want "model": the later dim must fall back
    spec = r.spec((256, 4096, 152064), ("batch", "seq_sp", "vocab"))
    assert spec == ("data", "model", None)


def test_rules_multi_axis_batch():
    r = _rules(shape=(2, 16, 16), axes=("pod", "data", "model"))
    assert r.spec((256, 4096), ("batch", None)) == (("pod", "data"), None)
    assert r.local_shape((256, 4096), ("batch", None)) == (8, 4096)


def test_rules_fsdp_preset_two_axis_embed():
    r = _rules(preset="fsdp")
    assert r.spec((3072, 4096), ("embed", "heads")) == (("data", "model"),
                                                        None)
    assert r.local_shape((3072, 4096), ("embed", "heads")) == (12, 4096)


def test_rules_none_mesh_noop():
    r = make_rules(None)
    x = np.ones((4, 4))
    assert r(x, ("batch", None)) is x
    assert r.spec((4, 4), ("batch", None)) == ()
    assert r.local_shape((4, 4), ("batch", None)) == (4, 4)


def test_make_rules_takes_json_overrides():
    r = make_rules(_fake_mesh((16, 16), ("data", "model")), "train",
                   {"embed": ["data", "model"], "heads": []})
    assert r.table["embed"] == ("data", "model") and r.table["heads"] == ()
    assert r.spec((5120, 5120), ("embed", "heads")) == (("data", "model"),
                                                        None)


_MESH_SCRIPT = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import make_rules, mesh_axes
    assert not dist.is_initialized()  # importing built nothing
    m2 = make_production_mesh(multi_pod=True)
    m1 = make_production_mesh()  # fits the 512-rank group
    r = make_rules(m2, "train")
    pl = r.placements((256, 4096, 5120), ("batch", None, "embed"))
    assert pl == (Shard(0), Shard(0), Replicate()), pl
    pl = make_rules(m1, "fsdp").placements((3072, 4096), ("embed", "heads"))
    assert pl == (Shard(0), Shard(0)), pl
    pl = make_rules(m1, "train").placements((5120, 1024),
                                            ("embed", "heads"))
    assert pl == (Shard(0), Shard(1)), pl
    # a DTensor goes to the rule's placements; a plain tensor stays as it is
    import torch
    from torch.distributed.tensor import DTensor
    x = DTensor.from_local(torch.zeros(32, 16, 64), m2,
                           (Replicate(), Replicate(), Replicate()))
    y = r(x, ("batch", None, "heads"))
    assert y.placements == (Shard(0), Shard(0), Shard(2)), y.placements
    assert tuple(y.to_local().shape) == (1, 16, 4), y.to_local().shape
    plain = torch.zeros(4)
    assert r(plain, ("batch",)) is plain
    # a mesh larger than the group already initialized raises
    from repro_torch.launch.mesh import make_mesh_shape
    try:
        make_mesh_shape((2, 16, 32), ("pod", "data", "model"))
        raised = "nothing"
    except RuntimeError as e:
        raised = str(e)
    print(json.dumps({"single": mesh_axes(m1), "multi": mesh_axes(m2),
                      "world": dist.get_world_size(),
                      "backend": dist.get_backend(), "raised": raised}))
""")


@pytest.fixture(scope="module")
def mesh_process():
    """The production meshes built in a process of their own: the fake
    process group is global to a process."""
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _MESH_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_meshes_build_over_the_fake_backend(mesh_process):
    res = mesh_process
    assert res["single"] == {"data": 16, "model": 16}
    assert res["multi"] == {"pod": 2, "data": 16, "model": 16}
    assert res["world"] == 512 and res["backend"] == "fake"


def test_a_mesh_larger_than_the_group_raises(mesh_process):
    assert "does not fit" in mesh_process["raised"], mesh_process["raised"]


def test_tree_shardings_follow_the_axes_trees():
    """A ``Sharding`` a leaf, nested as the axes tree: the parameters (a
    ParamTree) and a decode batch with its cache (dicts and k/v tuples)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.specs import input_specs
    cfg = get_config("deepseek-v3-671b", reduced=True)
    model = build_model(cfg)
    r = _rules("decode", (2, 16, 16), ("pod", "data", "model"))
    sh = r.tree_shardings(model.abstract(), model.axes())
    got = sh["moe_blocks"][0]["moe"]["w_gate"]
    assert got.spec == r.spec((8, 128, 64), ("expert", "embed", "mlp"))
    # 8 experts do not split over model = 16, so the mlp dim takes it
    assert got.spec == (None, "data", "model")
    from torch.distributed.tensor import Replicate, Shard
    assert sh["embed"].mesh is r.mesh and sh["embed"].spec == ("model", "data")
    assert sh["embed"].placements == (Replicate(), Shard(1), Shard(0))
    batch, axes = input_specs(cfg, SHAPES["decode_32k"], model)
    bsh = r.tree_shardings(batch, axes)
    c_kv, k_rope = bsh["cache"]["moe"]
    assert c_kv.spec == (None, ("pod", "data"), "model", None)
    assert bsh["token"].spec == (("pod", "data"), None)
    assert bsh["pos"].spec == (("pod", "data"),)
