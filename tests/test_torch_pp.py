"""The port's GPipe (``runtime.pp.gpipe`` on ``torch.distributed``
point-to-point) on gloo ranks of the CPU, against the JAX package's
``gpipe`` (``shard_map`` + ``ppermute`` over forced host devices, run once
in a subprocess as ``tests/test_distribution.py`` runs it) and against
the port's own stages applied one after another.

Cases, with the JAX test's sizes (S 4, M 8, mb 2, d 16, ``tanh(x @ w)``
stages, inputs from a numpy seed): four stages on a (4,) mesh; two stages
on a (stage 2, data 2) mesh, each data replica running the pipeline;
``bubble_fraction`` on a grid; a mesh over torch's fake process group
raises (``launch.mesh.require_execution``); an input that requires a
gradient raises.  Tolerance: 1e-5 absolute against JAX (f32, XLA's
products against torch's), bitwise against the sequential stages (the
same torch products on the same microbatches).

The ranks are spawned once for the module (``test_torch_ranks.run_ranks``)
while the JAX subprocess runs; they import this module, so it imports
nothing of JAX at its top.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.runtime.pp import bubble_fraction
from test_torch_ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, D = 4, 8, 2, 16


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return ws, xs


def _stage(w, x):
    return torch.tanh(x @ w)


def _sequential(ws, xs):
    """Each microbatch through the stages one after another."""
    out = []
    for m in range(xs.shape[0]):
        y = xs[m]
        for s in range(ws.shape[0]):
            y = _stage(ws[s], y)
        out.append(y)
    return torch.stack(out)


def _pipelines(rank):
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.runtime.pp import gpipe
    ws, xs = (torch.from_numpy(a) for a in _inputs())
    four = make_mesh_shape((S,), ("stage",))
    two = make_mesh_shape((2, 2), ("stage", "data"))
    out = {"four": gpipe(_stage, ws, xs, mesh=four, axis="stage"),
           "two": gpipe(_stage, ws[:2], xs, mesh=two, axis="stage"),
           "seq_four": _sequential(ws, xs), "seq_two": _sequential(ws[:2], xs)}
    try:
        gpipe(_stage, ws, xs.clone().requires_grad_(), mesh=four,
              axis="stage")
        out["grad"] = "nothing raised"
    except ValueError as e:
        out["grad"] = str(e)
    return out


_JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.launch.mesh import make_mesh_shape
    from repro.runtime.pp import gpipe
    data = np.load(sys.argv[1])
    ws, xs = jnp.asarray(data["ws"]), jnp.asarray(data["xs"])
    stage = lambda w, x: jnp.tanh(x @ w)
    four = make_mesh_shape((4,), ("stage",))
    two = make_mesh_shape((2, 2), ("stage", "data"))
    np.savez(sys.argv[2],
             four=np.asarray(gpipe(stage, ws, xs, mesh=four, axis="stage")),
             two=np.asarray(gpipe(stage, ws[:2], xs, mesh=two,
                                  axis="stage")))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    ws, xs = _inputs()
    np.savez(tmp / "inputs.npz", ws=ws, xs=xs)
    env = dict(os.environ, PYTHONPATH="src")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(_pipelines, S, tmp / "ranks")
    finally:
        _, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-2000:]
    return ranks, dict(np.load(tmp / "jax.npz"))


@pytest.mark.parametrize("mesh", ["four", "two"])
def test_gpipe_matches_jax_and_the_sequential_stages(runs, mesh):
    ranks, jax_out = runs
    for r, out in enumerate(ranks):
        got = out[mesh]
        assert got.shape == (M, MB, D)
        # every rank holds the last stage's bank
        assert torch.equal(got, ranks[0][mesh]), r
        assert torch.equal(got, out[f"seq_{mesh}"]), r
        np.testing.assert_allclose(got.numpy(), jax_out[mesh], rtol=0,
                                   atol=1e-5)


def test_gpipe_refuses_an_input_that_requires_grad(runs):
    ranks, _ = runs
    for out in ranks:
        assert "forward only" in out["grad"], out["grad"]


def test_bubble_fraction_is_the_jax_packages():
    from repro.runtime.pp import bubble_fraction as jax_bubble_fraction
    for m in (1, 2, 4, 8, 16, 64):
        for s in (1, 2, 4, 8):
            assert bubble_fraction(m, s) == jax_bubble_fraction(m, s)
    assert bubble_fraction(8, 4) == pytest.approx(3 / 11)


_FAKE_SCRIPT = textwrap.dedent("""
    import json
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import make_rules, make_train_step
    from repro_torch.runtime.pp import gpipe
    mesh = make_mesh_shape((2, 2), ("data", "model"))  # the fake group
    raised = {"device_type": mesh.device_type}
    for name, call in (
            ("gpipe", lambda: gpipe(lambda w, x: x, torch.zeros(2, 1),
                                    torch.zeros(1, 1), mesh=mesh,
                                    axis="data")),
            ("step", lambda: make_train_step(
                build_model(get_config("qwen2.5-32b", reduced=True)),
                AdamW(), rules=make_rules(mesh, "train")))):
        try:
            call()
            raised[name] = "nothing"
        except RuntimeError as e:
            raised[name] = str(e)
    print(json.dumps(raised))
""")


def test_a_mesh_over_the_fake_group_refuses_to_execute():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _FAKE_SCRIPT], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device_type"] == "cpu"
    for name in ("gpipe", "step"):
        assert "'fake'" in res[name], res
