"""The port's arch registry, its parameter specs without allocation, and
their logical axes, against the JAX package's, on the CPU.

``examples/train_tiny_lm.py`` registers its "tiny-100m" config in the
registry's ``_MODULES`` at run time, counts its parameters through
``build_model(cfg).abstract()`` and trains it through the train driver
by name.  Here the same path runs cut to a REDUCED config and a few
steps: both packages' drivers take a name registered at run time and
agree on the summary's counts, an unknown name raises ``KeyError``,
``Model.abstract()`` holds JAX's element counts on the meta device, and
``Model.axes()`` gives each leaf JAX's logical axis names with the
layer-stack axis removed.
"""
import jax
import numpy as np
import pytest

import repro.configs as jax_configs
import repro_torch.configs as configs
from repro.launch import train as jax_train
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.models.convert import jax_leaf_groups
from repro_torch.models.layers import DTYPES

NAME = "qwen2.5-registered"
# the example's flags cut to a few steps: a failure at step 10, a
# checkpoint every 4 steps, no --reduced (the registered FULL is the cut
# config, as the example's is)
ARGS = ["--arch", NAME, "--steps", "24", "--batch", "2", "--seq", "32",
        "--lr", "3e-3", "--fail-at", "10", "--save-every", "4"]
TINY = dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
            d_ff=2048, vocab=8192)  # examples/train_tiny_lm.py's


def _module(cfg):
    return type("M", (), {"FULL": cfg, "REDUCED": cfg})


def _tiny(get):
    return get("qwen2.5-32b", reduced=True).replace(**TINY)


def test_both_drivers_train_an_arch_registered_at_run_time(tmp_path):
    """A REDUCED qwen2.5-32b (2 layers) registered under a new name in
    each package's ``_MODULES``: ``launch.train.main`` of the port (on
    the CPU) and of the JAX package take ``--arch`` with that name, and
    count the same steps, restarts and lost steps; the port's loss
    falls.  The port's serve driver takes the name too.  The names are
    removed again after."""
    configs._MODULES[NAME] = _module(get_config(
        "qwen2.5-32b", reduced=True).replace(n_layers=2))
    jax_configs._MODULES[NAME] = _module(jax_configs.get_config(
        "qwen2.5-32b", reduced=True).replace(n_layers=2))
    try:
        ours = train.main(ARGS + ["--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "ours")])
        theirs = jax_train.main(ARGS + ["--ckpt-dir", str(tmp_path / "jax")])
        served = serve.main(["--arch", NAME, "--device", "cpu", "--batch",
                             "1", "--prompt-len", "8", "--gen", "2"])
    finally:
        del configs._MODULES[NAME], jax_configs._MODULES[NAME]
    for key in ("steps", "restarts", "lost_steps"):
        assert ours[key] == theirs[key], key
    assert ours["steps"] == 24 and ours["restarts"] == 1
    assert np.isfinite(ours["first_loss"]) and np.isfinite(ours["last_loss"])
    assert ours["last_loss"] < ours["first_loss"]
    assert served["out_shape"] == [1, 2]
    with pytest.raises(KeyError, match=NAME):
        get_config(NAME)


def test_an_unknown_arch_raises_key_error_naming_the_registry(tmp_path):
    with pytest.raises(KeyError, match="qwen2.5-32b"):
        get_config("llama-9000")
    with pytest.raises(KeyError, match="llama-9000"):
        train.main(["--arch", "llama-9000", "--device", "cpu", "--steps",
                    "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(KeyError, match="llama-9000"):
        serve.main(["--arch", "llama-9000", "--device", "cpu"])
    assert set(configs._MODULES) == set(ARCHS)


@pytest.mark.parametrize("arch", ARCHS + ("tiny-100m",))
def test_abstract_parameters_count_as_the_jax_packages(arch):
    """FULL configs and the example's tiny-100m: the port's
    ``abstract()`` is meta-device tensors of the parameter dtype, whose
    elements add up, JAX leaf by JAX leaf (a stacked JAX leaf against its
    layers' port leaves), to JAX's ``abstract()`` — with nothing
    allocated on either side."""
    if arch == "tiny-100m":
        cfg, jcfg = _tiny(get_config), _tiny(jax_configs.get_config)
    else:
        cfg, jcfg = get_config(arch), jax_configs.get_config(arch)
    model = build_model(cfg)
    tree = model.abstract()
    named = dict(tree.named_parameters())
    dtype = DTYPES[cfg.param_dtype]
    assert all(p.device.type == "meta" and p.dtype == dtype
               for p in named.values())
    theirs = jax_build_model(jcfg).abstract()
    total = 0
    for key, items in jax_leaf_groups(model.spec).items():
        leaf = theirs
        for k in key:
            leaf = leaf[k]
        assert isinstance(leaf, jax.ShapeDtypeStruct)
        ours = sum(named[name].numel() for _, name in items)
        assert ours == int(np.prod(leaf.shape)), key
        total += ours
    assert total == sum(int(np.prod(x.shape))
                        for x in jax.tree.leaves(theirs))
    if arch == "tiny-100m":  # the example prints it in millions
        assert round(total / 1e6, 1) == 39.9


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_are_the_jax_packages_without_the_layer_stack(arch):
    """At REDUCED, every leaf that ``convert.from_jax_params`` maps: the
    port's axis names equal JAX's ``param_axes`` after the leading
    "layers" axes of a stacked run (one per list index of the port's
    path), and each leaf has a name or None for every dim."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    ours_tree = model.axes()
    theirs_tree = jax_build_model(jax_configs.get_config(
        arch, reduced=True)).axes()
    shapes = {n: p.shape for n, p in model.abstract().named_parameters()}
    for key, items in jax_leaf_groups(model.spec).items():
        theirs = theirs_tree
        for k in key:
            theirs = theirs[k]
        for idx, name in items:
            ours = ours_tree
            for k in name.split("."):
                ours = ours[int(k)] if k.isdigit() else ours[k]
            assert len(ours) == len(shapes[name]), name
            assert tuple(theirs[:len(idx)]) == ("layers",) * len(idx), key
            assert tuple(theirs[len(idx):]) == ours, (name, theirs, ours)
