"""The port's meta-device input stand-ins and serving-cache specs against
the JAX package's: ``launch.specs.input_specs`` for every arch × shape
that applies (shapes, dtypes, logical axes), and ``Model.cache_spec``
against JAX's ``cache_spec`` and the port's own ``alloc_cache``."""
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch.specs import input_specs as jax_input_specs
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch.specs import batch_axes, input_specs
from repro_torch.models import build_model


def _flat(tree, prefix=()):
    """(path, leaf) of a nest of dicts, lists and tuples whose leaves are
    tensors / ShapeDtypeStructs, or tuples of axis names."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)) and not _is_axes(tree):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _is_axes(node):
    return isinstance(node, tuple) and all(
        a is None or isinstance(a, str) for a in node)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _same(jax_tree, port_tree):
    j, p = list(_flat(jax_tree)), list(_flat(port_tree))
    assert [k for k, _ in j] == [k for k, _ in p]
    for (path, a), (_, b) in zip(j, p):
        if _is_axes(a):
            assert tuple(a) == tuple(b), path
        else:
            assert tuple(a.shape) == tuple(b.shape), path
            assert _dtype_name(a.dtype) == _dtype_name(b.dtype), path
            assert b.device.type == "meta", path


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax_for_every_applicable_shape(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    n = 0
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        jb, ja = jax_input_specs(jcfg, JAX_SHAPES[name])
        tb, ta = input_specs(cfg, shape)
        _same(jb, tb)
        _same(ja, ta)
        assert batch_axes(cfg, shape) == ta
        n += 1
    assert n >= 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_cache_spec_matches_jax_and_alloc_cache(arch, reduced):
    cfg = get_config(arch, reduced=reduced)
    model = build_model(cfg)
    B, s_max = (3, 40) if reduced else (8, 4096)
    tree, axes = model.cache_spec(B, s_max)
    jtree, jaxes = jax_build_model(jax_get_config(arch, reduced=reduced)
                                   ).cache_spec(B, s_max)
    _same(jtree, tree)
    _same(jaxes, axes)
    if reduced:  # what alloc_cache allocates, shape and dtype
        real = model.alloc_cache(B, s_max, "cpu")
        flat = list(_flat(real))
        assert [k for k, _ in flat] == [k for k, _ in _flat(tree)]
        for (path, a), (_, b) in zip(flat, _flat(tree)):
            assert a.shape == b.shape and a.dtype == b.dtype, path


def test_decode_specs_carry_the_models_cache():
    cfg = get_config("zamba2-7b", reduced=True)
    model = build_model(cfg)
    batch, axes = input_specs(cfg, SHAPES["decode_32k"], model)
    tree, cache_axes = model.cache_spec(SHAPES["decode_32k"].global_batch,
                                        SHAPES["decode_32k"].seq_len)
    assert axes["cache"] == cache_axes
    assert {k: v.shape for k, v in batch["cache"].items()} == {
        k: v.shape for k, v in tree.items()}
