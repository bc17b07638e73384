"""Carry trees between the JAX package's layout and the port's:
``from_jax_params`` turns its parameter tree (nested dicts of numpy arrays,
``jax.device_get`` of ``Model.init``) into the port's ``ParamTree``, and
``to_jax_tree`` turns any tree of the port's parameters' shape — the
parameters, their gradients, AdamW's moments — back into the JAX layout.

The JAX package stacks runs of layers — a dense or ssm LM's
``blocks/...`` leaves are (L, ...), a moe LM's ``moe_blocks/...`` (L_moe,
...), zamba2's ``groups/mamba/...`` (G, M, ...) and ``tail/...`` (T,
...), with zamba2's shared attention block and deepseek's ``mtp/block``
mounted once.  The port keeps one parameter per layer, so its path
``groups.g.mamba.m.mixer.wz`` reads ``groups/mamba/mixer/wz`` at
``[g, m]`` and ``blocks.i.attn.wq`` reads ``blocks/attn/wq`` at ``[i]``:
the list positions of a port path index the JAX leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import DTYPES, Leaf, ParamTree
from .transformer import build_model

__all__ = ["from_jax_params", "to_jax_tree", "jax_leaf_groups",
           "named_from_jax", "opt_state_from_jax", "opt_state_to_jax"]


def _walk(node, path=()):
    """The port paths of a spec's leaves, in declaration order."""
    if isinstance(node, Leaf):
        yield path
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, path + (k,))
    else:
        for i, v in enumerate(node):
            yield from _walk(v, path + (i,))


def _name(path) -> str:
    return ".".join(map(str, path))


def jax_leaf_groups(spec) -> dict:
    """{JAX leaf path (a tuple of keys): [(index tuple, port name), ...]}
    in declaration order; the index tuple is the port path's list
    positions, () for a leaf mounted once.  The JAX leaf is the port
    leaves stacked in index order, which is also the order of its
    flattened elements."""
    groups = {}
    for path in _walk(spec):
        key = tuple(k for k in path if isinstance(k, str))
        idx = tuple(k for k in path if isinstance(k, int))
        groups.setdefault(key, []).append((idx, _name(path)))
    return groups


def _carry(cfg, tree, device, dtype) -> dict:
    """The port-shaped nested values of a JAX-layout tree of numpy arrays."""
    def carry(node, path):
        if isinstance(node, dict):
            return {k: carry(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [carry(v, path + (i,)) for i, v in enumerate(node)]
        leaf = tree
        for k in (k for k in path if isinstance(k, str)):
            if not isinstance(leaf, dict) or k not in leaf:
                raise ValueError(f"the JAX tree has no leaf for {path}")
            leaf = leaf[k]
        arr = np.asarray(leaf)[tuple(k for k in path if isinstance(k, int))]
        if arr.shape != node.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: JAX shape "
                             f"{arr.shape}, port shape {node.shape}")
        # bf16 has no numpy dtype: carry through f32, exact
        return torch.from_numpy(np.array(arr, np.float32)).to(device, dtype)

    return carry(build_model(cfg).spec, ())


def from_jax_params(cfg, tree, device="cpu", trainable: bool = False) -> ParamTree:
    """``tree``: the JAX parameters of ``cfg`` as nested dicts of numpy
    arrays.  Returns the port's parameters on ``device`` in the config's
    parameter dtype (requiring gradients when ``trainable``); raises
    ``ValueError`` on a missing leaf or a shape that is not the port's."""
    return ParamTree(_carry(cfg, tree, device, DTYPES[cfg.param_dtype]),
                     trainable)


def _flat(values) -> dict:
    """{port name: tensor} of nested port-shaped values."""
    out = {}

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            out[_name(path)] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (i,))
    walk(values, ())
    return out


def to_jax_tree(cfg, tree) -> dict:
    """The JAX layout, as nested dicts of float32 numpy arrays, of a tree
    of the port's parameters' shape: a ``ParamTree`` or any mapping
    {port name: tensor} (gradients, AdamW's moments).  Runs of layers are
    stacked back to (L, ...), (G, M, ...) as the JAX package stacks them;
    the inverse of :func:`from_jax_params`."""
    named = (dict(tree.named_parameters()) if isinstance(tree, ParamTree)
             else dict(tree))
    out = {}
    for key, items in jax_leaf_groups(build_model(cfg).spec).items():
        # copies: a CPU tensor's numpy() would share its memory
        arrs = [named[name].detach().float().cpu().numpy().copy()
                for _, name in items]
        if items[0][0] == ():
            arr = arrs[0]
        else:
            grid = tuple(max(idx[d] for idx, _ in items) + 1
                         for d in range(len(items[0][0])))
            arr = np.stack(arrs).reshape(grid + arrs[0].shape)
        node = out
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = arr
    return out


def named_from_jax(cfg, tree, device="cpu", dtype=torch.float32) -> dict:
    """{port name: tensor} of a JAX-layout tree of the parameters' shape
    (AdamW's moments, compression's error feedback), in ``dtype``."""
    return _flat(_carry(cfg, tree, device, dtype))


def opt_state_from_jax(cfg, step, m, v, device="cpu"):
    """The port's ``optim.OptState`` of a JAX ``OptState``'s fields: the
    int step and the f32 moment trees m and v in the JAX layout."""
    from ..optim import OptState  # the optimizer imports no model code
    return OptState(step=torch.tensor(int(step), dtype=torch.int32,
                                      device=device),
                    m=named_from_jax(cfg, m, device),
                    v=named_from_jax(cfg, v, device))


def opt_state_to_jax(cfg, opt) -> dict:
    """{"step": int, "m": tree, "v": tree} of the port's ``OptState`` in
    the JAX layout."""
    return {"step": int(opt.step), "m": to_jax_tree(cfg, opt.m),
            "v": to_jax_tree(cfg, opt.v)}
