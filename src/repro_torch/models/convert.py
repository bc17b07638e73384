"""Carry the JAX package's parameters across: ``from_jax_params`` turns its
parameter tree (nested dicts of numpy arrays, ``jax.device_get`` of
``Model.init``) into the port's ``ParamTree``.

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

from .layers import DTYPES, ParamTree
from .transformer import build_model

__all__ = ["from_jax_params"]


def from_jax_params(cfg, tree, device="cpu") -> ParamTree:
    """``tree``: the JAX parameters of ``cfg`` as nested dicts of numpy
    arrays.  Returns the port's parameters on ``device`` in the config's
    parameter dtype; raises ``ValueError`` on a missing leaf or a shape
    that is not the port's."""
    dtype = DTYPES[cfg.param_dtype]

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

    return ParamTree(carry(build_model(cfg).spec, ()))
