"""Parameter trees and basic layers (norms, rope and M-RoPE, MLP) of the
port.

A model's parameters are declared as a nested spec — dicts of ``Leaf``
declarations, with lists for runs of layers — and materialized as a
``ParamTree``: an ``nn.Module`` whose children mirror the spec, indexed
``p["wz"]`` as the JAX package's dicts are, with state-dict names such as
``groups.0.mamba.1.mixer.wz``.  Three things derive from the one spec, as
in the JAX package: ``init_params`` (random values), ``abstract_params``
(the same tree on the meta device: shapes and dtypes, no allocation) and
``param_axes`` (each leaf's logical axis names).  Parameters require
gradients only in a trainable tree (``trainable=True``, as
``runtime.init_train_state`` makes it); serving runs under
``torch.no_grad`` and builds no graph either way.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "DTYPES", "Leaf", "ParamTree", "init_params", "abstract_params",
    "param_axes", "spec_leaves", "rms_norm", "layer_norm",
    "rope_freqs", "apply_rope", "mlp_specs", "mlp_apply", "norm_specs",
    "ID_RULES",
]

def ID_RULES(x, axes):
    """The sharding hook without a mesh: ``x`` as it is (the JAX
    package's ``_ID``)."""
    return x


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class Leaf(NamedTuple):
    """One parameter: its shape and init kind (fan_in | zeros | ones |
    normal) with an optional scale, and one logical axis name (or None) a
    dim, as ``repro/models/layers.py`` declares them (the JAX package
    puts a "layers" axis in front of a stacked run's leaves; the port
    keeps one leaf a layer, so its own axes start at the leaf's dims)."""
    shape: tuple
    init: str = "fan_in"
    scale: float | None = None
    axes: tuple | None = None


class ParamTree(nn.Module):
    """Parameters in the shape of a spec: a dict node is a module with one
    attribute per key, a list node an ``nn.ModuleList``, a leaf an
    ``nn.Parameter`` that requires a gradient when ``trainable``.
    ``tree[key]`` reads a child."""

    def __init__(self, values: dict, trainable: bool = False):
        super().__init__()
        for k, v in values.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=trainable))
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v, trainable))
            else:
                self.add_module(k, nn.ModuleList(ParamTree(x, trainable)
                                                 for x in v))

    def __getitem__(self, key):
        return getattr(self, key)


def _draw(leaf: Leaf, dtype, generator, device) -> torch.Tensor:
    """One leaf by its init kind (``repro/models/layers.py:81-104``): the
    same distribution from a ``torch.Generator``, not the same bits."""
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "normal":
        std = leaf.scale or 0.02
    else:  # fan_in
        fan = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
        std = leaf.scale or 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn(leaf.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_params(
    spec, dtype, generator: torch.Generator, trainable: bool = False
) -> ParamTree:
    """Materialize ``spec`` in ``dtype`` on the generator's device, leaves
    drawn in declaration order; ``trainable`` leaves require gradients."""
    device = generator.device

    def build(node):
        if isinstance(node, Leaf):
            return _draw(node, dtype, generator, device)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return [build(v) for v in node]

    return ParamTree(build(spec), trainable)


def _map_spec(spec, fn):
    """``spec`` with each ``Leaf`` replaced by ``fn(leaf)``."""
    if isinstance(spec, Leaf):
        return fn(spec)
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn) for k, v in spec.items()}
    return [_map_spec(v, fn) for v in spec]


def abstract_params(spec, dtype) -> ParamTree:
    """``spec`` as a ``ParamTree`` of meta-device tensors in ``dtype``:
    every leaf's shape and dtype, nothing allocated (the JAX package's
    ``ShapeDtypeStruct`` tree)."""
    return ParamTree(_map_spec(spec, lambda leaf: torch.empty(
        leaf.shape, dtype=dtype, device="meta")))


def param_axes(spec):
    """The logical axis names of each leaf of ``spec``, in its shape:
    dicts and lists as the spec nests them, a tuple (one name or None a
    dim) for a leaf."""
    def axes(leaf):
        if leaf.axes is None or len(leaf.axes) != len(leaf.shape):
            raise ValueError(f"leaf {leaf} declares no axis name for each "
                             "of its dims")
        return tuple(leaf.axes)
    return _map_spec(spec, axes)


def spec_leaves(spec, prefix=()):
    """(dotted name, Leaf) of each leaf of ``spec``, named as
    ``ParamTree.named_parameters`` names its parameter (e.g.
    "blocks.3.attn.wq"), in declaration order."""
    if isinstance(spec, Leaf):
        yield ".".join(prefix), spec
    elif isinstance(spec, dict):
        for k, v in spec.items():
            yield from spec_leaves(v, prefix + (k,))
    else:
        for i, v in enumerate(spec):
            yield from spec_leaves(v, prefix + (str(i),))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_specs(d: int, plus_one: bool) -> dict:
    return {"w": Leaf((d,), "zeros" if plus_one else "ones", axes=(None,))}


def rms_norm(x, w, eps: float, plus_one: bool):
    """RMSNorm computed in f32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (x * scale).to(dt)


def layer_norm(x, w, b, eps: float):
    """LayerNorm computed in f32 (mean, variance, ``rsqrt``, affine),
    returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return float(theta) ** -exponents  # a host scalar: no copy to the card


def apply_rope(x, positions, theta, mrope_sections=None):
    """x: (B, S, H, hd); positions: (B, S) integer, or (3, B, S) for
    M-RoPE.

    M-RoPE (qwen2-vl): the hd/2 frequency pairs split into (t, h, w)
    sections, which sum to hd/2; section i rotates by position stream i,
    and the angles are concatenated in that order.  Without sections a
    (3, B, S) input uses stream 0; text passes identical streams, which
    reduces M-RoPE to standard RoPE.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    if mrope_sections is None:
        if positions.dim() == 3:
            positions = positions[0]
        angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    else:
        if positions.dim() != 3 or sum(mrope_sections) != hd // 2:
            raise ValueError(
                f"M-RoPE needs (3, B, S) positions and sections summing to "
                f"hd/2 = {hd // 2}: got {tuple(positions.shape)}, "
                f"{mrope_sections}")
        parts, start = [], 0
        for i, n in enumerate(mrope_sections):
            parts.append(positions[i][..., None].float()
                         * freqs[start:start + n])
            start += n
        angles = torch.cat(parts, dim=-1)  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------

def mlp_specs(d: int, d_ff: int, activation: str) -> dict:
    spec = {}
    if activation in ("swiglu", "geglu"):
        spec["w_gate"] = Leaf((d, d_ff), axes=("embed", "mlp"))
    spec["w_up"] = Leaf((d, d_ff), axes=("embed", "mlp"))
    spec["w_down"] = Leaf((d_ff, d), axes=("mlp", "embed"))
    return spec


def mlp_apply(p, x, activation: str):
    if activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]
