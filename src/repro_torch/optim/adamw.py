"""AdamW over the port's parameter trees (``repro/optim/adamw.py``).

Moments are f32 whatever the parameter dtype; the bias corrections
1 − bᵗ are taken in f32 from an f32 step, as the JAX code takes them; the
clip scale comes from the global f32 norm of every gradient; the new
parameter is computed in f32 and cast to the parameter's dtype.  A tree is
a {name: tensor} mapping in ``named_parameters`` order.  The update writes
the parameters and the moments in place (one copy of the state on the
card), under ``torch.no_grad``.

On ``DTensor`` gradients (a sharded step) each leaf's sum of squares is
summed over its shards before the square root and the clip: the norm is
the norm of the full tensors, the same on every rank.  The leaves whose
sums share a mesh and placements are reduced together, one collective for
each such group (``full_tensor`` of the stacked ``Partial`` scalars), not
one a leaf.  The moment updates stay elementwise on the shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from ..dtensor import is_dtensor

__all__ = ["AdamW", "OptState"]


@dataclasses.dataclass
class OptState:
    step: torch.Tensor  # () int32
    m: dict  # {name: f32 tensor}
    v: dict


def _full_scalars(xs: list) -> list:
    """Scalars, some of them ``DTensor``s partial over mesh dims, as their
    full values: one reduction for each (mesh, placements) among them."""
    groups = {}
    for i, x in enumerate(xs):
        if is_dtensor(x):
            groups.setdefault((x.device_mesh, tuple(x.placements)),
                              []).append(i)
    out = list(xs)
    for (mesh, placements), idx in groups.items():
        stacked = torch.stack([xs[i].to_local() for i in idx])
        whole = DTensor.from_local(stacked, mesh, placements,
                                   run_check=False).full_tensor()
        for j, i in enumerate(idx):
            out[i] = whole[j]
    return out


def _named(params) -> dict:
    return (dict(params.named_parameters())
            if isinstance(params, torch.nn.Module) else dict(params))


@dataclasses.dataclass(frozen=True, eq=False)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params) -> OptState:
        named = _named(params)
        dev = next(iter(named.values())).device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in named.items()},
            v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in named.items()})

    def _lr(self, step):
        if callable(self.lr):
            return torch.as_tensor(self.lr(step), dtype=torch.float32)
        return torch.tensor(self.lr, dtype=torch.float32)

    def update(self, grads: dict, state: OptState, params) -> tuple[Any, OptState, torch.Tensor]:
        """One step from ``grads`` {name: tensor}: returns (params, the new
        OptState, the global gradient norm, f32).  ``params`` (a ParamTree
        or {name: tensor}) and the moments are updated in place."""
        named = _named(params)
        with torch.no_grad():
            step = state.step + 1
            sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
            sq = _full_scalars(sq)
            if self.grad_clip is not None:
                gnorm = torch.sqrt(torch.stack(sq).sum())
                scale = torch.clamp(
                    self.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
            else:
                gnorm = torch.zeros((), dtype=torch.float32,
                                    device=step.device)
                scale = torch.ones((), dtype=torch.float32,
                                   device=step.device)
            stepf = step.float()
            lr = self._lr(step).to(step.device)
            b1c = 1.0 - torch.tensor(self.b1, dtype=torch.float32,
                                     device=step.device) ** stepf
            b2c = 1.0 - torch.tensor(self.b2, dtype=torch.float32,
                                     device=step.device) ** stepf
            for name, g in grads.items():
                p, m, v = named[name], state.m[name], state.v[name]
                g = g.float() * scale
                m.mul_(self.b1).add_(g * (1 - self.b1))
                v.mul_(self.b2).add_(g * g * (1 - self.b2))
                delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
                delta = delta + self.weight_decay * p.float()
                p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, OptState(step=step, m=state.m, v=state.v), gnorm
