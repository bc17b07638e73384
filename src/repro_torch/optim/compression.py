"""Gradient compression: top-k sparsification with error feedback
(``repro/optim/compression.py``).

The top k of |g + err| are kept (zeros elsewhere) and the rest carried
into the next step.  A leaf is the JAX package's leaf: the port's
per-layer tensors of one JAX leaf (``models.convert.jax_leaf_groups``)
compete for one top k, in the JAX leaf's element order.  Ties go to the
lower index, as ``jax.lax.top_k`` breaks them (``models.moe.stable_top_k``;
``torch.topk`` does not).  On ``DTensor`` gradients the top k is taken
over the full tensors of the group (gathered on every rank), the same
global k entries as on one device, and each result keeps its leaf's
placements.
"""
from __future__ import annotations

import torch

from ..dtensor import is_dtensor
from ..models.moe import stable_top_k

__all__ = ["topk_compress_with_feedback"]


def _compress_leaf(gs, errs, ratio: float):
    from ..runtime.sharding import full, shard_tensor
    like = gs
    gs = [full(g) for g in gs]
    flat = torch.cat([(g.float() + full(e)).reshape(-1)
                      for g, e in zip(gs, errs)])
    k = max(1, int(flat.numel() * ratio))
    _, idx = stable_top_k(torch.abs(flat), k)
    kept = torch.zeros_like(flat).scatter_(0, idx, flat[idx])
    new_err = flat - kept
    out, err, o = [], [], 0
    for g, lk in zip(gs, like):
        n = g.numel()
        out.append(kept[o:o + n].reshape(g.shape).to(g.dtype))
        err.append(new_err[o:o + n].reshape(g.shape))
        if is_dtensor(lk):  # back to its shards
            out[-1] = shard_tensor(out[-1], lk.device_mesh, lk.placements)
            err[-1] = shard_tensor(err[-1], lk.device_mesh, lk.placements)
        o += n
    return out, err


def topk_compress_with_feedback(
    grads: dict, err_state, ratio: float = 0.01, groups=None
):
    """Returns (compressed grads, new error state), both {name: tensor}.
    ``err_state``: f32 {name: tensor} like grads, or None for zeros.
    ``groups``: lists of names that form one leaf each, in stacking order
    (default: each name alone)."""
    if err_state is None:
        err_state = {n: torch.zeros(g.shape, dtype=torch.float32,
                                    device=g.device)
                     for n, g in grads.items()}
    if groups is None:
        groups = [[n] for n in grads]
    comp, err = {}, {}
    with torch.no_grad():
        for names in groups:
            out, e = _compress_leaf([grads[n] for n in names],
                                    [err_state[n] for n in names], ratio)
            comp.update(zip(names, out))
            err.update(zip(names, e))
    return {n: comp[n] for n in grads}, {n: err[n] for n in grads}
