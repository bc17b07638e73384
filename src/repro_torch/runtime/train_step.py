"""The train step: loss → gradients → AdamW, with the remat policy,
microbatch gradient accumulation and optional gradient compression; the
port of the JAX package's ``runtime/train_step.py``.

The gradients come from ``torch.autograd.grad`` through the model's loss,
which on the card runs the attention and SSD kernels forward and backward
(``kernels.flash_attention.FlashAttentionFn``, ``kernels.ssd.SsdFn``).
The step updates the state's parameters and moments in place and returns
the state.

Across ranks (``rules`` with a mesh): the state and the batch are
``DTensor``s (:func:`shard_train_state`, :func:`shard_batch`: every rank
builds the same full tensors and keeps its slice), the loss runs the
models' ``rules`` hook, plain tensors in the step count as replicated
(``sharding.replicating``), and ``constrain_grads`` redistributes each
gradient to its parameter's placements (``train_step.py:58-66`` of the
JAX package: a reduce-scatter to the FSDP shard, not an all-reduce of
the full gradient).  Microbatches are cut from the global batch.  The
metrics come back as plain tensors, the same on every rank.  A mesh over
torch's fake process group is refused: it would not communicate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..dtensor import is_dtensor
from ..models.convert import jax_leaf_groups
from ..models.layers import ID_RULES, spec_leaves
from ..optim import AdamW, OptState, topk_compress_with_feedback
from .sharding import Sharding, full, place, replicating, shard_tensor

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "state_shardings", "shard_train_state", "shard_batch"]


@dataclasses.dataclass
class TrainState:
    params: Any  # a trainable ParamTree
    opt: OptState
    err: Optional[dict]  # compression's error feedback, {name: f32 tensor}


def init_train_state(
    model,
    generator: torch.Generator,
    optimizer: AdamW,
    compress: bool = False,
) -> TrainState:
    """Random trainable parameters drawn on the generator's device, AdamW's
    zero moments, and a zero error state under compression."""
    params = model.init(generator, trainable=True)
    err = ({n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()} if compress else None)
    return TrainState(params=params, opt=optimizer.init(params), err=err)


def state_shardings(model, rules, state: TrainState) -> TrainState:
    """Where each leaf of ``state`` lives under ``rules``: a
    ``TrainState`` of ``Sharding``s — each parameter's by its logical axes
    (``{name: Sharding}``), AdamW's moments and the error feedback as
    their parameter; the step count stays a plain tensor, the same on
    every rank."""
    axes = dict(spec_leaves(model.spec))
    params = {n: rules.named(tuple(p.shape), axes[n].axes)
              for n, p in state.params.named_parameters()}
    return TrainState(
        params=params,
        opt=OptState(step=Sharding(None, (), ()), m=dict(params),
                     v=dict(params)),
        err=None if state.err is None else dict(params))


def shard_train_state(state: TrainState, model, rules) -> TrainState:
    """``state`` placed on ``rules``' mesh: ``jax.device_put(state,
    shardings)``.  Every rank must hold the same full state (the same
    seed); each keeps its slices."""
    return place(state, state_shardings(model, rules, state))


def shard_batch(batch: dict, rules) -> dict:
    """A training batch (the same full tensors on every rank) placed over
    the rules' batch axes (``launch/specs.py``'s train kind): every leaf's
    first dim, but the second of (3, B, S) M-RoPE positions."""
    out = {}
    for k, v in batch.items():
        axes = (None, "batch", None) if k == "positions" and v.dim() == 3 \
            else ("batch",) + (None,) * (v.dim() - 1)
        sh = rules.named(tuple(v.shape), axes)
        out[k] = v if sh.mesh is None else shard_tensor(v, sh.mesh,
                                                        sh.placements)
    return out


def _split(x, microbatches: int):
    """A batch leaf cut into ``microbatches`` along its batch axis; (3, B,
    S) M-RoPE positions along their second (``train_step.py:83-88``).  A
    ``DTensor`` leaf is cut from the global batch, each microbatch laid
    out as the leaf."""
    if is_dtensor(x):
        return [shard_tensor(m, x.device_mesh, x.placements)
                for m in _split(full(x), microbatches)]
    if x.dim() >= 3 and x.shape[0] == 3 and x.shape[1] % microbatches == 0:
        return list(x.reshape(3, microbatches, -1, *x.shape[2:])
                    .transpose(0, 1))
    if x.shape[0] % microbatches:
        raise ValueError(f"a batch leaf of shape {tuple(x.shape)} does not "
                         f"split into {microbatches} microbatches")
    return list(x.reshape(microbatches, -1, *x.shape[1:]))


def make_train_step(
    model,
    optimizer: AdamW,
    *,
    rules=None,
    remat: str = "full",
    microbatches: int = 1,
    compress_ratio: Optional[float] = None,
):
    """Returns step(state, batch) -> (state, metrics): metrics hold the
    model's, "loss" and "grad_norm" (f32 tensors).  With ``rules`` over a
    mesh the state and batch are ``DTensor``s on it (see the module
    docstring)."""
    mesh = getattr(rules, "mesh", None)
    if mesh is not None:
        from ..launch.mesh import require_execution
        require_execution(mesh, "the train step")
    hook = ID_RULES if rules is None else rules
    groups = [[n for _, n in items]
              for items in jax_leaf_groups(model.spec).values()]

    def constrain_grads(grads, named):
        """Each gradient on its parameter's placements."""
        return {n: (g.redistribute(named[n].device_mesh, named[n].placements)
                    if is_dtensor(g) else g) for n, g in grads.items()}

    def grad_fn(params, batch):
        named = dict(params.named_parameters())
        loss, metrics = model.loss(params, batch, rules=hook, remat=remat)
        if is_dtensor(loss):  # a replicated scalar seeds the backward
            from torch.distributed.tensor import Replicate
            loss = loss.redistribute(loss.device_mesh,
                                     [Replicate()] * loss.device_mesh.ndim)
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for (n, p), g in zip(named.items(), gs)}
        return full(loss.detach()), metrics, constrain_grads(grads, named)

    def compute_grads(params, batch):
        if microbatches == 1:
            return grad_fn(params, batch)
        parts = {k: _split(v, microbatches) for k, v in batch.items()}
        acc, loss_sum = None, torch.zeros((), dtype=torch.float32)
        for i in range(microbatches):
            loss, _, grads = grad_fn(params, {k: v[i] for k, v in
                                              parts.items()})
            loss_sum = loss_sum.to(loss.device) + loss
            if acc is None:
                acc = {n: g.float() for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    acc[n] += g.float()
            del grads
        grads = {n: a / microbatches for n, a in acc.items()}
        mean = loss_sum / microbatches
        return mean, {"ce": mean}, grads

    def step(state: TrainState, batch):
        with replicating(rules):
            loss, metrics, grads = compute_grads(state.params, batch)
            err = state.err
            if compress_ratio is not None:
                grads, err = topk_compress_with_feedback(
                    grads, err, compress_ratio, groups)
            params, opt, gnorm = optimizer.update(grads, state.opt,
                                                  state.params)
        metrics = {k: (full(v.detach()) if isinstance(v, torch.Tensor)
                       else v) for k, v in metrics.items()}
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return TrainState(params=params, opt=opt, err=err), metrics

    return step
