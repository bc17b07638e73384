"""The train step: loss → gradients → AdamW, with the remat policy,
microbatch gradient accumulation and optional gradient compression; the
port of the JAX package's ``runtime/train_step.py``.

The gradients come from ``torch.autograd.grad`` through the model's loss,
which on the card runs the attention and SSD kernels forward and backward
(``kernels.flash_attention.FlashAttentionFn``, ``kernels.ssd.SsdFn``).
The step updates the state's parameters and moments in place and returns
the state.  ``rules`` and ``constrain_grads`` are the identity until the
sharding runtime is ported: one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..models.convert import jax_leaf_groups
from ..optim import AdamW, OptState, topk_compress_with_feedback

__all__ = ["TrainState", "init_train_state", "make_train_step"]


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


def _split(x, microbatches: int):
    """A batch leaf cut into ``microbatches`` along its batch axis; (3, B,
    S) M-RoPE positions along their second (``train_step.py:83-88``)."""
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
    model's, "loss" and "grad_norm" (f32 tensors)."""
    del rules  # the identity on one card
    groups = [[n for _, n in items]
              for items in jax_leaf_groups(model.spec).values()]

    def constrain_grads(grads):
        return grads  # pins the gradient shardings once sharding is ported

    def grad_fn(params, batch):
        named = dict(params.named_parameters())
        loss, metrics = model.loss(params, batch, remat=remat)
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for (n, p), g in zip(named.items(), gs)}
        return loss.detach(), metrics, constrain_grads(grads)

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
        loss, metrics, grads = compute_grads(state.params, batch)
        err = state.err
        if compress_ratio is not None:
            grads, err = topk_compress_with_feedback(grads, err,
                                                     compress_ratio, groups)
        params, opt, gnorm = optimizer.update(grads, state.opt, state.params)
        metrics = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                   for k, v in metrics.items()}
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return TrainState(params=params, opt=opt, err=err), metrics

    return step
