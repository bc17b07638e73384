"""Serving steps: batched prefill and single-token decode over a KV cache;
the port of the JAX package's ``runtime/serve_step.py``.

Across ranks (``rules`` with a mesh, the ``decode`` or ``long`` preset):
the parameters are ``DTensor``s the caller placed (as
``train_step.shard_train_state`` places ``model.axes()``);
:func:`greedy_generate` places the cache by the rules from
``model.cache_spec`` (each rank allocates its own slice, ``cache_seq``
sharded where the mesh divides ``s_max``) and the inputs over the batch
axes, runs the prefill and the decode steps with the rules' hook (plain
tensors count as replicated, ``sharding.replicating``), and takes each
greedy token from the vocab-sharded logits on their shards
(``models.local.argmax_last``).  It returns the tokens as a plain tensor,
the same on every rank.  A mesh over torch's fake process group is
refused.
"""
from __future__ import annotations

import torch

from ..models.layers import ID_RULES
from ..models.local import argmax_last
from .sharding import full, replicating, zeros_placed
from .train_step import shard_batch

__all__ = ["make_prefill_step", "make_decode_step", "greedy_generate"]


def _hook(rules, what: str):
    """The models' hook for ``rules`` (None: the identity), after refusing
    a mesh whose process group does not communicate."""
    if getattr(rules, "mesh", None) is not None:
        from ..launch.mesh import require_execution
        require_execution(rules.mesh, what)
    return ID_RULES if rules is None else rules


def make_prefill_step(model, rules=None):
    hook = _hook(rules, "the prefill step")

    def prefill(params, batch, cache=None):
        with replicating(rules):
            return model.prefill(params, batch, cache=cache, rules=hook)

    return prefill


def make_decode_step(model, rules=None):
    hook = _hook(rules, "the decode step")

    def decode(params, batch):
        with replicating(rules):
            logits, cache = model.decode(params, batch, rules=hook)
            next_token = argmax_last(logits).to(torch.int32)
        return next_token, logits, cache

    return decode


def greedy_generate(model, params, batch, steps: int, s_max: int, rules=None):
    """Prefill then greedy-decode: ``steps`` tokens in all, the first from
    the prefill's logits.  batch["tokens"]: (B, S0), with whatever else
    the family's prefill reads ("positions", "patch_embeds",
    "enc_embeds").  The cache is allocated at ``s_max`` on the tokens'
    device (placed by ``rules`` on their mesh) and the prefill writes its
    k/v into the cache's head.  A vlm decode starts after the S0 +
    n_vision_tokens prefill positions, with that position on all three
    M-RoPE streams.  Returns the tokens (B, steps) int32."""
    mesh = getattr(rules, "mesh", None)
    prefill, decode = make_prefill_step(model, rules), make_decode_step(
        model, rules)
    tokens = batch["tokens"]
    B, S0 = tokens.shape
    vlm = model.config.family == "vlm"
    pos0 = S0 + (model.config.n_vision_tokens if vlm else 0)
    if s_max < pos0 + steps - 1:
        raise ValueError(f"s_max={s_max} is short of the {pos0 + steps - 1} "
                         "positions the run writes")
    if mesh is None:
        cache = model.alloc_cache(B, s_max, tokens.device)
    else:
        abstract, axes = model.cache_spec(B, s_max)
        cache = zeros_placed(abstract, rules.tree_shardings(abstract, axes))
        batch = shard_batch(batch, rules)
    logits, cache = prefill(params, batch, cache=cache)
    tok = argmax_last(logits).to(torch.int32)[:, None]
    out = [tok]
    for i in range(steps - 1):
        step = {"pos": torch.full((B,), pos0 + i, dtype=torch.long,
                                  device=tokens.device)}
        if vlm:
            step["positions"] = torch.full((3, B, 1), pos0 + i,
                                           dtype=torch.long,
                                           device=tokens.device)
        if mesh is not None:
            step = shard_batch(step, rules)
        nxt, logits, cache = decode(params, {"token": tok, **step,
                                             "cache": cache})
        tok = nxt[:, None]
        out.append(tok)
    return full(torch.cat(out, dim=1))
