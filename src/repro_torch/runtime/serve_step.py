"""Serving steps: batched prefill and single-token decode over a KV cache;
the port of the JAX package's ``runtime/serve_step.py``."""
from __future__ import annotations

import torch

__all__ = ["make_prefill_step", "make_decode_step", "greedy_generate"]


def make_prefill_step(model):
    def prefill(params, batch, cache=None):
        return model.prefill(params, batch, cache=cache)

    return prefill


def make_decode_step(model):
    def decode(params, batch):
        logits, cache = model.decode(params, batch)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode


def greedy_generate(model, params, batch, steps: int, s_max: int):
    """Prefill then greedy-decode: ``steps`` tokens in all, the first from
    the prefill's logits.  batch["tokens"]: (B, S0).  The cache is
    allocated at ``s_max`` on the tokens' device and the prefill writes its
    k/v into the cache's head.  Returns the tokens (B, steps) int32."""
    tokens = batch["tokens"]
    B, S0 = tokens.shape
    if s_max < S0 + steps - 1:
        raise ValueError(f"s_max={s_max} is short of the {S0 + steps - 1} "
                         "positions the run writes")
    cache = model.alloc_cache(B, s_max, tokens.device)
    logits, cache = model.prefill(params, batch, cache=cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(steps - 1):
        pos = torch.full((B,), S0 + i, dtype=torch.long, device=tokens.device)
        logits, cache = model.decode(params, {"token": tok, "pos": pos,
                                              "cache": cache})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
