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
    the prefill's logits.  batch["tokens"]: (B, S0), with whatever else
    the family's prefill reads ("positions", "patch_embeds",
    "enc_embeds").  The cache is allocated at ``s_max`` on the tokens'
    device and the prefill writes its k/v into the cache's head.  A vlm
    decode starts after the S0 + n_vision_tokens prefill positions, with
    that position on all three M-RoPE streams.  Returns the tokens
    (B, steps) int32."""
    tokens = batch["tokens"]
    B, S0 = tokens.shape
    vlm = model.config.family == "vlm"
    pos0 = S0 + (model.config.n_vision_tokens if vlm else 0)
    if s_max < pos0 + steps - 1:
        raise ValueError(f"s_max={s_max} is short of the {pos0 + steps - 1} "
                         "positions the run writes")
    cache = model.alloc_cache(B, s_max, tokens.device)
    logits, cache = model.prefill(params, batch, cache=cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(steps - 1):
        dec = {"token": tok, "cache": cache,
               "pos": torch.full((B,), pos0 + i, dtype=torch.long,
                                 device=tokens.device)}
        if vlm:
            dec["positions"] = torch.full((3, B, 1), pos0 + i,
                                          dtype=torch.long,
                                          device=tokens.device)
        logits, cache = model.decode(params, dec)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
