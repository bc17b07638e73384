"""Meta-device input stand-ins for every (arch × shape) cell: the port of
the JAX package's ``launch/specs.py``, with meta tensors in place of
``ShapeDtypeStruct``s.  Nothing allocates; the returned (batch, axes)
pair feeds ``Rules.tree_shardings`` and the dry run's traces.

Conventions:
  train   : tokens (B, S_text+1) — loss shifts internally
  prefill : tokens (B, S_text)
  decode  : token (B, 1) + pos (B,) + cache sized seq_len
  vlm     : n_vision_tokens of the seq budget are patch embeddings
            (precomputed by the stub frontend), positions are M-RoPE (3,B,S)
  encdec  : enc_embeds (B, enc_len, d) from the stub conv frontend
"""
from __future__ import annotations

import torch

from ..configs import Shape
from ..models import build_model
from ..models.layers import DTYPES

__all__ = ["input_specs", "batch_axes"]

I32 = torch.int32


def _sd(shape, dtype):
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def input_specs(cfg, shape: Shape, model=None):
    """Returns (meta batch, axes tree) for the step this shape runs."""
    B, S = shape.global_batch, shape.seq_len
    cdt = DTYPES[cfg.compute_dtype]
    kind = shape.kind

    if kind in ("train", "prefill"):
        extra = 1 if kind == "train" else 0
        batch, axes = {}, {}
        if cfg.family == "vlm":
            nv = cfg.n_vision_tokens
            s_text = S - nv
            batch["tokens"] = _sd((B, s_text + extra), I32)
            axes["tokens"] = ("batch", None)
            batch["patch_embeds"] = _sd((B, nv, cfg.d_model), cdt)
            axes["patch_embeds"] = ("batch", None, None)
            batch["positions"] = _sd((3, B, S), I32)
            axes["positions"] = (None, "batch", None)
        elif cfg.family == "encdec":
            batch["tokens"] = _sd((B, S + extra), I32)
            axes["tokens"] = ("batch", None)
            batch["enc_embeds"] = _sd((B, cfg.enc_len, cfg.d_model), cdt)
            axes["enc_embeds"] = ("batch", None, None)
        else:
            batch["tokens"] = _sd((B, S + extra), I32)
            axes["tokens"] = ("batch", None)
        return batch, axes

    if kind != "decode":
        raise ValueError(f"unknown shape kind {kind!r}")
    if model is None:
        model = build_model(cfg)
    cache, cache_axes = model.cache_spec(B, S)
    batch = {"token": _sd((B, 1), I32), "pos": _sd((B,), I32),
             "cache": cache}
    axes = {"token": ("batch", None), "pos": ("batch",),
            "cache": cache_axes}
    if cfg.family == "vlm":
        batch["positions"] = _sd((3, B, 1), I32)
        axes["positions"] = (None, "batch", None)
    return batch, axes


def batch_axes(cfg, shape: Shape):
    return input_specs(cfg, shape)[1]
