"""Model stacks and the ``Model`` facade of the port: the dense family
(gemma, gemma3, qwen1.5, qwen2.5), the moe family (dbrx, deepseek-v3 with
MLA), the vlm family (qwen2-vl), the ssm family (mamba2), the hybrid
family (zamba2) and the encdec family (whisper).

The JAX package scans stacked parameters with ``lax.scan``; the port runs
its layers in Python loops over per-layer parameters.  A dense LM is
``n_layers`` attention + MLP blocks, each with its own (window, θ) under a
gemma3-style local:global pattern (:func:`layer_pattern`); a moe LM is
``moe_layer_start`` such blocks (``blocks``) and then attention + MoE
blocks (``moe_blocks``), the attention MLA under ``cfg.mla``, and
deepseek's multi-token-prediction head (``mtp``) is declared for the
loss, which reads it; a vlm LM is a dense LM whose prefill puts the
caller's patch embeddings (the vision tower is a stub, as in JAX) before
the text and rotates by M-RoPE's three position streams; an ssm LM is
``n_layers`` Mamba2 blocks; zamba2 is ``n_groups`` groups of
[``hybrid_every`` − 1 Mamba2 blocks + one SHARED attention block (one
set of weights, applied once per group)] and a tail of Mamba2 blocks;
whisper is an encoder of ``n_enc_layers`` bidirectional blocks over the
caller's frame embeddings (the conv frontend is a stub) and a decoder of
``n_layers`` blocks with causal self-attention and cross-attention to
the encoder's output.

The serving caches keep the JAX layouts, in the compute dtype —

  dense   dense: (k, v), each (L, B, S_max, KV, hd)
  vlm     as dense; S_max counts the n_vision_tokens patch positions
  moe     dense (when moe_layer_start > 0), moe: (k, v) as dense, each
          (L_dense or L_moe, B, S_max, KV, hd); under MLA (c_kv
          (L, B, S_max, kv_lora), k_rope (L, B, S_max, rope_hd))
  ssm     ssm (L, B, H, P, N)           conv (L, B, W-1, conv_dim)
  hybrid  g_ssm  (G, M, B, H, P, N)     g_conv (G, M, B, W-1, conv_dim)
          k, v   (G, B, S_max, KV, hd)  t_ssm  (T, B, H, P, N)
                                        t_conv (T, B, W-1, conv_dim)
  encdec  k, v   (L, B, S_max, KV, hd)  ck, cv (L, B, enc_len, H, hd)

— ``Model.alloc_cache`` allocates one; prefill and decode write it in
place (prefill's k/v go to positions [0, S)) and return it, under
``torch.no_grad``.  ``Model.cache_spec`` gives the same tree on the meta
device with each leaf's logical axes (JAX's ``cache_spec``), for the dry
run and for placing a cache on a mesh.  Prefill and decode take the
sharding hook (``rules=``) at the JAX package's sites; on a ``DTensor``
cache (``runtime.serve_step.greedy_generate`` places one by the rules,
and a prefill given none allocates one so) each rank writes and attends
on its own slice (``models.local``).

``Model.loss(params, batch, rules=..., remat=...)`` is each family's
training loss,
as the JAX package's: the mean next-token cross-entropy from seq-chunked
logits (``_ce_from_hidden``, each chunk under ``torch.utils.checkpoint``),
plus 0.01 × the moe aux term and 0.3 × deepseek's multi-token-prediction
loss.  ``remat`` ("full" | "dots" | "none", ``_maybe_remat``) checkpoints
each layer as the JAX package's ``jax.checkpoint`` of its scan body does:
"full" keeps nothing, "dots" keeps the 2-D matrix products' outputs, "none"
keeps everything.  The loss never touches a serving cache.  ``rules(x,
axes)`` is the JAX package's sharding hook, called at its sites with its
logical axes (the block's residual, the logits, the attention and Mamba2
operands, the moe dispatch): the identity by default and on plain
tensors; with ``DTensor`` parameters and batch (``runtime.sharding``) it
redistributes the activations, and the attention and SSD kernels run on
each rank's shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from .attention import (attn_decode, attn_encode, attn_specs, attn_train,
                        cross_attn, cross_attn_specs, cross_kv, mla_decode,
                        mla_specs, mla_train)
from ..dtensor import is_dtensor
from .layers import (DTYPES, ID_RULES, Leaf, ParamTree, abstract_params,
                     init_params,
                     layer_norm, mlp_apply, mlp_specs, norm_specs,
                     param_axes, rms_norm)
from .local import take_last, write_prefix, write_state, zero_pad
from .moe import moe_apply, moe_specs
from .ssm import conv_dim, mamba_decode, mamba_train, ssm_specs

__all__ = ["Model", "build_model", "hybrid_layout", "layer_pattern"]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _norm(p, cfg, x):
    return rms_norm(x, p["w"], cfg.norm_eps, cfg.norm_plus_one)


def _lm_head_specs(cfg) -> dict:
    spec = {"embed": Leaf((cfg.vocab, cfg.d_model), "normal",
                          axes=("vocab", "embed")),
            "final_norm": norm_specs(cfg.d_model, cfg.norm_plus_one)}
    if not cfg.tie_embeddings:
        spec["head"] = Leaf((cfg.d_model, cfg.vocab), axes=("embed", "vocab"))
    return spec


def _embed(params, cfg, tokens):
    """Token embeddings in the compute dtype, times √d under
    ``embed_scale``: √d rounded to float32 and then to the compute dtype
    before the multiply, as the JAX package rounds it (in bf16 the factor
    is a bf16 value)."""
    cdt = DTYPES[cfg.compute_dtype]
    h = params["embed"][tokens].to(cdt)
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=h.device).to(cdt)
    return h


def _logits(params, cfg, h, rules=ID_RULES):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return rules((h @ head).float(), ("batch", "seq_sp", "vocab"))


# ---------------------------------------------------------------------------
# training: rematerialization and the cross-entropy
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "dots", "none")
# the 2-D matrix products whose outputs "dots" keeps: the JAX package's
# dots_with_no_batch_dims_saveable (a batched product, bmm, is recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return _ckpt.create_selective_checkpoint_contexts(_dots_policy)


def _maybe_remat(fn, remat: str):
    """``fn`` under ``torch.utils.checkpoint``: "full" saves nothing and
    recomputes the layer in the backward, "dots" saves the outputs of its
    2-D matrix products, "none" is ``fn`` itself."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} is not one of {REMAT_POLICIES}")
    if remat == "none":
        return fn
    kw = dict(use_reentrant=False)
    if remat == "dots":
        kw["context_fn"] = _dots_context

    def wrapped(*args):
        return _ckpt.checkpoint(fn, *args, **kw)
    return wrapped


def _xent(logits, labels):
    """Mean token cross-entropy in f32 and the token count; labels
    (B, S)."""
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - take_last(logits, labels.long())
    return nll.mean(), nll.numel()


def _ce_from_hidden(params, cfg, h, labels, rules=ID_RULES):
    """Cross-entropy from the final hidden states h (B, S, d) with
    seq-chunked logits (``transformer.py:220-251`` of the JAX package): S
    is padded to a multiple of ``cfg.xent_chunk``, each chunk's logits
    are formed under ``torch.utils.checkpoint`` (recomputed in the
    backward, never all held), the pad is masked, and the sum is divided
    by B·S.  A sequence no longer than one chunk takes :func:`_xent`."""
    B, S, _ = h.shape
    chunk = cfg.xent_chunk
    if chunk <= 0 or S <= chunk:
        return _xent(_logits(params, cfg, h, rules), labels)
    pad = (-S) % chunk
    labels = labels.long()
    if pad:
        h = zero_pad(h, 1, after=pad)
        labels = zero_pad(labels, 1, after=pad)
    valid = torch.arange(S + pad, device=h.device) < S

    def body(hs, ls, vs):
        logits = _logits(params, cfg, hs, rules)
        lse = torch.logsumexp(logits, dim=-1)
        gold = take_last(logits, ls)
        return torch.where(vs[None, :], lse - gold, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S + pad, chunk):
        total = total + _ckpt.checkpoint(
            body, h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            valid[c0:c0 + chunk], use_reentrant=False)
    n = float(B * S)
    return total / n, n


def _dense_block_specs(cfg, moe: bool = False) -> dict:
    spec = {"ln1": norm_specs(cfg.d_model, cfg.norm_plus_one),
            "attn": mla_specs(cfg) if cfg.mla else attn_specs(cfg),
            "ln2": norm_specs(cfg.d_model, cfg.norm_plus_one)}
    if moe:
        spec["moe"] = moe_specs(cfg)
    else:
        spec["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.activation)
    return spec


def _ffn(p, cfg, x, moe: bool, rules=ID_RULES):
    """The block's MLP or MoE and its aux loss (an f32 0 for an MLP)."""
    if moe:
        return moe_apply(p["moe"], cfg, x, rules)
    return (mlp_apply(p["mlp"], x, cfg.activation),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _dense_block_train(p, cfg, h, positions, window, theta, moe=False, rules=ID_RULES):
    """Full-sequence block: (h, the layer's k/v, the moe aux term)."""
    x = _norm(p["ln1"], cfg, h)
    if cfg.mla:
        a, kv = mla_train(p["attn"], cfg, x, positions, chunk=cfg.attn_chunk,
                          rules=rules)
    else:
        a, kv = attn_train(p["attn"], cfg, x, positions, window=window,
                           theta=theta, chunk=cfg.attn_chunk, rules=rules)
    h = h + a
    f, aux = _ffn(p, cfg, _norm(p["ln2"], cfg, h), moe, rules)
    return rules(h + f, ("batch", "seq_sp", None)), kv, aux


def _dense_block_decode(
    p, cfg, h, pos, cache, window, theta, moe=False, rope_positions=None, rules=ID_RULES
):
    x = _norm(p["ln1"], cfg, h)
    if cfg.mla:
        a, cache = mla_decode(p["attn"], cfg, x, pos, cache, rules=rules)
    else:
        a, cache = attn_decode(p["attn"], cfg, x, pos, cache, window=window,
                               theta=theta, rope_positions=rope_positions,
                               rules=rules)
    h = h + a
    return h + _ffn(p, cfg, _norm(p["ln2"], cfg, h), moe, rules)[0], cache


def _ssm_block_specs(cfg) -> dict:
    return {"ln": norm_specs(cfg.d_model, cfg.norm_plus_one),
            "mixer": ssm_specs(cfg)}


# ---------------------------------------------------------------------------
# the Model facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    config: Any
    spec: dict  # nested Leaf declarations, lists for runs of layers
    prefill: Callable  # (params, batch, cache=None, rules=) -> (last_logits, cache)
    decode: Callable  # (params, batch, rules=) -> (logits, cache)
    alloc_cache: Callable  # (batch_size, s_max, device) -> cache dict
    encode: Callable | None = None  # encdec: (params, enc_embeds) -> h
    loss: Callable | None = None  # (params, batch, rules=, remat=) -> (loss, metrics)
    cache_axes: Callable | None = None  # () -> the cache's axes tree

    def init(self, generator: torch.Generator, trainable: bool = False) -> ParamTree:
        """Random parameters on the generator's device, in the config's
        parameter dtype; ``trainable`` ones require gradients."""
        return init_params(self.spec, DTYPES[self.config.param_dtype],
                           generator, trainable)

    def abstract(self) -> ParamTree:
        """The parameters' shapes and dtypes as meta-device tensors:
        nothing allocated (count them with ``.parameters()``)."""
        return abstract_params(self.spec, DTYPES[self.config.param_dtype])

    def axes(self):
        """Each parameter's logical axis names, nested as the spec."""
        return param_axes(self.spec)

    def cache_spec(self, batch_size: int, s_max: int):
        """(the serving cache of ``alloc_cache(batch_size, s_max)`` as
        meta-device tensors — its shapes and dtypes, nothing allocated —
        and its axes tree, the same nesting with a tuple of logical names
        a leaf), as the JAX package's ``cache_spec``."""
        return (self.alloc_cache(batch_size, s_max, torch.device("meta")),
                self.cache_axes())


def _serving(fn):
    """A prefill, decode or encode that builds no autograd graph, whatever
    the parameters require."""
    if fn is None:
        return None

    def run(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)
    run.__doc__ = fn.__doc__
    return run


def _new_cache(alloc_cache, cache_axes, like, B, s_max, rules):
    """A zero cache for a prefill given none, at ``s_max``: placed by
    ``rules`` on their mesh when the prefill runs on ``DTensor``s (``like``
    is one), this rank's slice allocated alone."""
    if not is_dtensor(like):
        return alloc_cache(B, s_max, like.device)
    from ..runtime.sharding import zeros_placed
    meta = alloc_cache(B, s_max, torch.device("meta"))
    return zeros_placed(meta, rules.tree_shardings(meta, cache_axes()))


def _model(cfg, spec, prefill, decode, alloc_cache, cache_axes, encode=None, loss=None):
    return Model(cfg, spec, _serving(prefill), _serving(decode), alloc_cache,
                 _serving(encode), loss, cache_axes)


# a stacked k/v cache (L, B, S_max, KV, hd) and a recurrent state / conv
# window (L, B, H, P, N) / (L, B, W-1, conv_dim): the JAX cache_spec axes
_KV_AXES = ("layers", "batch", "cache_seq", "kv_heads", None)
_SSM_AXES = ("layers", "batch", "heads", None, None)
_CONV_AXES = ("layers", "batch", None, "heads")


def build_model(cfg) -> Model:
    if cfg.family in ("dense", "moe", "vlm"):
        return _build_decoder_lm(cfg)
    if cfg.family == "ssm":
        return _build_ssm_lm(cfg)
    if cfg.family == "hybrid":
        return _build_hybrid_lm(cfg)
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    raise ValueError(f"unknown model family {cfg.family!r}")


# ---------------------------------------------------------------------------
# decoder-only LM (the dense, moe and vlm families)
# ---------------------------------------------------------------------------

def layer_pattern(cfg, n_layers: int):
    """Per-layer (window, θ) lists of a gemma3-style local:global pattern
    — every ``global_every``-th layer global (window 0, θ 10⁶), the rest
    local (``window``, ``rope_theta``) — or ``(None, None)`` when
    ``global_every`` ≤ 0 (every layer global, ``rope_theta``)."""
    if cfg.global_every <= 0:
        return None, None
    is_global = [i % cfg.global_every == cfg.global_every - 1
                 for i in range(n_layers)]
    return ([0 if g else cfg.window for g in is_global],
            [1_000_000.0 if g else float(cfg.rope_theta) for g in is_global])


def _split_layers(cfg):
    """(dense layers, moe layers): a moe config's first ``moe_layer_start``
    layers are dense (deepseek's 3), the rest moe."""
    if cfg.n_experts > 0:
        return cfg.moe_layer_start, cfg.n_layers - cfg.moe_layer_start
    return cfg.n_layers, 0


def _build_decoder_lm(cfg):
    n_dense, n_moe = _split_layers(cfg)
    spec = _lm_head_specs(cfg)
    if n_dense:
        spec["blocks"] = [_dense_block_specs(cfg) for _ in range(n_dense)]
    if n_moe:
        spec["moe_blocks"] = [_dense_block_specs(cfg, moe=True)
                              for _ in range(n_moe)]
    if cfg.mtp:
        spec["mtp"] = {"proj": Leaf((2 * cfg.d_model, cfg.d_model),
                                    axes=("embed", "embed2")),
                       "norm_h": norm_specs(cfg.d_model, cfg.norm_plus_one),
                       "norm_e": norm_specs(cfg.d_model, cfg.norm_plus_one),
                       "block": _dense_block_specs(cfg)}
    windows, thetas = layer_pattern(cfg, n_dense)  # moe stacks are uniform
    # (stack, cache key, moe?, per-layer windows and θs)
    stacks = [("blocks", "dense", False, windows or [None] * n_dense,
               thetas or [None] * n_dense)] if n_dense else []
    if n_moe:
        stacks.append(("moe_blocks", "moe", True, [None] * n_moe,
                       [None] * n_moe))

    def alloc_cache(B, s_max, device):
        cdt = DTYPES[cfg.compute_dtype]

        def kv(n):
            if cfg.mla:
                return (torch.zeros((n, B, s_max, cfg.kv_lora_rank),
                                    dtype=cdt, device=device),
                        torch.zeros((n, B, s_max, cfg.rope_head_dim),
                                    dtype=cdt, device=device))
            shape = (n, B, s_max, cfg.n_kv_heads, cfg.head_dim)
            return (torch.zeros(shape, dtype=cdt, device=device),
                    torch.zeros(shape, dtype=cdt, device=device))

        cache = {}
        if n_dense:
            cache["dense"] = kv(n_dense)
        if n_moe:
            cache["moe"] = kv(n_moe)
        return cache

    def cache_axes():
        ax = (("layers", "batch", "cache_seq", None),) * 2 if cfg.mla \
            else (_KV_AXES, _KV_AXES)
        return {key: ax for key, n in (("dense", n_dense), ("moe", n_moe))
                if n}

    def embed_input(params, batch):
        """Token embeddings, after the patch embeddings (vlm) when the
        batch holds them, and their positions: ``batch["positions"]``
        when given ((B, S), or (3, B, S) under M-RoPE), else 0..S-1 —
        ``embed_input`` of the JAX package."""
        h = _embed(params, cfg, batch["tokens"])
        if cfg.family == "vlm" and "patch_embeds" in batch:
            h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
        B, S, _ = h.shape
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=h.device)[None].expand(B, S)
        return h, positions

    def prefill(params, batch, cache=None, rules=ID_RULES):
        """batch["tokens"]: (B, S); optional "positions" and, for vlm,
        "patch_embeds" (B, n_vision_tokens, d) before the text.  Returns
        the last position's logits (B, vocab) f32 and the cache, allocated
        at S_max = S (plus the patches) when none is given, with every
        layer's k/v (after RoPE; c_kv and k_rope under MLA) at positions
        [0, S)."""
        h, positions = embed_input(params, batch)
        B, S, _ = h.shape
        if cache is None:
            cache = _new_cache(alloc_cache, cache_axes, h, B, S, rules)
        for name, key, moe, wins, ths in stacks:
            a_cache, b_cache = cache[key]
            for i, lp in enumerate(params[name]):
                h, (a, b), _ = _dense_block_train(lp, cfg, h, positions,
                                                  wins[i], ths[i], moe, rules)
                write_prefix(a_cache[i], a)
                write_prefix(b_cache[i], b)
        h = _norm(params["final_norm"], cfg, h[:, -1:])
        return _logits(params, cfg, h, rules)[:, 0], cache

    def decode(params, batch, rules=ID_RULES):
        """batch: "token" (B, 1), "pos" (B,) the cache slot to write and
        attend up to, "cache", and for M-RoPE "positions" (3, B, 1), the
        rotary streams.  Returns (logits (B, vocab) f32, cache)."""
        cache, pos = batch["cache"], batch["pos"]
        rope_positions = batch.get("positions")
        h = _embed(params, cfg, batch["token"])
        for name, key, moe, wins, ths in stacks:
            a_cache, b_cache = cache[key]
            for i, lp in enumerate(params[name]):
                h, _ = _dense_block_decode(lp, cfg, h, pos,
                                           (a_cache[i], b_cache[i]), wins[i],
                                           ths[i], moe, rope_positions, rules)
        h = _norm(params["final_norm"], cfg, h)
        return _logits(params, cfg, h, rules)[:, 0], cache

    def run_stack(params, h, positions, remat, rules):
        """Every block, each under ``remat``; the final norm's output and
        the stacks' summed aux terms (each stack's layers summed first, as
        the JAX scans' outputs are)."""
        aux_total = 0
        for name, _, moe, wins, ths in stacks:
            auxes = []
            for i, lp in enumerate(params[name]):
                def block(h, lp=lp, w=wins[i], th=ths[i], moe=moe):
                    h, _, aux = _dense_block_train(lp, cfg, h, positions, w,
                                                   th, moe, rules)
                    return h, aux
                h, aux = _maybe_remat(block, remat)(h)
                auxes.append(aux)
            aux_total = aux_total + torch.stack(auxes).sum()
        return _norm(params["final_norm"], cfg, h), aux_total

    def mtp_loss(params, h, tokens, rules):
        """deepseek's one-depth multi-token prediction: h at position i
        with the embedding of token i+1 predicts token i+2."""
        cdt = DTYPES[cfg.compute_dtype]
        mp = params["mtp"]
        emb_next = params["embed"][tokens[:, 1:-1]].to(cdt)
        hh = _norm(mp["norm_h"], cfg, h[:, :-1])
        ee = _norm(mp["norm_e"], cfg, emb_next)
        hm = torch.cat([hh, ee], dim=-1) @ mp["proj"]
        B, S, _ = hm.shape
        positions = torch.arange(S, device=hm.device)[None].expand(B, S)
        hm = _dense_block_train(mp["block"], cfg, hm, positions, None, None,
                                rules=rules)[0]
        return _ce_from_hidden(params, cfg, hm, tokens[:, 2:], rules)[0]

    def loss(params, batch, rules=ID_RULES, remat="full"):
        """batch["tokens"] (B, S + 1): inputs [:, :-1], labels [:, 1:];
        for vlm also "patch_embeds" and (3, B, n_vision + S) "positions".
        Returns (ce + 0.01 aux [+ 0.3 mtp], metrics)."""
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        h, positions = embed_input(params, {**batch, "tokens": tokens[:, :-1]})
        h, aux = run_stack(params, h, positions, remat, rules)
        n_vis = h.shape[1] - labels.shape[1]
        ce, ntok = _ce_from_hidden(params, cfg, h[:, n_vis:], labels, rules)
        total = ce + 0.01 * aux
        metrics = {"ce": ce, "aux": aux, "ntok": ntok}
        if cfg.mtp:
            mtp = mtp_loss(params, h[:, n_vis:], tokens, rules)
            total = total + 0.3 * mtp
            metrics["mtp"] = mtp
        return total, metrics

    return _model(cfg, spec, prefill, decode, alloc_cache, cache_axes,
                  loss=loss)


# ---------------------------------------------------------------------------
# attention-free SSM LM (mamba2)
# ---------------------------------------------------------------------------

def _build_ssm_lm(cfg):
    L = cfg.n_layers
    spec = _lm_head_specs(cfg)
    spec["blocks"] = [_ssm_block_specs(cfg) for _ in range(L)]

    def alloc_cache(B, s_max, device):
        """The recurrent state: no sequence axis, so ``s_max`` is unused."""
        del s_max
        cdt = DTYPES[cfg.compute_dtype]
        H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        return {"ssm": torch.zeros((L, B, H, P, N), dtype=cdt,
                                   device=device),
                "conv": torch.zeros((L, B, cfg.conv_width - 1, conv_dim(cfg)),
                                    dtype=cdt, device=device)}

    def prefill(params, batch, cache=None, rules=ID_RULES):
        """Chunked-scan prefill (one SSD scan a layer); the cache is each
        layer's final recurrent state.  batch["tokens"]: (B, S)."""
        tokens = batch["tokens"]
        if cache is None:
            cache = _new_cache(alloc_cache, cache_axes, tokens,
                               tokens.shape[0], 0, rules)
        h = _embed(params, cfg, tokens)
        for i in range(L):
            lp = params["blocks"][i]
            y, st = mamba_train(lp["mixer"], cfg, _norm(lp["ln"], cfg, h),
                                return_state=True, rules=rules)
            write_state(cache["ssm"][i], st["ssm"])
            write_state(cache["conv"][i], st["conv"])
            h = rules(h + y, ("batch", "seq_sp", None))
        h = _norm(params["final_norm"], cfg, h[:, -1:])
        return _logits(params, cfg, h, rules)[:, 0], cache

    def decode(params, batch, rules=ID_RULES):
        """batch: "token" (B, 1), "pos" (unused: the state carries the
        position), "cache".  Returns (logits (B, vocab) f32, cache)."""
        cache = batch["cache"]
        h = _embed(params, cfg, batch["token"])
        for i in range(L):
            lp = params["blocks"][i]
            y, st = mamba_decode(lp["mixer"], cfg, _norm(lp["ln"], cfg, h),
                                 {"ssm": cache["ssm"][i],
                                  "conv": cache["conv"][i]}, rules)
            write_state(cache["ssm"][i], st["ssm"])
            write_state(cache["conv"][i], st["conv"])
            h = h + y
        h = _norm(params["final_norm"], cfg, h)
        return _logits(params, cfg, h, rules)[:, 0], cache

    def loss(params, batch, rules=ID_RULES, remat="full"):
        """batch["tokens"] (B, S + 1).  Returns (ce, metrics)."""
        tokens = batch["tokens"]
        h = params["embed"][tokens[:, :-1]].to(DTYPES[cfg.compute_dtype])
        for lp in params["blocks"]:
            h = _maybe_remat(
                lambda h, lp=lp: _mamba_residual(lp, cfg, h, rules), remat)(h)
        h = _norm(params["final_norm"], cfg, h)
        ce, ntok = _ce_from_hidden(params, cfg, h, tokens[:, 1:], rules)
        return ce, {"ce": ce, "ntok": ntok}

    def cache_axes():
        return {"ssm": _SSM_AXES, "conv": _CONV_AXES}

    return _model(cfg, spec, prefill, decode, alloc_cache, cache_axes,
                  loss=loss)


def _mamba_residual(lp, cfg, h, rules=ID_RULES):
    """h + one Mamba2 block of the training path (no state kept)."""
    y = mamba_train(lp["mixer"], cfg, _norm(lp["ln"], cfg, h),
                    rules=rules)[0]
    return rules(h + y, ("batch", "seq_sp", None))


# ---------------------------------------------------------------------------
# hybrid (zamba2): groups of mamba blocks + one shared attention block
# ---------------------------------------------------------------------------

def hybrid_layout(cfg):
    """(n_groups, mamba blocks per group, tail): 81 layers =
    13 · (5 mamba + 1 shared attn) + 3."""
    per = cfg.hybrid_every
    n_groups = cfg.n_layers // per
    return n_groups, per - 1, cfg.n_layers - n_groups * per


def _build_hybrid_lm(cfg):
    n_groups, mamba_per, tail = hybrid_layout(cfg)
    spec = _lm_head_specs(cfg)
    spec["groups"] = [{"mamba": [_ssm_block_specs(cfg)
                                 for _ in range(mamba_per)]}
                      for _ in range(n_groups)]
    spec["shared_attn"] = _dense_block_specs(cfg)  # ONE shared block
    if tail:
        spec["tail"] = [_ssm_block_specs(cfg) for _ in range(tail)]

    def alloc_cache(B, s_max, device):
        cdt = DTYPES[cfg.compute_dtype]
        H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        W1, Ch = cfg.conv_width - 1, conv_dim(cfg)
        kv = (n_groups, B, s_max, cfg.n_kv_heads, cfg.head_dim)

        def z(*shape):
            return torch.zeros(shape, dtype=cdt, device=device)

        cache = {"g_ssm": z(n_groups, mamba_per, B, H, P, N),
                 "g_conv": z(n_groups, mamba_per, B, W1, Ch),
                 "k": z(*kv), "v": z(*kv)}
        if tail:
            cache["t_ssm"] = z(tail, B, H, P, N)
            cache["t_conv"] = z(tail, B, W1, Ch)
        return cache

    def cache_axes():
        axes = {"g_ssm": ("layers", None, "batch", "heads", None, None),
                "g_conv": ("layers", None, "batch", None, "heads"),
                "k": _KV_AXES, "v": _KV_AXES}
        if tail:
            axes.update(t_ssm=_SSM_AXES, t_conv=_CONV_AXES)
        return axes

    def mamba_prefill(lp, h, ssm_out, conv_out, rules):
        y, st = mamba_train(lp["mixer"], cfg, _norm(lp["ln"], cfg, h),
                            return_state=True, rules=rules)
        write_state(ssm_out, st["ssm"])
        write_state(conv_out, st["conv"])
        return rules(h + y, ("batch", "seq_sp", None))

    def mamba_step(lp, h, ssm, conv, rules):
        y, st = mamba_decode(lp["mixer"], cfg, _norm(lp["ln"], cfg, h),
                             {"ssm": ssm, "conv": conv}, rules)
        write_state(ssm, st["ssm"])
        write_state(conv, st["conv"])
        return h + y

    def prefill(params, batch, cache=None, rules=ID_RULES):
        """batch["tokens"]: (B, S).  Returns the last position's logits
        (B, vocab) f32 and the cache, allocated at S_max = S when none is
        given."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        if cache is None:
            cache = _new_cache(alloc_cache, cache_axes, tokens, B, S, rules)
        h = _embed(params, cfg, tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for g in range(n_groups):
            for m in range(mamba_per):
                h = mamba_prefill(params["groups"][g]["mamba"][m], h,
                                  cache["g_ssm"][g, m], cache["g_conv"][g, m],
                                  rules)
            h, (k, v), _ = _dense_block_train(params["shared_attn"], cfg, h,
                                              positions, None, None,
                                              rules=rules)
            write_prefix(cache["k"][g], k)
            write_prefix(cache["v"][g], v)
        for t in range(tail):
            h = mamba_prefill(params["tail"][t], h, cache["t_ssm"][t],
                              cache["t_conv"][t], rules)
        h = _norm(params["final_norm"], cfg, h[:, -1:])
        return _logits(params, cfg, h, rules)[:, 0], cache

    def decode(params, batch, rules=ID_RULES):
        """batch: "token" (B, 1), "pos" (B,) the cache slot to write and
        attend up to, "cache".  Returns (logits (B, vocab) f32, cache)."""
        cache, pos = batch["cache"], batch["pos"]
        h = _embed(params, cfg, batch["token"])
        for g in range(n_groups):
            for m in range(mamba_per):
                h = mamba_step(params["groups"][g]["mamba"][m], h,
                               cache["g_ssm"][g, m], cache["g_conv"][g, m],
                               rules)
            h, _ = _dense_block_decode(params["shared_attn"], cfg, h, pos,
                                       (cache["k"][g], cache["v"][g]), None,
                                       None, rules=rules)
        for t in range(tail):
            h = mamba_step(params["tail"][t], h, cache["t_ssm"][t],
                           cache["t_conv"][t], rules)
        h = _norm(params["final_norm"], cfg, h)
        return _logits(params, cfg, h, rules)[:, 0], cache

    def loss(params, batch, rules=ID_RULES, remat="full"):
        """batch["tokens"] (B, S + 1).  Each Mamba2 block under ``remat``;
        the shared attention block, applied once a group, is not (as in
        the JAX package) and gathers its gradient from every group.
        Returns (ce, metrics)."""
        tokens = batch["tokens"]
        h = params["embed"][tokens[:, :-1]].to(DTYPES[cfg.compute_dtype])
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device)[None].expand(B, S)

        def mamba(lp, h):
            return _maybe_remat(lambda h: _mamba_residual(lp, cfg, h, rules),
                                remat)(h)
        for g in range(n_groups):
            for lp in params["groups"][g]["mamba"]:
                h = mamba(lp, h)
            h = _dense_block_train(params["shared_attn"], cfg, h, positions,
                                   None, None, rules=rules)[0]
        for t in range(tail):
            h = mamba(params["tail"][t], h)
        h = _norm(params["final_norm"], cfg, h)
        ce, ntok = _ce_from_hidden(params, cfg, h, tokens[:, 1:], rules)
        return ce, {"ce": ce, "ntok": ntok}

    return _model(cfg, spec, prefill, decode, alloc_cache, cache_axes,
                  loss=loss)


# ---------------------------------------------------------------------------
# enc-dec (whisper): the conv frontend is a stub — the caller gives frame
# embeddings (B, enc_len, d); sinusoidal positions on the encoder, a
# learned position table on the decoder
# ---------------------------------------------------------------------------

def _sinusoid(S, d, device=None):
    """(S, d) f32: sin then cos of pos / 10⁴^(2i/d), computed in f64 by
    numpy as the JAX package computes it."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10_000 ** (2 * i / d))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.as_tensor(out.astype(np.float32), device=device)


def _ln(p, cfg, x):
    return layer_norm(x, p["w"], p["b"], cfg.norm_eps)


def _ln_specs(d: int) -> dict:
    return {"w": Leaf((d,), "ones", axes=(None,)),
            "b": Leaf((d,), "zeros", axes=(None,))}


def _build_encdec(cfg):
    L, d = cfg.n_layers, cfg.d_model
    cdt = DTYPES[cfg.compute_dtype]
    spec = {"embed": Leaf((cfg.vocab, d), "normal", axes=("vocab", "embed")),
            "pos_embed": Leaf((cfg.max_positions, d), "normal",
                              axes=(None, "embed")),
            "enc_final_ln": _ln_specs(d), "dec_final_ln": _ln_specs(d),
            "enc": [{"ln1": _ln_specs(d), "attn": attn_specs(cfg),
                     "ln2": _ln_specs(d),
                     "mlp": mlp_specs(d, cfg.d_ff, "gelu")}
                    for _ in range(cfg.n_enc_layers)],
            "dec": [{"ln1": _ln_specs(d), "attn": attn_specs(cfg),
                     "ln2": _ln_specs(d), "xattn": cross_attn_specs(cfg),
                     "ln3": _ln_specs(d),
                     "mlp": mlp_specs(d, cfg.d_ff, "gelu")}
                    for _ in range(L)]}

    def alloc_cache(B, s_max, device):
        """The decoder's self-attention k/v at ``s_max`` positions and the
        cross-attention's ck/cv over the encoder's ``enc_len`` frames."""
        kv = (L, B, s_max, cfg.n_kv_heads, cfg.head_dim)
        ckv = (L, B, cfg.enc_len, cfg.n_heads, cfg.head_dim)
        return {k: torch.zeros(shape, dtype=cdt, device=device)
                for k, shape in (("k", kv), ("v", kv), ("ck", ckv),
                                 ("cv", ckv))}

    def cache_axes():
        cross = ("layers", "batch", None, "heads", None)
        return {"k": _KV_AXES, "v": _KV_AXES, "ck": cross, "cv": cross}

    def encode(params, enc_embeds, remat="none", rules=ID_RULES):
        """The encoder over frame embeddings (B, Se, d): the embeddings
        plus the sinusoid, both in the compute dtype, then bidirectional
        blocks, each under ``remat``; returns the final LayerNorm's
        output."""
        h = enc_embeds.to(cdt) + _sinusoid(enc_embeds.shape[1], d,
                                           enc_embeds.device).to(cdt)

        def block(lp, h):
            h = h + attn_encode(lp["attn"], cfg, _ln(lp["ln1"], cfg, h),
                                chunk=cfg.attn_chunk, rules=rules)
            h = h + mlp_apply(lp["mlp"], _ln(lp["ln2"], cfg, h), "gelu")
            return rules(h, ("batch", "seq_sp", None))
        for lp in params["enc"]:
            h = _maybe_remat(lambda h, lp=lp: block(lp, h), remat)(h)
        return _ln(params["enc_final_ln"], cfg, h)

    def logits(params, h):
        """The tied head on the final LayerNorm of h (B, d), in f32."""
        return (_ln(params["dec_final_ln"], cfg, h) @ params["embed"].T
                ).float()

    def prefill(params, batch, cache=None, rules=ID_RULES):
        """batch: "tokens" (B, S), "enc_embeds" (B, enc_len, d).  Returns
        the last position's logits (B, vocab) f32 and the cache, allocated
        at S_max = S when none is given: each decoder layer's self k/v at
        positions [0, S) and its cross ck/cv over the encoder's output."""
        tokens, frames = batch["tokens"], batch["enc_embeds"]
        B, S = tokens.shape
        if tuple(frames.shape) != (B, cfg.enc_len, d):
            raise ValueError(f"enc_embeds {tuple(frames.shape)}: the cache "
                             f"holds ({B}, enc_len={cfg.enc_len}, {d})")
        if cache is None:
            cache = _new_cache(alloc_cache, cache_axes, tokens, B, S, rules)
        enc_out = encode(params, frames, rules=rules)
        # added in the parameter dtype, then cast: the JAX order
        h = (params["embed"][tokens] + params["pos_embed"][:S]).to(cdt)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for i, lp in enumerate(params["dec"]):
            a, (k, v) = attn_train(lp["attn"], cfg, _ln(lp["ln1"], cfg, h),
                                   positions, chunk=cfg.attn_chunk,
                                   rules=rules)
            write_prefix(cache["k"][i], k)
            write_prefix(cache["v"][i], v)
            h = h + a
            ck, cv = cross_kv(lp["xattn"], cfg, enc_out)
            write_state(cache["ck"][i], ck)
            write_state(cache["cv"][i], cv)
            h = h + cross_attn(lp["xattn"], cfg, _ln(lp["ln2"], cfg, h),
                               (ck, cv), chunk=cfg.attn_chunk, rules=rules)
            h = h + mlp_apply(lp["mlp"], _ln(lp["ln3"], cfg, h), "gelu")
            h = rules(h, ("batch", "seq_sp", None))
        return logits(params, h[:, -1]), cache

    def decode(params, batch, rules=ID_RULES):
        """batch: "token" (B, 1), "pos" (B,) the cache slot to write and
        attend up to (and the row of the position table), "cache".
        Returns (logits (B, vocab) f32, cache)."""
        cache, pos = batch["cache"], batch["pos"]
        h = (params["embed"][batch["token"]]
             + params["pos_embed"][pos][:, None, :]).to(cdt)
        for i, lp in enumerate(params["dec"]):
            a, _ = attn_decode(lp["attn"], cfg, _ln(lp["ln1"], cfg, h), pos,
                               (cache["k"][i], cache["v"][i]), rules=rules)
            h = h + a
            h = h + cross_attn(lp["xattn"], cfg, _ln(lp["ln2"], cfg, h),
                               (cache["ck"][i], cache["cv"][i]), rules=rules)
            h = h + mlp_apply(lp["mlp"], _ln(lp["ln3"], cfg, h), "gelu")
        return logits(params, h[:, 0]), cache

    def loss(params, batch, rules=ID_RULES, remat="full"):
        """batch: "tokens" (B, S + 1), "enc_embeds" (B, enc_len, d).  The
        encoder runs inside the loss; each encoder and decoder block under
        ``remat``.  Returns (ce, metrics)."""
        tokens = batch["tokens"]
        enc_out = encode(params, batch["enc_embeds"], remat, rules)
        inp = tokens[:, :-1]
        B, S = inp.shape
        h = (params["embed"][inp] + params["pos_embed"][:S]).to(cdt)
        positions = torch.arange(S, device=h.device)[None].expand(B, S)

        def block(lp, h):
            a, _ = attn_train(lp["attn"], cfg, _ln(lp["ln1"], cfg, h),
                              positions, chunk=cfg.attn_chunk, rules=rules)
            h = h + a
            h = h + cross_attn(lp["xattn"], cfg, _ln(lp["ln2"], cfg, h),
                               cross_kv(lp["xattn"], cfg, enc_out),
                               chunk=cfg.attn_chunk, rules=rules)
            h = h + mlp_apply(lp["mlp"], _ln(lp["ln3"], cfg, h), "gelu")
            return rules(h, ("batch", "seq_sp", None))
        for lp in params["dec"]:
            h = _maybe_remat(lambda h, lp=lp: block(lp, h), remat)(h)
        h = _ln(params["dec_final_ln"], cfg, h)
        ce, ntok = _ce_from_hidden(params, cfg, h, tokens[:, 1:], rules)
        return ce, {"ce": ce, "ntok": ntok}

    return _model(cfg, spec, prefill, decode, alloc_cache, cache_axes, encode,
                  loss)
