"""Grouped-query attention (GQA/MQA/MHA, optional bias, sliding window,
M-RoPE), whisper's bidirectional encoder attention and cross-attention,
and DeepSeek-V3's multi-head latent attention (MLA): the port of the JAX
package's ``models/attention.py`` for the serving path.

Full-sequence attention goes through ``chunked_attention``: on the card
the CUDA kernel of ``kernels/flash_attention`` (K6's counterpart), on the
CPU its plain version, the online-softmax scan over KV chunks.  MLA's
prefill expands the compressed keys and values to every head and runs
there too (q/k nope + rope wide, v ``v_head_dim`` wide), and so does
cross-attention, in prefill and in decode alike (Sq queries against the
encoder's Se keys, no mask).

The functions take the JAX package's sharding hook ``rules(x, axes)``
(the identity by default; see ``runtime.sharding.Rules``) at its sites:
q, k, v and the context in ``attn_train`` and ``mla_train``, the written
caches in ``attn_decode`` and ``mla_decode``.  The port also pins q, k and
v in ``attn_encode`` and ``cross_attn``, where the JAX package lets GSPMD
choose: on ``DTensor`` operands the kernel runs on each rank's shards
(``models.local.attention_on_shards``), which takes them sharded over
batch and heads only.  A decode over ``DTensor`` caches, which the
``decode`` and ``long`` presets shard over their sequence, writes and
attends on each rank's slice (``models.local``).

Caches, per layer, written in place by decode:
  GQA   : k/v (B, S_max, KV, hd).
  MLA   : compressed c_kv (B, S_max, kv_lora) + k_rope (B, S_max, rope_hd);
          decode runs in the absorbed form, in the compressed space, and
          never expands the cache to the heads.
  cross : ck/cv (B, Se, H, hd), the encoder's keys and values, written
          once by prefill (``cross_kv``) and only read by decode.
"""
from __future__ import annotations

import math

import torch

from ..dtensor import is_dtensor
from ..kernels.flash_attention import flash_attention_op
from .layers import ID_RULES, Leaf, apply_rope, rms_norm
from .local import (attention_on_shards, decode_attention_on_shards,
                    gqa_decode, mla_decode_on_shards, mla_decode_softmax,
                    split_heads, write_rows)

__all__ = ["chunked_attention", "attn_specs", "attn_train", "attn_decode",
           "attn_encode", "cross_attn_specs", "cross_kv", "cross_attn",
           "mla_specs", "mla_train", "mla_decode"]


def chunked_attention(
    q, k, v, *, scale: float, causal: bool = True, window=None, chunk: int = 1024
):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, vh) with
    H = KH·g.  ``window`` None or ≤ 0 means no sliding window.  Returns
    (B, Sq, H, vh) in q's dtype; f32 softmax state regardless of input
    dtype.  ``DTensor`` operands run on each rank's shards."""
    kw = dict(scale=scale, causal=causal, window=window, chunk=chunk)
    if is_dtensor(q):
        return attention_on_shards(flash_attention_op, q, k, v, **kw)
    return flash_attention_op(q, k, v, **kw)


def attn_specs(cfg) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {"wq": Leaf((d, H * hd), axes=("embed", "heads")),
            "wk": Leaf((d, KV * hd), axes=("embed", "heads")),
            "wv": Leaf((d, KV * hd), axes=("embed", "heads")),
            "wo": Leaf((H * hd, d), axes=("heads", "embed"))}
    if cfg.qkv_bias:
        spec.update(bq=Leaf((H * hd,), "zeros", axes=("heads",)),
                    bk=Leaf((KV * hd,), "zeros", axes=("heads",)),
                    bv=Leaf((KV * hd,), "zeros", axes=("heads",)))
    return spec


def _qkv(p, cfg, x):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_heads(q, H, hd), split_heads(k, KV, hd),
            split_heads(v, KV, hd))


def _pin_qkv(rules, q, k, v, kv_axis="kv_heads"):
    return (rules(q, ("batch", "seq", "heads", None)),
            rules(k, ("batch", "seq", kv_axis, None)),
            rules(v, ("batch", "seq", kv_axis, None)))


def attn_train(
    p, cfg, x, positions, *, window=None, theta=None, chunk: int = 1024, rules=ID_RULES
):
    """Full-sequence attention (training and prefill). Returns (out, (k,
    v)) with k after RoPE."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    theta = cfg.rope_theta if theta is None else theta
    q, k, v = _qkv(p, cfg, x)
    if cfg.use_rope:
        q = apply_rope(q, positions, theta, cfg.mrope_sections)
        k = apply_rope(k, positions, theta, cfg.mrope_sections)
    q, k, v = _pin_qkv(rules, q, k, v)
    ctx = chunked_attention(q, k, v, scale=1.0 / math.sqrt(hd), causal=True,
                            window=window, chunk=chunk)
    ctx = rules(ctx.reshape(B, S, H * hd), ("batch", "seq", "heads"))
    return ctx @ p["wo"], (k, v)


def attn_encode(p, cfg, x, chunk: int = 1024, rules=ID_RULES):
    """whisper's encoder self-attention: bidirectional, no RoPE, nothing
    cached (``transformer.py:731-737`` of the JAX package)."""
    B, S, _ = x.shape
    q, k, v = _pin_qkv(rules, *_qkv(p, cfg, x))
    ctx = chunked_attention(q, k, v, scale=1.0 / math.sqrt(cfg.head_dim),
                            causal=False, chunk=chunk)
    return ctx.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]


def attn_decode(
    p,
    cfg,
    x,
    pos,
    kv_cache,
    *,
    window=None,
    theta=None,
    rope_positions=None,
    rules=ID_RULES,
):
    """One-token decode. x: (B, 1, d); pos: (B,) absolute positions (cache
    write index + mask); ``rope_positions`` overrides the rotary stream
    (M-RoPE decode passes (3, B, 1)); kv_cache: (k, v) each (B, S_max, KV,
    hd), written in place and pinned by ``rules`` (``attention.py:168-171``
    of the JAX package).  ``DTensor`` caches, sharded over their sequence
    too, run on each rank's shards (``models.local``)."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    theta = cfg.rope_theta if theta is None else theta
    k_cache, v_cache = kv_cache

    q, k_new, v_new = _qkv(p, cfg, x)
    pos_b = pos[:, None] if rope_positions is None else rope_positions
    if cfg.use_rope:
        q = apply_rope(q, pos_b, theta, cfg.mrope_sections)
        k_new = apply_rope(k_new, pos_b, theta, cfg.mrope_sections)
    axes = ("batch", "cache_seq", "kv_heads", None)
    k_cache = rules(write_rows(k_cache, k_new, pos), axes)
    v_cache = rules(write_rows(v_cache, v_new, pos), axes)

    if is_dtensor(k_cache):
        ctx = decode_attention_on_shards(q, k_cache, v_cache, pos,
                                         window=window)
    else:
        ctx = gqa_decode(q, k_cache, v_cache, pos, window=window)
    out = ctx.reshape(B, 1, H * hd).to(x.dtype) @ p["wo"]
    return out, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_specs(cfg) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": Leaf((d, H * hd), axes=("embed", "heads")),
            "wk": Leaf((d, H * hd), axes=("embed", "heads")),
            "wv": Leaf((d, H * hd), axes=("embed", "heads")),
            "wo": Leaf((H * hd, d), axes=("heads", "embed"))}


def cross_kv(p, cfg, enc_out):
    """The encoder output's keys and values, each (B, Se, H, hd)."""
    H, hd = cfg.n_heads, cfg.head_dim
    return (split_heads(enc_out @ p["wk"], H, hd),
            split_heads(enc_out @ p["wv"], H, hd))


def cross_attn(p, cfg, x, enc_kv, chunk: int = 1024, rules=ID_RULES):
    """x: (B, Sq, d); enc_kv: (k, v) each (B, Se, H, hd), precomputed.
    Every query sees every encoder key (no mask), on K6 in prefill and in
    decode (Sq = 1)."""
    B, Sq, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _pin_qkv(rules, split_heads(x @ p["wq"], H, hd), *enc_kv,
                       kv_axis="heads")
    ctx = chunked_attention(q, k, v, scale=1.0 / math.sqrt(hd),
                            causal=False, chunk=chunk)
    return ctx.reshape(B, Sq, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def mla_specs(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    nh, rh, vh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    R = cfg.kv_lora_rank
    return {"wq_a": Leaf((d, cfg.q_lora_rank), axes=("embed", None)),
            "q_norm": Leaf((cfg.q_lora_rank,), "ones", axes=(None,)),
            "wq_b": Leaf((cfg.q_lora_rank, H * (nh + rh)),
                         axes=(None, "heads")),
            "wkv_a": Leaf((d, R + rh), axes=("embed", None)),
            "kv_norm": Leaf((R,), "ones", axes=(None,)),
            "wk_b": Leaf((R, H * nh), axes=(None, "heads")),
            "wv_b": Leaf((R, H * vh), axes=(None, "heads")),
            "wo": Leaf((H * vh, d), axes=("heads", "embed"))}


def _mla_q(p, cfg, x, positions):
    H, nh, rh = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    ql = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps, False)
    q = split_heads(ql @ p["wq_b"], H, nh + rh)
    return q[..., :nh], apply_rope(q[..., nh:], positions, cfg.rope_theta)


def _mla_ckv(p, cfg, x, positions):
    kv = x @ p["wkv_a"]
    R = cfg.kv_lora_rank
    c_kv = rms_norm(kv[..., :R], p["kv_norm"], cfg.norm_eps, False)
    k_rope = apply_rope(kv[:, :, None, R:], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_train(p, cfg, x, positions, chunk: int = 1024, rules=ID_RULES):
    """Naive-expansion MLA (prefill).  Returns (out, (c_kv, k_rope))."""
    B, S, _ = x.shape
    H, nh, rh, vh = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions)
    k_nope = split_heads(c_kv @ p["wk_b"], H, nh)
    v = split_heads(c_kv @ p["wv_b"], H, vh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rh)],
                  dim=-1)
    q, k, v = _pin_qkv(rules, q, k, v, kv_axis="heads")
    ctx = chunked_attention(q, k, v, scale=1.0 / math.sqrt(nh + rh),
                            causal=True, chunk=chunk)
    ctx = rules(ctx.reshape(B, S, H * vh), ("batch", "seq", "heads"))
    return ctx @ p["wo"], (c_kv, k_rope)


def mla_decode(p, cfg, x, pos, cache, rules=ID_RULES):
    """Absorbed-form decode: attention entirely in the compressed
    (kv_lora) space.  x: (B, 1, d); pos: (B,); cache: (c_kv (B, S_max,
    kv_lora), k_rope (B, S_max, rh)), written in place, c_kv pinned by
    ``rules`` (``attention.py:294`` of the JAX package).  ``DTensor``
    caches run on each rank's shards."""
    B = x.shape[0]
    H, nh, rh, vh = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    R = cfg.kv_lora_rank
    c_cache, r_cache = cache

    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None])
    c_new, r_new = _mla_ckv(p, cfg, x, pos[:, None])
    c_cache = rules(write_rows(c_cache, c_new, pos),
                    ("batch", "cache_seq", None))
    r_cache = write_rows(r_cache, r_new, pos)

    # absorb W_k^b into q:  q_eff[h] = q_nope[h] @ W_k^b[h]^T  ∈ R^R
    q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope,
                         p["wk_b"].reshape(R, H, nh))
    scale = 1.0 / math.sqrt(nh + rh)
    if is_dtensor(c_cache):
        ctx = mla_decode_on_shards(q_eff, q_rope, c_cache, r_cache, pos,
                                   scale)
    else:
        ctx = mla_decode_softmax(q_eff, q_rope, c_cache, r_cache, pos, scale)
    o = torch.einsum("bqhr,rhv->bqhv", ctx.to(x.dtype),
                     p["wv_b"].reshape(R, H, vh))
    return o.reshape(B, 1, H * vh) @ p["wo"], (c_cache, r_cache)
