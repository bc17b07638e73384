"""Depth-affine cost extrapolation: the port of the JAX package's
``launch/cost_model.py``.

The JAX package fits cost(L) = a + b·L because XLA's ``cost_analysis``
counts a ``while`` body once, not × trip count.  A torch trace counts
every layer it runs, so the port needs the fit for another reason: a
trace on meta tensors of a full-depth 61-layer deepseek or 80-layer
qwen2-vl at train_4k still costs real host time.  ``cost_variants``
lets the dry run trace 2–4 reduced-DEPTH, full-WIDTH variants and
extrapolate to the full depth, exactly: the layers of one kind cost the
same, and the counts are integers (the solve keeps them exact).

Only depth varies.  The chunks stay as configured: a torch trace counts
every attention, SSD and cross-entropy chunk, so the JAX package's
``1/nc`` probes and its single-chunk forcing (``attn_chunk = ssm_chunk =
S``, which the SSD kernel's Q ≤ 128 would refuse) are not needed.

Family systems:
  dense/moe/vlm/ssm : vary n_layers ∈ {2, 4}        → a + b·L
  dense with a local:global pattern (gemma3): local and global layers
                      cost differently (a window's pairs)
                                                   → a + b_l·L_l + b_g·L_g
  deepseek          : vary (dense, moe) layers     → a + b_d·Ld + b_m·Lm
  whisper           : enc & dec vary jointly       → a + (b_e+b_d)·L
  zamba2 (hybrid)   : vary groups G and mamba blocks a group P, the tail
                      as configured → a + G·(c + P·m) + tail·m
"""
from __future__ import annotations

from fractions import Fraction
from typing import Callable

__all__ = ["cost_variants", "solve_costs"]


def _affine(vals, full: int, lo: int, hi: int) -> dict:
    """a + b·L through (lo, vals[0]) and (hi, vals[1]), at L = full."""
    out = {}
    for k in vals[0]:
        v0 = Fraction(vals[0][k])
        b = (Fraction(vals[1][k]) - v0) / (hi - lo)
        out[k] = v0 + b * (full - lo)
    return out


def cost_variants(cfg, seq_len: int = 0, kind: str = "train"):
    """Returns (variant_cfgs, solve_fn).  solve_fn(values: list[dict]) ->
    dict of extrapolated cost values for the FULL config; values[i] aligns
    with variant_cfgs[i] and maps key -> number.  ``seq_len`` and ``kind``
    (the JAX signature's) change no variant here: the system is in depth
    alone."""
    del seq_len, kind
    L_full = cfg.n_layers

    if cfg.family == "hybrid":
        per_full = cfg.hybrid_every
        G_full = cfg.n_layers // per_full
        P_full = per_full - 1
        tail = cfg.n_layers - G_full * per_full
        if tail >= 4:
            raise ValueError(f"a tail of {tail} mamba blocks would change "
                             "the probes' group count")
        A = cfg.replace(hybrid_every=4, n_layers=2 * 4 + tail)  # G2 P3
        B = cfg.replace(hybrid_every=4, n_layers=3 * 4 + tail)  # G3 P3
        C = cfg.replace(hybrid_every=6, n_layers=2 * 6 + tail)  # G2 P5

        def solve(vals):
            out = {}
            for k in vals[0]:
                vA, vB, vC = (Fraction(v[k]) for v in vals)
                m = (vC - vA) / 4  # ΔP = 2 in each of 2 groups
                c = (vB - vA) - 3 * m  # ΔG = 1 at P = 3
                a = vA - 2 * (c + 3 * m) - tail * m
                out[k] = a + G_full * (c + P_full * m) + tail * m
            return out

        return [A, B, C], solve

    if cfg.family == "encdec":
        if cfg.n_enc_layers != cfg.n_layers:
            raise ValueError("the joint encoder/decoder fit needs as many "
                             f"encoder layers ({cfg.n_enc_layers}) as "
                             f"decoder layers ({cfg.n_layers})")
        A = cfg.replace(n_layers=2, n_enc_layers=2)
        B = cfg.replace(n_layers=4, n_enc_layers=4)
        return [A, B], lambda vals: _affine(vals, L_full, 2, 4)

    if cfg.n_experts > 0 and cfg.moe_layer_start > 0:
        # deepseek: v = a + b_d·Ld + b_m·Lm
        Ld_full, Lm_full = cfg.moe_layer_start, cfg.n_layers - cfg.moe_layer_start
        A = cfg.replace(n_layers=3, moe_layer_start=1)  # Ld1 Lm2
        B = cfg.replace(n_layers=4, moe_layer_start=2)  # Ld2 Lm2
        C = cfg.replace(n_layers=5, moe_layer_start=1)  # Ld1 Lm4

        def solve(vals):
            out = {}
            for k in vals[0]:
                vA, vB, vC = (Fraction(v[k]) for v in vals)
                bd = vB - vA
                bm = (vC - vA) / 2
                a = vA - bd - 2 * bm
                out[k] = a + Ld_full * bd + Lm_full * bm
            return out

        return [A, B, C], solve

    if cfg.global_every > 1:
        # every global_every-th layer global: (local, global) layers
        ge = cfg.global_every
        Lg_full = L_full // ge
        Ll_full = L_full - Lg_full
        A = cfg.replace(n_layers=ge - 1)  # Ll ge-1, Lg 0
        B = cfg.replace(n_layers=ge)  # Ll ge-1, Lg 1
        C = cfg.replace(n_layers=2 * ge)  # Ll 2ge-2, Lg 2

        def solve(vals):
            out = {}
            for k in vals[0]:
                vA, vB, vC = (Fraction(v[k]) for v in vals)
                bg = vB - vA
                bl = (vC - vA - 2 * bg) / (ge - 1)
                a = vA - (ge - 1) * bl
                out[k] = a + Ll_full * bl + Lg_full * bg
            return out

        return [A, B, C], solve

    # uniform stacks (dense / moe-uniform / vlm / ssm)
    A = cfg.replace(n_layers=2)
    B = cfg.replace(n_layers=4)
    if cfg.n_experts > 0:
        A = A.replace(moe_layer_start=0)
        B = B.replace(moe_layer_start=0)
    return [A, B], lambda vals: _affine(vals, L_full, 2, 4)


def solve_costs(variant_values: list[dict], solve: Callable) -> dict:
    """The extrapolated values, never below 0: an integer where the fit
    gives one (counts), else a float."""
    out = {}
    for k, v in solve(variant_values).items():
        v = max(Fraction(v), Fraction(0))
        out[k] = int(v) if v.denominator == 1 else float(v)
    return out
