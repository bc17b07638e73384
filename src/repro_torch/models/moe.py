"""Mixture-of-Experts with grouped, gather-based, capacity-limited dispatch:
the port of the JAX package's ``models/moe.py``.

Tokens reshape to (G, T/G, d) dispatch groups.  The router's softmax (f32)
picks each token's top-k experts, renormalised; each expert then keeps, in
every group, the top-C tokens of its routing weights ("expert choice"
within the top-k mask, C from ``capacity_factor``).  Kept tokens are
gathered to (G, E, C, d), run through the swiglu experts as three batched
products, multiplied by their gate (a token an expert holds without having
chosen it has gate 0) and combined back; the shared expert sees every
token, dropped ones included.

Both top-k choices break ties toward the lower index, as
``jax.lax.top_k`` does (:func:`stable_top_k`): which token an expert drops
at capacity depends on it.  The combine adds each token's kept
contributions in ascending expert order, the order in which a sequential
scatter-add over (group, expert, slot) adds them, with no atomics, so that
two runs on the card give the same bits.  ``moe_combine`` picks a sharding
layout in the JAX package; the port always combines by gathering the
experts back to each group's rank (JAX's default "gather").
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import ID_RULES, Leaf, mlp_apply, mlp_specs
from .local import on_group_shards

__all__ = ["moe_specs", "moe_apply", "stable_top_k"]


def moe_specs(cfg) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    spec = {"router": Leaf((d, E), axes=("embed", "expert")),
            "w_gate": Leaf((E, d, f), axes=("expert", "embed", "mlp")),
            "w_up": Leaf((E, d, f), axes=("expert", "embed", "mlp")),
            "w_down": Leaf((E, f, d), axes=("expert", "mlp", "embed"))}
    if cfg.n_shared_experts > 0:
        spec["shared"] = mlp_specs(d, cfg.n_shared_experts * f, "swiglu")
    return spec


def _n_groups(T: int, want: int = 32) -> int:
    g = min(want, T)
    while T % g:
        g -= 1
    return max(g, 1)


def stable_top_k(x, k: int):
    """The ``k`` largest entries along the last axis, largest first, and
    their indices; equal values in ascending index order, as
    ``jax.lax.top_k`` orders them (``torch.topk`` leaves ties unordered)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _route(probs, k: int, C: int):
    """Per dispatch group: each token's top-k experts (renormalised
    weights, ``w_te`` (G, Tg, E) with one term an expert) and each
    expert's top-C tokens of those weights (gate, idx (G, E, C))."""
    top_w, top_i = stable_top_k(probs, k)  # (G, Tg, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    # each expert gets at most one term: the one-hot einsum's bits
    w_te = torch.zeros_like(probs).scatter_(-1, top_i, top_w)
    gate, idx = stable_top_k(w_te.transpose(1, 2), C)  # (G, E, C)
    return top_i, w_te, gate, idx


def _dispatch(xg, idx):
    """The kept tokens of each (group, expert): (G, E, C, d)."""
    G, E, C = idx.shape
    d = xg.shape[-1]
    xe = torch.gather(xg, 1, idx.reshape(G, E * C, 1).expand(G, E * C, d))
    return xe.reshape(G, E, C, d)


def _combine(ye, top_i, idx):
    """Each token's kept expert outputs summed, (G, Tg, d): its slot c in
    the lists of its k experts (-1 where the expert dropped it), read in
    ascending expert order."""
    G, E, C, d = ye.shape
    Tg, k = top_i.shape[1], top_i.shape[2]
    slot = torch.full((G, E, Tg), -1, dtype=torch.long, device=ye.device)
    slot.scatter_(-1, idx, torch.arange(C, device=ye.device).expand(G, E, C))
    experts = torch.sort(top_i, dim=-1).values  # (G, Tg, k)
    c = torch.gather(slot.transpose(1, 2), -1, experts)
    rows = (experts * C + c.clamp_min(0)).reshape(G, Tg * k, 1)
    parts = torch.gather(ye.reshape(G, E * C, d), 1, rows.expand(-1, -1, d))
    parts = torch.where((c >= 0)[..., None], parts.reshape(G, Tg, k, d), 0)
    out = torch.zeros((G, Tg, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        out = out + parts[:, :, j]
    return out


def moe_apply(p, cfg, x, rules=ID_RULES):
    """x: (B, S, d) -> (out (B, S, d), the switch aux loss, an f32
    scalar).  ``rules`` pins the JAX package's sites; on ``DTensor``s the
    routing, the dispatch gather and the combine run on each rank's
    dispatch groups (``models.local.on_group_shards``), the expert
    products on the ``DTensor``s sharded over experts."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = _n_groups(T)
    Tg = T // G
    # dispatch groups with a pure batch sharding
    x = rules(x, ("batch", None, None))
    xg = rules(x.reshape(G, Tg, d), ("moe_group", None, None))

    gte = ("moe_group", None, "expert")
    logits = rules((xg @ p["router"]).float(), gte)
    probs = rules(torch.softmax(logits, dim=-1), gte)  # (G, Tg, E)
    C = min(max(1, int(math.ceil(Tg * k / E * cfg.capacity_factor))), Tg)
    top_i, w_te, gate, idx = on_group_shards(
        lambda pr: _route(pr, k, C), xg, probs)

    # gather the kept tokens where their group lives, then shard the
    # experts: the all-to-all of the JAX package's dispatch
    xe = on_group_shards(_dispatch, xg, xg, idx)
    xe = rules(xe, ("moe_group", "expert", None, None))
    # (E, G·C, d) rows for three batched products
    xe = xe.transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(E, G, C, d).transpose(0, 1)
    ye = ye * gate[..., None].to(ye.dtype)  # dropped ⇒ gate 0
    ye = rules(ye, ("moe_group", "expert", None, None))
    # the combine gathers the experts back to each group's rank
    ye = rules(ye, ("moe_group", None, None, None))
    out = rules(on_group_shards(_combine, xg, ye, top_i, idx),
                ("moe_group", None, None))
    outf = out.reshape(T, d)

    if cfg.n_shared_experts > 0:
        outf = outf + mlp_apply(p["shared"], xg.reshape(T, d), "swiglu")

    # switch-style load-balancing aux: E · Σ_e fraction_e · router_prob_e
    frac = (w_te > 0).float().mean(dim=(0, 1))
    pmean = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * pmean)
    return outf.reshape(B, S, d), aux
