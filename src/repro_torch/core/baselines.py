"""Handcrafted baseline policies from paper Sec. 4.1 (HSWF, LCF, LWTF) and
the Markovian-service-rate baselines (MSR-greedy, MSR-index).

Counterpart of ``repro.core.baselines``, batch-first.  Every baseline
ranks edges and packs greedily under A x ≤ c (skipping infeasible edges
and scanning on).  Ties go to the highest edge index, as in the JAX
package (a stable ascending sort, reversed).  Random tie-breaking uses
the slot's injected uniforms ``pol_u`` scaled by ``tiebreak``.
"""
from __future__ import annotations

import numpy as np
import torch

from .esdp import Policy, PolicyFactory
from .graph import Instance

__all__ = [
    "make_hswf_policy", "make_lcf_policy", "make_lwtf_policy", "greedy_pack",
    "make_msr_greedy_policy", "make_msr_index_policy",
    "hswf_factory", "lcf_factory", "lwtf_factory",
    "msr_greedy_factory", "msr_index_factory",
]


def greedy_pack(scores, eligible, A, c):
    """Greedily set x_e = 1 in descending score order under A x ≤ c.

    ``scores`` (B, E) float32, ``eligible`` (B, E) bool, ``A`` (K, E) and
    ``c`` (K,) int32.  Returns x (B, E) int32.  Each edge's requirement
    column and eligibility are gathered in score order once; the walk
    then carries only the residual capacity.
    """
    B, E = scores.shape
    masked = torch.where(eligible, scores, -torch.inf)
    order = torch.argsort(masked, dim=-1, stable=True).flip(-1)
    need = A.T[order]  # (B, E, K) in score order
    elig = eligible.gather(1, order)
    cap = c.expand(B, -1)
    take = []
    for j in range(E):
        ok = elig[:, j] & (cap >= need[:, j]).all(dim=-1)
        cap = cap - torch.where(ok[:, None], need[:, j], 0)
        take.append(ok)
    return torch.zeros((B, E), dtype=torch.int32,
                       device=scores.device).scatter_(
        1, order, torch.stack(take, 1).to(torch.int32))


def _on_device(**arrays):
    """Per-device copies of a policy's constant arrays, made on first use."""
    cache = {}

    def get(device):
        if device not in cache:
            cache[device] = {k: torch.as_tensor(v, device=device)
                             for k, v in arrays.items()}
        return cache[device]

    return get


def _common(instance: Instance):
    return _on_device(A=instance.A, c=instance.c, port=instance.port_of_edge,
                      cost=instance.cost,
                      server=instance.edges[:, 1].astype(np.int64))


def _tiebreak(pol_u, scale: float):
    if scale == 0.0:
        return torch.zeros_like(pol_u)
    return pol_u * scale


def make_hswf_policy(instance: Instance, tiebreak: float = 1e-4) -> Policy:
    """Highest (estimated) Social Welfare First; ``tiebreak=0`` is the
    paper-literal deterministic variant."""
    consts = _common(instance)

    def step(state, slot, eligible, arrived, vhat, n, pol_u):
        k = consts(vhat.device)
        score = vhat + _tiebreak(pol_u, tiebreak)
        return greedy_pack(score, eligible, k["A"], k["c"]), state

    return Policy(name="hswf", init=lambda batch, device: (), step=step)


def make_lcf_policy(instance: Instance, tiebreak: float = 1e-4) -> Policy:
    """Lowest Cost First (ascending supply cost Σ_k f_k(a_k^e))."""
    consts = _common(instance)

    def step(state, slot, eligible, arrived, vhat, n, pol_u):
        k = consts(vhat.device)
        score = -k["cost"] + _tiebreak(pol_u, tiebreak)
        return greedy_pack(score, eligible, k["A"], k["c"]), state

    return Policy(name="lcf", init=lambda batch, device: (), step=step)


def make_lwtf_policy(instance: Instance, tiebreak: float = 1e-4) -> Policy:
    """Longest Waiting Time First (port-level priority, value tiebreak)."""
    consts = _common(instance)
    L = instance.n_ports

    def init(batch, device):
        return torch.zeros((batch, L), dtype=torch.int32, device=device)

    def step(waiting, slot, eligible, arrived, vhat, n, pol_u):
        k = consts(vhat.device)
        port = k["port"].long()
        score = (waiting[:, port].to(torch.float32) * 1e3 + vhat
                 + _tiebreak(pol_u, tiebreak))
        x = greedy_pack(score, eligible, k["A"], k["c"])
        served = torch.zeros_like(waiting).index_add(1, port, x) > 0
        waiting = torch.where(served, 0, waiting + arrived.to(torch.int32))
        return x, waiting

    return Policy(name="lwtf", init=init, step=step)


# ---------------------------------------------------------------------------
# Markovian-service-rate baselines (arXiv:2412.08915): a per-server rate
# estimate ŝ_r tracked from the newest observations, reconstructed exactly
# as (n·v̂ − n_prev·v̂_prev) / (n − n_prev); MSR-greedy ranks edges by
# v̂·ŝ_r, MSR-index adds a UCB bonus c·√(log(t+1)/(n+1)).
# ---------------------------------------------------------------------------

def _msr_init(instance: Instance, batch: int, device):
    E, R = instance.n_edges, instance.n_servers
    return (torch.zeros((batch, E), dtype=torch.float32, device=device),
            torch.zeros((batch, E), dtype=torch.int32, device=device),
            torch.ones((batch, R), dtype=torch.float32, device=device))


def _msr_update(state, vhat, n, server, n_servers, ema, revert):
    """Fold this slot's fresh observations into the per-server rate chain."""
    prev_vhat, prev_n, shat = state
    dn = (n - prev_n).to(torch.float32)
    seen = dn > 0
    obs = torch.where(
        seen,
        (n.to(torch.float32) * vhat - prev_n.to(torch.float32) * prev_vhat)
        / torch.clamp(dn, min=1.0),
        0.0)
    base = torch.clamp(torch.where(prev_n > 0, prev_vhat, vhat), min=1e-3)
    ratio = torch.clamp(obs / base, 0.0, 2.0)
    B = vhat.shape[0]
    zeros = torch.zeros((B, n_servers), dtype=torch.float32,
                        device=vhat.device)
    cnt = zeros.index_add(1, server, seen.to(torch.float32))
    rsum = zeros.index_add(1, server, torch.where(seen, ratio, 0.0))
    robs = rsum / torch.clamp(cnt, min=1.0)
    shat = torch.where(cnt > 0, (1.0 - ema) * shat + ema * robs,
                       shat + revert * (1.0 - shat))
    return (vhat, n, shat), shat


def make_msr_greedy_policy(
    instance: Instance,
    ema: float = 0.35,
    revert: float = 0.1,
    tiebreak: float = 1e-4,
) -> Policy:
    """MSR-greedy: rank edges by v̂ · ŝ_server."""
    consts = _common(instance)
    R = instance.n_servers

    def step(state, slot, eligible, arrived, vhat, n, pol_u):
        k = consts(vhat.device)
        state, shat = _msr_update(state, vhat, n, k["server"], R, ema, revert)
        score = vhat * shat[:, k["server"]] + _tiebreak(pol_u, tiebreak)
        return greedy_pack(score, eligible, k["A"], k["c"]), state

    return Policy(name="msr_greedy",
                  init=lambda batch, device: _msr_init(instance, batch,
                                                       device),
                  step=step)


def make_msr_index_policy(
    instance: Instance,
    ema: float = 0.35,
    revert: float = 0.1,
    ucb: float = 0.15,
    tiebreak: float = 1e-4,
) -> Policy:
    """MSR-index: v̂ · ŝ_server plus a UCB bonus c·√(log(t+1)/(n+1))."""
    consts = _common(instance)
    R = instance.n_servers

    def step(state, slot, eligible, arrived, vhat, n, pol_u):
        k = consts(vhat.device)
        state, shat = _msr_update(state, vhat, n, k["server"], R, ema, revert)
        bonus = ucb * torch.sqrt(slot.log1p_t
                                 / (n.to(torch.float32) + 1.0))
        score = (vhat * shat[:, k["server"]] + bonus
                 + _tiebreak(pol_u, tiebreak))
        return greedy_pack(score, eligible, k["A"], k["c"]), state

    return Policy(name="msr_index",
                  init=lambda batch, device: _msr_init(instance, batch,
                                                       device),
                  step=step)


def _factory(make, name: str, tiebreak: float, **kw) -> PolicyFactory:
    def factory(instance: Instance, T: int, tables=None) -> Policy:
        del T, tables  # greedy baselines are horizon-free and DP-free
        return make(instance, tiebreak=tiebreak, **kw)

    factory.policy_name = name
    return factory


def hswf_factory(tiebreak: float = 1e-4) -> PolicyFactory:
    return _factory(make_hswf_policy, "hswf", tiebreak)


def lcf_factory(tiebreak: float = 1e-4) -> PolicyFactory:
    return _factory(make_lcf_policy, "lcf", tiebreak)


def lwtf_factory(tiebreak: float = 1e-4) -> PolicyFactory:
    return _factory(make_lwtf_policy, "lwtf", tiebreak)


def msr_greedy_factory(tiebreak: float = 1e-4, **kw) -> PolicyFactory:
    return _factory(make_msr_greedy_policy, "msr_greedy", tiebreak, **kw)


def msr_index_factory(tiebreak: float = 1e-4, **kw) -> PolicyFactory:
    return _factory(make_msr_index_policy, "msr_index", tiebreak, **kw)
