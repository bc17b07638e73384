"""Evolving statistics of ESDP (paper eqs. 7–15), in PyTorch.

Counterpart of ``repro.core.stats``.  Schedules take a float32 tensor of
1-based slot times and return float32 tensors.  The per-slot values a run
needs — ξ(t), g(t) and log(t+1) — are tabulated once per horizon by
:func:`schedule_table`, and :func:`scale_statistics` takes the slot's
values from it rather than re-evaluating the schedule.  That split is what
lets a test hand both packages the same schedule: XLA and PyTorch
evaluate float32 ``log`` one ulp apart at some t, which moves a ceiling
in Σ̂² now and then.

Integer outputs are exact int32 (see the bounds argument in the JAX
package's module): Υ̂_e = ⌈ξ v̂_e⌉ ≤ ξ and Σ̂²_e = ⌈ξ² g/(2n)⌉.

The host sizing helpers work in float64 ``math`` for the registered
schedules and in float64 PyTorch for any other δ.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..device import resolve_device

__all__ = [
    "delta_default", "delta_fast", "delta_slow",
    "g_default", "g_no_logt", "g_logt_only",
    "xi_of", "s_cap_for_horizon", "u_max_for_horizon",
    "horizon_for_s_cap", "schedule_table", "scale_statistics",
    "sigma2_bound", "DELTA_VARIANTS", "G_VARIANTS",
]

# --------------------------------------------------------------------------
# δ(t) — converge-to-zero relaxation sequence (paper eq. 11 & Fig. 7)
# --------------------------------------------------------------------------


def delta_fast(t):
    """(ln(t+1)+1)^-1 — fastest decay."""
    return 1.0 / (torch.log(t + 1.0) + 1.0)


def delta_default(t):
    """(ln(ln(t+1)+1)+1)^-1 — the paper's default."""
    return 1.0 / (torch.log(torch.log(t + 1.0) + 1.0) + 1.0)


def delta_slow(t):
    """(ln(ln(ln(t+1)+1)+1)+1)^-1 — slowest decay."""
    return 1.0 / (torch.log(torch.log(torch.log(t + 1.0) + 1.0) + 1.0) + 1.0)


DELTA_VARIANTS: dict[str, Callable] = {
    "fast": delta_fast, "default": delta_default, "slow": delta_slow,
}


def _delta_fast_host(t: float) -> float:
    return 1.0 / (math.log(t + 1.0) + 1.0)


def _delta_default_host(t: float) -> float:
    return 1.0 / (math.log(math.log(t + 1.0) + 1.0) + 1.0)


def _delta_slow_host(t: float) -> float:
    return 1.0 / (math.log(math.log(math.log(t + 1.0) + 1.0) + 1.0) + 1.0)


_DELTA_HOST: dict[Callable, Callable[[float], float]] = {
    delta_fast: _delta_fast_host,
    delta_default: _delta_default_host,
    delta_slow: _delta_slow_host,
}

# --------------------------------------------------------------------------
# g(t) — exploration scale (paper eq. 10 & Fig. 8 variants); m = ⌈α|E|⌉
# --------------------------------------------------------------------------


def g_default(t, m):
    """ln(t+1) + 4 ln(ln(t+1)+1)·m — the paper's default experimental g."""
    return torch.log(t + 1.0) + 4.0 * torch.log(torch.log(t + 1.0) + 1.0) * m


def g_no_logt(t, m):
    """4 ln(ln(t+1)+1)·m."""
    return 4.0 * torch.log(torch.log(t + 1.0) + 1.0) * m


def g_logt_only(t, m):
    """ln(t+1) — the variant the paper found 'overwhelmingly' best (Fig. 8)."""
    return torch.log(t + 1.0)


G_VARIANTS: dict[str, Callable] = {
    "default": g_default, "no_logt": g_no_logt, "logt_only": g_logt_only,
}

# --------------------------------------------------------------------------
# ξ(t), the per-horizon schedule table and scaled statistics (eqs. 13–15)
# --------------------------------------------------------------------------


def xi_of(t, m, delta_fn=delta_default):
    """ξ(t) = ⌈m / δ(t)⌉ (paper eq. 15), int32."""
    return torch.ceil(m / delta_fn(t)).to(torch.int32)


def _delta_at_host(T: int, delta_fn=delta_default) -> float:
    """δ(T) in float64: the registered schedules' ``math`` mirrors, any
    other schedule on a float64 tensor (a float32 T is exact only below
    2²⁴)."""
    host = _DELTA_HOST.get(delta_fn)
    if host is not None:
        return host(float(T))
    return float(delta_fn(torch.tensor(float(T), dtype=torch.float64)))


def _xi_at_horizon(T: int, m: int, delta_fn=delta_default) -> int:
    """ξ(T) as a host int — the max of ξ(t) over t ≤ T (δ decreasing)."""
    return int(math.ceil(m / _delta_at_host(T, delta_fn)))


def s_cap_for_horizon(T: int, m: int, delta_fn=delta_default) -> int:
    """Static bound on max_t ξ(t)·m over a horizon."""
    return _xi_at_horizon(T, m, delta_fn) * int(m)


def u_max_for_horizon(T: int, m: int, delta_fn=delta_default) -> int:
    """Static bound on max_{t,e} Υ̂_e(t) + 1 over a horizon (Υ̂ ≤ ξ(T))."""
    return _xi_at_horizon(T, m, delta_fn) + 1


def horizon_for_s_cap(
    s_cap: int, m: int, delta_fn=delta_default, t_max: int = 10 ** 12
) -> "int | None":
    """Smallest horizon T ≤ ``t_max`` whose budget axis reaches ``s_cap``
    (inverse of :func:`s_cap_for_horizon`, nondecreasing in T); ``None``
    when even ``t_max`` falls short.  Doubling then bisection."""
    if s_cap_for_horizon(1, m, delta_fn) >= s_cap:
        return 1
    lo, hi = 1, 2
    while s_cap_for_horizon(hi, m, delta_fn) < s_cap:
        if hi >= t_max:
            return None
        lo, hi = hi, min(hi * 2, t_max)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if s_cap_for_horizon(mid, m, delta_fn) < s_cap:
            lo = mid
        else:
            hi = mid
    return hi


def schedule_table(T: int, m: int, delta_fn=delta_default, g_fn=g_default, device=None):
    """Per-slot schedule of a horizon, t = 1..T.

    Returns ``(xi (T,) int32, g (T,) float32, log1p_t (T,) float32)``:
    ξ(t), g(t, m) and log(t+1), computed once on ``device`` (``None`` is
    the card, see ``resolve_device``) so that a slot reads its values by
    index and never syncs with the host.
    """
    t = torch.arange(1, T + 1, device=resolve_device(device)).to(torch.float32)
    return (xi_of(t, m, delta_fn), g_fn(t, m).to(torch.float32),
            torch.log(t + 1.0))


def scale_statistics(vhat, n, xi_t, g_t, m: int):
    """Compute (Υ̂, Σ̂², s_limit) for one slot — eqs. (13)–(15).

    ``vhat`` float32 and ``n`` int32 are (..., E); ``xi_t`` (int32) and
    ``g_t`` (float32) are the slot's entries of :func:`schedule_table`,
    0-d or broadcastable against the leading dims.  Unexplored channels
    (n = 0) get the finite dominance bonus ``(m+1)·⌈ξ²g/2⌉`` instead of
    the paper's +∞, which keeps forced exploration exact in int32.
    """
    xif = xi_t.to(torch.float32)
    upsilon = torch.ceil(xif * vhat).to(torch.int32)
    max_explored = torch.ceil(xif * xif * g_t / 2.0).to(torch.int32)
    sigma2_explored = torch.ceil(
        xif * xif * g_t / (2.0 * torch.clamp(n, min=1).to(torch.float32))
    ).to(torch.int32)
    unexp = (m + 1) * max_explored
    sigma2 = torch.where(n > 0, sigma2_explored, unexp)
    s_limit = xi_t * m
    return upsilon, sigma2, s_limit


def sigma2_bound(xi, g, m: int) -> int:
    """The largest Σ̂² :func:`scale_statistics` gives over a schedule: an
    unexplored channel's (m+1)·⌈ξ(t)²g(t)/2⌉ at its worst slot (an
    explored one's is at most ⌈ξ²g/2⌉).  ``xi``, ``g``: the (T,) columns
    of :func:`schedule_table` or a caller's own, on any device — read to
    the host once each and computed in float32, as the slot computes
    them; the product is taken in int64, so it is exact past 2³¹."""
    xif = torch.as_tensor(xi).to("cpu", torch.float32)
    gf = torch.as_tensor(g).to("cpu", torch.float32)
    if xif.numel() == 0:
        return 0
    explored = torch.ceil(xif * xif * gf / 2.0).to(torch.int64)
    return (int(m) + 1) * int(explored.max())
