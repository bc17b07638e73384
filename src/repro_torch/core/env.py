"""Simulation environment for the EASW maximization problem (paper Sec. 2).

Counterpart of ``repro.core.env``: a slot loop over the horizon that draws
arrivals ~ Bernoulli(ρ_l) and net valuations z̃_e(t) = clip(N(μ_e·speed_r(t)
− cost_e, σ_e), 0, 1), asks the policy for x(t), enforces constraint (2),
realizes SW(x(t)) = Σ_e x_e·z̃_e (eq. 4), updates the shared observation
statistics and accounts the per-slot regret against the omniscient oracle.

Batch-first: every tensor carries a leading run dimension B.
``simulate`` is one run (B = 1), ``simulate_batch`` a seed fleet; ESDP
solves the B runs of a slot together, in one forward launch per slot (or
per chunk of edges on a tiled plane).  A slot enqueues device work
only; the traces come back to the host once, at the end.

Random draws are made in bulk before the loop (:func:`make_draws`, one
``torch.Generator`` per seed) and can be injected instead (``draws=``),
as can the per-slot schedule (``schedule=``); that is how the tests hand
this package and the JAX package the same inputs.  The valuation noise is
added with one fused multiply-add (``addcmul``), the rounding XLA uses
for the same expression.

Only the paper's iid regime is ported; the fluctuation regimes come with
the scenario slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import stats as stats_mod
from .dp import DPTables, build_tables, oracle_value
from .esdp import Policy, Slot
from .graph import Instance

__all__ = [
    "Scenario", "default_scenario", "SimResult", "Draws", "make_draws",
    "simulate", "simulate_batch", "crash_events",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """A generative regime for arrivals, processing speeds and aliveness.

    ``init(params, batch, n_servers, device) -> state``;
    ``step(params, state, t, n_servers) -> (state, arr_scale, speed,
    alive)`` advances one slot: ``arr_scale`` scalar or (B, L) multiplies
    ρ, ``speed`` (R,) or (B, R) float32 multiplies μ per server, ``alive``
    (R,) or (B, R) bool masks dead servers' channels.  ``fluctuates``
    must be True iff speed can differ from 1: the oracle then uses
    per-slot clipped means.
    """

    name: str
    init: Callable[..., Any]
    step: Callable[..., tuple]
    params: dict = dataclasses.field(default_factory=dict)
    fluctuates: bool = False
    description: str = ""


def _default_init(params, batch, n_servers, device):
    return (torch.ones(n_servers, dtype=torch.float32, device=device),
            torch.ones(n_servers, dtype=torch.bool, device=device))


def _default_step(params, state, t, n_servers):
    speed, alive = state
    return state, 1.0, speed, alive


def default_scenario() -> Scenario:
    """The paper's baseline regime: iid clipped-Gaussian valuations,
    constant ρ, unit speeds, every server alive."""
    return Scenario(
        name="iid",
        init=_default_init,
        step=_default_step,
        fluctuates=False,
        description="iid clipped-Gaussian valuations at constant unit speed "
                    "(paper Sec. 5 baseline setting)",
    )


def crash_events(alive):
    """(T, R) bool: server r crashed during slot t (an up→down transition
    between slots t and t+1; the last slot reports none).  Host numpy."""
    alive = np.asarray(alive, dtype=bool)
    out = np.zeros_like(alive)
    out[:-1] = alive[:-1] & ~alive[1:]
    return out


_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _clipped_normal_mean(m, s, lo=0.0, hi=1.0):
    """E[clip(N(m, s), lo, hi)] on tensors (float32 ``erf``) — the
    per-slot oracle mean of a fluctuating regime."""
    s = torch.clamp(s, min=1e-6)
    a = (lo - m) / s
    b = (hi - m) / s
    phi_a = _INV_SQRT_2PI * torch.exp(-0.5 * a * a)
    phi_b = _INV_SQRT_2PI * torch.exp(-0.5 * b * b)
    Phi_a = 0.5 * (1.0 + torch.erf(a / _SQRT2))
    Phi_b = 0.5 * (1.0 + torch.erf(b / _SQRT2))
    inner = m * (Phi_b - Phi_a) - s * (phi_b - phi_a)
    return lo * Phi_a + hi * (1.0 - Phi_b) + inner


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Per-slot traces as numpy: (T,) for ``simulate``, (B, T) for
    ``simulate_batch``; ``x`` adds a trailing edge axis."""

    sw: np.ndarray  # realized social welfare per slot
    sw_oracle: np.ndarray  # oracle expected welfare ṽᵀx*(t)
    regret: np.ndarray  # ṽᵀx*(t) − ṽᵀx(t)
    n_dispatched: np.ndarray  # ‖x(t)‖₁
    x: np.ndarray  # int32 dispatch vectors
    policy_final: Any = None  # final policy state, as numpy

    @property
    def asw(self) -> np.ndarray:
        return np.cumsum(self.sw, axis=-1)

    @property
    def cum_regret(self) -> np.ndarray:
        return np.cumsum(self.regret, axis=-1)


@dataclasses.dataclass(frozen=True)
class Draws:
    """The random inputs of B runs over T slots, float32 on one device:
    ``arr_u`` (B, T, L) uniforms (port l arrives iff u < ρ_l),
    ``val_n`` (B, T, E) standard normals (valuation noise) and ``pol_u``
    (B, T, E) uniforms (policy tie-breaking)."""

    arr_u: torch.Tensor
    val_n: torch.Tensor
    pol_u: torch.Tensor


def make_draws(instance: Instance, T: int, seed: int, device=None) -> Draws:
    """One run's draws from ``torch.Generator(device).manual_seed(seed)``:
    arrival uniforms, then valuation normals, then policy uniforms, each
    made in bulk on ``device``.  Returns a batch of one."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, E = instance.n_ports, instance.n_edges
    kw = dict(generator=gen, device=dev, dtype=torch.float32)
    return Draws(arr_u=torch.rand((1, T, L), **kw),
                 val_n=torch.randn((1, T, E), **kw),
                 pol_u=torch.rand((1, T, E), **kw))


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _run(instance, policy, T, tables, scenario, draws, schedule, dev):
    if tables is None:
        tables = build_tables(instance.A, instance.c)
    if scenario is None:
        scenario = default_scenario()
    if schedule is None:
        schedule = stats_mod.schedule_table(T, instance.m, policy.delta_fn,
                                            policy.g_fn, dev)
    xi_tab, g_tab, log_tab = (torch.as_tensor(a, device=dev)
                              for a in schedule)
    B = draws.arr_u.shape[0]
    E, R = instance.n_edges, instance.n_servers
    for name, shape in (("arr_u", (B, T, instance.n_ports)),
                        ("val_n", (B, T, E)), ("pol_u", (B, T, E))):
        got = tuple(getattr(draws, name).shape)
        if got != shape:
            raise ValueError(f"draws.{name} has shape {got}, expected {shape}")

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    v_true = on(instance.v, torch.float32)
    mu, sigma = on(instance.mu, torch.float32), on(instance.sigma,
                                                   torch.float32)
    cost, rho = on(instance.cost, torch.float32), on(instance.rho,
                                                     torch.float32)
    port = on(instance.port_of_edge, torch.long)
    server = on(instance.edges[:, 1], torch.long)
    arr_u, val_n, pol_u = (getattr(draws, k).to(dev)
                           for k in ("arr_u", "val_n", "pol_u"))

    n = torch.zeros((B, E), dtype=torch.int32, device=dev)
    sumz = torch.zeros((B, E), dtype=torch.float32, device=dev)
    pstate = policy.init(B, dev)
    sstate = scenario.init(scenario.params, B, R, dev)
    traces = torch.zeros((3, B, T), dtype=torch.float32, device=dev)
    nd = torch.zeros((B, T), dtype=torch.int32, device=dev)
    xs = torch.zeros((B, T, E), dtype=torch.int32, device=dev)

    for i in range(T):
        t = i + 1
        sstate, arr_scale, speed, alive = scenario.step(
            scenario.params, sstate, t, R)
        rho_t = torch.clamp(rho * arr_scale, 0.0, 1.0)
        arrived = arr_u[:, i] < rho_t
        mean_e = mu * speed[..., server] - cost
        z = torch.clamp(torch.addcmul(mean_e, sigma, val_n[:, i]), 0.0, 1.0)
        eligible = arrived[:, port] & alive[..., server]

        vhat = torch.where(n > 0, sumz / torch.clamp(n, min=1).to(
            torch.float32), 0.0)
        slot = Slot(xi_tab[i], g_tab[i], log_tab[i])
        x, pstate = policy.step(pstate, slot, eligible, arrived, vhat, n,
                                pol_u[:, i])
        x = x * eligible.to(torch.int32)  # constraint (2)

        xf = x.to(torch.float32)
        v_t = (_clipped_normal_mean(mean_e, sigma) if scenario.fluctuates
               else v_true)
        sw_star = oracle_value(v_t, tables, eligible)
        traces[0, :, i] = (xf * z).sum(dim=-1)  # realized SW (eq. 4)
        traces[1, :, i] = sw_star
        traces[2, :, i] = sw_star - (xf * v_t).sum(dim=-1)  # eq. 5
        nd[:, i] = x.sum(dim=-1)
        xs[:, i] = x
        n = n + x
        sumz = sumz + xf * z

    sw, sw_star, regret = traces.cpu().numpy()
    return SimResult(sw=sw, sw_oracle=sw_star, regret=regret,
                     n_dispatched=nd.cpu().numpy(), x=xs.cpu().numpy(),
                     policy_final=_to_numpy(pstate))


def simulate(
    instance: Instance,
    policy: Policy,
    T: int,
    seed: int = 0,
    tables: DPTables | None = None,
    scenario: Scenario | None = None,
    device=None,
    draws: Draws | None = None,
    schedule=None,
) -> SimResult:
    """Run one policy for T slots; returns (T,) traces and (T, E) ``x``.

    ``device=None`` is the card (``RuntimeError`` without one).  ``draws``
    (a batch of one) replaces :func:`make_draws`; ``schedule`` — ``(xi,
    g, log1p_t)`` of shape (T,) — replaces the policy's own
    ``stats.schedule_table``."""
    dev = resolve_device(device)
    if draws is None:
        draws = make_draws(instance, T, seed, dev)
    r = _run(instance, policy, T, tables, scenario, draws, schedule, dev)
    return SimResult(sw=r.sw[0], sw_oracle=r.sw_oracle[0],
                     regret=r.regret[0], n_dispatched=r.n_dispatched[0],
                     x=r.x[0], policy_final=r.policy_final)


def simulate_batch(
    instance: Instance,
    policy: Policy,
    T: int,
    seeds: Sequence[int],
    tables: DPTables | None = None,
    scenario: Scenario | None = None,
    device=None,
    draws: Draws | None = None,
    schedule=None,
) -> SimResult:
    """``simulate`` over a seed fleet in one slot loop: (B, T) traces.

    Row i makes the same decisions as ``simulate(..., seed=seeds[i])``;
    with ESDP every slot solves the whole fleet in one kernel launch."""
    dev = resolve_device(device)
    if draws is None:
        per_seed = [make_draws(instance, T, s, dev) for s in seeds]
        draws = Draws(*(torch.cat([getattr(d, k) for d in per_seed])
                        for k in ("arr_u", "val_n", "pol_u")))
    return _run(instance, policy, T, tables, scenario, draws, schedule, dev)
