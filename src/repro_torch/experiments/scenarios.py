"""Scenario registry: named generative regimes for fluctuated speeds and
arrivals (counterpart of ``repro.experiments.scenarios``).

The paper's motivation (Sec. 1) is that the actual service rate a
multi-server job sees fluctuates — DVFS, power oversubscription,
multi-tenant co-location — and ESDP must learn under that fluctuation.
This module names a family of regimes behind the
:class:`repro_torch.core.env.Scenario` protocol, so "does ESDP still win
under regime X?" is a registry lookup.

Every regime is batch-first over the runs of a fleet or a grid: its
parameters arrive as (B, 1) tensors and its state and outputs are (B, R)
(or broadcast to it), with shapes that never depend on parameter values.
A stochastic regime declares its random inputs (``Scenario.draws``) —
uniforms per slot, a server permutation per run — which the simulator
draws in bulk from each run's scenario generator (seeded from the seed
and a salt, so turning a regime on never perturbs the arrival and
valuation draws) or takes injected; ``step`` is a pure transition on
them.  The tests inject the uniforms and permutations the JAX package's
key chain gives and hold every transition to the JAX regime's.

:func:`unroll_scenario` materializes one run of a regime into host
(arr_scale, speed, alive) arrays, which ``sched.dispatcher.ClusterSim``
consumes.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.env import (Scenario, ScenarioDraws, _row_params,
                        _scenario_inputs, default_scenario)
from ..device import resolve_device

__all__ = [
    "SCENARIOS", "register_scenario", "get_scenario", "scenario_names",
    "unroll_scenario", "power_allocation",
]

# name -> make(**params) -> Scenario
SCENARIOS: dict[str, Callable[..., Scenario]] = {}


def register_scenario(name: str):
    """Decorator: register ``make(**params) -> Scenario`` under ``name``."""
    def deco(make: Callable[..., Scenario]):
        SCENARIOS[name] = make
        make.scenario_name = name
        return make
    return deco


def get_scenario(name: str, **overrides) -> Scenario:
    """Build a registered scenario, overriding its default parameters.

    Raises ``ValueError`` (listing the registered names) on an unknown
    name — the one validation boundary every consumer (``SweepSpec``,
    ``ClusterSim``) goes through.
    """
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; registered scenarios: "
            f"{', '.join(sorted(SCENARIOS))}")
    return SCENARIOS[name](**overrides)


def scenario_names() -> tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


def _ones(batch, n_servers, device):
    """(unit speeds, every server alive), (B, R), made once per run."""
    return (torch.ones((batch, n_servers), dtype=torch.float32,
                       device=device),
            torch.ones((batch, n_servers), dtype=torch.bool, device=device))


def _subset(perm, frac, n_servers):
    """(B, R) bool: the ⌈frac·R⌉ servers whose permutation index falls
    below the count — a mask, so its shape is the same for every frac."""
    return perm < torch.ceil(frac * n_servers).to(torch.int32)


# ---------------------------------------------------------------------------
# iid — the paper's baseline setting
# ---------------------------------------------------------------------------

@register_scenario("iid")
def iid() -> Scenario:
    """iid clipped-Gaussian valuations, constant ρ, unit speeds (paper Sec. 5)."""
    return default_scenario()


# ---------------------------------------------------------------------------
# markov_dvfs — per-server two-state Markov-modulated speeds
# ---------------------------------------------------------------------------

def _dvfs_init(params, perms, n_servers, batch, device):
    # every server starts fast
    return (torch.zeros((batch, n_servers), dtype=torch.int32, device=device),
            _ones(batch, n_servers, device)[1])


def _dvfs_step(params, state, t, n_servers, u):
    regime, alive = state
    u = u["u"]
    go_slow = (regime == 0) & (u < params["p_slow"])
    go_fast = (regime == 1) & (u < params["p_fast"])
    regime = torch.where(go_slow, 1, torch.where(go_fast, 0, regime))
    speed = torch.where(regime == 1, params["slow_speed"], 1.0)
    return (regime, alive), 1.0, speed, alive


@register_scenario("markov_dvfs")
def markov_dvfs(
    slow_speed: float = 0.5, p_slow: float = 0.05, p_fast: float = 0.25
) -> Scenario:
    """DVFS / co-location throttling: each server's speed follows an
    independent two-state Markov chain {fast=1, slow=slow_speed}."""
    return Scenario(
        name="markov_dvfs",
        init=_dvfs_init,
        step=_dvfs_step,
        params={"slow_speed": slow_speed, "p_slow": p_slow, "p_fast": p_fast},
        fluctuates=True,
        description="per-server two-state Markov speed modulation (DVFS)",
        speed_bounds=(slow_speed, 1.0),
        draws=(("u", "slot", None),),
    )


# ---------------------------------------------------------------------------
# mmpp_arrivals — bursty arrivals via a global on/off Markov modulation
# ---------------------------------------------------------------------------

def _mmpp_init(params, perms, n_servers, batch, device):
    phase = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    return (phase,) + _ones(batch, n_servers, device)  # 0 quiet, 1 burst


def _mmpp_step(params, state, t, n_servers, u):
    phase, speed, alive = state
    u = u["u"]  # (B, 1): one draw a run
    to_burst = (phase == 0) & (u < params["p_burst"])
    to_quiet = (phase == 1) & (u < params["p_quiet"])
    phase = torch.where(to_burst, 1, torch.where(to_quiet, 0, phase))
    scale = torch.where(phase == 1, params["burst_scale"],
                        params["quiet_scale"])
    return (phase, speed, alive), scale, speed, alive


@register_scenario("mmpp_arrivals")
def mmpp_arrivals(
    quiet_scale: float = 0.4,
    burst_scale: float = 1.2,
    p_burst: float = 0.05,
    p_quiet: float = 0.1,
) -> Scenario:
    """Bursty traffic: a cluster-wide two-phase Markov-modulated Bernoulli
    process scales every port's arrival probability (MMPP discretization)."""
    return Scenario(
        name="mmpp_arrivals",
        init=_mmpp_init,
        step=_mmpp_step,
        params={"quiet_scale": quiet_scale, "burst_scale": burst_scale,
                "p_burst": p_burst, "p_quiet": p_quiet},
        fluctuates=False,  # speeds stay 1 ⇒ true means unchanged
        description="global on/off Markov modulation of arrival intensity",
        draws=(("u", "slot", 1),),
    )


# ---------------------------------------------------------------------------
# chronic_straggler — a random subset of servers is persistently degraded
# ---------------------------------------------------------------------------

def _straggler_init(params, perms, n_servers, batch, device):
    slow = _subset(perms["perm"], params["frac"], n_servers)
    speed = torch.where(slow, params["straggler_speed"], 1.0)
    return speed, _ones(batch, n_servers, device)[1]


def _constant_step(params, state, t, n_servers, u):
    speed, alive = state
    return state, 1.0, speed, alive


@register_scenario("chronic_straggler")
def chronic_straggler(frac: float = 0.25, straggler_speed: float = 0.35) -> Scenario:
    """Chronic stragglers: a seed-dependent ⌈frac·R⌉-subset of servers runs
    at straggler_speed for the whole horizon (bad hosts / slow pods)."""
    return Scenario(
        name="chronic_straggler",
        init=_straggler_init,
        step=_constant_step,
        params={"frac": frac, "straggler_speed": straggler_speed},
        fluctuates=True,
        description="a persistent random subset of servers is degraded",
        speed_bounds=(straggler_speed, 1.0),
        draws=(("perm", "perm", None),),
    )


# ---------------------------------------------------------------------------
# transient_brownout — deterministic cluster-wide speed dip in a window
# ---------------------------------------------------------------------------

def _brownout_init(params, perms, n_servers, batch, device):
    return _ones(batch, n_servers, device)[1]


def _brownout_step(params, alive, t, n_servers, u):
    tf = float(t)
    in_window = (tf >= params["t_start"]) & (tf < params["t_end"])
    speed = torch.where(in_window, params["brownout_speed"], 1.0)
    return alive, 1.0, speed.expand(-1, n_servers), alive


@register_scenario("transient_brownout")
def transient_brownout(
    t_start: float = 300.0, t_end: float = 600.0, brownout_speed: float = 0.5
) -> Scenario:
    """Power-oversubscription brownout: every server is throttled to
    brownout_speed during [t_start, t_end) and recovers afterwards."""
    return Scenario(
        name="transient_brownout",
        init=_brownout_init,
        step=_brownout_step,
        params={"t_start": t_start, "t_end": t_end,
                "brownout_speed": brownout_speed},
        fluctuates=True,
        description="cluster-wide speed dip in a fixed time window",
        speed_bounds=(brownout_speed, 1.0),
    )


# ---------------------------------------------------------------------------
# elastic_outage — servers die and rejoin (aliveness, not speed)
# ---------------------------------------------------------------------------

def _outage_init(params, perms, n_servers, batch, device):
    dead = _subset(perms["perm"], params["frac"], n_servers)
    return dead, _ones(batch, n_servers, device)[0]


def _outage_step(params, state, t, n_servers, u):
    dead, speed = state
    tf = float(t)
    in_window = (tf >= params["t_down"]) & (tf < params["t_up"])
    return state, 1.0, speed, ~(dead & in_window)


@register_scenario("elastic_outage")
def elastic_outage(
    frac: float = 0.25, t_down: float = 200.0, t_up: float = 400.0
) -> Scenario:
    """Elastic scale-down/up: a seed-dependent ⌈frac·R⌉-subset of servers is
    dead during [t_down, t_up) — their channels become infeasible — and
    rejoins afterwards."""
    return Scenario(
        name="elastic_outage",
        init=_outage_init,
        step=_outage_step,
        params={"frac": frac, "t_down": t_down, "t_up": t_up},
        fluctuates=False,  # live servers run at unit speed
        description="a random subset of servers is down for a window",
        draws=(("perm", "perm", None),),
    )


# ---------------------------------------------------------------------------
# server_failures — Markov crash/repair per server, optional rack correlation
# ---------------------------------------------------------------------------

def _failures_init(params, perms, n_servers, batch, device):
    lemon = _subset(perms["perm"], params["lemon_frac"], n_servers)
    p = params["p_crash"] * torch.where(lemon, params["lemon_mult"], 1.0)
    # correlated rack failures: servers partition into n_racks contiguous
    # groups; one uniform per rack, read through the rack's first server
    G = torch.clamp(params["n_racks"].to(torch.int32), min=1)  # (B, 1)
    r_ids = torch.arange(n_servers, device=device)
    rack = (r_ids * G) // n_servers  # (B, R) rack id, non-decreasing
    first = ((rack * n_servers + G - 1) // G).long()  # its first server
    racks_on = params["n_racks"] > 0
    down = torch.zeros((batch, n_servers), dtype=torch.bool, device=device)
    return down, p, first, racks_on, _ones(batch, n_servers, device)[0]


def _failures_step(params, state, t, n_servers, u):
    down, p, first, racks_on, speed = state
    # repairs land at the slot boundary: a repaired server serves slot t
    down = down & ~(u["repair"] < params["p_repair"])
    alive = ~down
    # crash draws come AFTER aliveness is emitted: a server crashing in
    # slot t still shows alive[t] (it accepted work) and is down from t+1
    # until repaired — the up→down transition is the crash event
    # (core.env.crash_events)
    crash = alive & (u["crash"] < p)
    u_rack = torch.gather(u["rack"], -1, first)
    rack_crash = racks_on & alive & (u_rack < params["p_rack"])
    down = down | crash | rack_crash
    return ((down, p, first, racks_on, speed),
            params["arr_scale"].to(torch.float32), speed, alive)


@register_scenario("server_failures")
def server_failures(
    p_crash: float = 0.03,
    p_repair: float = 0.4,
    n_racks: int = 0,
    p_rack: float = 0.0,
    lemon_frac: float = 0.0,
    lemon_mult: float = 1.0,
    arr_scale: float = 1.0,
) -> Scenario:
    """Seeded Markov crash/repair per server: an alive server crashes with
    p_crash per slot (losing that slot's in-flight work) and stays down
    until repaired with p_repair per slot.  With ``n_racks > 0`` servers
    also partition into contiguous rack groups and each rack fails as a
    unit with p_rack per slot.  ``lemon_frac``/``lemon_mult`` make a
    seeded ⌈frac·R⌉-subset of servers crash lemon_mult× as often, and
    ``arr_scale`` uniformly scales arrival intensity."""
    return Scenario(
        name="server_failures",
        init=_failures_init,
        step=_failures_step,
        params={"p_crash": p_crash, "p_repair": p_repair,
                "n_racks": n_racks, "p_rack": p_rack,
                "lemon_frac": lemon_frac, "lemon_mult": lemon_mult,
                "arr_scale": arr_scale},
        fluctuates=False,  # live servers run at unit speed
        description="Markov crash/repair per server, optional correlated "
                    "rack-group failures and crash-prone lemon hosts",
        draws=(("perm", "perm", None), ("repair", "slot", None),
               ("crash", "slot", None), ("rack", "slot", None)),
    )


# ---------------------------------------------------------------------------
# power_coupled — shared sum-power budget couples per-server speeds
# ---------------------------------------------------------------------------

def power_allocation(demand, budget):
    """Ration a shared power budget across servers, proportionally.

    demand: (…, R) float32 per-server power draw this slot (≥ 0); budget:
    the total budget P, broadcasting against (…, 1) (clamped at 0).
    Returns p with ``p_i = d_i · min(1, P / Σd)``: every allocation is cut
    by the same oversubscription ratio, the droop model of a shared feed.
    ``Σp = min(P, Σd) ≤ P``, and p is non-decreasing in P elementwise.
    """
    d = torch.as_tensor(demand, dtype=torch.float32)
    return d * _power_ratio(d, budget)


def _power_ratio(d, budget):
    """min(1, P / Σd) of :func:`power_allocation`, (…, 1)."""
    B = torch.clamp(torch.as_tensor(budget, dtype=torch.float32,
                                    device=d.device), min=0.0)
    total = d.sum(dim=-1, keepdim=True)
    return torch.where(total > B, B / torch.clamp(total, min=1e-9), 1.0)


def _power_init(params, perms, n_servers, batch, device):
    burst = torch.zeros((batch, n_servers), dtype=torch.bool, device=device)
    return burst, _ones(batch, n_servers, device)[1]


def _power_step(params, state, t, n_servers, u):
    burst, alive = state
    u = u["u"]
    start = ~burst & (u < params["p_burst"])
    stop = burst & (u < params["p_calm"])
    burst = (burst | start) & ~stop
    # demand: 1 unit for the job, plus (burst_mult − 1) drawn by a bursting
    # co-tenant; the feed rations everyone by one factor and the
    # co-tenant's draw comes off the top of its server's allocation
    d = torch.where(burst, params["burst_mult"], 1.0)
    ratio = _power_ratio(d, params["budget"] * n_servers)
    # p − (d − 1) with p = d·ratio (power_allocation), rounded once as
    # XLA's fused multiply-add does
    job_power = torch.clamp(torch.addcmul(1.0 - d, d, ratio), 0.0, 1.0)
    speed = torch.minimum(torch.maximum(job_power ** params["alpha"],
                                        params["s_min"]),
                          torch.ones_like(job_power))
    return (burst, alive), 1.0, speed, alive


@register_scenario("power_coupled")
def power_coupled(
    budget: float = 1.1,
    burst_mult: float = 3.0,
    p_burst: float = 0.08,
    p_calm: float = 0.25,
    alpha: float = 0.5,
    s_min: float = 0.05,
) -> Scenario:
    """Power-oversubscribed co-location (arXiv:2108.06935): all R servers
    share one power feed with total budget ``budget·R``.  Each server hosts
    a co-located tenant whose draw follows a two-state Markov chain (calm =
    1 unit, burst = ``burst_mult`` units, entered w.p. ``p_burst``, left
    w.p. ``p_calm``).  The feed rations proportionally
    (:func:`power_allocation`), the co-tenant's draw comes off the top, and
    the scheduled job's speed is ``clip(job_power^alpha, s_min, 1)``."""
    if burst_mult < 1.0:
        raise ValueError(f"burst_mult must be ≥ 1, got {burst_mult}")
    return Scenario(
        name="power_coupled",
        init=_power_init,
        step=_power_step,
        params={"budget": budget, "burst_mult": burst_mult,
                "p_burst": p_burst, "p_calm": p_calm,
                "alpha": alpha, "s_min": s_min},
        fluctuates=True,
        description="shared sum-power budget: co-located bursts slow every "
                    "server via proportional power rationing, s_i ∝ p_i^α",
        speed_bounds=(s_min, 1.0),
        draws=(("u", "slot", None),),
    )


# ---------------------------------------------------------------------------
# host-side unrolling (the interface ClusterSim consumes)
# ---------------------------------------------------------------------------

def unroll_scenario(
    scenario: Scenario,
    T: int,
    n_servers: int,
    seed: int = 0,
    n_ports: int = 1,
    device=None,
    draws: "ScenarioDraws | None" = None,
):
    """Materialize one run of a regime into host arrays (arr_scale
    (T, n_ports), speed (T, R), alive (T, R)): the run ``simulate(...,
    seed=seed)`` sees, stepped on ``device`` (``None`` is the card) from
    the same scenario draws, or from ``draws`` (a batch of one) when
    given.  Per-slot arrival scales of any shape broadcast across
    ports."""
    dev = resolve_device(device)
    _, sd = _scenario_inputs(scenario, draws, T, n_servers, [seed])
    sd = sd.to(dev)
    params = _row_params(scenario.params, 1, dev)
    state = scenario.init(params, sd.perms, n_servers, 1, dev)
    arr = torch.empty((T, n_ports), dtype=torch.float32, device=dev)
    speed = torch.empty((T, n_servers), dtype=torch.float32, device=dev)
    alive = torch.empty((T, n_servers), dtype=torch.bool, device=dev)
    for i in range(T):
        state, a, s, al = scenario.step(
            params, state, i + 1, n_servers,
            {k: v[:, i] for k, v in sd.slots.items()})
        arr[i] = torch.as_tensor(a, dtype=torch.float32,
                                 device=dev).reshape(-1)
        speed[i] = s.reshape(-1, n_servers)[0]
        alive[i] = al.reshape(-1, n_servers)[0]
    return (arr.cpu().numpy(), speed.cpu().numpy(), alive.cpu().numpy())
