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
for the same expression, and so is the fluctuated mean μ_e·speed_r −
cost_e.

The generative regime — how arrival intensities, processing speeds and
server aliveness evolve — is pluggable through :class:`Scenario`; the
default is the paper's iid regime, and the named fluctuation regimes live
in ``repro_torch.experiments.scenarios``.  A regime's random inputs are
drawn in bulk too (:func:`make_scenario_draws`, one generator per run
seeded from the seed and a salt) or injected (``scenario_draws=``), and
its ``step`` is a pure transition on them.  ``simulate_grid`` runs a
scenario-parameter grid × a seed fleet as one batch: every slot solves
all its runs in one forward and one epilogue launch.
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
    "Scenario", "ScenarioDraws", "default_scenario", "replay_scenario",
    "make_scenario_draws", "SimResult", "Draws", "make_draws",
    "simulate", "simulate_batch", "simulate_grid", "crash_events",
]

# Salt mixed into a run's seed for the scenario's private generator (the
# JAX package folds the same constant into its key): turning a stochastic
# regime on never perturbs the arrival, valuation and policy draws of the
# seed, so comparisons across regimes stay paired.
_SCENARIO_SALT = 0x5CE


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """A named generative regime for arrivals, processing speeds and
    aliveness, batch-first over B runs.

    ``draws`` declares the regime's random inputs as ``(name, kind,
    width)`` triples: kind ``"perm"`` is one random permutation of the
    servers per run, (B, R), drawn before the first slot; kind ``"slot"``
    is ``width`` uniforms per run and slot (``None`` means one per
    server), (B, T, width).  ``init(params, perms, n_servers, batch,
    device) -> state`` takes the ``"perm"`` draws by name; ``step(params,
    state, t, n_servers, u) -> (state, arr_scale, speed, alive)`` advances
    slot t (1-based) on ``u``, slot t's row of every ``"slot"`` draw, and
    emits:

      arr_scale: a float, or a float32 tensor that broadcasts to (B, L) —
        multiplies the instance's ρ (clipped to [0, 1]);
      speed:     (R,) or (B, R) float32 — per-server speed multiplier; the
        mean net valuation of channel e = (l, r) becomes μ_e·speed_r −
        cost_e (the paper's "fluctuated processing speeds");
      alive:     (R,) or (B, R) bool — dead servers' channels are
        infeasible.

    ``params`` reach ``init`` and ``step`` as float32 (or int32) tensors
    of shape (B, 1), one value per run, so a parameter grid runs as one
    batch; state and output shapes must not depend on parameter values.
    ``fluctuates`` must be True iff speed can differ from 1: the regret
    oracle then takes per-slot clipped means.  ``speed_bounds`` is the
    regime's declared (lo, hi) envelope for every emitted speed, a
    contract the tests hold each regime to.
    """

    name: str
    init: Callable[..., Any]
    step: Callable[..., tuple]
    params: dict = dataclasses.field(default_factory=dict)
    fluctuates: bool = False
    description: str = ""
    speed_bounds: tuple = (1.0, 1.0)
    draws: tuple = ()


@dataclasses.dataclass(frozen=True)
class ScenarioDraws:
    """A regime's random inputs for B runs over T slots: ``perms`` maps a
    name to (B, R) int64 server permutations, ``slots`` to (B, T, width)
    float32 uniforms (slot t's at index t − 1)."""

    perms: dict
    slots: dict

    def rows(self, index) -> "ScenarioDraws":
        """The draws of the runs ``index`` selects (a slice or a list)."""
        return ScenarioDraws({k: v[index] for k, v in self.perms.items()},
                             {k: v[index] for k, v in self.slots.items()})

    def to(self, device) -> "ScenarioDraws":
        return ScenarioDraws(
            {k: v.to(device) for k, v in self.perms.items()},
            {k: v.to(device) for k, v in self.slots.items()})


def _default_init(params, perms, n_servers, batch, device):
    return (torch.ones(n_servers, dtype=torch.float32, device=device),
            torch.ones(n_servers, dtype=torch.bool, device=device))


def _default_step(params, state, t, n_servers, u):
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


def replay_scenario(arr_scale, speed, alive, fluctuates=None) -> Scenario:
    """A regime that steps through a given trace: ``arr_scale`` (T, L),
    ``speed`` (T, R) float32 and ``alive`` (T, R) bool — one trace for
    every run — or each with a leading run axis (B, T, ·), one trace per
    run.  Slot t emits row t − 1.  ``fluctuates`` defaults to whether any
    speed differs from 1; pass the traced regime's own flag to give the
    oracle the same means (the parity tests replay the JAX package's
    unrolled traces this way)."""
    trace = [torch.from_numpy(np.array(a)) for a in (arr_scale, speed,
                                                     alive)]
    trace = [trace[0].to(torch.float32), trace[1].to(torch.float32),
             trace[2].to(torch.bool)]
    if fluctuates is None:
        fluctuates = bool((trace[1] != 1.0).any())

    def init(params, perms, n_servers, batch, device):
        return tuple(a.to(device) for a in trace)

    def step(params, state, t, n_servers, u):
        arr, spd, alv = state
        return state, arr[..., t - 1, :], spd[..., t - 1, :], \
            alv[..., t - 1, :]

    lo, hi = float(trace[1].min()), float(trace[1].max())
    return Scenario(name="replay", init=init, step=step,
                    fluctuates=fluctuates,
                    description="replays a given (arr_scale, speed, alive) "
                                "trace", speed_bounds=(lo, hi))


def _scenario_generator(seed: int) -> torch.Generator:
    """A run's scenario generator: on the CPU, so that a regime's
    realization is the same on every device, seeded from the seed and
    ``_SCENARIO_SALT``."""
    gen = torch.Generator()
    gen.manual_seed(int(np.random.SeedSequence(
        [int(seed), _SCENARIO_SALT]).generate_state(1, np.uint64)[0]
        >> np.uint64(1)))
    return gen


def make_scenario_draws(
    scenario: Scenario, T: int, n_servers: int, seeds: Sequence[int]
) -> ScenarioDraws:
    """The random inputs ``scenario.draws`` declares, for one run per seed,
    each drawn in bulk from that run's own generator in declaration order
    (a permutation as the argsort of R uniforms).  On the CPU: the
    simulator moves them to its device."""
    perms: dict = {k: [] for k, kind, _ in scenario.draws if kind == "perm"}
    slots: dict = {k: [] for k, kind, _ in scenario.draws if kind == "slot"}
    for seed in seeds:
        gen = _scenario_generator(seed)
        for name, kind, width in scenario.draws:
            if kind == "perm":
                perms[name].append(torch.argsort(
                    torch.rand(n_servers, generator=gen)))
            elif kind == "slot":
                w = n_servers if width is None else int(width)
                slots[name].append(torch.rand((T, w), generator=gen))
            else:
                raise ValueError(f"scenario {scenario.name!r}: unknown draw "
                                 f"kind {kind!r} (want 'perm' or 'slot')")
    return ScenarioDraws({k: torch.stack(v) for k, v in perms.items()},
                         {k: torch.stack(v) for k, v in slots.items()})


def _check_scenario_draws(scenario, sd, B, T, n_servers):
    for name, kind, width in scenario.draws:
        table = sd.perms if kind == "perm" else sd.slots
        want = ((B, n_servers) if kind == "perm" else
                (B, T, n_servers if width is None else int(width)))
        got = tuple(table[name].shape) if name in table else None
        if got != want:
            raise ValueError(f"scenario_draws {kind} {name!r} has shape "
                             f"{got}, expected {want}")


def _row_params(params: dict, B: int, dev) -> dict:
    """Each parameter as a (B, 1) tensor, float32 for floats and int32 for
    integers (the dtypes the JAX package's ``jnp.asarray`` gives): a
    scalar repeats over the B runs, a (B,) vector gives one per run."""
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.asarray(v))
        t = (t.to(torch.float32) if t.is_floating_point()
             else t.to(torch.int32))
        if t.numel() == 1:
            t = t.reshape(1, 1).expand(B, 1)
        elif t.numel() == B:
            t = t.reshape(B, 1)
        else:
            raise ValueError(f"scenario parameter {k!r} has {t.numel()} "
                             f"values for {B} runs")
        out[k] = t.to(dev)
    return out


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
    ``simulate_batch``, (G, B, T) for ``simulate_grid``; ``x`` adds a
    trailing edge axis."""

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


def _fleet_draws(instance, T, seeds, dev) -> Draws:
    per_seed = [make_draws(instance, T, s, dev) for s in seeds]
    return Draws(*(torch.cat([getattr(d, k) for d in per_seed])
                   for k in ("arr_u", "val_n", "pol_u")))


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _run(
    instance,
    policy,
    T,
    tables,
    scenario,
    draws,
    schedule,
    dev,
    scenario_draws,
    params=None,
):
    if tables is None:
        tables = build_tables(instance.A, instance.c)
    if schedule is None:
        schedule = stats_mod.schedule_table(T, instance.m, policy.delta_fn,
                                            policy.g_fn, dev)
    xi_tab, g_tab, log_tab = (torch.as_tensor(a, device=dev)
                              for a in schedule)
    if policy.name == "esdp":  # the one policy that solves the DP
        from ..kernels.budgeted_dp.ops import check_horizon_value_bound
        check_horizon_value_bound(tables, instance.m, schedule[0],
                                  schedule[1])
    B = draws.arr_u.shape[0]
    E, R = instance.n_edges, instance.n_servers
    for name, shape in (("arr_u", (B, T, instance.n_ports)),
                        ("val_n", (B, T, E)), ("pol_u", (B, T, E))):
        got = tuple(getattr(draws, name).shape)
        if got != shape:
            raise ValueError(f"draws.{name} has shape {got}, expected {shape}")
    _check_scenario_draws(scenario, scenario_draws, B, T, R)
    sd = scenario_draws.to(dev)
    params = _row_params(scenario.params if params is None else params, B,
                         dev)

    def on(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    v_true = on(instance.v, torch.float32)
    mu, sigma = on(instance.mu, torch.float32), on(instance.sigma,
                                                   torch.float32)
    cost, rho = on(instance.cost, torch.float32), on(instance.rho,
                                                     torch.float32)
    neg_cost = -cost
    port = on(instance.port_of_edge, torch.long)
    server = on(instance.edges[:, 1], torch.long)
    arr_u, val_n, pol_u = (getattr(draws, k).to(dev)
                           for k in ("arr_u", "val_n", "pol_u"))

    n = torch.zeros((B, E), dtype=torch.int32, device=dev)
    sumz = torch.zeros((B, E), dtype=torch.float32, device=dev)
    pstate = policy.init(B, dev)
    sstate = scenario.init(params, sd.perms, R, B, dev)
    traces = torch.zeros((3, B, T), dtype=torch.float32, device=dev)
    nd = torch.zeros((B, T), dtype=torch.int32, device=dev)
    xs = torch.zeros((B, T, E), dtype=torch.int32, device=dev)

    for i in range(T):
        t = i + 1
        sstate, arr_scale, speed, alive = scenario.step(
            params, sstate, t, R, {k: v[:, i] for k, v in sd.slots.items()})
        rho_t = torch.clamp(rho * arr_scale, 0.0, 1.0)
        arrived = arr_u[:, i] < rho_t
        # μ·speed − cost rounded once, as XLA's fused multiply-add does
        mean_e = torch.addcmul(neg_cost, mu, speed[..., server])
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


def _scenario_inputs(scenario, scenario_draws, T, R, seeds):
    if scenario is None:
        scenario = default_scenario()
    if scenario_draws is None:
        scenario_draws = make_scenario_draws(scenario, T, R, seeds)
    return scenario, scenario_draws


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
    scenario_draws: ScenarioDraws | None = None,
) -> SimResult:
    """Run one policy for T slots; returns (T,) traces and (T, E) ``x``.

    ``device=None`` is the card (``RuntimeError`` without one).
    ``scenario=None`` is the paper's iid regime.  ``draws`` (a batch of
    one) replaces :func:`make_draws`, ``scenario_draws`` replaces
    :func:`make_scenario_draws`; ``schedule`` — ``(xi, g, log1p_t)`` of
    shape (T,) — replaces the policy's own ``stats.schedule_table``."""
    dev = resolve_device(device)
    if draws is None:
        draws = make_draws(instance, T, seed, dev)
    scenario, scenario_draws = _scenario_inputs(
        scenario, scenario_draws, T, instance.n_servers, [seed])
    r = _run(instance, policy, T, tables, scenario, draws, schedule, dev,
             scenario_draws)
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
    scenario_draws: ScenarioDraws | None = None,
) -> SimResult:
    """``simulate`` over a seed fleet in one slot loop: (B, T) traces.

    Row i makes the same decisions as ``simulate(..., seed=seeds[i])``;
    with ESDP every slot solves the whole fleet in one kernel launch."""
    dev = resolve_device(device)
    if draws is None:
        draws = _fleet_draws(instance, T, seeds, dev)
    scenario, scenario_draws = _scenario_inputs(
        scenario, scenario_draws, T, instance.n_servers, seeds)
    return _run(instance, policy, T, tables, scenario, draws, schedule, dev,
                scenario_draws)


def _grid_rows(tree, G: int, B: int):
    """A fleet result's leading G·B axis split into (G, B)."""
    if isinstance(tree, np.ndarray) and tree.ndim >= 1:
        return tree.reshape((G, B) + tree.shape[1:])
    if hasattr(tree, "_fields"):
        return type(tree)(*(_grid_rows(v, G, B) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_grid_rows(v, G, B) for v in tree)
    return tree


def simulate_grid(
    instance: Instance,
    policy: Policy,
    T: int,
    seeds: Sequence[int],
    scenario: Scenario,
    stacked_params: dict,
    tables: DPTables | None = None,
    device=None,
    draws: Draws | None = None,
    schedule=None,
    scenario_draws: ScenarioDraws | None = None,
) -> SimResult:
    """Sweep a scenario-parameter grid × a seed fleet as ONE batch of G·B
    runs (the JAX package's ``lax.map`` over a vmapped seed batch): every
    slot solves all of them together — with ESDP one forward and one
    epilogue launch a slot for the whole grid.

    ``stacked_params`` has ``scenario.params``' keys, each leaf a length-G
    sequence.  Every grid point replays the same seeds: ``draws`` and
    ``scenario_draws``, when given, are the fleet's (B runs) and repeat
    over the grid.  Returns a SimResult of shape (G, B, T)."""
    dev = resolve_device(device)
    seeds = [int(s) for s in seeds]
    B = len(seeds)
    if set(stacked_params) != set(scenario.params):
        raise ValueError(
            f"stacked_params keys {sorted(stacked_params)} differ from "
            f"scenario {scenario.name!r}'s {sorted(scenario.params)}")
    sizes = {len(np.asarray(v).reshape(-1)) for v in stacked_params.values()}
    if len(sizes) != 1:
        raise ValueError(f"stacked_params leaves differ in length: {sizes}")
    G = sizes.pop()
    if draws is None:
        draws = _fleet_draws(instance, T, seeds, dev)
    _, scenario_draws = _scenario_inputs(scenario, scenario_draws, T,
                                         instance.n_servers, seeds)
    rows = [i % B for i in range(G * B)]  # grid point g, seed b → g·B + b
    draws = Draws(*(getattr(draws, k)[rows] for k in ("arr_u", "val_n",
                                                       "pol_u")))
    params = {k: np.repeat(np.asarray(v).reshape(-1), B)
              for k, v in stacked_params.items()}
    r = _run(instance, policy, T, tables, scenario, draws, schedule, dev,
             scenario_draws.rows(rows), params)
    return SimResult(*(_grid_rows(getattr(r, f), G, B) for f in (
        "sw", "sw_oracle", "regret", "n_dispatched", "x")),
        policy_final=_grid_rows(r.policy_final, G, B))
