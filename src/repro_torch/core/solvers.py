"""Pluggable backends for the per-slot Algorithm-2 solve (paper P4/P5).

Counterpart of ``repro.core.solvers``.  Every backend implements one
contract::

    solver(upsilon, sigma2, tables, s_cap, s_limit, allowed=None,
           u_max=None) -> (x, info)

for (E,) or batch-first (B, E) int32 statistics: ``x`` int32 of the same
shape and ``info`` with ``s_star`` and ``value_row`` — the (s_cap+1,)
int32 DP value row with exactly ``dp.NEG`` at budget-infeasible entries.
``u_max`` is an optional bound on max Υ̂ (``stats.u_max_for_horizon``);
the kernels size the up halo of a tiled plane with it, ``None`` meaning
``s_cap + 1``.  Backends are bit-exact interchangeable.

Registry:
  reference — the plain int32 edge fold of ``core.dp.solve_budgeted_dp``,
              on CPU tensors only: a CUDA tensor raises, so no setting can
              send the card's slot to a plain version.
  cuda      — the budgeted-DP kernels (``kernels.budgeted_dp``): (E,)
              statistics solve as a batch of one, (B, E) as one fleet
              (``accepts_batch``), with the tiling picked by
              ``tiling.choose_tiling``.  CPU tensors run the kernels'
              plain versions under the same host loop.
  auto      — per call: ``cuda`` for CUDA tensors, ``reference`` otherwise.

Selection: ``get_solver(None)`` consults ``$REPRO_DP_SOLVER`` and falls
back to ``auto``; an explicit name in code wins over the env var, except
that explicit ``"auto"`` lets the env var refine it.  An invalid env value
warns and falls back to ``auto``; an invalid name in code raises.

Incremental layer: :class:`CachedSolver` wraps any backend with the
quantized-statistics solve cache (``core.incremental.SolveCache``) — the
same call contract, ``accepts_batch`` passed through, no solve on a hit.

Degradation layer: :class:`FallbackSolver` wraps the registry with a
bounded retry chain (the primary, then ``reference`` by default),
catching backend launch failures and rejecting corrupted value rows
(``kernels.budgeted_dp.ops.validate_value_row``) before falling through —
bit-identical results whichever link serves, because backends are
bit-exact interchangeable.  A deterministic fault-injection hook
(``runtime.fault.planned_fault``, or ``$REPRO_DP_FAULT_RATE``) exercises
the chain without real faults.  It is opt-in: nothing wraps a backend in
it unless asked.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import warnings
from typing import Callable

import numpy as np
import torch

from .dp import NEG, DPTables, solve_budgeted_dp

__all__ = ["SOLVER_ENV_VAR", "SOLVER_NAMES", "Solver", "get_solver",
           "CachedSolver", "FallbackSolver", "POISON"]

SOLVER_ENV_VAR = "REPRO_DP_SOLVER"
SOLVER_NAMES = ("auto", "reference", "cuda")


def _requested(name: "str | None") -> str:
    """Apply the env-var rules; returns a name from ``SOLVER_NAMES``."""
    from_env = False
    if name is None or name == "auto":
        env_name = os.environ.get(SOLVER_ENV_VAR) or None
        if env_name is not None:
            name, from_env = env_name, True
        else:
            name = "auto"
    if name not in SOLVER_NAMES:
        if from_env:
            warnings.warn(
                f"ignoring invalid {SOLVER_ENV_VAR}={name!r} (choose from "
                f"{SOLVER_NAMES}); falling back to 'auto'",
                RuntimeWarning, stacklevel=3)
            return "auto"
        raise ValueError(
            f"unknown DP solver backend {name!r}; choose from {SOLVER_NAMES}")
    return name


@dataclasses.dataclass(frozen=True, eq=False)
class Solver:
    """A registry backend, callable with the shared contract.

    ``accepts_batch``: a (B, E) call is one fleet-batched kernel launch.
    """

    name: str
    _fn: Callable = dataclasses.field(repr=False)
    accepts_batch: bool = False

    def __call__(
        self,
        upsilon,
        sigma2,
        tables: DPTables,
        s_cap: int,
        s_limit,
        allowed=None,
        u_max=None,
    ):
        return self._fn(upsilon, sigma2, tables, s_cap, s_limit, allowed,
                        u_max)


def _reference_solve(upsilon, sigma2, tables, s_cap, s_limit, allowed, u_max):
    del u_max  # the plain fold needs no halo
    if upsilon.device.type != "cpu":
        raise ValueError(
            f"the 'reference' DP backend runs on CPU tensors only, got "
            f"{upsilon.device}; tensors on the card go through 'cuda' "
            "(or 'auto')")
    x, info = solve_budgeted_dp(upsilon, sigma2, tables, s_cap, s_limit,
                                allowed=allowed)
    row = info["value_row"]
    return x, {"s_star": info["s_star"],
               "value_row": torch.where(row >= 0, row, NEG)}


def _cuda_solve(upsilon, sigma2, tables, s_cap, s_limit, allowed, u_max):
    from ..kernels.budgeted_dp import ops
    if upsilon.dim() == 2:
        return ops.solve_budgeted_dp_batched(upsilon, sigma2, tables, s_cap,
                                             s_limit, u_max=u_max,
                                             allowed=allowed)
    x, info = ops.solve_budgeted_dp_batched(
        upsilon[None], sigma2[None], tables, s_cap, s_limit, u_max=u_max,
        allowed=None if allowed is None else allowed[None])
    return x[0], {k: v[0] for k, v in info.items()}


def _auto_solve(upsilon, sigma2, tables, s_cap, s_limit, allowed, u_max):
    solve = (_cuda_solve if upsilon.device.type == "cuda"
             else _reference_solve)
    return solve(upsilon, sigma2, tables, s_cap, s_limit, allowed, u_max)


_SOLVERS = {
    "reference": Solver("reference", _reference_solve),
    "cuda": Solver("cuda", _cuda_solve, accepts_batch=True),
    "auto": Solver("auto", _auto_solve, accepts_batch=True),
}


class CachedSolver:
    """A backend wrapped with the quantized-statistics solve cache.

    Same call contract as :class:`Solver`, and ``accepts_batch`` follows
    the wrapped backend.  The cache is host-side: each call copies its
    inputs to the host to key them (one sync on the card), ticks the
    staleness clock once and, on a hit, returns the stored tensors without
    a solve.  The JAX package lets traced inputs bypass the cache; the
    port has no tracing, so every call is keyed (``stats.bypasses`` stays
    0).

    Batched (B, E) inputs are keyed per row.  A full hit skips the solve;
    any miss solves the whole batch in one batched call, as the JAX
    package does, and refreshes every row (so a quantized cache stores the
    fresh solutions of rows that hit, and their ticks restart).

    With the default quanta the cache is exact: hits are bit-identical to
    cold solves.  ``exact`` says which mode this wrapper is in.  ``scope``
    labels the counters when a consumer owns several wrappers (one per A/B
    variant in ``sched.engine``, which sets it to the variant's name when
    it is ``None``).
    """

    def __init__(
        self, base: Solver, cache=None, scope: "str | None" = None, **cache_kwargs
    ):
        from .incremental import SolveCache
        self.base = base
        self.cache = cache if cache is not None else SolveCache(**cache_kwargs)
        self.scope = scope

    def stats_dict(self) -> dict:
        """``stats.as_dict()`` plus the ``scope`` label when set."""
        d = self.cache.stats.as_dict()
        if self.scope is not None:
            d["scope"] = self.scope
        return d

    @property
    def name(self) -> str:
        return f"cached:{self.base.name}"

    @property
    def accepts_batch(self) -> bool:
        return self.base.accepts_batch

    @property
    def exact(self) -> bool:
        return self.cache.exact

    @property
    def stats(self):
        return self.cache.stats

    def __call__(
        self,
        upsilon,
        sigma2,
        tables: DPTables,
        s_cap: int,
        s_limit,
        allowed=None,
        u_max=None,
    ):
        from .incremental import host
        ups_t = torch.as_tensor(upsilon)
        dev = ups_t.device
        sig_t = torch.as_tensor(sigma2, device=dev)
        ups, sig = host(ups_t), host(sig_t)
        self.cache.tick()
        if ups.ndim == 1:
            key = self.cache.key(ups, sig, allowed, int(host(s_limit)))
            hit = self.cache.get(key)
            if hit is not None:
                self.cache.stats.launches_saved += 1
                return hit
            alw = (None if allowed is None
                   else torch.as_tensor(allowed, device=dev))
            out = self.base(ups_t, sig_t, tables, s_cap,
                            torch.as_tensor(s_limit, device=dev),
                            allowed=alw, u_max=u_max)
            self.cache.put(key, out)
            return out

        B = ups.shape[0]
        slim = np.broadcast_to(host(s_limit), (B,))
        alw = (np.ones(ups.shape, bool) if allowed is None
               else np.broadcast_to(host(allowed).astype(bool), ups.shape))
        keys = [self.cache.key(ups[b], sig[b], alw[b], int(slim[b]))
                for b in range(B)]
        hits = [self.cache.get(k) for k in keys]
        if all(h is not None for h in hits):
            self.cache.stats.launches_saved += 1
            return (torch.stack([h[0] for h in hits]),
                    {k: torch.stack([h[1][k] for h in hits])
                     for k in ("s_star", "value_row")})
        x, info = self.base(ups_t, sig_t, tables, s_cap,
                            torch.as_tensor(np.array(slim), device=dev),
                            allowed=torch.as_tensor(np.array(alw),
                                                    device=dev),
                            u_max=u_max)
        for b, k in enumerate(keys):
            self.cache.put(k, (x[b], {"s_star": info["s_star"][b],
                                      "value_row": info["value_row"][b]}))
        return x, info


# What an injected "corrupt" fault writes into a value row: the int32
# plane's VALUE_BOUND (2**29), which ``validate_value_row`` rejects.  (The
# JAX package writes 2**24, its f32-exact bound, which the port's wider
# int32 bound would accept.)
POISON = 2 ** 29


class FallbackSolver:
    """Graceful degradation of the solve path: a bounded backend retry
    chain (counterpart of the JAX package's ``FallbackSolver``).

    Per call the wrapper walks ``chain`` (default: the primary backend,
    then ``reference``).  An attempt degrades when the backend raises (a
    launch failure, caught and recorded) or when its value row violates
    the DP invariants of ``kernels.budgeted_dp.ops.validate_value_row``
    (theorems of the recurrence, so a violation always means corruption).
    Every link is bit-exact with every other, so whichever serves, ``x``,
    ``s_star`` and ``value_row`` are the same.  The last link is never
    injected and its failures propagate: a chain that cannot serve at all
    is an outage, not a degradation.  Each degradation is counted in
    ``stats`` and recorded as a structured event in ``stats["events"]``
    (the first 256; the counters never truncate).

    ``reference`` takes CPU tensors only: that link runs on CPU copies of
    the inputs, and its outputs go back to the caller's device.  Every
    call reads the serving link's value row back to the host to validate
    it (one sync on the card), as the JAX package's wrapper does; the
    wrapper is opt-in (``ClusterSim(fallback=True)``, or ``solver=`` a
    ``FallbackSolver``).

    Deterministic fault injection: with ``fault_rate > 0`` (explicit, else
    ``$REPRO_DP_FAULT_RATE``) each non-final attempt consults
    ``runtime.fault.planned_fault(call, rate, seed, attempt)`` and either
    raises an ``InjectedFault`` before launching or poisons the returned
    value row with :data:`POISON`, which validation must reject.  The
    plan is pure in the call index, so a run is reproducible and, since
    fallbacks are exact, bit-identical to the fault-free run; the JAX
    package's wrapper plans the same faults.

    The JAX package lets traced calls bypass the chain; the port has no
    tracing, so every call walks it and ``stats["bypasses"]`` stays 0.
    ``accepts_batch`` follows the primary; (B, E) inputs walk the same
    chain with each row's value row validated.
    """

    _MAX_EVENTS = 256  # structured events kept; counters never truncate

    def __init__(
        self,
        base: "Solver | str | None" = None,
        chain: "tuple | None" = None,
        fault_rate: "float | None" = None,
        fault_seed: "int | None" = None,
        scope: "str | None" = None,
    ):
        from ..runtime.fault import FAULT_SEED_ENV, fault_rate_from_env
        if chain is not None:
            links = [get_solver(s) for s in chain]
            if not links:
                raise ValueError("FallbackSolver chain must be non-empty")
        else:
            primary = get_solver(base)
            links = [primary]
            if primary.name != "reference":
                links.append(get_solver("reference"))
        self.chain = tuple(links)
        self.base = self.chain[0]
        self.fault_rate = (fault_rate_from_env() if fault_rate is None
                           else float(fault_rate))
        self.fault_seed = (int(os.environ.get(FAULT_SEED_ENV, "0") or 0)
                           if fault_seed is None else int(fault_seed))
        # scope labels this wrapper's counters when a consumer owns several
        self.scope = scope
        self.stats: dict = {
            "calls": 0, "bypasses": 0, "degraded_calls": 0,
            "launch_failures": 0, "validation_failures": 0,
            "faults_injected": 0, "served_by": {s.name: 0 for s in links},
            "events": [],
        }
        if scope is not None:
            self.stats["scope"] = scope

    def stats_dict(self) -> dict:
        """A detached copy of the counters (scope label included)."""
        return copy.deepcopy(self.stats)

    @property
    def name(self) -> str:
        return "fallback:" + "->".join(s.name for s in self.chain)

    @property
    def accepts_batch(self) -> bool:
        return self.base.accepts_batch

    def _record(self, **event) -> None:
        ev = self.stats["events"]
        if len(ev) < self._MAX_EVENTS:
            ev.append(event)

    def __call__(
        self,
        upsilon,
        sigma2,
        tables: DPTables,
        s_cap: int,
        s_limit,
        allowed=None,
        u_max=None,
    ):
        from ..kernels.budgeted_dp.ops import validate_value_row
        from ..runtime.fault import InjectedFault, planned_fault

        call = self.stats["calls"]
        self.stats["calls"] += 1
        ups = torch.as_tensor(upsilon)
        dev = ups.device
        args = (ups, torch.as_tensor(sigma2, device=dev),
                torch.as_tensor(s_limit, device=dev),
                None if allowed is None else torch.as_tensor(allowed,
                                                             device=dev))
        last = len(self.chain) - 1
        for attempt, link in enumerate(self.chain):
            fault = (None if attempt == last else planned_fault(
                call, self.fault_rate, seed=self.fault_seed,
                attempt=attempt))
            try:
                if fault == "launch":
                    self.stats["faults_injected"] += 1
                    raise InjectedFault(
                        f"injected launch failure (call {call}, "
                        f"attempt {attempt}, backend {link.name})")
                on = "cpu" if link.name == "reference" else dev
                u, s, lim, alw = (None if a is None else a.to(on)
                                  for a in args)
                x, info = link(u, s, tables, s_cap, lim, allowed=alw,
                               u_max=u_max)
                row = info["value_row"].cpu().numpy()
                if fault == "corrupt":
                    # poison past the int32 plane's bound: validation MUST
                    # reject this row, proving the checks are live
                    self.stats["faults_injected"] += 1
                    row = row.copy()
                    row[..., 0] = POISON
            except Exception as err:  # noqa: BLE001 — any launch failure degrades
                if attempt == last:
                    raise
                self.stats["launch_failures"] += 1
                self._record(call=call, attempt=attempt, backend=link.name,
                             kind="launch",
                             injected=isinstance(err, InjectedFault),
                             error=f"{type(err).__name__}: {err}")
                continue
            reason = validate_value_row(row)
            if reason is not None:
                if attempt == last:
                    raise RuntimeError(
                        f"DP value plane failed validation on the final "
                        f"chain link {link.name!r}: {reason}")
                self.stats["validation_failures"] += 1
                self._record(call=call, attempt=attempt, backend=link.name,
                             kind="validate", injected=fault == "corrupt",
                             error=reason)
                continue
            if attempt > 0:
                self.stats["degraded_calls"] += 1
            self.stats["served_by"][link.name] += 1
            return x.to(dev), {k: info[k].to(dev)
                               for k in ("s_star", "value_row")}
        raise AssertionError("unreachable: the final chain link never skips")


def get_solver(name: "str | Solver | None" = None):
    """The backend ``name`` selects (see the module docstring); a
    ``Solver``, or a solver-shaped wrapper (callable, with ``name`` and
    ``accepts_batch``, as :class:`CachedSolver` and
    :class:`FallbackSolver`), passes through
    unchanged."""
    if isinstance(name, Solver) or (
            callable(name) and hasattr(name, "accepts_batch")
            and hasattr(name, "name")):
        return name
    return _SOLVERS[_requested(name)]
