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
The JAX package's degradation wrapper (``FallbackSolver``) is not ported
yet.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable

import numpy as np
import torch

from .dp import NEG, DPTables, solve_budgeted_dp

__all__ = ["SOLVER_ENV_VAR", "SOLVER_NAMES", "Solver", "get_solver",
           "CachedSolver"]

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
    cold solves.  ``exact`` says which mode this wrapper is in.
    """

    def __init__(self, base: Solver, cache=None, **cache_kwargs):
        from .incremental import SolveCache
        self.base = base
        self.cache = cache if cache is not None else SolveCache(**cache_kwargs)

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


def get_solver(name: "str | Solver | None" = None):
    """The backend ``name`` selects (see the module docstring); a
    ``Solver``, or a solver-shaped wrapper (callable, with ``name`` and
    ``accepts_batch``, as :class:`CachedSolver`), passes through
    unchanged."""
    if isinstance(name, Solver) or (
            callable(name) and hasattr(name, "accepts_batch")
            and hasattr(name, "name")):
        return name
    return _SOLVERS[_requested(name)]
