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

The cache and fallback wrappers of the JAX package (``CachedSolver``,
``FallbackSolver``) come with the incremental re-solve slice.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable

import torch

from .dp import NEG, DPTables, solve_budgeted_dp

__all__ = ["SOLVER_ENV_VAR", "SOLVER_NAMES", "Solver", "get_solver"]

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


def get_solver(name: "str | Solver | None" = None) -> Solver:
    """The backend ``name`` selects (see the module docstring); a
    ``Solver`` passes through unchanged."""
    if isinstance(name, Solver):
        return name
    return _SOLVERS[_requested(name)]
