"""The paper's contribution, in PyTorch: ESDP dispatching of multi-server
jobs (counterpart of ``repro.core``).

Public API:
  generate_instance / Instance / instance_from_arrays — problem instances
  build_tables / solve_budgeted_dp      — Algorithm 2 (int32 reference)
  get_solver / Solver                   — backends (reference | cuda | auto)
  CachedSolver / SolveCache             — quantized-statistics solve cache
  solve_budgeted_dp_warm / WarmCarry    — warm-started re-solves across slots
  make_esdp_policy / esdp_factory       — Algorithm 1 (ESDP)
  make_hswf_policy / make_lcf_policy / make_lwtf_policy — paper baselines
  simulate / simulate_batch / simulate_grid / SimResult — the slot
                                          simulator (seed fleets, grids)
  make_draws / Draws                    — a run's random inputs
  Scenario / default_scenario / replay_scenario — the regime protocol,
                                          the iid regime, a replayed trace
                                          (named regimes: repro_torch.
                                          experiments.scenarios)
  make_scenario_draws / ScenarioDraws   — a regime's random inputs
  FallbackSolver                        — the solve's degradation chain
"""
from . import stats
from .baselines import (hswf_factory, lcf_factory, lwtf_factory,
                        make_hswf_policy, make_lcf_policy, make_lwtf_policy,
                        make_msr_greedy_policy, make_msr_index_policy)
from .dp import DPTables, build_tables, oracle_knapsack, solve_budgeted_dp
from .env import (Draws, Scenario, ScenarioDraws, SimResult,
                  default_scenario, make_draws, make_scenario_draws,
                  replay_scenario, simulate, simulate_batch, simulate_grid)
from .esdp import Policy, PolicyFactory, Slot, esdp_factory, make_esdp_policy
from .graph import Instance, generate_instance, instance_from_arrays
from .incremental import (CacheStats, SolveCache, WarmCarry,
                          solve_budgeted_dp_warm, warm_carry_init)
from .solvers import (SOLVER_NAMES, CachedSolver, FallbackSolver, Solver,
                      get_solver)

__all__ = [
    "Instance", "generate_instance", "instance_from_arrays",
    "DPTables", "build_tables", "solve_budgeted_dp", "oracle_knapsack",
    "SOLVER_NAMES", "Solver", "get_solver",
    "CachedSolver", "FallbackSolver", "SolveCache", "CacheStats",
    "WarmCarry", "warm_carry_init", "solve_budgeted_dp_warm",
    "Policy", "PolicyFactory", "Slot", "make_esdp_policy", "esdp_factory",
    "make_hswf_policy", "make_lcf_policy", "make_lwtf_policy",
    "make_msr_greedy_policy", "make_msr_index_policy",
    "hswf_factory", "lcf_factory", "lwtf_factory",
    "Scenario", "ScenarioDraws", "default_scenario", "replay_scenario",
    "make_scenario_draws", "Draws", "make_draws",
    "SimResult", "simulate", "simulate_batch", "simulate_grid", "stats",
]
