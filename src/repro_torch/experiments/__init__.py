"""Scenario regimes and sweeps for the ESDP reproduction (counterpart of
``repro.experiments``).

  scenarios — registry of named generative regimes for fluctuated
              processing speeds, arrivals and aliveness (DVFS, MMPP bursts,
              stragglers, brownouts, elastic outages, server failures,
              power coupling) behind the ``core.env.Scenario`` protocol.
  sweep     — declarative (policy × scenario × grid) sweeps, each cell one
              batch of seeds (``simulate_batch``), scenario-parameter grids
              one batch of grid points × seeds (``simulate_grid``), plus
              CSV/JSON sinks and the streaming engine's per-variant
              records (``engine_variant_records``).
"""
from .scenarios import (SCENARIOS, get_scenario, power_allocation,
                        register_scenario, scenario_names, unroll_scenario)
from .sweep import (POLICY_FACTORIES, GridPoint, SweepRow, SweepSpec,
                    default_policies, engine_variant_records, run_spec,
                    summarize, sweep_scenario_param, write_csv, write_json)

__all__ = [
    "SCENARIOS", "get_scenario", "register_scenario", "scenario_names",
    "unroll_scenario", "power_allocation",
    "POLICY_FACTORIES", "GridPoint", "SweepRow", "SweepSpec",
    "default_policies", "engine_variant_records", "run_spec", "summarize",
    "sweep_scenario_param", "write_csv", "write_json",
]
