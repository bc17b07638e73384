"""ESDP against HSWF across the fluctuation regimes, from the command line
(the configuration of the JAX package's ``examples/scenario_sweep.py``).

    python -m repro_torch.launch.scenario_sweep --device cpu

Part 1 runs every registered regime as a ``SweepSpec`` — ESDP with g = ln t
against the paper-literal HSWF (ties unbroken) on the Table-2 instance, T =
1000, seeds (0, 1, 2), each (policy × regime) one seed fleet — prints the
example's table and writes its CSV.  Part 2 sweeps ``chronic_straggler``'s
``straggler_speed`` over (0.2, 0.4, 0.6, 0.8, 1.0) as one batch of five
grid points × three seeds.  Runs on the card unless ``--device`` names
another; ``--T`` and ``--seeds`` shrink the run.  ``main`` returns the
rows and the grid's final ASW.
"""
from __future__ import annotations

import argparse

from ..core import build_tables, generate_instance
from ..core.baselines import hswf_factory
from ..core.esdp import esdp_factory
from ..core.stats import g_logt_only
from ..experiments import (SweepSpec, run_spec, scenario_names,
                           sweep_scenario_param, write_csv)

__all__ = ["T", "SEEDS", "SPEEDS", "policies", "regime_spec", "table_line",
           "straggler_grid", "main"]

T = 1000
SEEDS = (0, 1, 2)
SPEEDS = (0.2, 0.4, 0.6, 0.8, 1.0)  # part 2's straggler_speed grid


def policies() -> dict:
    """ESDP (g = ln t) and the paper-literal HSWF (tiebreak 0)."""
    return {"esdp": esdp_factory(g_fn=g_logt_only),
            "hswf": hswf_factory(tiebreak=0.0)}


def regime_spec(
    scenario: str, T: int = T, seeds=SEEDS, lineup: "dict | None" = None
) -> SweepSpec:
    """Part 1's spec for one regime on the Table-2 instance; ``lineup``
    replaces :func:`policies` (``chip_smoke.py`` counts each policy's
    launches apart)."""
    return SweepSpec(name=f"sweep/{scenario}", T=T, seeds=tuple(seeds),
                     policies=policies() if lineup is None else lineup,
                     scenario=scenario, instance_kwargs={"seed": 0})


def table_line(scenario: str, rows: dict) -> str:
    """The example's table row: each policy's mean ASW ± CI, the winner."""
    e, h = rows["esdp"], rows["hswf"]
    return (f"{scenario:20s} {e.asw_mean:8.1f}±{e.asw_ci95:3.0f} "
            f"{h.asw_mean:8.1f}±{h.asw_ci95:3.0f} "
            f"{'esdp' if e.asw_mean > h.asw_mean else 'hswf':>8s}")


def straggler_grid(T: int = T, seeds=SEEDS, device=None):
    """Part 2: ESDP over the straggler-severity grid, one batch of
    len(SPEEDS) × len(seeds) runs; a SimResult of shape (G, S, T)."""
    inst = generate_instance(seed=0)
    return sweep_scenario_param(
        inst, esdp_factory(g_fn=g_logt_only), T, seeds,
        "chronic_straggler", "straggler_speed", SPEEDS,
        tables=build_tables(inst.A, inst.c), device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    ap.add_argument("--T", type=int, default=T, help="horizon (slots)")
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)),
                    help="comma-separated run seeds")
    ap.add_argument("--out", default="results/scenario_sweep_torch.csv",
                    help="where part 1's CSV goes")
    args = ap.parse_args(argv)
    seeds = tuple(int(s) for s in args.seeds.split(","))

    print(f"{'scenario':20s} {'esdp ASW':>12s} {'hswf ASW':>12s} "
          f"{'winner':>8s}")
    rows = []
    for scen in scenario_names():
        res = {r.policy: r for r in run_spec(regime_spec(scen, args.T, seeds),
                                             device=args.device)}
        rows += list(res.values())
        print(table_line(scen, res))
    path = write_csv(rows, args.out)
    print(f"\nwrote {path}")

    grid = straggler_grid(args.T, seeds, device=args.device)
    print("\nstraggler severity sweep (one batch of grid points × seeds):")
    asw = grid.asw[..., -1]  # (G, S)
    for v, mean, sd in zip(SPEEDS, asw.mean(axis=1), asw.std(axis=1)):
        print(f"  straggler_speed={v:.1f}  ASW={mean:7.1f} ± {sd:4.1f}")
    return {"rows": rows, "grid_asw": asw}


if __name__ == "__main__":
    main()
