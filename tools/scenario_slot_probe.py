"""Where an ESDP slot's time goes under each scenario regime, on the card.

    python3 tools/scenario_slot_probe.py [--T 300] [--seeds 0,1,2] [--reps 2]

Runs ESDP (g = ln t) through ``simulate_batch`` on the Table-2 instance
under every registered regime, ``--reps`` times, the regime order reversed
on every other pass so that no regime always runs first, and prints each
run's host-clock ms a slot.  Then one run of each regime under
``torch.profiler``: CUDA kernel launches a slot, the kernels' device ms a
slot and the device's idle share (1 − device ms / wall ms), and the kernel
names whose launches a slot differ most from the iid run's.  Run from the
root of a checkout; needs the card.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=300, help="slots a run")
    ap.add_argument("--seeds", default="0,1,2", help="the fleet's seeds")
    ap.add_argument("--reps", type=int, default=2, help="timed passes")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (build_tables, esdp, generate_instance,
                                  simulate_batch, stats)
    from repro_torch.experiments import get_scenario, scenario_names

    if not torch.cuda.is_available():
        raise SystemExit("scenario_slot_probe: needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    T, seeds = args.T, [int(s) for s in args.seeds.split(",")]
    inst = generate_instance(seed=0)
    tables = build_tables(inst.A, inst.c)
    policy = esdp.make_esdp_policy(inst, T, g_fn=stats.g_logt_only,
                                   tables=tables)
    regimes = list(scenario_names())

    def run(name):
        simulate_batch(inst, policy, T, seeds, tables=tables,
                       scenario=get_scenario(name))
        torch.cuda.synchronize()

    run("iid")  # warm-up: the kernel build and the first launches
    times = collections.defaultdict(list)
    for rep in range(args.reps):
        for name in regimes if rep % 2 == 0 else regimes[::-1]:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            run(name)
            times[name].append((time.perf_counter() - w0) / T * 1e3)
    kernels = {}
    out = {}
    for name in regimes:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                run(name)
                wall = (time.perf_counter() - w0) * 1e3
        evts = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        kernels[name] = {e.key: e.count / T for e in evts}
        busy = sum(getattr(e, "device_time_total", 0.0) for e in evts) / 1e3
        launches = sum(e.count for e in evts) / T
        out[name] = dict(ms=times[name], launches=launches,
                         busy_ms=busy / T, idle=max(0.0, 1 - busy / wall))
        print(f"{name:20s} ms a slot {' '.join(f'{t:.3f}' for t in times[name])}"
              f"; {launches:.1f} launches and {busy / T:.4f} device ms a "
              f"slot, device idle {out[name]['idle'] * 100:.1f}% "
              f"(profiled {wall / T:.3f} ms a slot)", flush=True)
    base = kernels["iid"]
    for name in regimes:
        diff = sorted(((kernels[name].get(k, 0.0) - base.get(k, 0.0), k)
                       for k in set(base) | set(kernels[name])),
                      key=lambda d: -abs(d[0]))
        top = "; ".join(f"{d:+.1f} {k[:60]}" for d, k in diff[:4] if d)
        print(f"   {name} vs iid, launches a slot: {top or 'none'}",
              flush=True)
    print(f"card: {card.strip()}; T={T}, seeds {seeds}, Table 2, ESDP "
          "g = ln t", flush=True)
    return out


if __name__ == "__main__":
    main()
