"""The cluster dispatcher from the command line: ESDP gang-dispatches five
(arch × shape) job types onto a heterogeneous fleet of four simulated TPU
pod slices whose service rates fluctuate, with a brownout of pod-b in the
middle third of the horizon (the configuration of the JAX package's
``examples/dispatch_cluster.py``).

    python -m repro_torch.launch.dispatch --device cpu

Runs on the card unless ``--device`` names another.  Prints the instance,
each policy's ASW and cumulative regret (ESDP, HSWF, LCF, LWTF, ties
unbroken), and ESDP's dispatch share of pod-b before, during and after
the brownout.  ``main`` returns the numbers.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..sched import ClusterSim, JobType, Slice, build_instance, rate_matrix

__all__ = ["SLICES", "JOBS", "T", "SEED", "dispatch_instance", "brownout",
           "main"]

T, SEED = 800, 7  # the example's horizon and seed

SLICES = [
    Slice("pod-a", "v5e", 256, 32, 4),
    Slice("pod-b", "v5e", 256, 32, 4),
    Slice("pod-c", "v5e", 512, 64, 8),
    Slice("pod-d", "v5p", 256, 32, 4),
]
JOBS = [
    JobType("qwen2.5:train", "qwen2.5-32b", "train_4k", ("v5e", "v5p"),
            256, 32, 4, value_rate=1.0),
    JobType("deepseek:decode", "deepseek-v3-671b", "decode_32k",
            ("v5e", "v5p"), 256, 32, 4, value_rate=1.5),
    JobType("mamba2:long", "mamba2-2.7b", "long_500k", ("v5e",),
            256, 32, 4, value_rate=0.8),
    JobType("gemma3:prefill", "gemma3-27b", "prefill_32k", ("v5e",),
            256, 32, 4, value_rate=0.9),
    JobType("whisper:train", "whisper-medium", "train_4k", ("v5p",),
            256, 32, 4, value_rate=0.4),
]


def dispatch_instance():
    """The dispatch configuration's instance: E = 15 channels, capacities
    (5, 5, 5), so C = 216 capacity states and m = 8."""
    inst, _ = build_instance(SLICES, JOBS, rate_matrix(JOBS, SLICES), seed=0)
    return inst


def brownout(T: int, n_servers: int = len(SLICES)):
    """pod-b at 40% speed in the middle third of the horizon."""
    def speed(t0):
        s = np.ones(n_servers, np.float32)
        if T // 3 < t0 < 2 * T // 3:
            s[1] = 0.4
        return s
    return speed


def main(argv=None, schedule=None) -> dict:
    """Run the four policies over T = 800 slots with seed 7; ``schedule``
    optionally replaces ESDP's per-slot ξ(t), g(t)
    (``ClusterSim(schedule=...)``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    inst = dispatch_instance()
    print(f"cluster instance: {inst.n_ports} job types × "
          f"{inst.n_servers} slices, {inst.n_edges} channels")
    speed = brownout(T, inst.n_servers)

    def sim():
        return ClusterSim(inst, T, speed_fn=speed, seed=SEED,
                          device=args.device, schedule=schedule)

    result = {}
    for pol in ("esdp", "hswf", "lcf", "lwtf"):
        out = sim().run(pol, tiebreak=0.0)
        result[pol] = (out.asw, float(out.cum_regret[-1]))
        print(f"{pol:5s} ASW={out.asw:8.1f} "
              f"cumRegret={out.cum_regret[-1]:8.1f}")

    out = sim().run("esdp")
    mid = slice(T // 3, 2 * T // 3)
    share = tuple(float(out.dispatch_share[s, 1].mean())
                  for s in (slice(None, T // 3), mid, slice(2 * T // 3, None)))
    result["pod_b_share"] = share
    print("pod-b dispatch share: before brownout "
          f"{share[0]:.3f}, during {share[1]:.3f}, after {share[2]:.3f}")
    return result


if __name__ == "__main__":
    main()
