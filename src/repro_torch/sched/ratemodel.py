"""Service rates of the simulated fleet for the dispatcher (counterpart of
``repro.sched.ratemodel``).

Mean service rate of (arch × shape) on a slice = tokens/s implied by a
dry-run roofline record (``results/dryrun/*.json``, where the JAX package
wrote them): the step time is max(compute, memory, collective) and
throughput = tokens_per_step / step_s.  Without a record a parametric
estimate keyed on the arch's active parameters is used, so rates stay
positive and ordered.  Both are properties of the *simulated* TPU fleet
the dispatcher schedules — an instance's data, kept equal to the JAX
package's so both build the same instances — and say nothing of the
speed of the device this package runs on.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

from ..configs import SHAPES

__all__ = ["roofline_rate", "rate_matrix"]

# the simulated fleet's data, as in the JAX package: active parameters
# (billions) of each arch where no dry-run record exists
_ACTIVE_B = {
    "qwen2.5-32b": 32.8, "gemma3-27b": 27.0, "gemma-7b": 8.5,
    "qwen1.5-32b": 35.2, "zamba2-7b": 5.7, "dbrx-132b": 36.0,
    "deepseek-v3-671b": 37.0, "whisper-medium": 0.79,
    "mamba2-2.7b": 2.8, "qwen2-vl-72b": 72.7,
}


def roofline_rate(
    arch: str, shape_name: str, results_dir: str = "results/dryrun"
) -> float:
    """Normalized tokens/s per chip for the single-pod mesh."""
    shape = SHAPES[shape_name]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    path = pathlib.Path(results_dir) / f"{arch}_{shape_name}_single.json"
    if path.exists():
        rec = json.loads(path.read_text())
        if "roofline" in rec:
            t = rec["roofline"]
            step_s = max(t["compute_s"], t["memory_s"], t["collective_s"],
                         1e-9)
            return tokens / step_s / 256.0
    # parametric fallback: compute-bound at 40% of a simulated v5e pod
    # slice's 197 TFLOP/s a chip over 256 chips (instance data only)
    n_active = _ACTIVE_B.get(arch, 10.0) * 1e9
    factor = 6.0 if shape.kind == "train" else 2.0
    step_s = factor * n_active * tokens / (0.4 * 197e12 * 256)
    return tokens / max(step_s, 1e-9) / 256.0


def rate_matrix(
    jobs, slices, results_dir: str = "results/dryrun", slice_speed: dict | None = None
) -> np.ndarray:
    """mean_rates[l, r] for build_instance; slice_speed scales per slice
    (heterogeneous fleets / chronic stragglers)."""
    out = np.zeros((len(jobs), len(slices)), np.float32)
    for li, job in enumerate(jobs):
        base = roofline_rate(job.arch, job.shape, results_dir)
        for r, sl in enumerate(slices):
            speed = (slice_speed or {}).get(sl.name, 1.0)
            out[li, r] = base * speed * sl.chips
    return out
