"""The perf hill-climb runner: re-plans chosen cells under candidate
changes and prints the baseline's roofline terms (the port of the JAX
package's ``launch/perf.py``).

    python -m repro_torch.launch.perf --cell gemma-7b:train_4k:single

Each candidate is (tag, the dry run's extra flags: sharding-rule
overrides, remat, config overrides).  Results are written as tagged JSONs
next to the baselines in results/dryrun_torch/, which
``repro_torch.launch.report`` renders.  The candidates and the notes
beside them are the JAX package's, chosen from its own dry run on TPU
figures; the port's plans of them are yet to be read.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

__all__ = ["RESULTS", "CANDIDATES", "main"]

RESULTS = pathlib.Path("results/dryrun_torch")

# candidate changes per hillclimb cell: (tag, dryrun extra args)
CANDIDATES: dict[str, list[tuple[str, list[str]]]] = {
    # collective-bound dense train cell: TP psums dominate ⇒ FSDP pivot
    "gemma-7b:train_4k": [
        ("fsdp", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"]})]),
        ("fsdp_dots", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"]}), "--remat", "dots"]),
        ("dots", ["--remat", "dots"]),
    ],
    # collective-bound MoE train cell: keep EP, drop dense TP
    "dbrx-132b:train_4k": [
        ("fsdp_ep", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"], "expert": ["model"]})]),
        ("fsdp_ep_dots", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"], "expert": ["model"]}),
         "--remat", "dots"]),
    ],
    # deepseek: EP stays on model, dense TP dropped; remat policy second
    "deepseek-v3-671b:train_4k": [
        ("fsdp_ep", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"], "expert": ["model"]})]),
        ("fsdp_ep_dots", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"], "expert": ["model"]}),
         "--remat", "dots"]),
    ],
    # worst-fraction cell: SSD resharding + f32 intermediates
    "mamba2-2.7b:prefill_32k": [
        ("fsdp", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"]})]),
        ("fsdp_q64", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"]}),
         "--config-overrides", json.dumps({"ssm_chunk": 64})]),
        ("fsdp_q256", ["--overrides", json.dumps(
            {"heads": [], "kv_heads": [], "mlp": [], "vocab": [],
             "embed": ["data", "model"]}),
         "--config-overrides", json.dumps({"ssm_chunk": 256})]),
    ],
    # memory-bound hybrid train cell: SSD chunk trade-off
    "zamba2-7b:train_4k": [
        ("ssmq64", ["--config-overrides", json.dumps({"ssm_chunk": 64})]),
    ],
    # memory-bound decode cell: cache traffic
    "qwen2.5-32b:decode_32k": [
        ("cacheseq_dm", ["--overrides", json.dumps(
            {"cache_seq": ["model"], "batch": ["pod", "data"]})]),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", action="append", default=[],
                    help="arch:shape[:mesh] (default mesh=single)")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    cells = args.cell or (list(CANDIDATES) if args.all else [])
    for cell in cells:
        parts = cell.split(":")
        arch, shape = parts[0], parts[1]
        mesh = parts[2] if len(parts) > 2 else "single"
        base = RESULTS / f"{arch}_{shape}_{mesh}.json"
        if base.exists():
            b = json.loads(base.read_text())
            if "roofline" in b:
                t = b["roofline"]
                print(f"BASE {arch}:{shape}:{mesh} "
                      f"comp={t['compute_s']:.3f} mem={t['memory_s']:.3f} "
                      f"coll={t['collective_s']:.3f} "
                      f"frac={t['roofline_fraction']:.3f}", flush=True)
        for tag, extra in CANDIDATES.get(f"{arch}:{shape}", []):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--tag", tag] + extra
            print(">>", tag, flush=True)
            subprocess.run(cmd)


if __name__ == "__main__":
    main()
