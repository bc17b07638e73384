"""What AdamW's gradient norm costs on a sharded step: one reduction for
each distinct placements of the leaves' sums of squares (the optimizer's
way) against one reduction a leaf, on the card's machine.

    python3 tools/sharded_norm_probe.py [--steps 4]

FULL Mamba2-2.7B, bf16, one 2 × 2048-token ``SyntheticLM`` batch, remat
"full", through ``make_train_step(rules=make_rules(mesh, "train"))`` with
the state and the batch as ``DTensor``s on a one-rank NCCL group and the
(1, 1) (data, model) mesh (the card holds one NCCL rank), as
``chip_smoke.py`` phase (m) runs it.  Prints the all-reduces of one step
each way (``CommDebugMode``), then ms a step each way, alternating, the
median of ``--steps`` steps each after one warm-up step each, and the
card's name and power limit.  Run from the root of a checkout; needs the
card.  Prints one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEVICE = "cuda"  # a rehearsal on the CPU sets "cpu": gloo in place of nccl


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.dtensor import is_dtensor
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, adamw
    from repro_torch.runtime import TrainState, make_rules, make_train_step
    from repro_torch.runtime.train_step import shard_batch, shard_train_state

    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "card": card}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh_shape((1, 1), ("data", "model"))
        rules = make_rules(mesh, "train")
        cfg = get_config("mamba2-2.7b")
        model = build_model(cfg)
        params = model.init(torch.Generator(dev).manual_seed(42),
                            trainable=True)
        opt = AdamW(lr=1e-4)
        state = shard_train_state(
            TrainState(params=params, opt=opt.init(params), err=None),
            model, rules)
        del params
        torch.cuda.empty_cache()
        tokens = SyntheticLM(vocab=cfg.vocab, seq_len=2048, global_batch=2,
                             seed=42).batch(0)["tokens"]
        batch = shard_batch(
            {"tokens": torch.as_tensor(tokens, device=dev).long()}, rules)
        step = make_train_step(model, opt, rules=rules, remat="full")

        def per_leaf(xs):
            return [x.full_tensor() if is_dtensor(x) else x for x in xs]
        ways = {"grouped": (), "per_leaf": (
            mock.patch.object(adamw, "_full_scalars", per_leaf),)}

        def run(way, comm=None):
            nonlocal state
            for p in ways[way]:
                p.start()
            try:
                sync()
                t0 = time.perf_counter()
                if comm is None:
                    state, _ = step(state, batch)
                else:
                    with comm:
                        state, _ = step(state, batch)
                sync()
                return (time.perf_counter() - t0) * 1e3
            finally:
                for p in ways[way]:
                    p.stop()

        reduces = {}
        for way in ways:  # the warm-up steps, counted
            comm = CommDebugMode()
            run(way, comm)
            reduces[way] = sum(n for op, n in comm.get_comm_counts().items()
                               if "all_reduce" in str(op))
        out["all_reduces_a_step"] = reduces
        out["leaves"] = len(dict(state.params.named_parameters()))
        print(f"all-reduces a step: {json.dumps(reduces)} over "
              f"{out['leaves']} parameter leaves", flush=True)
        ms = {way: [] for way in ways}
        names = list(ways)
        for i in range(args.steps):
            for way in (names if i % 2 == 0 else names[::-1]):
                ms[way].append(run(way))
        out["mamba2_sharded_step_ms"] = {w: statistics.median(v)
                                         for w, v in ms.items()}
        out["mamba2_sharded_step_ms_each"] = ms
        print(f"mamba2-2.7b sharded step ms ({card}): {json.dumps(ms)}",
              flush=True)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
