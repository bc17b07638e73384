"""Training driver: the fault-tolerant loop over the train step, the port
of the JAX package's ``launch/train.py`` (the same flags and summary).

    python -m repro_torch.launch.train --device cpu --arch qwen2.5-32b \
        --reduced --steps 30 --batch 2 --seq 64 --fail-at 12 --save-every 5
    python -m repro_torch.launch.train --arch qwen2.5-32b --reduced  # card

Runs on the card unless ``--device`` names another.  The weights come
from a ``torch.Generator`` seeded with ``--seed`` (the JAX package's
distributions, not its bits); the batches from ``data.SyntheticLM``,
the JAX package's tokens bit for bit.  A scheduled failure (``--fail-at``)
or a Bernoulli one (``--fail-p``) restores the latest checkpoint and
replays the stream from it (``runtime.fault.TrainSupervisor``).

``--mesh d,m`` trains across ranks on a (data, model) ``DeviceMesh``
with ``make_rules(mesh, "train")``: the state and each batch are placed
as ``DTensor``s (every rank draws the same full state from ``--seed`` and
reads the same batches) and the checkpoints are saved whole by the mesh's
first rank.  The process group is the one already initialized, else
torchrun's (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``),
else one rank: nccl on the card, gloo on the CPU, never torch's fake
backend.  d · m must equal the world size.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --mesh 2,2 --arch qwen2.5-32b --reduced --steps 30 --batch 4
    python -m repro_torch.launch.train --mesh 1,1 --arch qwen2.5-32b --reduced

Every rank takes the same steps (the failure injector is seeded alike);
rank 0 prints the summary, a JSON line, and every rank returns it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import SyntheticLM, make_batch_iterator
from ..device import resolve_device
from ..models import build_model
from ..optim import AdamW, linear_warmup_cosine
from ..runtime import init_train_state, make_rules, make_train_step
from ..runtime.fault import FailureInjector, TrainSupervisor
from ..runtime.train_step import shard_batch, shard_train_state
from .mesh import make_mesh_shape


def _on_device(it, dev, rules=None):
    """The pipeline's (step, numpy batch) pairs with the batch on ``dev``
    (token ids as int64), placed by ``rules`` when it has a mesh."""
    for step, batch in it:
        batch = {k: torch.as_tensor(v, device=dev).long()
                 if np.issubdtype(v.dtype, np.integer)
                 else torch.as_tensor(v, device=dev)
                 for k, v in batch.items()}
        yield step, batch if rules is None else shard_batch(batch, rules)


def _start_group(dev) -> bool:
    """A real process group for ``--mesh``: the one initialized already,
    else torchrun's environment, else one rank; nccl for the card, gloo
    for the CPU.  Returns whether this call started it."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)  # env://
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b",
                    help="a registered arch (configs.get_config)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", default="none",
                    choices=("full", "dots", "none"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", type=float, default=0.0,
                    help="top-k gradient compression ratio (0 = off)")
    ap.add_argument("--fail-p", type=float, default=0.0)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--mesh", default="", help="e.g. '1,1' => data,model")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)

    rules = mesh = None
    started = False
    if args.mesh:
        import torch.distributed as dist
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dev = torch.device("cuda", torch.cuda.current_device())
        started = _start_group(dev)
        sizes = tuple(int(x) for x in args.mesh.split(","))
        if math.prod(sizes) != dist.get_world_size():
            raise ValueError(f"--mesh {args.mesh}: {math.prod(sizes)} ranks, "
                             f"and the process group has "
                             f"{dist.get_world_size()}")
        mesh = make_mesh_shape(sizes, ("data", "model")[:len(sizes)])
        rules = make_rules(mesh, "train")

    opt = AdamW(lr=linear_warmup_cosine(args.lr, 10, args.steps))
    step_fn = make_train_step(model, opt, rules=rules, remat=args.remat,
                              microbatches=args.microbatches,
                              compress_ratio=args.compress or None)
    state = init_train_state(model, torch.Generator(dev).manual_seed(
        args.seed), opt, compress=args.compress > 0)
    if rules is not None:
        state = shard_train_state(state, model, rules)

    ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                     global_batch=args.batch, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, mesh=mesh)
    injector = FailureInjector(p_fail=args.fail_p, seed=args.seed,
                               scheduled=tuple(args.fail_at))
    sup = TrainSupervisor(step_fn, ckpt, injector,
                          save_every=args.save_every)

    losses = []

    def on_metrics(step, metrics):
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 10 == 0 and (mesh is None
                               or torch.distributed.get_rank() == 0):
            print(f"step {step:5d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f}", flush=True)

    t0 = time.time()
    state, final_step = sup.run(
        state,
        make_iterator=lambda s: _on_device(
            make_batch_iterator(ds, start_step=s), dev, rules),
        total_steps=args.steps, on_metrics=on_metrics)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    summary = {
        "arch": cfg.name, "steps": final_step, "wall_s": round(wall, 1),
        "first_loss": losses[0] if losses else None,
        "last_loss": float(np.mean(losses[-10:])) if losses else None,
        "restarts": sup.restarts, "lost_steps": sup.lost_steps,
        "straggler_slow_steps": sup.straggler.slow_steps,
    }
    if mesh is None or torch.distributed.get_rank() == 0:
        print(json.dumps(summary))
    if started:
        torch.distributed.destroy_process_group()
    return summary


if __name__ == "__main__":
    main()
