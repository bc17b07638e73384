"""Serving from the command line: batched prefill + greedy decode of a
reduced config of any arch of the registry (zamba2-7b, mamba2-2.7b,
gemma-7b, gemma3-27b, qwen1.5-32b, qwen2.5-32b, dbrx-132b,
deepseek-v3-671b, qwen2-vl-72b, whisper-medium).

    python -m repro_torch.launch.serve --device cpu [--arch gemma3-27b]
    python -m repro_torch.launch.serve --arch deepseek-v3-671b \
        --batch 4 --prompt-len 48 --gen 16    # examples/serve_batched.py's

Runs on the card unless ``--device`` names another; prompts are drawn with
numpy under ``--seed``, and the weights from a ``torch.Generator`` seeded
with it.  qwen2-vl's patch embeddings (positions 0.. on all three M-RoPE
streams) and whisper's frame embeddings are drawn from a second generator
seeded with ``--seed`` + 1: the distributions of the JAX package's
``launch/serve.py``, not its bits.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..runtime import greedy_generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b",
                    help="a registered arch (configs.get_config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed + 1)
    B = args.batch
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, args.prompt_len)), device=dev)}
    g = torch.Generator(dev).manual_seed(args.seed + 1)
    extra = 0
    if cfg.family == "vlm":
        extra = cfg.n_vision_tokens
        batch["patch_embeds"] = torch.randn((B, extra, cfg.d_model),
                                            generator=g, device=dev)
        stot = extra + args.prompt_len
        batch["positions"] = torch.arange(stot, device=dev).expand(3, B,
                                                                   stot)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((B, cfg.enc_len, cfg.d_model),
                                          generator=g, device=dev)

    s_max = args.prompt_len + extra + args.gen + 1
    t0 = time.perf_counter()
    out = greedy_generate(model, params, batch, steps=args.gen, s_max=s_max)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    toks = out.numel()
    summary = {"arch": cfg.name, "device": str(dev), "generated": toks,
               "tokens_per_s": round(toks / wall, 1),
               "wall_s": round(wall, 2), "out_shape": list(out.shape)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
