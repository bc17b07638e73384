"""Prefill and decode times of the serving path from a given source tree,
so that two trees can be compared in one call on the card.

    python3 tools/serve_ab_probe.py --src SRC [--reps 3] [--archs A ...]

SRC is the ``src`` directory of a checkout (this one's is ``src``); the
script imports ``repro_torch`` from there, so run it once a tree and
alternate the trees (A, B, B, A).  For each arch, at ``chip_smoke.py``'s
serving shapes (bf16, random weights from a seed, batch 4, prompt 2048 +
32 tokens; whisper-medium's decoder prompt 416 over 1500 frame
embeddings; deepseek-v3-671b at 4 layers): one warm-up prefill and
decode, then ``--reps`` times one prefill (ms) and 31 decode steps (ms a
token), and their medians.  Needs the card.  Prints the card's name and
power limit, and one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

B, S, GEN, WHISPER_S, SEED = 4, 2048, 32, 416, 0
LAYERS = {"deepseek-v3-671b": 4}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--archs", nargs="*", default=[
        "mamba2-2.7b", "gemma-7b", "deepseek-v3-671b", "whisper-medium"])
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import make_decode_step, make_prefill_step

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out = {"src": args.src, "package": repro_torch.__file__, "card": card,
           "prefill_ms": {}, "decode_ms": {}}
    print(f"repro_torch from {repro_torch.__file__}; {card}", flush=True)
    for arch in args.archs:
        cfg = get_config(arch)
        if arch in LAYERS:
            cfg = cfg.replace(n_layers=LAYERS[arch])
        S_ = WHISPER_S if cfg.family == "encdec" else S
        model = build_model(cfg)
        params = model.init(torch.Generator(dev).manual_seed(SEED))
        batch = {"tokens": torch.as_tensor(np.random.default_rng(
            SEED).integers(0, cfg.vocab, (B, S_)), device=dev)}
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.randn(
                (B, cfg.enc_len, cfg.d_model), device=dev,
                generator=torch.Generator(dev).manual_seed(SEED + 1))
        prefill, decode = make_prefill_step(model), make_decode_step(model)

        def once():
            cache = model.alloc_cache(B, S_ + GEN, dev)
            sync()
            t0 = time.perf_counter()
            logits, cache = prefill(params, batch, cache=cache)
            sync()
            p_ms = (time.perf_counter() - t0) * 1e3
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            sync()
            t0 = time.perf_counter()
            for i in range(GEN - 1):
                nxt, _, cache = decode(params, {
                    "token": tok, "cache": cache,
                    "pos": torch.full((B,), S_ + i, device=dev)})
                tok = nxt[:, None]
            sync()
            d_ms = (time.perf_counter() - t0) * 1e3 / (GEN - 1)
            del cache
            return p_ms, d_ms

        once()  # warm-up
        runs = [once() for _ in range(args.reps)]
        p = out["prefill_ms"][arch] = statistics.median(r[0] for r in runs)
        d = out["decode_ms"][arch] = statistics.median(r[1] for r in runs)
        print(f"{arch} ({cfg.n_layers} layers): prefill {p:.1f} ms, decode "
              f"{d:.2f} ms a token (medians of {args.reps}: "
              f"{[(round(a, 1), round(b, 2)) for a, b in runs]})",
              flush=True)
        del model, params, batch
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
