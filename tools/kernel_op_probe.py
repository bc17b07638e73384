"""What the ``torch.library`` operators in front of K6 and K7 cost, and what
the dry run's depth fit saves, on the card's machine.

    python3 tools/kernel_op_probe.py [--calls 200] [--reps 7] [--steps 4]
                                     [--no-fit]

1. Host microseconds a call, the operator (``torch.ops.repro_torch.*``,
   what the wrappers call) against a direct call of the same Python
   implementation, on the same preallocated tensors: K6's forward at
   whisper-medium's cross-attention decode shape (the one decode path
   that reaches an operator, 24 calls a token) and K7's scan at
   Mamba2-2.7B's training shape.  ``--calls`` calls are enqueued between
   two host clock reads after a synchronize; the median of ``--reps``
   such spans, the two ways alternating.
2. FULL Mamba2-2.7B, bf16, one 2 × 2049-token ``SyntheticLM`` batch,
   remat "full": ms a training step through the operators and with the
   wrappers calling the implementations directly, alternating, the
   median of ``--steps`` steps each after one warm-up step each.
3. Unless ``--no-fit``: host seconds of the dry run's cost trace of a
   FULL train_4k cell on the multi-pod mesh (512 ranks of the fake
   process group) at full depth, against the 2–3 reduced-depth traces
   of ``cost_model`` and their solve, and whether the two counts agree;
   qwen2.5-32b, deepseek-v3-671b and qwen2-vl-72b.

Run from the root of a checkout; needs the card.  Prints one JSON line
last.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parents[1]


def host_us(fns, calls, reps, sync):
    """{name: median host µs a call} of ``fns`` {name: thunk}, enqueued
    ``calls`` at a time, the names alternating in each rep."""
    got = {name: [] for name in fns}
    for fn in fns.values():  # warm-up
        fn()
    sync()
    for rep in range(reps):
        order = list(fns.items())
        if rep % 2:
            order.reverse()
        for name, fn in order:
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            got[name].append((time.perf_counter() - t0) / calls * 1e6)
            sync()
    return {name: statistics.median(v) for name, v in got.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--no-fit", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainState, make_train_step

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    g = torch.Generator(dev).manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0)}

    # 1. the operator against a direct call
    B, Sk, H, hd = 4, 1500, 16, 64
    q = torch.randn(B, 1, H, hd, device=dev, generator=g,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(B, Sk, H, hd, device=dev, generator=g,
                        dtype=torch.bfloat16) for _ in range(2))
    o = torch.empty_like(q)
    fa_args = (q, k, v, o, None, hd, hd, hd ** -0.5, False, 0, 1024)
    cfg_m = get_config("mamba2-2.7b")
    Bm, S, N, P = 2, 2048, cfg_m.ssm_state, cfg_m.ssm_head_dim
    Hm = cfg_m.ssm_expand * cfg_m.d_model // P
    Q = cfg_m.ssm_chunk
    x = torch.randn(Bm, S, Hm, P, device=dev, generator=g)
    dt = torch.rand(Bm, S, Hm, device=dev, generator=g) * 0.1
    A = -torch.rand(Hm, device=dev, generator=g)
    Bs, Cs = (torch.randn(Bm, S, N, device=dev, generator=g)
              for _ in range(2))
    n_chunks, Qp = -(-S // Q), -(-Q // 16) * 16
    ssd_args = (x, dt, A, Bs, Cs, torch.empty_like(x),
                torch.empty(Bm, Hm, N, P, device=dev),
                torch.empty(Bm, Hm, n_chunks, N, P, device=dev),
                torch.empty(Bm, Hm, n_chunks, Qp, 2, device=dev), Q)
    calls = {
        "k6_decode_operator": lambda: fa._fwd_op(*fa_args),
        "k6_decode_direct": lambda: fa._fwd_impl(*fa_args),
        "k6_decode_wrapper": lambda: fa.flash_attention(
            q, k, v, scale=hd ** -0.5),
        "k7_train_operator": lambda: ssd._scan_op(*ssd_args),
        "k7_train_direct": lambda: ssd._scan_impl(*ssd_args),
    }
    us = host_us(calls, args.calls, args.reps, sync)
    out["host_us_a_call"] = us
    for kern in ("k6_decode", "k7_train"):
        out[f"{kern}_overhead_us"] = us[f"{kern}_operator"] - \
            us[f"{kern}_direct"]
    print(f"host us a call (median of {args.reps} spans of {args.calls} "
          f"calls): {json.dumps(us)}", flush=True)
    del q, k, v, o, fa_args, x, dt, A, Bs, Cs, ssd_args
    torch.cuda.empty_cache()

    # 2. the Mamba2-2.7B training step both ways
    model = build_model(cfg_m)
    params = model.init(torch.Generator(dev).manual_seed(42), trainable=True)
    opt = AdamW(lr=1e-4)
    state = TrainState(params=params, opt=opt.init(params), err=None)
    step = make_train_step(model, opt, remat="full")
    tokens = SyntheticLM(vocab=cfg_m.vocab, seq_len=2048, global_batch=2,
                         seed=42).batch(0)["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device=dev).long()}
    direct = (mock.patch.object(ssd, "_scan_op", ssd._scan_impl),
              mock.patch.object(ssd, "_bwd_op", ssd._bwd_impl))

    def timed(way):
        nonlocal state
        for p in direct if way == "direct" else ():
            p.start()
        try:
            sync()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            sync()
            return (time.perf_counter() - t0) * 1e3
        finally:
            for p in direct if way == "direct" else ():
                p.stop()

    ways = ("operator", "direct")
    for way in ways:
        timed(way)
    ms = {way: [] for way in ways}
    for i in range(args.steps):
        for way in (ways if i % 2 == 0 else ways[::-1]):
            ms[way].append(timed(way))
    out["mamba2_step_ms"] = {w: statistics.median(v) for w, v in ms.items()}
    out["mamba2_step_ms_each"] = ms
    print(f"mamba2-2.7b step ms: {json.dumps(ms)}", flush=True)
    del model, params, opt, state, step, batch
    torch.cuda.empty_cache()

    # 3. the depth fit against a full-depth cost trace
    if not args.no_fit:
        from repro_torch.launch import dryrun
        from repro_torch.launch.cost_model import cost_variants, solve_costs
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.runtime.sharding import make_rules
        mesh = make_production_mesh(multi_pod=True)
        rules = make_rules(mesh, "train")
        shape = SHAPES["train_4k"]
        fit = {}
        for arch in ("qwen2.5-32b", "deepseek-v3-671b", "qwen2-vl-72b"):
            cfg = get_config(arch)
            try:
                t0 = time.perf_counter()
                variants, solve = cost_variants(cfg, shape.seq_len, "train")
                solved = solve_costs(
                    [dryrun.step_cost(build_model(c), shape, rules,
                                      n_devices=512) for c in variants],
                    solve)
                fit_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                full = dryrun.step_cost(build_model(cfg), shape, rules,
                                        n_devices=512)
                full_s = time.perf_counter() - t0
                fit[arch] = {"layers": cfg.n_layers, "fit_s": fit_s,
                             "full_depth_s": full_s,
                             "flops_equal": solved["flops"] == full["flops"],
                             "bytes_equal": (solved["bytes accessed"]
                                             == full["bytes accessed"])}
            except Exception as e:  # noqa: BLE001 — reported
                fit[arch] = {"error": f"{type(e).__name__}: {e}"[:300]}
            print(f"{arch}: {json.dumps(fit[arch])}", flush=True)
        out["cost_trace"] = fit
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
