"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``repro_torch`` from
``src/``).  Phases, each asserted; any failure exits non-zero:

1. build the port's seven CUDA libraries (budgeted DP, the three flash
   attention kernels — bf16 on wgmma, f32 in split TF32, and the f32-FMA
   referee —, SSD scan, and the attention and SSD backward kernels), one
   nvcc each, all started together (timed); print ptxas's registers and
   spills for every kernel, and fail if a budgeted-DP, SSD (forward or
   backward) or TF32 attention kernel (forward or backward), or the wgmma
   attention at D = 192 or 256, spills;
2. each kernel against its plain PyTorch version on the card, bitwise
   (tolerance 0): the whole-plane forward and the epilogue on the paper's
   Table-2 instance at B = 1, 7 and 64 with random ``allowed`` masks, one
   case whose DP sums reach [2^24, 2^29), and the fig-6 c_hi = 4
   instance (a 160 KB plane); the whole-plane forward alone on its other
   cell layouts (the largest plane the gate admits, one resource of
   C = 101 — threads that own no cell, small offsets —, C = 216 and
   C = 1331); the epilogue, both instances (the default packing and a
   forward in three segments with its (word row, bit) table), at E = 1, 5,
   6, 31, 32, 33, 64 and 65 with walks that clamp at 0, on tied scores
   and with no feasible budget; the per-edge and fused forwards on planes
   over one block's shared memory — fig-6 c_hi = 6 at T = 1500 and
   ``benchmarks/dp_bench.py``'s E16_C512_S4096 problem — and on its
   E40_K3 shape (chunks across the 32-bit word boundary), at B = 1, 7 and
   64 under the auto tiling and forced tilings (the per-edge one at B = 1,
   its launches chained and one at a time), and the epilogue on each
   plane; the fused forward is one cooperative launch per chunk;
3. the tiling choice: fig-6 c_hi = 6 goes to the fused forward, a forced
   whole-plane solve of it raises, c_hi = 5 switches from the whole plane
   at T = 1500 to tiles at T = 2000;
4. the main paths, each with the kernels' launch counts set to 0 just
   before and read just after: ESDP ``simulate`` (T = 2000) and
   ``simulate_batch`` (B = 64) on Table 2 (whole-plane forward, T
   launches each); the same at fig-6 c_hi = 6, T = 1500 (fused forward,
   ⌈E/block_e⌉·T launches, no whole-plane launch), with the card's
   per-slot x of ``simulate`` and of ``simulate_batch`` rows 0, 1 and 63
   equal to the CPU int32 reference on the same draws and schedule in
   each of the 1500 slots (the reference runs in a worker process that
   sees no card, started with the run's draws and read at the end, so it
   overlaps the card's phases); ESDP at c_hi = 5, T = 1500 and T = 2000
   (the switch-over),
   and the first 200 slots of ESDP on the whole-plane fig-6 planes
   (c_hi = 4 at T = 2000, c_hi = 5 at T = 1500) against the CPU
   reference;
   the solver registry without u_max on the c_hi = 6 plane at B = 1,
   which takes the per-edge forward; HSWF/LCF/LWTF with the quickstart's
   ASW lines;
   the dispatch path: ``sched.ClusterSim`` on ``examples/
   dispatch_cluster.py``'s fleet (E 15, C 216, S 201 at T = 800, pod-b
   browned out) for ESDP cold, ``incremental="cache"`` and ``"warm"``,
   HSWF, LCF and LWTF, each with its launch counts (cold: one whole-plane
   forward and one epilogue a slot; cache: forwards = misses; warm:
   forwards = segments launched, one tabled epilogue a solve, each run
   under ``torch.cuda.set_sync_debug_mode("error")``, so that a
   synchronising read in it fails; baselines:
   none) and its per-slot x and solve_stats equal to the same run on the
   CPU, then ``run_batch`` over 8 seeds (one K2 forward a slot, each seed
   equal to its own ``run()``); warm_tiled: ``WarmCudaSolver`` over 50
   solves of an ESDP trajectory on the fig-6 c_hi = 6 plane, each equal
   to the cold solve, ``dp_chunk`` launches = segments launched, every
   tabled epilogue call under the sync check, and the device ms of a warm
   solve against a cold one;
   the scenario paths (``experiments/``): (a) ``launch.scenario_sweep``'s
   part 1 through ``run_spec`` — every regime × (ESDP g = ln t, HSWF
   ties unbroken), Table 2, seeds (0, 1, 2), T = 500 (cut from the
   example's 1000 to bound the run's time) but for ``power_coupled`` at
   T = 1000, each ESDP run one K2 forward and one epilogue a slot, HSWF
   none; (b) its severity grid (T = 1000),
   ``chronic_straggler`` at five straggler speeds × three seeds as ONE
   batch of 15 runs: T forwards and T epilogues, not 5T, its first point
   equal to its own ``simulate_batch``; (c) ESDP on the card against the
   CPU int32 reference under ``power_coupled`` and ``server_failures``
   (Table 2, T = 300, B = 3, the same draws, replayed traces and
   schedule): x and the running means v̂ equal every slot, ``addcmul``'s
   single rounding of μ·speed − cost equal on 65,536 entries, each regime
   stepped on the card within 1e-6 of the CPU's; (d) the fig-6 c_hi = 4
   and 6 grid under ``markov_dvfs`` through ``run_spec`` (T = 1500, two
   seeds: K2 and K5); (e) ``ClusterSim(scenario="power_coupled")`` on the
   dispatch configuration, equal to its CPU run, and ``server_failures``
   failure-aware with its ledger conserved; (f) ``ClusterSim(fallback=
   True)``: no degradation on the card, served by ``cuda`` every call, x
   equal to the plain run's; at fault rate 0.2 the failures counted, x
   unchanged and K1 launched once for each cuda attempt that launched;
   the slot times of these paths beside the plain ones;
   (g) the streaming engine (``sched.DispatchEngine``) on the dispatch
   configuration, T = 800: ESDP alone and A/B (ESDP 0.9 / HSWF 0.1),
   ``run(mode="stream")`` and ``"lockstep"`` bitwise equal, ``run_batch``
   over 8 seeds each equal to its seed's run, the stream loop and
   ``run_batch`` under ``torch.cuda.set_sync_debug_mode("error")``, one
   K1 (K2 in ``run_batch``) and one epilogue a slot and none for HSWF;
   each backpressure policy at queue capacity 1 under triple arrivals
   (only its own channel fires, the ledger conserved); a failure run
   (p_crash 0.1, 2-way redundancy) with a ``CachedSolver`` (per-variant
   ledgers conserved, its scoped counters, K1 = misses); the card and
   the CPU (``reference`` solver) bitwise equal at T = 200; the ms a
   slot of each mode and, from one profiled A/B stream run, the
   launches a slot and the device's idle share;
5. the attention kernels (K6) against their plain version on the card:
   the six shapes of ``tests/test_kernels.py:28-58`` in f32 (the split-TF32
   kernel, tolerance 2e-5) and bf16 (the wgmma kernel, 2e-2: the plain
   version rounds q·k and p to bf16, the kernels do not), the Zamba2-7B
   and dbrx-132b (GQA 48:8) serving shapes in bf16, a ragged GQA Sq < Sk
   case in both, whisper-medium's bidirectional shapes in both (16 heads
   of 64 over 1500 frames, from 1, 416 and 1500 queries), qwen2-vl-72b's
   prefill (GQA 64:8, 3072 positions) in bf16, and bf16 at
   hd 136, 192, 200 and 256 (ragged GQA Sq < Sk and windowed cases among
   them); each case's distance from the plain version run in f64 printed
   beside the CUDA-core referee's (launched raw), and each bf16 case no
   farther from it than 1.25 times the referee; the
   SSD kernels (K7) against their plain version on
   the four shapes of ``tests/test_kernels.py:66-71``, the serving shape
   on three seeds and Mamba2-2.7B's heads (N = 128) on four seeds and at
   the serving length, all f32: each held to the plain version run in
   f64, within 1e-4 or twice the f32 plain version's own distance from
   it (at Q = 128 f32 itself is ~1e-4 off), each distance over its limit
   printed and the largest for each N; attention_vh: a v head dim other
   than q/k's at deepseek-v3's widths (q/k 192, v 128) and at q/k 64, v
   32, bf16, one wgmma launch each, within 2e-2 of the plain version;
6. the serving path: FULL Zamba2-7B (5.7 B parameters, 81 layers) in
   bf16, initialised on the card from a seed, ``greedy_generate`` of 32
   tokens after a 2048-token prompt at batch 4, with every launch count
   set to 0 just before and read just after — 13 tensor-core
   flash-attention and 68 SSD launches for the prefill, none for the
   decode steps — then the
   prefill and the decode timed apart, each with its counts; the
   kernels' prefill logits against the plain versions' on the same
   weights and tokens, in f32 (relative L2 ≤ 1e-3; the f32 prefill goes
   through the split-TF32 attention kernel, 13 launches) and in bf16 (no
   further from the f32 plain logits than the bf16 plain ones, within
   50%); (h) the same for FULL Mamba2-2.7B (64 SSD launches a prefill),
   FULL gemma-7b (28 wgmma attention launches, D = 256) and gemma3-27b
   at full width with 6 of its 62 layers (one 5 local : 1 global cycle;
   6 launches, D = 128, GQA 32:16, window 1024 on the local layers),
   each with its prefill and decode ms and its logits check; (i) the
   same for the moe family at full width, dbrx-132b with 4 of its 40
   layers (4 wgmma attention launches, GQA 48:8, D = 128; 16 experts
   top-4) and deepseek-v3-671b with 3 dense + 1 moe of its 61 layers
   (4 launches of MLA attention at D = 192, v zero-padded from 128;
   256 experts top-8 + 1 shared), each also with two bf16 prefills
   bitwise equal (the combine has no atomics) and, per moe layer, the
   routed-expert and kept-token indices that differ between the
   kernels' and the plain versions' runs, in bf16 and in f32; (j) the
   same for qwen2-vl-72b at full width with 8 of its 80 layers (1024
   patch embeddings before the 2048-token prompt at Qwen2-VL's grid
   positions on three M-RoPE streams; 8 wgmma attention launches, GQA
   64:8, D = 128) and FULL whisper-medium (1500 frame embeddings, a
   416-token decoder prompt: 24 encoder, 24 self- and 24
   cross-attention launches a prefill, D = 64, and 24 cross-attention
   launches a decode token, whose f32 decode step is held to the plain
   versions' too), each with the peak memory and whisper's encoder ms;
   (k) training, with no fallback to the plain versions: the attention
   backward kernel (``flash_attention_bwd``) against its plain version
   and the plain version run in f64 at qwen2.5-32b's, gemma-7b's (D 256),
   gemma3-27b's local (window 1024), whisper's encoder and cross
   (1500 × 1500, 448 × 1500), deepseek-v3's MLA (q/k 192, v 128) shapes
   in bf16 and Zamba2's (D 112), qwen2.5-32b's (GQA 40:8, D 128) and the
   tiny-100m milestone's (B 16 × 256, 8:4, D 64) in f32 (the split-TF32
   route) — bf16 no farther from the f64
   backward than 1.5 × the bf16 plain version + 2e-3, f32 than 2 × the
   f32 plain version + 1e-5 — with the forward's log-sum-exp leaving its
   output's bits alone; the SSD backward (``ssd_bwd``) the same way at
   Mamba2-2.7B's (S 2049: S % Q = 1; and its training shape, S 2048
   with no final-state gradient) and Zamba2-7B's shapes; both bitwise
   equal over two runs; every gradient leaf of the attention layers
   (qwen2.5-32b, 4 layers) and of the Mamba2 mixers (Mamba2-2.7B, 16
   layers) at full width in f32, through the kernels, within 1e-3
   (‖Δg‖₂ / ‖g‖₂) of the same leaf through the plain versions, with a
   planted fault (dK or dB zeroed) that must land outside that limit;
   qwen2.5-32b at full width with 4 of its
   64 layers and FULL Mamba2-2.7B through ``make_train_step`` in bf16,
   5 AdamW steps on one 2 × 2049-token ``SyntheticLM`` batch under remat
   "full", the loss falling, each step's launches counted (2 forward and
   1 backward a layer), the first step's loss and gradient norm within
   1e-3 (relative) of the same step through the plain versions, and the
   planted fault's gradient norm outside it, the step ms and the peak
   memory; one more step of each under ``torch.profiler``, its ten device
   operations with the most total time printed; ``launch.train`` on the
   reduced qwen2.5-32b with a failure at step 12, one restart from its
   checkpoint, and its launches counted; the training milestone,
   ``examples/train_tiny_lm.py``'s "tiny-100m" config registered by name
   at run time, its parameters counted on the meta device, then
   ``launch.train`` with the example's flags (300 steps at batch 16 ×
   256, a failure at step 120, a checkpoint every 50) in f32: one
   restart, the last loss no more than 0.02 over the JAX package's own
   ratio on those flags (0.7564 of the first: the example's 0.7 is missed
   by JAX too, and printed), 8 split-TF32 forward
   and 8 backward attention launches a step run, the driver's ms a step,
   its peak memory, then its step alone (ms, and one profiled step's
   device idle share);
   (m) execution across ranks on a one-rank NCCL group and the (1, 1)
   (data, model) mesh (one card holds one NCCL rank; several ranks run
   on the CPU's gloo in the tests): (m1) qwen2.5-32b (4 layers) and (m2)
   FULL Mamba2-2.7B steps through ``make_train_step(rules=make_rules(
   mesh, "train"))`` with the parameters, moments and batch as
   ``DTensor``s on the card, from (k)'s initial weights on (k)'s batch:
   (k)'s launches a step, each step's loss and gradient norm within (k)'s
   1e-3 of (k)'s same step, bitwise equality printed (the first aten op
   whose output differs named where it fails), the ms a step beside
   (k)'s; (m3) ``launch.train --mesh 1,1`` on (k)'s reduced run, its
   steps, restarts, lost steps, losses and launches equal to (k)'s run
   without the mesh; (m4) ``runtime.pp.gpipe`` with one stage on CUDA
   tensors bitwise equal to the stage applied in turn;
   (n) serving across ranks on (m)'s group and mesh, before (m) ends it:
   ``greedy_generate(rules=make_rules(mesh, preset))`` with the
   parameters placed as ``DTensor``s by the rules, the cache by the rules
   from ``model.cache_spec``, against the same run unsharded in the
   phase: (n1) FULL whisper-medium under ``decode`` on (j)'s weights and
   inputs (batch 4, 1500 frames, prompt 416, 8 tokens, s_max 424), (n2)
   FULL Mamba2-2.7B under ``long`` at batch 1 (prompt 2048, 4 tokens,
   s_max 2052); each run's tokens and every step's logits bitwise equal
   to the unsharded run's (the first aten op whose output differs named
   where they are not), its K6 launches (72 a prefill, 24 a decode token)
   and K7 launches (64 a prefill) equal to the unsharded run's, and the
   prefill ms and ms a decode token beside the unsharded ones (the
   sharded run twice: its first prefill and decode pay DTensor's sharding
   propagation);
7. kernel and plain-version times at the main paths' shapes: each
   kernel's device time per launch from a ``torch.profiler`` trace of
   many launches of its C entry point, summed over the kernels one call
   launches (K7's three, each one's share printed; the mean of the
   events the trace holds where it holds fewer than were launched, the
   shortfall printed; CUDA events around the same back-to-back launches,
   divided by their number, where the trace has no device time or one
   below the bound or over 1.1 times the events'), beside the least time
   the card could take and, for
   attention, ``scaled_dot_product_attention``'s time on the same inputs
   (a yardstick only: the port never calls it; the backend it takes is
   printed); attention at the Zamba2-7B shape in bf16 (wgmma) and f32
   (split TF32, its bound three TF32 products per f32 product, the f32-FMA
   bound beside it), and in bf16 at gemma-7b's (hd 256), gemma3-27b's
   local layers' (GQA 32:16, hd 128, window 1024; SDPA with the window as
   a boolean mask), dbrx-132b's (GQA 48:8, hd 128) and deepseek-v3's MLA
   (q/k 192, v 128, zero-padded to 192) attention, each at batch 4 ×
   2048 with its launches from (h) or (i), qwen2-vl-72b's (GQA 64:8 over
   3072 positions) and whisper-medium's four (the encoder, the decoder's
   self-attention, cross-attention in prefill and in decode, Sq = 1) with
   their launches from (j), with the CUDA-core referee's
   time at the f32, gemma and MLA shapes; K7 at the Zamba2-7B and the Mamba2-2.7B shapes; the
   attention backward at qwen2.5-32b's training shape beside torch
   autograd of ``scaled_dot_product_attention`` (its backward alone), in
   bf16 and in f32 (the split-TF32 route, beside the CUDA-core referee it
   replaced, launched raw, which it must beat; the bound three TF32
   products a product), and the SSD backward at Mamba2-2.7B's; and
   the
   whole-plane forward's tiled sweep on the fig-6 c_hi = 4 and 5 planes
   at B = 1 and 64 with each cell layout forced (one capacity column a
   thread, the launcher's pick there, against a column a cell), both held
   bitwise to the plain version; the dispatch path's kernels at its
   plane (the whole-plane forward at B = 1 and 8, the epilogue's tabled
   instance, and its default one held bitwise there) and ``dp_chunk`` on
   one warm segment of 8 edges; the epilogue's walk at B = 1 on the
   Table-2 plane cut to 0, 1, 9, 17, 25 and 33 edges (its cost an edge);
   the per-edge pipeline's span a solve (its words' zero fill and 31
   ``dp_edge`` launches, between CUDA events), issued by the host loop and
   queued behind a sleeping kernel, chained and one launch at a time;
   beside the bounds of the epilogue's two rows and K3's, an empty
   kernel's device time on the row's grid and block, the floor no launch
   beats.

Last, the fig-6 c_hi = 6 run's 1500 slots against the CPU reference
that ran alongside (phase 4).  The line before the last is the JSON
kernel table; the last line is
``{"ok": true, "device": {...}}``.  Without a GPU, or outside a checkout,
it exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

HERE = pathlib.Path(__file__).resolve().parent
T = 2000
T6 = 1500  # the paper's Fig.-6 horizon (benchmarks/sensitivity.py)
FLEET = 64
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT32_OPS_PER_S = 67e12  # the card's non-tensor 32-bit rate (FP32 table)
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores
TF32_OPS_PER_S = 495e12  # dense TF32 on the tensor cores
# int32 operations per plane cell and edge of a forward: the budget shift
# (sub, max), the capacity shift (sub), the mask (two compares, and), the
# add, the take > V compare, the max and the bit OR
FWD_OPS_PER_CELL = 10
SOURCE = "src/repro_torch/kernels/budgeted_dp/csrc/budgeted_dp.cu"
TPU = "src/repro/kernels/budgeted_dp/"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FAW_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_wgmma.cu")
FAT_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_tf32.cu")
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
FAB_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd.cu")
SSB_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu"
# warm_tiled: solves WARM_FROM .. WARM_FROM + N_WARM of an ESDP run on the
# fig-6 c_hi = 6 plane, re-solved in segments of WARM_K edges
WARM_FROM, N_WARM, WARM_K = 1000, 50, 8
# the Zamba2-7B serving shape (configs/zamba2_7b.py FULL)
SERVE_B, SERVE_S, SERVE_GEN = 4, 2048, 32
WHISPER_S = 416  # whisper's decoder prompt: + SERVE_GEN = its 448 positions


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)


M_STEPS = 3  # phase (m)'s sharded steps a model
# phase (n): (arch, preset, batch rows, prompt, generated tokens)
N_RUNS = (("whisper-medium", "decode", SERVE_B, WHISPER_S, 8),
          ("mamba2-2.7b", "long", 1, SERVE_S, 4))


def first_difference(run_plain, run_sharded):
    """The first aten operation whose output differs between two runs of
    one computation — the plain one and the one on ``DTensor``s over a
    one-rank mesh, whose local operations are the plain run's — as "name
    (its k-th call)", or None.  Each run is a callable; every floating
    output tensor of its own (a ``DTensor``'s local one; not a view, not
    an uninitialised allocation) is summarised by its shape and f64 sum,
    and the k-th calls of each operation are compared in the plain run's
    order."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def local(t):  # a DTensor by its local tensor: the whole one on one rank
        return t._local_tensor if isinstance(t, DTensor) else t

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {local(a).untyped_storage().data_ptr()
                   for a in tree_leaves((args, kwargs))
                   if isinstance(local(a), torch.Tensor)
                   and not local(a).is_meta}
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                # outputs of their own: not views of an input, nor
                # uninitialised allocations, nor the fake tensors of
                # DTensor's sharding propagation
                t = local(t)
                if isinstance(t, torch.Tensor) and not isinstance(
                        t, FakeTensor) and not t.is_meta \
                        and t.is_floating_point() \
                        and "empty" not in str(func) \
                        and t.untyped_storage().data_ptr() not in ins:
                    self.seen.append((str(func), tuple(t.shape),
                                      float(t.detach().double().sum())))
            return out

    traces = []
    for run in (run_plain, run_sharded):
        with Record() as rec:
            run()
        by_op = {}
        for name, shape, digest in rec.seen:
            by_op.setdefault(name, []).append((shape, digest))
        traces.append((rec.seen, by_op))
    (plain_seen, plain_ops), (_, sharded_ops) = traces
    count = {}
    for name, shape, digest in plain_seen:
        k = count[name] = count.get(name, -1) + 1
        other = sharded_ops.get(name, [])
        if k >= len(other) or other[k] != (shape, digest):
            return f"{name} (its call {k})"
    return None


def execution_across_ranks(
    dev,
    train_steps,
    train_ms,
    k_launch,
    step_limit,
    train_batch,
    reset,
    read_counts,
    expect,
    serve=None,
):
    """Phase (m): the sharded path on a one-rank NCCL group; see the
    module docstring.  ``train_steps``/``train_ms``/``k_launch``: phase
    (k)'s losses and norms, ms a step and ``launch.train`` run.
    ``serve(mesh)``, when given, runs last on the group (phase (n))."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainState, make_rules, make_train_step
    from repro_torch.runtime.pp import gpipe
    from repro_torch.runtime.train_step import shard_batch, shard_train_state

    t0 = phase("(m) execution across ranks: a one-rank NCCL group, the (1, 1)"
               " (data, model) mesh on the card")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh_shape((1, 1), ("data", "model"))
        rules = make_rules(mesh, "train")
        print(f"   backend {dist.get_backend()}, mesh {mesh}, device type "
              f"{mesh.device_type}", flush=True)
        if mesh.device_type != "cuda":
            fail(f"the mesh over nccl has device type {mesh.device_type}")
        done(t0)
        for arch, n_layers, per_step in (
                ("qwen2.5-32b", 4, {"flash_attention_wgmma": 8,
                                    "flash_attention_bwd": 4}),
                ("mamba2-2.7b", 0, {"ssd_scan": 128, "ssd_bwd": 64})):
            cfg = get_config(arch)
            if n_layers:
                cfg = dataclasses.replace(cfg, n_layers=n_layers)
            t0 = phase(f"(m) execution across ranks: {arch} "
                       f"({cfg.n_layers} layers, full width), bf16, "
                       f"{M_STEPS} sharded AdamW steps from (k)'s weights "
                       "on (k)'s batch, remat full")
            model = build_model(cfg)
            params = model.init(torch.Generator(dev).manual_seed(SEED),
                                trainable=True)
            opt = AdamW(lr=1e-4)  # (k)'s TRAIN_LR
            state = shard_train_state(
                TrainState(params=params, opt=opt.init(params), err=None),
                model, rules)
            del params
            torch.cuda.empty_cache()
            batch = shard_batch(train_batch(cfg), rules)
            step = make_train_step(model, opt, rules=rules, remat="full")
            losses, gnorms, step_ms = [], [], []
            reset()
            for _ in range(M_STEPS):
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - w0) * 1e3)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            counts = read_counts()
            k_losses, k_gnorms = (x[:M_STEPS] for x in train_steps[arch])
            gaps = [max(abs(a - b) / abs(b), abs(c - d) / abs(d))
                    for a, b, c, d in zip(losses, k_losses, gnorms, k_gnorms)]
            bitwise = losses == k_losses and gnorms == k_gnorms
            ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
            k_ms = train_ms[arch][0]
            print(f"   launches over {M_STEPS} steps {counts}; losses "
                  f"{losses} ((k): {k_losses}); gradient norms {gnorms} ((k):"
                  f" {k_gnorms}); largest relative gap {max(gaps):.3g} (limit"
                  f" {step_limit:g}); bitwise equal to (k): {bitwise}",
                  flush=True)
            print(f"   ms a step {[round(x, 1) for x in step_ms]}, median of "
                  f"steps 2-{M_STEPS} {ms:.1f} against (k)'s {k_ms:.1f}: "
                  f"{ms - k_ms:+.1f} ms of DTensor's host work a step",
                  flush=True)
            if not bitwise:
                # name the first operation whose output differs, on one
                # forward of the loss from fresh weights of both kinds
                params = model.init(torch.Generator(dev).manual_seed(SEED))
                plain_batch = train_batch(cfg)
                sh = shard_train_state(TrainState(params=model.init(
                    torch.Generator(dev).manual_seed(SEED)), opt=None,
                    err=None), model, rules).params
                from repro_torch.runtime.sharding import replicating
                with torch.no_grad():
                    def sharded():
                        with replicating(rules):
                            model.loss(sh, batch, rules=rules, remat="none")
                    where = first_difference(
                        lambda: model.loss(params, plain_batch,
                                           remat="none"), sharded)
                print(f"   the first operation whose output differs: {where}",
                      flush=True)
                del params, sh
            want = {k: n * M_STEPS for k, n in per_step.items()}
            if not expect(counts, **want):
                fail(f"(m) {arch}: the sharded steps launched {counts}, "
                     f"expected {want}")
            if not (max(gaps) <= step_limit and all(map(np.isfinite, losses))):
                fail(f"(m) {arch}: the sharded steps' losses {losses} / norms "
                     f"{gnorms} differ from (k)'s {k_losses} / {k_gnorms}")
            del model, state, batch, step, m
            torch.cuda.empty_cache()
            done(t0)

        t0 = phase("(m) execution across ranks: launch.train --mesh 1,1 on "
                   "(k)'s reduced qwen2.5-32b run (30 steps, a failure at "
                   "step 12, a checkpoint every 5)")
        with tempfile.TemporaryDirectory() as ckdir:
            reset()
            summary = train_mod.main([
                "--arch", "qwen2.5-32b", "--reduced", "--steps", "30",
                "--batch", "2", "--seq", "64", "--fail-at", "12",
                "--save-every", "5", "--ckpt-dir", ckdir, "--mesh", "1,1"])
            torch.cuda.synchronize()
            counts = read_counts()
        k_summary, k_counts = k_launch
        keys = ("steps", "restarts", "lost_steps", "first_loss", "last_loss")
        same = all(summary[k] == k_summary[k] for k in keys)
        print(f"   summary {summary}; (k)'s without the mesh {k_summary} "
              f"(wall_s and straggler_slow_steps read the host clock); "
              f"launches {counts}, (k)'s {k_counts}", flush=True)
        if not same or counts != k_counts:
            fail(f"(m) launch.train --mesh 1,1: {summary}, {counts}; without "
                 f"the mesh {k_summary}, {k_counts}")
        done(t0)

        t0 = phase("(m) execution across ranks: gpipe with one stage on the "
                   "card against the stage applied in turn")
        stage_mesh = make_mesh_shape((1,), ("stage",))
        g = torch.Generator(dev).manual_seed(SEED)
        ws = torch.randn(1, 1024, 1024, generator=g, device=dev) * 0.03
        xs = torch.randn(8, 16, 1024, generator=g, device=dev)

        def stage(w, x):
            return torch.tanh(x @ w)
        got = gpipe(stage, ws, xs, mesh=stage_mesh, axis="stage")
        want = torch.stack([stage(ws[0], xs[i]) for i in range(8)])
        print(f"   S 1, M 8, microbatch 16 x 1024: bitwise equal "
              f"{torch.equal(got, want)}; pipelines of several stages run "
              "only on the CPU's gloo ranks (tests/test_torch_pp.py): one "
              "card cannot hold two NCCL ranks", flush=True)
        if not torch.equal(got, want):
            fail("(m) gpipe with one stage differs from the stage applied "
                 "in turn")
        done(t0)
        if serve is not None:
            serve(mesh)
    finally:
        dist.destroy_process_group()


def _timed_calls(model, calls, reset, read_counts):
    """``model`` whose prefill and decode each keep (the whole logits,
    the call's ms on the host clock between synchronisations, its
    launches) in ``calls``."""
    import torch
    from repro_torch.runtime.sharding import full

    def timed(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            reset()
            w0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - w0) * 1e3
            calls.append((full(out[0]).clone(), ms, read_counts()))
            return out
        return run
    return dataclasses.replace(model, prefill=timed(model.prefill),
                               decode=timed(model.decode))


def serving_across_ranks(mesh, dev, card, serving_batch, reset, read_counts, expect):
    """Phase (n): ``greedy_generate`` with the rules on ``mesh`` (the
    one-rank NCCL group's (1, 1) mesh) against the same run unsharded;
    see the module docstring.  ``serving_batch``: phase (h)-(j)'s inputs
    of an arch at a prompt length."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import TrainState, greedy_generate, make_rules
    from repro_torch.runtime.train_step import shard_train_state

    for arch, preset, rows, prompt, steps in N_RUNS:
        cfg = get_config(arch)
        s_max = prompt + steps
        t0 = phase(f"(n) serving across ranks: {arch} ({cfg.n_layers} layers"
                   + (f" + {cfg.n_enc_layers} encoder layers"
                      if cfg.family == "encdec" else "")
                   + f", full width), bf16, under make_rules(mesh, "
                   f"{preset!r}), batch {rows} x prompt {prompt} + {steps} "
                   f"tokens, s_max {s_max}, against the same run unsharded")
        if cfg.family == "encdec":
            per_prefill = {"flash_attention_wgmma":
                           cfg.n_enc_layers + 2 * cfg.n_layers}
            per_decode = {"flash_attention_wgmma": cfg.n_layers}
        else:
            per_prefill, per_decode = {"ssd_scan": cfg.n_layers}, {}
        model = build_model(cfg)
        batch = {k: v[:rows] for k, v in serving_batch(cfg, prompt)[0].items()}
        rules = make_rules(mesh, preset)
        # two draws of the same weights: placing a tree replaces its
        # parameters in place
        params, sharded = (model.init(torch.Generator(dev).manual_seed(SEED))
                           for _ in range(2))
        sharded = shard_train_state(
            TrainState(params=sharded, opt=None, err=None), model,
            rules).params
        runs = {}
        for label, p, r in (("unsharded", params, None),
                            ("sharded", sharded, rules),
                            ("sharded again", sharded, rules)):
            calls = []
            toks = greedy_generate(
                _timed_calls(model, calls, reset, read_counts), p, batch,
                steps, s_max, rules=r)
            runs[label] = (toks, calls)
        (u_toks, u_calls) = runs["unsharded"]
        same = all(torch.equal(runs[k][0], u_toks)
                   and all(torch.equal(a[0], b[0])
                           for a, b in zip(runs[k][1], u_calls))
                   for k in ("sharded", "sharded again"))
        counts_same = all([c[2] for c in runs[k][1]]
                          == [c[2] for c in u_calls] for k in runs)
        want_counts = expect(u_calls[0][2], **per_prefill) and all(
            expect(c[2], **per_decode) for c in u_calls[1:])

        def ms(calls):  # prefill, the median decode token
            dec = sorted(c[1] for c in calls[1:])
            return calls[0][1], dec[len(dec) // 2]
        (up, ud), (sp1, sd1), (sp, sd) = (ms(runs[k][1]) for k in (
            "unsharded", "sharded", "sharded again"))
        print(f"   tokens and every step's logits ({len(u_calls)} calls) "
              f"bitwise equal to the unsharded run's: {same}; launches a "
              f"prefill {runs['sharded'][1][0][2]}, a decode token "
              f"{runs['sharded'][1][1][2]}, equal to the unsharded run's "
              f"in every call: {counts_same}", flush=True)
        print(f"   prefill {sp:.1f} ms sharded (its first run {sp1:.1f}, "
              f"with DTensor's sharding propagation) against {up:.1f} "
              f"unsharded; decode {sd:.2f} ms a token (median; first run "
              f"{sd1:.2f}) against {ud:.2f}; {card}", flush=True)
        if not same:
            where = first_difference(
                lambda: greedy_generate(model, params, batch, steps, s_max),
                lambda: greedy_generate(model, sharded, batch, steps, s_max,
                                        rules=rules))
            fail(f"(n) {arch}: the sharded generation differs from the "
                 f"unsharded one; the first operation whose output differs: "
                 f"{where}")
        if not (counts_same and want_counts):
            fail(f"(n) {arch}: launches {[c[2] for c in u_calls]} unsharded, "
                 f"{[c[2] for c in runs['sharded'][1]]} sharded; expected "
                 f"{per_prefill} a prefill, {per_decode} a decode token")
        del model, params, sharded, runs, u_calls
        torch.cuda.empty_cache()
        done(t0)


# phase (l): the dry run's predicted peak against the measured one
# (relative), and its FLOPs against FlopCounterMode's on the real step
PLAN_PEAK_LIMIT, PLAN_FLOP_LIMIT = 0.10, 1e-6


def plan_against_card(cells, shape):
    """Phase (l): plan each training cell with the dry run's per-cell
    function on a one-device mesh and hold the plan against phase (k)'s
    measurements.  ``cells``: (arch, config, the state's bytes, the step's
    own peak bytes, the step's FlopCounterMode FLOPs, its median ms,
    whether remat "none" must predict over the peak) each.  Gates: the
    state's bytes exact; the FLOPs within ``PLAN_FLOP_LIMIT``; the peak
    within ``PLAN_PEAK_LIMIT``; a plan whose optimizer holds no AdamW
    moments below it by more than the limit; the remat-"none" plan above
    it by more than the limit where asked.  Alongside, the FULL
    multi-pod train_4k cell of qwen2.5-32b through the dry run's CLI in a
    process of its own (512 ranks of the fake process group), which must
    record no error."""
    from unittest import mock

    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.optim import AdamW, OptState

    class NoMoments(AdamW):
        """The planted fault: AdamW with its moments left out, a step of
        plain gradient descent whose state is the step count alone."""

        def init(self, params):
            return OptState(step=super().init(params).step, m={}, v={})

        def update(self, grads, state, params):
            named = dict(params.named_parameters())
            with torch.no_grad():
                for name, g in grads.items():
                    p = named[name]
                    p.copy_((p.float() - 3e-4 * g.float()).to(p.dtype))
            step = state.step + 1
            return params, OptState(step=step, m={}, v={}), \
                torch.zeros((), device=step.device)

    out = HERE / "results" / "dryrun_torch" / "qwen2.5-32b_train_4k_multi.json"
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"),
               CUDA_VISIBLE_DEVICES="")
    multi = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-32b", "--shape", "train_4k", "--mesh", "multi"],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    w_multi = time.perf_counter()
    one = make_mesh_shape((1, 1), ("data", "model"))
    gib = 2 ** 30
    try:
        for arch, cfg, state_bytes, own_peak, flops, step_ms, gate_none in cells:
            w0 = time.perf_counter()
            rec = dryrun.plan_cell(cfg, shape, one, remat="full")
            none = dryrun.plan_cell(cfg, shape, one, remat="none")
            with mock.patch.object(dryrun, "AdamW", NoMoments):
                bare = dryrun.plan_cell(cfg, shape, one, remat="full")
            plan_s = time.perf_counter() - w0
            mem, roof = rec["memory"], rec["roofline"]
            state = mem["params_bytes"] + mem["opt_state_bytes"]
            flop_gap = abs(rec["cost_global"]["flops"] - flops) / flops
            pred = mem["peak_est_bytes"]
            gap = (pred - own_peak) / own_peak
            bare_pred = bare["memory"]["peak_est_bytes"]
            planted = (bare_pred - own_peak) / own_peak
            none_gap = (none["memory"]["peak_est_bytes"] - own_peak) / own_peak
            bound_s = max(roof["compute_s"], roof["memory_s"])
            print(f"   {arch} ({cfg.n_layers} layers), {shape.global_batch} x "
                  f"{shape.seq_len + 1} tokens, remat full, one-device mesh "
                  f"(planned in {plan_s:.1f} s, all three plans; traces "
                  f"{rec['trace_s']} s + {rec['cost_traces_s']} s):",
                  flush=True)
            print(f"      state: planned {state} bytes, on the card "
                  f"{state_bytes}; FLOPs: planned {rec['cost_global']['flops']}, "
                  f"FlopCounterMode on the real step {flops} ({flop_gap:.3g} "
                  f"relative, limit {PLAN_FLOP_LIMIT:g})", flush=True)
            print(f"      peak: planned {pred / gib:.3f} GiB (argument "
                  f"{mem['argument_bytes'] / gib:.3f} + temp "
                  f"{mem['temp_bytes'] / gib:.3f}), measured {own_peak / gib:.3f}"
                  f" GiB ({100 * gap:+.2f}%, limit {100 * PLAN_PEAK_LIMIT:g}%); "
                  f"planted faults: no AdamW moments {bare_pred / gib:.3f} GiB "
                  f"({100 * planted:+.2f}%; state "
                  f"{bare['memory']['opt_state_bytes']} bytes), "
                  f"remat none {none['memory']['peak_est_bytes'] / gib:.3f} GiB "
                  f"({100 * none_gap:+.2f}%"
                  + ("" if gate_none else ", no gate") + ")", flush=True)
            print(f"      roofline on the H100 data sheet's figures: compute "
                  f"{roof['compute_s'] * 1e3:.3f} ms, memory "
                  f"{roof['memory_s'] * 1e3:.3f} ms -> {roof['bottleneck']}; "
                  f"measured step {step_ms:.1f} ms, {step_ms / 1e3 / bound_s:.2f}"
                  " x max(compute, memory)", flush=True)
            if state != state_bytes:
                fail(f"{arch}: the dry run plans {state} bytes of parameters and "
                     f"AdamW state, the card holds {state_bytes}")
            if not flop_gap <= PLAN_FLOP_LIMIT:
                fail(f"{arch}: the dry run counts {rec['cost_global']['flops']} "
                     f"FLOPs, FlopCounterMode on the real step {flops}")
            if not abs(gap) <= PLAN_PEAK_LIMIT:
                fail(f"{arch}: the planned peak {pred} bytes is {100 * gap:+.2f}% "
                     f"from the measured {own_peak}")
            if not planted < -PLAN_PEAK_LIMIT:
                fail(f"{arch}: the plan without the AdamW moments is only "
                     f"{100 * planted:+.2f}% from the measured peak: the peak "
                     "gate cannot see it")
            if gate_none and not none_gap > PLAN_PEAK_LIMIT:
                fail(f"{arch}: the remat-none plan is only {100 * none_gap:+.2f}%"
                     " from the measured peak: the peak gate cannot see it")
    except BaseException:  # a failed gate: stop the planning process too
        multi.kill()
        multi.communicate()
        raise

    try:
        stdout, stderr = multi.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        multi.kill()
        multi.communicate()
        fail("the multi-pod dry run of qwen2.5-32b train_4k ran over 600 s")
    wall = time.perf_counter() - w_multi
    rec = json.loads(out.read_text()) if out.exists() else {}
    if multi.returncode or rec.get("error") or "memory" not in rec:
        fail(f"the multi-pod dry run of qwen2.5-32b train_4k: exit "
             f"{multi.returncode}, {rec.get('error')}; "
             f"{stdout[-500:]} {stderr[-1500:]}")
    roof = rec["roofline"]
    print(f"   qwen2.5-32b FULL train_4k on the multi-pod mesh ({rec['n_devices']}"
          f" ranks, fake process group): traces {rec['trace_s']} s + "
          f"{rec['cost_traces_s']} s, {wall:.1f} s with the process (run "
          "beside the plans above); "
          f"per-device peak {rec['memory']['peak_est_bytes'] / gib:.2f} GiB "
          f"(argument {rec['memory']['argument_bytes'] / gib:.2f}); compute "
          f"{roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} s, "
          f"collective {roof['collective_s']:.4f} s -> {roof['bottleneck']}",
          flush=True)


def per_call_ms(fn, calls, reps=5):
    """Milliseconds per call of ``fn``: ``calls`` back-to-back calls between
    one pair of CUDA events, divided by ``calls``; the median of ``reps``
    such spans after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    times.sort()
    return times[len(times) // 2]


def profiled_ms(fn, calls, kernel_names, launches_per_call=1):
    """Device milliseconds per call of ``fn`` over ``calls`` calls, summed
    over the CUDA kernels whose names contain one of ``kernel_names`` (one
    call may launch several), read from a ``torch.profiler`` trace, and
    each name's share; (None, shares) when the trace holds no device time
    for them.  A long process's trace can hold fewer of a kernel's events
    than were launched: a name's time a call is then the mean of the
    events the trace holds times ``launches_per_call`` (its launches a
    call), and the shortfall is printed; ``None`` where a call's launches
    vary, which divides the trace's total by ``calls``; a dict gives each
    name its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if isinstance(kernel_names, str):
        kernel_names = (kernel_names,)
    with warnings.catch_warnings():  # its note on clearing events per cycle
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    shares = {name: 0.0 for name in kernel_names}
    events = {name: 0 for name in kernel_names}
    for evt in prof.key_averages():
        for name in kernel_names:
            if name in evt.key:
                shares[name] += getattr(
                    evt, "device_time_total",
                    getattr(evt, "cuda_time_total", 0.0)) / 1e3
                events[name] += evt.count
    for name in kernel_names:
        per = (launches_per_call.get(name, 1)
               if isinstance(launches_per_call, dict) else launches_per_call)
        if per is None or not events[name]:
            shares[name] /= calls
            continue
        if events[name] < calls * per:
            print(f"   the trace holds {events[name]} of the "
                  f"{calls * per} {name} launches: its time a call from "
                  "their mean", flush=True)
        shares[name] *= per / events[name]
    total = sum(shares.values())
    return (total if total > 0 else None), shares


def span_ms(fn, solves, queued):
    """Mean milliseconds between two CUDA events around one call of ``fn``
    on the current stream, over ``solves`` calls.  ``queued``: each call
    is held back behind a sleeping kernel while the host issues it, so the
    first event completes when the sleep ends and the span is the device's
    alone; else the span is as long as the host takes to issue the call."""
    import torch
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(solves):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        spans.append(start.elapsed_time(stop))
    return sum(spans) / len(spans)


def ptxas_report(log):
    """(kernel, registers, spill-store bytes) per entry function of an
    ``nvcc -Xptxas -v`` log; a template instance is named by its bool and
    int arguments, as ``dp_epilogue_kernel<true>`` or
    ``flash_fwd_tf32_kernel<128, 8, 64>``."""
    import re
    out, name, spilled = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled, name, end = m.group(1), m.group(1), 0
            # the kernel's name is the shortest "<length><name>" ending in
            # "_kernel" (a file's hash may run into the length's digits,
            # and a longer match then takes some of the hash with it)
            for run in re.finditer(r"\d+", mangled):
                for i in range(len(run.group())):
                    n = int(run.group()[i:])
                    cand = mangled[run.end():run.end() + n]
                    if len(cand) == n and re.fullmatch(
                            r"[a-z][a-z0-9_]*_kernel", cand) and (
                                not end or n < len(name)):
                        name, end = cand, run.end() + n
            args = []
            if end and mangled[end:end + 1] == "I":  # template arguments
                targs = mangled[end:mangled.find("Ev", end)]
                args = [{"Lb1": "true", "Lb0": "false", "If": "float",
                         "I13__nv_bfloat16": "bf16"}.get(a, a[2:])
                        for a in re.findall(
                            r"^I(?:f|13__nv_bfloat16)|L[bi]\d+(?=E)", targs)]
            name += "<" + ", ".join(args) + ">" if args else ""
            spilled = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spilled = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spilled))
            name = None
    return out


def dp_bench_problem(E, c, u_hi, B, seed=0, c_rand=None):
    """``benchmarks/dp_bench.py::_make_problem`` in numpy, with B rows of
    statistics (row 0 is dp_bench's own): ``c`` fixed, or ``c_rand =
    (K, c_hi)`` drawn.  Returns (A, c, Υ̂ (B, E), Σ̂² (B, E)) numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if c_rand is None:
        c = np.asarray(c, np.int64)
        A = rng.integers(0, 2, (c.shape[0], E))
        A[:, A.sum(axis=0) == 0] = 1  # no all-zero demand columns
    else:
        K, c_hi = c_rand
        A = rng.integers(1, 3, (K, E))
        c = rng.integers(1, c_hi + 1, K)
        A = np.minimum(A, c[:, None])
    ups = [rng.integers(0, u_hi + 1, E)]
    sig = [rng.integers(1, 5000, E)]
    for _ in range(B - 1):
        ups.append(rng.integers(0, u_hi + 1, E))
        sig.append(rng.integers(1, 5000, E))
    return (A, c, np.stack(ups).astype(np.int32),
            np.stack(sig).astype(np.int32))


def fig6_cpu_reference(conn, src, horizon, seed_rows, single, rows, schedule):
    """The fig-6 c_hi = 6 ESDP run through the CPU int32 reference, in a
    worker process that sees no card: ``simulate`` on ``single`` (one
    run's draws) and ``simulate_batch`` over ``seed_rows`` on ``rows``
    (theirs), every slot on the given schedule; the draws and schedule are
    numpy arrays (field tuples of ``Draws``, (xi, g, log1p_t)).  Sends
    (x of the single run, x of the rows, its seconds) down ``conn``, or
    the traceback of what failed."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # before torch: no card here
    w0 = time.perf_counter()
    try:
        sys.path.insert(0, src)
        import torch
        # half the host's cores: the card's phases run on the other half
        torch.set_num_threads(4)
        from repro_torch.core import (Draws, build_tables, esdp,
                                      generate_instance, simulate,
                                      simulate_batch)
        inst = generate_instance(seed=2, c_lo=1, c_hi=6)
        tables = build_tables(inst.A, inst.c)
        policy = esdp.make_esdp_policy(inst, horizon, tables=tables)
        sched = tuple(torch.from_numpy(a) for a in schedule)

        def draws(fields):
            return Draws(*(torch.from_numpy(a) for a in fields))

        one = simulate(inst, policy, horizon, tables=tables, device="cpu",
                       draws=draws(single), schedule=sched)
        batch = simulate_batch(inst, policy, horizon, seed_rows,
                               tables=tables, device="cpu",
                               draws=draws(rows), schedule=sched)
        conn.send((one.x, batch.x, time.perf_counter() - w0))
    except Exception:
        import traceback
        conn.send(traceback.format_exc())
    finally:
        conn.close()


def main():
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {HERE / 'chip_smoke.py'}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")

    from repro_torch.core import (Draws, build_tables, esdp,
                                  generate_instance, get_solver, make_draws,
                                  simulate, simulate_batch, stats)
    from repro_torch.core import baselines
    from repro_torch.core.dp import initial_plane
    from repro_torch.core.solvers import Solver
    from repro_torch.launch.dispatch import SEED as DSEED
    from repro_torch.launch.dispatch import T as TD
    from repro_torch.launch.dispatch import brownout, dispatch_instance
    from repro_torch.sched import ClusterSim
    from repro_torch.kernels.budgeted_dp import (build, kernel, ops, ref,
                                                 tiling)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nvcc, ssd

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print("kernels: dp_forward_batched (K1 _dp_kernel at B = 1, K2 "
          "_dp_kernel_batched), dp_edge (K3 _edge_tile_kernel/"
          "_edge_stile_kernel), dp_chunk (K4 _fused_chunk_kernel at B = 1, "
          "K5 _batched_fused_kernel), dp_epilogue (s* + backtrack) from "
          f"{SOURCE}; flash_attention_wgmma (K6 _flash_kernel, bf16) from "
          f"{FAW_SOURCE}; flash_attention_tf32 (K6, f32) from {FAT_SOURCE}; "
          f"the f32-FMA referee flash_fwd_kernel (no input routed to it) "
          f"from {FA_SOURCE}; ssd_scan (K7 _ssd_kernel: "
          f"{', '.join(ssd.KERNELS)}) from {SSD_SOURCE}; for training "
          f"flash_attention_bwd (new, no TPU kernel: the gradient of K6's "
          f"function; bf16: {', '.join(fa.bwd_route(torch.bfloat16)[1])} "
          f"on the tensor cores, f32: "
          f"{', '.join(fa.bwd_route(torch.float32)[1])} in split TF32 on "
          f"the tensor cores; the f32-FMA referee "
          f"{', '.join(fa.BWD_REFEREE[1][1:])}, no input routed to it) "
          f"from {FAB_SOURCE} and ssd_bwd (new: the gradient of K7's, "
          f"{', '.join(ssd.BWD_KERNELS)}, split TF32 on the tensor cores) "
          f"from {SSB_SOURCE}",
          flush=True)
    # a reference states both: f32 products in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------- build
    t0 = phase("build (one nvcc per library, all started together)")
    libraries = (build.LIBRARY, fa.WGMMA_LIBRARY, fa.TF32_LIBRARY,
                 fa.LIBRARY, ssd.LIBRARY, fa.BWD_LIBRARY, ssd.BWD_LIBRARY)
    nvcc.build_all(libraries)
    for lib in libraries:
        lib.load()
        print(f"   {lib.path().name}", flush=True)
        kernels = ptxas_report(lib.build_log())
        for name, regs, spilled in kernels:
            print(f"      {name}: {regs} registers, {spilled} bytes spilled",
                  flush=True)
        # the redesigned kernels must not spill: every DP, SSD (forward
        # and backward) and TF32 attention kernel (forward and backward),
        # and the wgmma attention at D = 192 and 256; the referees and the
        # bf16 attention backward are reported only
        gated = {fa.LIBRARY: [], fa.BWD_LIBRARY: [
            k for k in kernels if "_tf32_kernel<" in k[0]],
            fa.WGMMA_LIBRARY: [k for k in kernels
                               if k[0].endswith(("<192>", "<256>"))]}.get(
                lib, kernels)
        if (lib is not fa.LIBRARY and not gated) or any(
                sp for _, _, sp in gated):
            fail(f"{lib.source.name}: ptxas reports spills (or no report): "
                 f"{gated}")
    print(f"   built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ----------------------------------------------- kernels vs plain
    def instance(c_hi, seed):
        inst = generate_instance(seed=seed, c_lo=1, c_hi=c_hi)
        return inst, build_tables(inst.A, inst.c)

    def stats_case(inst, B, seed, horizon=T, big=False):
        """Realistic (B, E) statistics: scale_statistics at random slots,
        with some channels unexplored; ``big`` draws Σ̂² in [2^22, 2^25]."""
        rng = np.random.default_rng(seed)
        E, m = inst.n_edges, inst.m
        xi_tab, g_tab, _ = stats.schedule_table(horizon, m, device=dev)
        t = torch.as_tensor(rng.integers(0, horizon, B), device=dev)
        vhat = torch.as_tensor(rng.random((B, E)), dtype=torch.float32,
                               device=dev)
        n = torch.as_tensor(rng.integers(0, 30, (B, E)) * (
            rng.random((B, E)) < 0.9), dtype=torch.int32, device=dev)
        ups, sig, slim = stats.scale_statistics(vhat, n, xi_tab[t][:, None],
                                                g_tab[t][:, None], m)
        if big:
            sig = torch.as_tensor(rng.integers(2 ** 22, 2 ** 25, (B, E)),
                                  dtype=torch.int32, device=dev)
        alw = torch.as_tensor(rng.random((B, E)) < 0.7, device=dev)
        return ups, sig, slim[:, 0].contiguous(), alw

    def operands(tables, s_cap):
        feas, offs = ops.prepare_tables(tables)
        return (torch.as_tensor(feas, device=dev),
                torch.as_tensor(offs, device=dev),
                initial_plane(s_cap, tables.n_states, dev))

    worst = {k: 0 for k in kernel.LAUNCHES}

    def max_err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    def epilogue_err(V, W, ups, offs, slim, full, rows=None, bits=None, want=None):
        """Largest |kernel − plain| of the epilogue through the wrapper,
        against ``ref.dp_epilogue_ref`` on the card."""
        if want is None:
            want = ref.dp_epilogue_ref(V, W, ups, offs, slim, full, rows,
                                       bits)
        got = kernel.dp_epilogue(V, W, ups, offs, slim, full, rows, bits)
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(got, want))
        worst["dp_epilogue"] = max(worst["dp_epilogue"], err)
        return err

    def compare(label, inst, tables, B, seed, big=False):
        s_cap = stats.s_cap_for_horizon(T, inst.m)
        feas, offs, v0 = operands(tables, s_cap)
        ups, sig, slim, alw = stats_case(inst, B, seed, big=big)
        alw_i = alw.to(torch.int32)
        Vk, Wk = kernel.dp_forward_batched(ups, sig, alw_i, feas, offs, v0)
        Vp, Wp = ref.dp_forward_ref(ups, sig, alw_i, feas, offs, v0)
        ep = ref.dp_epilogue_ref(Vp, Wp, ups, offs, slim, tables.full_state)
        torch.cuda.synchronize()
        err_f = max(max_err(Vk, Vp), max_err(Wk, Wp))
        err_e = epilogue_err(Vk, Wk, ups, offs, slim, tables.full_state,
                             want=ep)
        worst["dp_forward_batched"] = max(worst["dp_forward_batched"], err_f)
        top = int(ep[2].max())
        print(f"   {label}: S={s_cap + 1} C={tables.n_states} "
              f"E={inst.n_edges} B={B} max value {top} "
              f"max |kernel - plain| {max(err_f, err_e)}", flush=True)
        if max(err_f, err_e) != 0:
            fail(f"{label}: kernel differs from its plain version")
        return top

    t0 = phase("whole-plane kernels vs plain versions on the card (bitwise)")
    table2, tables2 = instance(2, 0)
    for B in (1, 7, FLEET):
        compare(f"table2 B={B}", table2, tables2, B, seed=B)
    top = compare("table2 sums in [2^24, 2^29)", table2, tables2, 7, seed=5,
                  big=True)
    if not 2 ** 24 <= top < 2 ** 29:
        fail(f"large-value case reached {top}, not [2^24, 2^29)")
    fig6, tables6 = instance(4, 2)
    S6 = stats.s_cap_for_horizon(T, fig6.m) + 1
    print(f"   fig6 c_hi=4 plane: "
          f"{tiling.whole_plane_smem_bytes(S6, tables6.n_states)} bytes of "
          "shared memory", flush=True)
    for B in (1, 7):
        compare(f"fig6 c_hi=4 B={B}", fig6, tables6, B, seed=10 + B)
    # the forward's other cell layouts: the largest plane the gate admits
    # and one resource of C = 101 (the tiled sweep, one capacity column a
    # thread; at C = 101, 14 threads own no cell and offsets are small),
    # and capacity axes too wide or too awkward for one column a thread (a
    # column a cell)
    rng_w = np.random.default_rng(3)
    for label, A_w, c_w, S_w in (
            ("largest plane (Table 2)", table2.A, table2.c,
             tiling.SMEM_LIMIT_BYTES // 4 // tables2.n_states),
            ("C=101 (one resource)", rng_w.integers(1, 6, (1, 20)), (100,),
             200),
            ("C=216", rng_w.integers(1, 3, (3, 20)), (5, 5, 5), 250),
            ("C=1331", rng_w.integers(1, 4, (3, 12)), (10, 10, 10), 43)):
        tables_w = build_tables(np.asarray(A_w), np.asarray(c_w))
        feas, offs, v0 = operands(tables_w, S_w - 1)
        E_w = offs.shape[0]
        for B in (1, 7):
            ups = torch.as_tensor(rng_w.integers(0, S_w // 8 + 1, (B, E_w)),
                                  dtype=torch.int32, device=dev)
            sig = torch.as_tensor(rng_w.integers(0, 2 ** 20, (B, E_w)),
                                  dtype=torch.int32, device=dev)
            alw = torch.as_tensor(rng_w.random((B, E_w)) < 0.7,
                                  device=dev).int()
            Vk, Wk = kernel.dp_forward_batched(ups, sig, alw, feas, offs, v0)
            Vp, Wp = ref.dp_forward_ref(ups, sig, alw, feas, offs, v0)
            torch.cuda.synchronize()
            err = max(max_err(Vk, Vp), max_err(Wk, Wp))
            worst["dp_forward_batched"] = max(worst["dp_forward_batched"],
                                              err)
            print(f"   {label}: S={S_w} C={tables_w.n_states} E={E_w} B={B} "
                  f"({tiling.whole_plane_smem_bytes(S_w, tables_w.n_states)}"
                  f" bytes) max |kernel - plain| {err}", flush=True)
            if err != 0:
                fail(f"{label} B={B}: kernel differs from its plain version")
    done(t0)

    # the epilogue where its look-ahead window makes a walk risky: E
    # around the window (5 edges) and the 32-edge word (Υ̂ up to s_cap + 1 and
    # small budgets, so walks take edges above their budget: the clamp at
    # 0), two budgets tied on the score (0 + √9 = 1 + √4) and no feasible
    # budget (s_limit = −1); each on the default packing and on a forward
    # in three segments with the (word row, bit) table
    def epilogue_case(case, tabled):
        if case == "ties":
            E_, B, s_cap_ = 33, 2, 3
            A_, c_ = np.ones((1, E_), np.int64), np.array([1])
            u_ = np.zeros((B, E_), np.int32)
            g_ = np.tile(np.arange(1, E_ + 1, dtype=np.int32), (B, 1))
            u_[:, E_ - 2], g_[:, E_ - 2], g_[:, E_ - 1] = 1, 4, 9
            a_ = np.zeros((B, E_), bool)
            a_[:, E_ - 2:] = True
            l_ = np.full(B, s_cap_, np.int32)
        else:
            E_ = 33 if case == "no_feasible" else case
            B, s_cap_ = 7, 12
            rng_c = np.random.default_rng(E_)
            c_ = rng_c.integers(1, 5, 2)
            A_ = np.minimum(rng_c.integers(1, 3, (2, E_)), c_[:, None])
            u_ = rng_c.integers(0, s_cap_ + 2, (B, E_)).astype(np.int32)
            g_ = rng_c.integers(1, 5000, (B, E_)).astype(np.int32)
            a_ = rng_c.random((B, E_)) < 0.7
            l_ = (np.full(B, -1, np.int32) if case == "no_feasible"
                  else rng_c.integers(1, s_cap_ // 2, B).astype(np.int32))
        tables_c = build_tables(A_, c_)
        feas_c, offs_c, v0_c = operands(tables_c, s_cap_)
        u_, g_, a_, l_ = (torch.as_tensor(x, device=dev) for x in (
            u_, g_, a_.astype(np.int32), l_))
        if not tabled:
            V_, W_ = kernel.dp_forward_batched(u_, g_, a_, feas_c, offs_c,
                                               v0_c)
            return V_, W_, u_, offs_c, l_, tables_c.full_state, None, None
        k_ = -(-E_ // 3)
        bounds = [(max(E_ - (si + 1) * k_, 0), E_ - si * k_)
                  for si in range(-(-E_ // k_))]
        rows_c, bits_c, w_off = (np.zeros(E_, np.int32),
                                 np.zeros(E_, np.int32), 0)
        planes_c, packs = [], []
        for lo, hi in bounds:
            rows_c[lo:hi] = w_off + np.arange(hi - lo) // 32
            bits_c[lo:hi] = np.arange(hi - lo) % 32
            w_off += -(-(hi - lo) // 32)
        for b in range(B):
            vin_c, ws = v0_c, []
            for lo, hi in bounds:
                V_, W_ = kernel.dp_forward_batched(
                    *(x[b:b + 1, lo:hi].contiguous() for x in (u_, g_, a_)),
                    feas_c[lo:hi].contiguous(), offs_c[lo:hi].contiguous(),
                    vin_c)
                vin_c = V_[0]
                ws.append(W_)
            planes_c.append(vin_c)
            packs.append(torch.cat(ws, dim=1))
        r_, b_ = kernel.epilogue_table(rows_c, bits_c, dev)
        return (torch.stack(planes_c), torch.cat(packs), u_, offs_c, l_,
                tables_c.full_state, r_, b_)

    t0 = phase("the epilogue (both instances) vs its plain version "
               "(bitwise) on risky walks")
    for case in (1, 5, 6, 31, 32, 33, 64, 65, "ties", "no_feasible"):
        errs = []
        for tabled in (False, True):
            V_, W_, u_, o_, l_, full_, r_, b_ = epilogue_case(case, tabled)
            want_c = ref.dp_epilogue_ref(V_, W_, u_, o_, l_, full_, r_, b_)
            if case == "ties" and not (
                    (want_c[1] == 0).all() and int(want_c[2][0, 0]) == 9
                    and int(want_c[2][0, 1]) == 4):
                fail(f"the tie case has no tie: s* {want_c[1].tolist()}")
            errs.append(epilogue_err(V_, W_, u_, o_, l_, full_, r_, b_,
                                     want=want_c))
        label = f"E={case}" if isinstance(case, int) else f"{case} (E=33)"
        print(f"   {label}, B={u_.shape[0]}: max |kernel - plain| default "
              f"{errs[0]}, tabled {errs[1]}", flush=True)
        if max(errs) != 0:
            fail(f"epilogue case {case}: kernel differs from its plain "
                 "version")
    done(t0)

    # the tiled planes: (label, tables, s_cap, u_max, stats maker)
    big6, big6_tables = instance(6, 2)
    s_cap6 = stats.s_cap_for_horizon(T6, big6.m)
    u_max6 = stats.u_max_for_horizon(T6, big6.m)

    def fig6_stats(B, seed):
        ups, sig, _, alw = stats_case(big6, B, seed, horizon=T6)
        return ups, sig, alw

    def bench_stats(E, c, u_hi, c_rand=None):
        def make(B, seed):
            _, _, ups, sig = dp_bench_problem(E, c, u_hi, B, c_rand=c_rand)
            alw = np.random.default_rng(seed).random((B, E)) < 0.7
            return (torch.as_tensor(ups, device=dev),
                    torch.as_tensor(sig, device=dev),
                    torch.as_tensor(alw, device=dev))
        return make

    A16, c16, _, _ = dp_bench_problem(16, (7, 7, 7), 3, 1)
    A40, c40, u40, _ = dp_bench_problem(40, None, 6, 1, c_rand=(3, 2))
    t16, t40 = build_tables(A16, c16), build_tables(A40, c40)
    # u_max: the bound of the drawn Υ̂ (dp_bench's max + 1 for one row)
    planes = [
        ("fig6 c_hi=6 T=1500", big6_tables, s_cap6, u_max6, fig6_stats),
        ("E16_C512_S4096", t16, 4095, 3 + 1, bench_stats(16, (7, 7, 7), 3)),
        ("E40_K3", t40, int(u40.sum()), 6 + 1,
         bench_stats(40, None, 6, c_rand=(3, 2))),
    ]

    def up8(n):
        return -(-n // 8) * 8

    def forced_tilings(tables, u_max, off_max, E):
        """(name, block_e, block_s, block_c, B list) of one plane."""
        C = tables.n_states
        c_tile = -(-off_max // 32) * 32  # several C tiles where it can
        c_tile = c_tile if c_tile < C else off_max
        both = (1, 7, FLEET)
        if E > 32:  # the word-boundary shape: every chunk length over it
            return [("fused full-height, one C tile, e=7", 7, None, C, both),
                    ("fused 2-D e=5", 5, up8(u_max), off_max, both),
                    ("fused 2-D e=32", 32, up8(u_max), c_tile, both)]
        return [
            ("per-edge, chained launches (its grid has no tiles)", None,
             None, C, (1,)),
            ("per-edge, one launch at a time", "unchained", None, C, (1,)),
            ("fused 2-D e=1", 1, up8(u_max), c_tile, both),
            ("fused 2-D e=7", 7, up8(u_max), c_tile, both),
            ("fused 2-D e=32", 32, up8(u_max), off_max, both),
        ]

    t0 = phase("tiled kernels vs plain versions on the card (bitwise)")
    for label, tables, s_cap, u_max, make_stats in planes:
        feas, offs, v0 = operands(tables, s_cap)
        off_max = int(offs.max())
        S, C = s_cap + 1, tables.n_states
        E = offs.shape[0]
        auto = tiling.choose_tiling(S, C, E, u_max, off_max)
        cases = forced_tilings(tables, u_max, off_max, E)
        if auto[2] is not None:
            cases = [("auto", *auto, (1, 7, FLEET))] + cases
        print(f"   {label}: S={S} C={C} E={E} u_max={u_max} "
              f"off_max={off_max} whole plane "
              f"{tiling.whole_plane_smem_bytes(S, C)} bytes, auto {auto}",
              flush=True)
        for B in (1, 7, FLEET):
            ups, sig, alw = make_stats(B, 100 + B)
            alw_i = alw.to(torch.int32)
            Vp, Wp = ref.dp_forward_ref(ups, sig, alw_i, feas, offs, v0)
            slim = torch.as_tensor(np.random.default_rng(B).integers(
                0, S, B), dtype=torch.int32, device=dev)
            err = epilogue_err(Vp, Wp, ups, offs, slim, tables.full_state)
            print(f"      B={B} epilogue on the plain forward's plane: max "
                  f"|kernel - plain| {err}", flush=True)
            if err != 0:
                fail(f"{label} B={B}: the epilogue differs from its plain "
                     "version")
            for name, be, bs, bc, batches in cases:
                if B not in batches:
                    continue
                w0 = time.perf_counter()
                if be == "unchained":  # each dp_edge launch on its own
                    W = torch.zeros_like(Wp)
                    bufs = [torch.empty_like(Vp) for _ in range(2)]
                    V = v0
                    for n, e in enumerate(range(E - 1, -1, -1)):
                        V, W = kernel.dp_edge(V, bufs[n % 2], W, ups, sig,
                                              alw_i, feas, offs, e)
                    key = "dp_edge"
                elif be is None:  # chained launches
                    V, W = kernel.dp_forward_blocked(ups, sig, alw_i, feas,
                                                     offs, v0)
                    key = "dp_edge"
                else:
                    V, W = kernel.dp_forward_fused(
                        ups, sig, alw_i, feas, offs, v0, block_e=be,
                        u_max=u_max, off_max=off_max, block_s=bs,
                        block_c=bc)
                    key = "dp_chunk"
                torch.cuda.synchronize()
                err = max(max_err(V, Vp), max_err(W, Wp))
                worst[key] = max(worst[key], err)
                print(f"      B={B} {name} (block_e={be}, block_s={bs}, "
                      f"block_c={bc}): max |kernel - plain| {err} "
                      f"({(time.perf_counter() - w0) * 1e3:.1f} ms)",
                      flush=True)
                if err != 0:
                    fail(f"{label} B={B} {name}: kernel differs from its "
                         "plain version")
            del Vp, Wp
    done(t0)

    t0 = phase("tiling choice")
    E6 = big6.n_edges
    off_max6 = int(ops.prepare_tables(big6_tables)[1].max())
    auto6 = tiling.choose_tiling(s_cap6 + 1, big6_tables.n_states, E6,
                                 u_max6, off_max6)
    if auto6[0] is None or auto6[0] < E6:
        fail(f"fig6 c_hi=6 auto tiling {auto6} is not one fused chunk")
    try:
        ops.solve_budgeted_dp_batched(
            torch.zeros((1, E6), dtype=torch.int32, device=dev),
            torch.ones((1, E6), dtype=torch.int32, device=dev), big6_tables,
            s_cap6, s_cap6, u_max=u_max6, block_c=None)
    except ValueError as err:
        print(f"   fig6 c_hi=6 ({s_cap6 + 1} x {big6_tables.n_states}): auto "
              f"{auto6}; forced block_c=None raises ValueError: "
              f"{str(err)[:60]}...", flush=True)
    else:
        fail("a forced whole-plane solve of the fig6 c_hi=6 plane did not "
             "raise")
    fig5, tables5 = instance(5, 2)
    for horizon, whole in ((1500, True), (2000, False)):
        S5 = stats.s_cap_for_horizon(horizon, fig5.m) + 1
        got = tiling.choose_tiling(
            S5, tables5.n_states, fig5.n_edges,
            stats.u_max_for_horizon(horizon, fig5.m),
            int(ops.prepare_tables(tables5)[1].max()))
        print(f"   fig6 c_hi=5 T={horizon}: "
              f"{tiling.whole_plane_smem_bytes(S5, tables5.n_states)} bytes, "
              f"tiling {got}", flush=True)
        if (got == (None, None, None)) != whole:
            fail(f"fig6 c_hi=5 T={horizon} chose {got}")
    done(t0)

    # --------------------------------------------------------- main path
    # every kernel wrapper's count: the budgeted DP's four, K6's two, K7's
    counters = (kernel.LAUNCHES, fa.LAUNCHES, ssd.LAUNCHES)

    def reset():
        for c in counters:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counters for k, v in c.items()}

    def expect(counts, **want):
        full = {k: 0 for k in read_counts()}
        full.update(want)
        return counts == full

    def drive(label, fn, slots, **want):
        t0 = phase(label)
        reset()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        counts = read_counts()
        print(f"   launches {counts}; {wall:.2f} s, "
              f"{wall / slots * 1e3:.3f} ms per slot", flush=True)
        if not expect(counts, **want):
            fail(f"{label} launched {counts}, expected {want}")
        done(t0)
        return out, counts, wall / slots * 1e3

    policy = esdp.make_esdp_policy(table2, T, tables=tables2)
    seeds = [SEED] + list(range(1, FLEET))
    single, counts_single, _ = drive(
        f"main path: ESDP simulate, T={T}, Table 2",
        lambda: simulate(table2, policy, T, seed=SEED, tables=tables2), T,
        dp_forward_batched=T, dp_epilogue=T)
    fleet, counts_fleet, _ = drive(
        f"main path: ESDP simulate_batch, B={FLEET}, T={T}, Table 2",
        lambda: simulate_batch(table2, policy, T, seeds, tables=tables2), T,
        dp_forward_batched=T, dp_epilogue=T)

    def moved(d, fn):
        return Draws(*(fn(getattr(d, k)) for k in ("arr_u", "val_n",
                                                    "pol_u")))

    # fig-6 c_hi = 6: injected draws and schedule, so that the CPU run
    # through the int32 reference makes its decisions on the same inputs
    policy6 = esdp.make_esdp_policy(big6, T6, tables=big6_tables)
    sched6 = stats.schedule_table(T6, big6.m, device="cpu")
    per_seed = [make_draws(big6, T6, s, dev) for s in seeds]
    draws6 = Draws(*(torch.cat([getattr(d, k) for d in per_seed])
                     for k in ("arr_u", "val_n", "pol_u")))
    n_chunks6 = -(-E6 // auto6[0])
    # the CPU int32 reference of this run, all T6 slots of simulate and of
    # two simulate_batch rows (minutes of CPU), in a worker process that
    # runs alongside the card's phases; its decisions are read at the end
    import multiprocessing
    ref6_rows = [1, FLEET - 1]

    def fields(d, pick):
        return tuple(pick(getattr(d, k)).cpu().numpy()
                     for k in ("arr_u", "val_n", "pol_u"))

    ref6_conn, child_conn = multiprocessing.Pipe(duplex=False)
    ref6 = multiprocessing.get_context("spawn").Process(
        target=fig6_cpu_reference, daemon=True, args=(
            child_conn, str(HERE / "src"), T6, [seeds[i] for i in ref6_rows],
            fields(per_seed[0], lambda t: t),
            fields(draws6, lambda t: t[ref6_rows]),
            tuple(a.numpy() for a in sched6)))
    ref6.start()
    ref6_t0 = time.perf_counter()
    child_conn.close()
    single6, counts_single6, ms_single6 = drive(
        f"main path: ESDP simulate, T={T6}, fig6 c_hi=6 (tiled)",
        lambda: simulate(big6, policy6, T6, tables=big6_tables,
                         draws=per_seed[0], schedule=sched6), T6,
        dp_chunk=n_chunks6 * T6, dp_epilogue=T6)
    fleet6, counts_fleet6, ms_fleet6 = drive(
        f"main path: ESDP simulate_batch, B={FLEET}, T={T6}, fig6 c_hi=6 "
        "(tiled)",
        lambda: simulate_batch(big6, policy6, T6, seeds, tables=big6_tables,
                               draws=draws6, schedule=sched6), T6,
        dp_chunk=n_chunks6 * T6, dp_epilogue=T6)
    fig5_runs = {}
    for horizon, want in ((1500, dict(dp_forward_batched=1500,
                                      dp_epilogue=1500)),
                          (2000, dict(dp_chunk=2000, dp_epilogue=2000))):
        pol5 = esdp.make_esdp_policy(fig5, horizon, tables=tables5)
        fig5_runs[horizon] = drive(
            f"main path: ESDP simulate, T={horizon}, fig6 c_hi=5",
            lambda: simulate(fig5, pol5, horizon, seed=SEED, tables=tables5),
            horizon, **want)[0]
    n_edge_solves = 40
    ups_e, sig_e, slim_e, alw_e = stats_case(big6, n_edge_solves, 77,
                                             horizon=T6)
    cuda_solver = get_solver("cuda")
    edge_tiles = tiling.choose_tiling(s_cap6 + 1, big6_tables.n_states, E6,
                                      s_cap6 + 1, off_max6)
    if edge_tiles[0] is not None:
        fail(f"fig6 c_hi=6 without u_max chose {edge_tiles}, not the "
             "per-edge pipeline")
    _, counts_edge, _ = drive(
        f"the per-edge path: {n_edge_solves} solves through the solver "
        "registry without u_max (u_max = s_cap + 1), fig6 c_hi=6, B = 1, "
        f"tiling {edge_tiles}",
        lambda: [cuda_solver(ups_e[i], sig_e[i], big6_tables, s_cap6,
                             slim_e[i], allowed=alw_e[i])
                 for i in range(n_edge_solves)], n_edge_solves,
        dp_edge=E6 * n_edge_solves, dp_epilogue=n_edge_solves)

    t0 = phase("checks of the main paths' output")
    for name, r, shape, E in (
            ("simulate", single, (T,), table2.n_edges),
            ("simulate_batch", fleet, (FLEET, T), table2.n_edges),
            ("simulate c_hi=6", single6, (T6,), E6),
            ("simulate_batch c_hi=6", fleet6, (FLEET, T6), E6),
            ("simulate c_hi=5 T=1500", fig5_runs[1500], (1500,),
             fig5.n_edges),
            ("simulate c_hi=5 T=2000", fig5_runs[2000], (2000,),
             fig5.n_edges)):
        for field in ("sw", "sw_oracle", "regret"):
            a = getattr(r, field)
            if a.shape != shape or not np.isfinite(a).all():
                fail(f"{name}.{field}: shape {a.shape} or non-finite values")
        if r.x.shape != shape + (E,) or r.x.min() < 0 or r.x.max() > 1:
            fail(f"{name}.x has shape {r.x.shape} or values outside 0/1")
        if (r.regret < -1e-4).any() or (r.sw_oracle + 1e-4 < 0).any():
            fail(f"{name}: negative regret or oracle welfare")
    if not np.array_equal(fleet.x[0], single.x):
        fail("simulate_batch row 0 differs from simulate(seed 42) in x")
    for i in (1, 2):
        one = simulate(table2, policy, T, seed=seeds[i], tables=tables2)
        if not np.array_equal(fleet.x[i], one.x):
            fail(f"simulate_batch row {i} differs from simulate(seed "
                 f"{seeds[i]}) in x")
    print("   Table 2: simulate_batch rows 0-2 equal simulate(seed) in x",
          flush=True)
    Ts = 60
    small = esdp.make_esdp_policy(table2, Ts, tables=tables2)
    draws = make_draws(table2, Ts, 7, dev)
    # one schedule for both: the card's and the CPU's float32 log may
    # differ by an ulp, which would move a ceiling in the statistics
    sched = stats.schedule_table(Ts, table2.m, device="cpu")
    on_card = simulate(table2, small, Ts, tables=tables2, draws=draws,
                       schedule=sched)
    on_cpu = simulate(table2, small, Ts, tables=tables2, device="cpu",
                      draws=moved(draws, lambda t: t.cpu()), schedule=sched)
    if not np.array_equal(on_card.x, on_cpu.x):
        fail("ESDP on the card and the CPU reference disagree on the same "
             f"draws (Table 2, T={Ts})")
    print(f"   Table 2, T={Ts}: card (CUDA kernels) and CPU (int32 "
          "reference) ESDP make the same decisions on the same draws",
          flush=True)
    # the whole-plane forward's two cell layouts on ESDP's main path: the
    # fig-6 planes at c_hi = 4 (T = 2000) and 5 (T = 1500) take the tiled
    # sweep; the first slots of a run on the full-size plane
    Tw = 200
    for c_hi, inst_w, tables_w, horizon in ((4, fig6, tables6, T),
                                            (5, fig5, tables5, T6)):
        pol_w = esdp.make_esdp_policy(inst_w, horizon, tables=tables_w)
        S_w = stats.s_cap_for_horizon(horizon, inst_w.m) + 1
        draws_w = make_draws(inst_w, Tw, 11, dev)
        sched_w = stats.schedule_table(Tw, inst_w.m, device="cpu")
        reset()
        card_w = simulate(inst_w, pol_w, Tw, tables=tables_w, draws=draws_w,
                          schedule=sched_w)
        torch.cuda.synchronize()
        n_w = read_counts()["dp_forward_batched"]
        cpu_w = simulate(inst_w, pol_w, Tw, tables=tables_w, device="cpu",
                         draws=moved(draws_w, lambda t: t.cpu()),
                         schedule=sched_w)
        if n_w != Tw:
            fail(f"fig6 c_hi={c_hi}: {n_w} whole-plane launches in {Tw} "
                 "slots")
        if not np.array_equal(card_w.x, cpu_w.x):
            fail(f"fig6 c_hi={c_hi}, horizon {horizon}: card and CPU "
                 "reference ESDP differ on the same draws")
        print(f"   fig6 c_hi={c_hi}, horizon {horizon} ({S_w} x "
              f"{tables_w.n_states} plane, {Tw} slots, {n_w} whole-plane "
              "launches): card and CPU int32 reference ESDP make the same "
              "decisions on the same draws", flush=True)
    if not np.array_equal(fleet6.x[0], single6.x):
        fail("fig6 c_hi=6: simulate_batch row 0 differs from simulate in x")
    done(t0)

    t0 = phase(f"quickstart policies, T={T}, seed {SEED}")
    runs = {"ESDP (paper default g)": single}
    logt = esdp.make_esdp_policy(table2, T, g_fn=stats.g_logt_only,
                                 tables=tables2)
    runs["ESDP (g=ln t, Fig-8 winner)"] = simulate(table2, logt, T,
                                                   seed=SEED, tables=tables2)
    for name, make in (("HSWF", baselines.make_hswf_policy),
                       ("LCF", baselines.make_lcf_policy),
                       ("LWTF", baselines.make_lwtf_policy)):
        w0 = time.perf_counter()
        runs[name] = simulate(table2, make(table2, tiebreak=0.0), T,
                              seed=SEED, tables=tables2)
        print(f"   {name}: {(time.perf_counter() - w0) / T * 1e3:.3f} ms "
              "per slot", flush=True)
    for name, r in runs.items():
        print(f"   {name:30s} ASW={r.asw[-1]:8.1f}  "
              f"cumRegret={r.cum_regret[-1]:8.1f}  "
              f"avg|x|={r.n_dispatched.mean():.2f}", flush=True)
    best = runs["ESDP (g=ln t, Fig-8 winner)"].asw[-1]
    for b in ("HSWF", "LCF", "LWTF"):
        print(f"   ESDP improvement vs {b}: "
              f"{(best / runs[b].asw[-1] - 1) * 100:+.0f}%", flush=True)
    print(f"   fig6 c_hi=6 ESDP ASW: simulate {single6.asw[-1]:.1f}, "
          f"simulate_batch mean {fleet6.asw[:, -1].mean():.1f}", flush=True)
    done(t0)

    # ------------------------------------------------- dispatch path
    # the cluster dispatcher (sched/) on examples/dispatch_cluster.py's
    # fleet: E = 15 channels, C = 216 capacity states, S = 201 at T = 800
    # (a 174 KB whole plane), pod-b browned out in the middle third; one
    # schedule for the card and the CPU runs (their float32 log may differ
    # by an ulp)
    d_inst = dispatch_instance()
    d_speed = brownout(TD, d_inst.n_servers)
    d_sched = stats.schedule_table(TD, d_inst.m, stats.delta_default,
                                   stats.g_logt_only, "cpu")

    def dispatch_sim(device=None, **kw):
        return ClusterSim(d_inst, TD, speed_fn=d_speed, seed=DSEED,
                          device=device, schedule=d_sched, **kw)

    d_S = stats.s_cap_for_horizon(TD, d_inst.m) + 1
    d_C = build_tables(d_inst.A, d_inst.c).n_states
    t0 = phase(f"dispatch path: ClusterSim on the dispatch_cluster fleet, "
               f"T={TD}, brownout, on the card (E={d_inst.n_edges}, "
               f"C={d_C}, S={d_S}, "
               f"{tiling.whole_plane_smem_bytes(d_S, d_C)} bytes a plane)")
    modes = (("esdp cold", "esdp", {}),
             ("esdp incremental=cache", "esdp", dict(incremental="cache")),
             ("esdp incremental=warm", "esdp", dict(incremental="warm")),
             ("hswf", "hswf", {}), ("lcf", "lcf", {}), ("lwtf", "lwtf", {}))
    @contextlib.contextmanager
    def strict_tabled_epilogue():
        """Every tabled epilogue call of the warm solver runs under
        ``torch.cuda.set_sync_debug_mode("error")``: a synchronising read
        in it (the table read back from the card) raises.  Yields the
        count of such calls."""
        real, calls = ops.dp_epilogue, [0]

        def strict(*args, **kw):
            if len(args) < 8 and kw.get("word_rows") is None:
                return real(*args, **kw)
            calls[0] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        ops.dp_epilogue = strict
        try:
            with warnings.catch_warnings():  # "a prototype feature"
                warnings.simplefilter("ignore", UserWarning)
                yield calls
        finally:
            ops.dp_epilogue = real

    d_runs, d_counts = {}, {}
    for label, pol, kw in modes:
        sim = dispatch_sim(**kw)
        reset()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        with strict_tabled_epilogue() as n_strict:
            out = sim.run(pol, tiebreak=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        if kw.get("incremental") == "warm" and n_strict[0] != TD:
            fail(f"dispatch {label}: {n_strict[0]} tabled epilogue calls "
                 f"under the sync check, expected {TD}")
        counts = read_counts()
        st = out.solve_stats or {}
        if pol != "esdp":
            want = {}
        elif "incremental" not in kw:
            want = dict(dp_forward_batched=TD, dp_epilogue=TD)
        elif kw["incremental"] == "cache":
            want = dict(dp_forward_batched=st["misses"],
                        dp_epilogue=st["misses"])
        else:
            want = dict(dp_forward_batched=st["segments_launched"],
                        dp_epilogue=st["solves"])
        print(f"   {label}: ASW {out.asw:.1f}, cumRegret "
              f"{float(out.cum_regret[-1]):.1f}; "
              + (f"hit rate {st['cache_hit_rate']:.4f} ({st['hits']} hits, "
                 f"{st['misses']} misses); " if "hits" in st else "")
              + (f"edge-skip rate {st['edge_skip_rate']:.4f} "
                 f"({st['segments_launched']} segments launched, "
                 f"{st['segments_skipped']} skipped, {st['full_hits']} full "
                 "hits); " if "edge_skip_rate" in st else "")
              + f"launches {counts}; {wall / TD * 1e3:.3f} ms per slot",
              flush=True)
        if not expect(counts, **want):
            fail(f"dispatch {label} launched {counts}, expected {want}")
        d_runs[label], d_counts[label] = (out, wall / TD * 1e3), counts
    w0 = time.perf_counter()
    for label, pol, kw in modes:
        out = d_runs[label][0]
        ref_out = dispatch_sim("cpu", **kw).run(pol, tiebreak=0.0)
        if not np.array_equal(out.x, ref_out.x):
            slot = int(np.flatnonzero((out.x != ref_out.x).any(axis=1))[0])
            fail(f"dispatch {label}: the card's x differs from the CPU run's "
                 f"at slot {slot}")
        if out.solve_stats != ref_out.solve_stats:
            fail(f"dispatch {label}: solve_stats {out.solve_stats} on the "
                 f"card, {ref_out.solve_stats} on the CPU")
        if not (np.isfinite(out.sw).all() and out.x.shape == (
                TD, d_inst.n_edges)):
            fail(f"dispatch {label}: non-finite welfare or x of shape "
                 f"{out.x.shape}")
    esdp_x = d_runs["esdp cold"][0].x
    for label in ("esdp incremental=cache", "esdp incremental=warm"):
        if not np.array_equal(d_runs[label][0].x, esdp_x):
            fail(f"dispatch {label}: x differs from the cold run's")
    mid = slice(TD // 3, 2 * TD // 3)
    share = d_runs["esdp cold"][0].dispatch_share[:, 1]
    print(f"   every mode's per-slot x equals its CPU run's (plain versions, "
          f"{time.perf_counter() - w0:.1f} s on the CPU) and solve_stats "
          f"match; the incremental modes' x equal the cold run's; ESDP "
          f"pod-b share before/during/after the brownout "
          f"{share[:TD // 3].mean():.3f} / {share[mid].mean():.3f} / "
          f"{share[2 * TD // 3:].mean():.3f}", flush=True)
    d_seeds = [DSEED + i for i in range(8)]
    reset()
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    d_fleet = dispatch_sim().run_batch(d_seeds, "esdp", tiebreak=0.0)
    torch.cuda.synchronize()
    d_fleet_ms = (time.perf_counter() - w0) / TD * 1e3
    d_fleet_counts = read_counts()
    print(f"   run_batch over {len(d_seeds)} seeds: launches "
          f"{d_fleet_counts}; {d_fleet_ms:.3f} ms per slot", flush=True)
    if not expect(d_fleet_counts, dp_forward_batched=TD, dp_epilogue=TD):
        fail(f"dispatch run_batch launched {d_fleet_counts}, expected one "
             f"K2 forward and one epilogue per slot ({TD} each)")
    for s, out in zip(d_seeds, d_fleet):
        one = ClusterSim(d_inst, TD, speed_fn=d_speed, seed=s,
                         schedule=d_sched).run("esdp", tiebreak=0.0)
        if not (np.array_equal(out.x, one.x) and np.array_equal(
                out.sw, one.sw) and np.array_equal(out.regret, one.regret)):
            fail(f"dispatch run_batch: seed {s} differs from its run()")
    print("   each seed's run_batch output equals its own run()", flush=True)
    # where a cold ESDP slot's time goes: kernels by name, launches and the
    # device's idle share over the whole T = TD cold run, under the profiler
    from torch.profiler import ProfilerActivity, profile
    sim = dispatch_sim()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            sim.run("esdp", tiebreak=0.0)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
    d_kernels = sorted(
        ((getattr(e, "device_time_total", 0.0) / 1e3, e.count, e.key)
         for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
        reverse=True)
    busy = sum(ms for ms, _, _ in d_kernels)
    n_launch = sum(n for _, n, _ in d_kernels)
    print(f"   cold ESDP slot under the profiler (T={TD}, S={d_S}, all "
          f"{TD} slots): {wall / TD:.3f} ms a slot, kernels "
          f"{busy / TD:.4f} ms and {n_launch / TD:.1f} launches a slot, "
          f"device idle "
          f"{max(0.0, 1 - busy / wall) * 100:.1f}%", flush=True)
    for ms, n, key in d_kernels[:6]:
        print(f"      {ms / TD:8.4f} ms a slot {n / TD:6.1f}x  "
              f"{key[:80]}", flush=True)
    done(t0)

    # warm re-solves on the fig-6 c_hi = 6 plane (S 801, C 126: the fused
    # route): a real ESDP statistics trajectory, recorded through the
    # solver registry, replayed through WarmCudaSolver
    t0 = phase(f"warm_tiled: WarmCudaSolver on the fig6 c_hi=6 plane "
               f"({s_cap6 + 1} x {big6_tables.n_states}), {N_WARM} solves "
               "of an ESDP trajectory")
    recorded = []

    def recording(ups, sig, tables, s_cap, s_limit, allowed=None, u_max=None):
        recorded.append((ups[0].clone(), sig[0].clone(), allowed[0].clone(),
                         s_limit[0].clone()))
        return cuda_solver(ups, sig, tables, s_cap, s_limit, allowed, u_max)

    rec_policy = esdp.make_esdp_policy(
        big6, T6, tables=big6_tables,
        solver=Solver("recording", recording, accepts_batch=True))
    simulate(big6, rec_policy, WARM_FROM + N_WARM, seed=SEED,
             tables=big6_tables)
    traj = recorded[WARM_FROM:]
    del recorded[:]

    def warm_solver():
        return ops.WarmCudaSolver(big6_tables, s_cap6, u_max=u_max6,
                                  checkpoint_every=WARM_K, device=dev)

    def warm_pass(warm):
        return [warm(u, s, big6_tables, s_cap6, lim, allowed=a,
                     u_max=u_max6) for u, s, a, lim in traj]

    def cold_pass():
        return [cuda_solver(u[None], s[None], big6_tables, s_cap6, lim,
                            allowed=a[None], u_max=u_max6)
                for u, s, a, lim in traj]

    warm = warm_solver()
    reset()
    torch.cuda.synchronize()
    with strict_tabled_epilogue() as n_strict:
        warm_out = warm_pass(warm)
    torch.cuda.synchronize()
    warm_counts = read_counts()
    if n_strict[0] != N_WARM:
        fail(f"warm_tiled: {n_strict[0]} tabled epilogue calls under the "
             f"sync check, expected {N_WARM}")
    print(f"   {n_strict[0]} tabled epilogue calls ran under "
          "torch.cuda.set_sync_debug_mode('error'): none synchronised",
          flush=True)
    wst = warm.stats
    want = dict(dp_chunk=wst["segments_launched"], dp_epilogue=N_WARM)
    print(f"   stats {wst}, edge-skip rate {warm.skip_rate:.4f}; launches "
          f"{warm_counts}", flush=True)
    if not expect(warm_counts, **want):
        fail(f"warm_tiled launched {warm_counts}, expected {want}")
    for i, ((x, info), (cx, cinfo)) in enumerate(zip(warm_out, cold_pass())):
        if not (torch.equal(x, cx[0]) and int(info["s_star"]) == int(
                cinfo["s_star"][0]) and torch.equal(
                    info["value_row"], cinfo["value_row"][0])):
            fail(f"warm_tiled: solve {i} differs from the cold solve")
    w_ms, _ = profiled_ms(lambda: warm_pass(warm_solver()), 1,
                          ("dp_chunk_kernel", "dp_epilogue_kernel"), None)
    c_ms, _ = profiled_ms(cold_pass, 1,
                          ("dp_chunk_kernel", "dp_epilogue_kernel"), None)
    warm_ms = None if w_ms is None else w_ms / N_WARM
    cold_ms = None if c_ms is None else c_ms / N_WARM
    print(f"   every warm solve equals the cold solve bitwise; device ms a "
          f"solve (profiler, dp_chunk + dp_epilogue, averaged over the "
          f"{N_WARM} solves from a fresh solver): warm "
          f"{'not measured' if warm_ms is None else f'{warm_ms:.4f}'}, "
          f"cold {'not measured' if cold_ms is None else f'{cold_ms:.4f}'}",
          flush=True)
    done(t0)

    # ------------------------------------------------- scenario paths
    # the fluctuation regimes (experiments/), the sweep engine and the
    # degradation chain, each main path with the launch counts set to 0
    # just before it and read just after
    from repro_torch.core import replay_scenario
    from repro_torch.core.solvers import FallbackSolver
    from repro_torch.experiments import (GridPoint, SweepSpec, get_scenario,
                                         run_spec, scenario_names,
                                         unroll_scenario)
    from repro_torch.launch import scenario_sweep as ssw
    from repro_torch.sched import FailureModel

    def check_result(label, r, shape, E):
        for field in ("sw", "sw_oracle", "regret"):
            a = getattr(r, field)
            if a.shape != shape or not np.isfinite(a).all():
                fail(f"{label}.{field}: shape {a.shape} or non-finite values")
        if r.x.shape != shape + (E,) or r.x.min() < 0 or r.x.max() > 1:
            fail(f"{label}.x has shape {r.x.shape} or values outside 0/1")
        if (r.regret < -1e-4).any():
            fail(f"{label}: negative regret")

    def timed_run(fn):
        """(fn(), launch counts, wall seconds) with the counts set to 0
        just before."""
        reset()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, read_counts(), time.perf_counter() - w0

    # part 1 at T = 500, power_coupled at the example's T = 1000: the
    # whole sweep at T = 1000 takes 2-3 min, more than this script's time
    # limit can spare
    TS, SS = ssw.T, ssw.SEEDS
    E2 = table2.n_edges

    def sweep_T(scen):
        return TS if scen == "power_coupled" else TS // 2

    t0 = phase(f"(a) scenario sweep (launch.scenario_sweep part 1): every "
               f"regime x (ESDP g=ln t, HSWF tiebreak 0) through run_spec, "
               f"Table 2, T={TS // 2} (power_coupled {TS}), seeds {SS}")
    sweep_ms = {}
    for scen in scenario_names():
        rows, ts = {}, sweep_T(scen)
        for pname, factory in ssw.policies().items():
            (row,), counts, wall = timed_run(lambda: run_spec(
                ssw.regime_spec(scen, ts, SS, {pname: factory})))
            want = (dict(dp_forward_batched=ts, dp_epilogue=ts)
                    if pname == "esdp" else {})
            if not expect(counts, **want):
                fail(f"sweep {scen}/{pname} launched {counts}, expected "
                     f"{want}")
            check_result(f"sweep {scen}/{pname}", row.result,
                         (len(SS), ts), E2)
            rows[pname] = row
            sweep_ms[scen, pname] = wall / ts * 1e3
        print(f"   {ssw.table_line(scen, rows)}   T={ts}, slot ms: esdp "
              f"{sweep_ms[scen, 'esdp']:.3f}, hswf "
              f"{sweep_ms[scen, 'hswf']:.3f}", flush=True)
    print(f"   every ESDP run: one K2 forward (B={len(SS)}) and one epilogue "
          "a slot; HSWF: no DP launch", flush=True)
    done(t0)

    t0 = phase(f"(b) severity grid: chronic_straggler straggler_speed "
               f"{ssw.SPEEDS} x seeds {SS}, ESDP, Table 2, T={TS}, as one "
               f"batch of {len(ssw.SPEEDS) * len(SS)} runs")
    grid, counts, wall = timed_run(lambda: ssw.straggler_grid(TS, SS))
    print(f"   launches {counts}; {wall / TS * 1e3:.3f} ms per slot",
          flush=True)
    if not expect(counts, dp_forward_batched=TS, dp_epilogue=TS):
        fail(f"severity grid launched {counts}, expected one forward and "
             f"one epilogue a slot for the whole grid ({TS} each)")
    check_result("severity grid", grid, (len(ssw.SPEEDS), len(SS), TS), E2)
    grid_ms = wall / TS * 1e3
    point = simulate_batch(
        table2, esdp.make_esdp_policy(table2, TS, g_fn=stats.g_logt_only,
                                      tables=tables2), TS, SS,
        tables=tables2, scenario=get_scenario("chronic_straggler",
                                              straggler_speed=ssw.SPEEDS[0]))
    if not np.array_equal(grid.x[0], point.x):
        fail("severity grid: the straggler_speed=0.2 rows differ from its "
             "own simulate_batch")
    asw = grid.asw[..., -1]
    print("   " + ", ".join(f"{v:.1f}: ASW {m:.1f}" for v, m in zip(
        ssw.SPEEDS, asw.mean(axis=1))) + "; the 0.2 rows equal their own "
          "simulate_batch in x", flush=True)
    done(t0)

    TC, seeds_c = 300, [0, 1, 2]
    t0 = phase(f"(c) card against the CPU under power_coupled and "
               f"server_failures: ESDP, Table 2, T={TC}, B={len(seeds_c)}, "
               "the same draws, traces and schedule")
    rng_c = np.random.default_rng(19)
    mu_c, cost_c, speed_c = (torch.as_tensor(rng_c.uniform(lo, hi, 1 << 16),
                                             dtype=torch.float32)
                             for lo, hi in ((0, 1), (0, 0.5), (0.05, 1)))
    fused = [torch.addcmul(-cost_c.to(d), mu_c.to(d), speed_c.to(d)).cpu()
             for d in (dev, "cpu")]
    n_split = int((mu_c * speed_c - cost_c != fused[1]).sum())
    if not torch.equal(*fused):
        fail("addcmul on the card rounds μ·speed − cost differently from "
             "the CPU")
    print(f"   addcmul(−cost, μ, speed) on 65536 random entries: card == "
          f"CPU bitwise (a multiply then a subtract differs from it in "
          f"{n_split})", flush=True)
    sched_c = stats.schedule_table(TC, table2.m, device="cpu")
    for regime in ("power_coupled", "server_failures"):
        scn = get_scenario(regime)
        traces = [unroll_scenario(scn, TC, table2.n_servers, s,
                                  n_ports=table2.n_ports, device="cpu")
                  for s in seeds_c]
        on_card = unroll_scenario(scn, TC, table2.n_servers, seeds_c[0],
                                  n_ports=table2.n_ports)
        gap = float(np.abs(on_card[1] - traces[0][1]).max())
        if not (np.array_equal(on_card[2], traces[0][2])
                and np.array_equal(on_card[0], traces[0][0]) and gap <= 1e-6):
            fail(f"{regime}: the regime stepped on the card differs from "
                 f"the CPU's (speed gap {gap})")
        replay = replay_scenario(*(np.stack([tr[k] for tr in traces])
                                   for k in range(3)),
                                 fluctuates=scn.fluctuates)
        draws_c = Draws(*(torch.cat([getattr(make_draws(table2, TC, s, dev),
                                             k) for s in seeds_c])
                          for k in ("arr_u", "val_n", "pol_u")))
        seen = {}

        def recording_esdp(where):
            inner = esdp.make_esdp_policy(table2, TC, tables=tables2)
            seen[where] = []

            def step(state, slot, eligible, arrived, vhat, n, pol_u):
                seen[where].append(vhat.clone())
                return inner.step(state, slot, eligible, arrived, vhat, n,
                                  pol_u)
            return dataclasses.replace(inner, step=step)

        card_c, counts, _ = timed_run(lambda: simulate_batch(
            table2, recording_esdp("card"), TC, seeds_c, tables=tables2,
            scenario=replay, draws=draws_c, schedule=sched_c))
        if not expect(counts, dp_forward_batched=TC, dp_epilogue=TC):
            fail(f"{regime} card run launched {counts}")
        w0 = time.perf_counter()
        cpu_c = simulate_batch(
            table2, recording_esdp("cpu"), TC, seeds_c, tables=tables2,
            device="cpu", scenario=replay, schedule=sched_c,
            draws=moved(draws_c, lambda t: t.cpu()))
        if not np.array_equal(card_c.x, cpu_c.x):
            slot = int(np.flatnonzero((card_c.x != cpu_c.x).any(
                axis=(0, 2)))[0])
            fail(f"{regime}: the card's ESDP decisions differ from the CPU "
                 f"reference's at slot {slot + 1}")
        vk, vc = (torch.stack(seen[w]).cpu() for w in ("card", "cpu"))
        if not torch.equal(vk, vc):
            fail(f"{regime}: the running means v̂ on the card differ from "
                 "the CPU's")
        check_result(f"{regime} card", card_c, (len(seeds_c), TC), E2)
        print(f"   {regime}: launches {counts}; x and v̂ (every slot, every "
              f"run) equal the CPU int32 reference's "
              f"({time.perf_counter() - w0:.1f} s on the CPU); the regime "
              f"stepped on the card: speeds within {gap:.1e} of the CPU's",
              flush=True)
    done(t0)

    t0 = phase(f"(d) the fig-6 grid under markov_dvfs through run_spec: "
               f"c_hi 4 (whole plane) and 6 (fused), ESDP, T={T6}, seeds "
               "(11, 12)")
    spec6 = SweepSpec(name="fig6/markov_dvfs", T=T6, seeds=(11, 12),
                      policies={"esdp": esdp.esdp_factory()},
                      scenario="markov_dvfs",
                      grid=tuple(GridPoint(f"c_hi{c}", instance_kwargs={
                          "seed": 2, "c_lo": 1, "c_hi": c}) for c in (4, 6)))
    rows6, counts, wall = timed_run(lambda: run_spec(spec6))
    want = dict(dp_forward_batched=T6, dp_chunk=n_chunks6 * T6,
                dp_epilogue=2 * T6)
    print(f"   launches {counts}; {wall / (2 * T6) * 1e3:.3f} ms per slot",
          flush=True)
    if not expect(counts, **want):
        fail(f"fig-6 grid launched {counts}, expected {want}")
    for r in rows6:
        check_result(f"fig-6 grid {r.point}", r.result, (2, T6),
                     r.instance.n_edges)
        print(f"   {r.point}: ASW {r.asw_mean:.1f} ± {r.asw_ci95:.1f}, "
              f"regret {r.regret_mean:.1f}, C={r.tables.n_states}",
              flush=True)
    done(t0)

    t0 = phase(f"(e) the dispatcher under a scenario: ClusterSim on the "
               f"dispatch_cluster fleet, T={TD}: power_coupled, and "
               "server_failures failure-aware")
    pc_out, counts, wall = timed_run(lambda: ClusterSim(
        d_inst, TD, scenario="power_coupled", seed=DSEED,
        schedule=d_sched).run("esdp", tiebreak=0.0))
    if not expect(counts, dp_forward_batched=TD, dp_epilogue=TD):
        fail(f"ClusterSim(scenario='power_coupled') launched {counts}")
    pc_cpu = ClusterSim(d_inst, TD, scenario="power_coupled", seed=DSEED,
                        schedule=d_sched, device="cpu").run("esdp",
                                                            tiebreak=0.0)
    if not np.array_equal(pc_out.x, pc_cpu.x):
        fail("ClusterSim(scenario='power_coupled'): the card's x differs "
             "from the CPU run's")
    pc_ms = wall / TD * 1e3
    print(f"   power_coupled: ASW {pc_out.asw:.1f}, launches {counts}, "
          f"{pc_ms:.3f} ms per slot; x equal to the CPU run's", flush=True)
    model = FailureModel(redundancy=2, checkpoints=2, checkpoint_cost=0.003,
                         detect=True)
    sf_out, counts, wall = timed_run(lambda: ClusterSim(
        d_inst, TD, scenario="server_failures", failures=model, seed=DSEED,
        schedule=d_sched).run("esdp", tiebreak=0.0))
    if not expect(counts, dp_forward_batched=TD, dp_epilogue=TD):
        fail(f"ClusterSim(scenario='server_failures') launched {counts}")
    led = sf_out.failures
    if not (np.allclose(led["dispatched"], led["completed"] + led["lost"]
                        + led["salvaged"], rtol=1e-6, atol=1e-6)
            and np.allclose(sf_out.sw, led["completed"] + led["salvaged"]
                            - led["ckpt_cost"], rtol=1e-5, atol=1e-5)
            and led["total_dispatched"] > 0):
        fail("server_failures: the failure ledger is not conserved")
    print(f"   server_failures: ASW {sf_out.asw:.1f}, launches {counts}, "
          f"{wall / TD * 1e3:.3f} ms per slot; ledger conserved "
          f"(dispatched {led['total_dispatched']:.1f} = completed "
          f"{led['total_completed']:.1f} + lost {led['total_lost']:.1f} + "
          f"salvaged {led['total_salvaged']:.1f}), "
          f"{int(led['crashes'].sum())} crashes", flush=True)
    done(t0)

    t0 = phase(f"(f) the degradation chain: ClusterSim(fallback=True) on "
               f"the dispatch configuration, T={TD}")
    plain_out, plain_ms = d_runs["esdp cold"]
    fb_out, counts, wall = timed_run(lambda: dispatch_sim(
        solver="cuda", fallback=True).run("esdp", tiebreak=0.0))
    st = fb_out.solve_stats
    print(f"   fault-free: {st['calls']} calls, served_by {st['served_by']},"
          f" degraded {st['degraded_calls']}; launches {counts}", flush=True)
    if not (st["degraded_calls"] == 0 and st["calls"] == TD
            and st["served_by"]["cuda"] == TD and st["events"] == []):
        fail(f"fallback=True degraded on a fault-free card run: {st}")
    if not expect(counts, dp_forward_batched=TD, dp_epilogue=TD):
        fail(f"fallback=True launched {counts}")
    if not np.array_equal(fb_out.x, plain_out.x):
        fail("fallback=True: x differs from the plain run's")
    fb_ms = wall / TD * 1e3
    chain = FallbackSolver(chain=("cuda", "reference"), fault_rate=0.2,
                           fault_seed=1)
    ft_out, counts, wall = timed_run(lambda: dispatch_sim(
        solver=chain).run("esdp", tiebreak=0.0))
    st = ft_out.solve_stats
    launched = st["calls"] - st["launch_failures"]
    print(f"   fault rate 0.2: {st['calls']} calls, {st['launch_failures']} "
          f"launch and {st['validation_failures']} validation failures, "
          f"served_by {st['served_by']}; launches {counts}", flush=True)
    if not (st["launch_failures"] > 0 and st["validation_failures"] > 0
            and st["degraded_calls"] == st["launch_failures"]
            + st["validation_failures"]):
        fail(f"fault rate 0.2: failures not counted as expected: {st}")
    if not expect(counts, dp_forward_batched=launched, dp_epilogue=launched):
        fail(f"fault rate 0.2 launched {counts}, expected {launched} (the "
             "cuda attempts that launched)")
    if not np.array_equal(ft_out.x, fb_out.x):
        fail("fault rate 0.2: x differs from the fault-free run's")
    ft_ms = wall / TD * 1e3
    print(f"   x identical to the fault-free and plain runs; slot ms: plain "
          f"{plain_ms:.3f}, fallback=True {fb_ms:.3f}, fault rate 0.2 "
          f"{ft_ms:.3f}", flush=True)
    print(f"   scenario slot ms (host clock, {card}): simulate_batch via "
          f"run_spec, Table 2, B={len(SS)}: "
          + "; ".join(f"{s} (T={sweep_T(s)}) esdp {sweep_ms[s, 'esdp']:.3f} "
                      f"hswf {sweep_ms[s, 'hswf']:.3f}"
                      for s in ("iid", "power_coupled", "server_failures"))
          + f"; severity grid (B=15) {grid_ms:.3f}; dispatch: plain "
          f"{plain_ms:.3f}, power_coupled {pc_ms:.3f}, fallback=True "
          f"{fb_ms:.3f}", flush=True)
    done(t0)

    # ------------------------------------------------------- engine path
    # (g) the streaming dispatch engine (sched/engine.py) on the dispatch
    # fleet: ESDP alone and A/B (ESDP 0.9 / HSWF 0.1), stream and
    # lockstep, run_batch over 8 seeds, the three backpressure policies,
    # a failure run with a CachedSolver, card against CPU
    from repro_torch.core import CachedSolver
    from repro_torch.experiments import engine_variant_records
    from repro_torch.sched import (DispatchEngine, EngineConfig,
                                   FailureModel, VariantSpec)

    ENGINE_FIELDS = ("x", "sw", "regret", "dispatch_share", "sw_variant",
                     "regret_variant", "dispatched_variant",
                     "routed_variant", "n", "sumz", "queue_len")
    ENGINE_EXACT = ("x", "dispatched_variant", "routed_variant", "n",
                    "sumz", "queue_len")

    def ab_variants(solver=None):
        return (VariantSpec("esdp", weight=0.9, solver=solver),
                VariantSpec("hswf", kind="hswf", weight=0.1))

    def dispatch_engine(cfg, device=None, horizon=TD, **kw):
        return DispatchEngine(d_inst, horizon, cfg, speed_fn=d_speed,
                              seed=DSEED, device=device,
                              schedule=tuple(a[:horizon] for a in d_sched),
                              **kw)

    @contextlib.contextmanager
    def strict_horizon():
        """Every pass of the engine's horizon loop runs under
        ``torch.cuda.set_sync_debug_mode("error")``: a read back to the
        host inside it raises.  Yields the count of such passes."""
        real, calls = DispatchEngine._horizon, [0]

        def strict(self, *args, **kw):
            calls[0] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real(self, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        DispatchEngine._horizon = strict
        try:
            with warnings.catch_warnings():  # "a prototype feature"
                warnings.simplefilter("ignore", UserWarning)
                yield calls
        finally:
            DispatchEngine._horizon = real

    def same_trace(a, b, fields=ENGINE_FIELDS):
        """The fields (and every ledger entry) of two outputs on which
        they differ."""
        bad = [f for f in fields if not np.array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))]
        return bad + [k for k in a.ledger if not np.array_equal(
            np.asarray(a.ledger[k]), np.asarray(b.ledger[k]))]

    def conserves(out):
        led = out.ledger
        return (led["total_arrivals"] == led["total_rejected"]
                + led["total_blocked"] + led["total_admitted"]
                and led["total_admitted"] == led["total_dispatched"]
                + led["total_dropped"] + led["total_shed"]
                + led["final_queue"])

    t0 = phase(f"(g) the streaming engine on the dispatch fleet, T={TD}: "
               "stream and lockstep, run_batch, backpressure, failures, "
               "card against CPU")
    g_seeds = [DSEED + i for i in range(8)]
    g_ms, g_runs = {}, {}
    for label, cfg in (("esdp", EngineConfig()),
                       ("ab", EngineConfig(variants=ab_variants()))):
        eng = dispatch_engine(cfg)
        dp = dict(dp_forward_batched=TD, dp_epilogue=TD)  # one ESDP variant
        lock, counts, wall = timed_run(lambda: eng.run(mode="lockstep"))
        if not expect(counts, **dp):
            fail(f"(g) {label} lockstep launched {counts}, expected {dp}")
        g_ms[label, "lockstep"] = wall / TD * 1e3
        with strict_horizon() as n_strict:
            stream, counts, wall = timed_run(lambda: eng.run(mode="stream"))
            g_ms[label, "stream"] = wall / TD * 1e3
            if not expect(counts, **dp):
                fail(f"(g) {label} stream launched {counts}, expected {dp}")
            fleet, counts, wall = timed_run(lambda: eng.run_batch(g_seeds))
            g_ms[label, "run_batch"] = wall / TD * 1e3
            if not expect(counts, **dp):
                fail(f"(g) {label} run_batch over {len(g_seeds)} seeds "
                     f"launched {counts}, expected one K2 forward and one "
                     f"epilogue a slot ({dp})")
        if n_strict[0] != 2:
            fail(f"(g) {label}: {n_strict[0]} horizon passes under the "
                 "sync check, expected 2")
        bad = same_trace(stream, lock)
        if bad:
            fail(f"(g) {label}: stream and lockstep differ in {bad}")
        for s, out in zip(g_seeds, fleet):
            one = stream if s == DSEED else eng.run(mode="stream", seed=s)
            bad = same_trace(out, one)
            if bad:
                fail(f"(g) {label}: run_batch seed {s} differs from its "
                     f"run() in {bad}")
        if not all(conserves(o) for o in [stream, lock] + fleet):
            fail(f"(g) {label}: a ledger is not conserved")
        if not (np.isfinite(stream.sw).all() and stream.x.shape == (
                TD, len(cfg.variants), d_inst.n_edges)):
            fail(f"(g) {label}: non-finite welfare or x of shape "
                 f"{stream.x.shape}")
        g_runs[label] = stream
        print(f"   {label}: ASW {stream.asw:.1f}, cumRegret "
              f"{float(stream.cum_regret[-1]):.1f}, dispatched "
              f"{stream.ledger['total_dispatched']} of "
              f"{stream.ledger['total_arrivals']} arrivals; ms a slot: "
              f"stream {g_ms[label, 'stream']:.3f}, lockstep "
              f"{g_ms[label, 'lockstep']:.3f}, run_batch (B=8) "
              f"{g_ms[label, 'run_batch']:.3f}; one K1 (K2 in run_batch) "
              "and one epilogue a slot, none for HSWF; stream = lockstep "
              "and each run_batch seed = its run(), bitwise", flush=True)
    for rec in engine_variant_records(g_runs["ab"]):
        print(f"   A/B arm {rec['variant']}: routed {rec['routed']}, "
              f"dispatched {rec['dispatched']}, ASW {rec['asw_mean']:.1f}, "
              f"regret {rec['regret_mean']:.1f}", flush=True)

    for bp, channel in (("drop_oldest", "dropped"), ("block", "blocked"),
                        ("shed_by_utility", "shed")):
        cfg = EngineConfig(queue_capacity=1, backpressure=bp,
                           variants=ab_variants())
        out, counts, wall = timed_run(lambda: dispatch_engine(
            cfg, arr_scale=3.0).run(mode="stream"))
        led = out.ledger
        fired = {ch: led[f"total_{ch}"] for ch in ("dropped", "blocked",
                                                   "shed")}
        if not (conserves(out) and fired[channel] > 0 and all(
                v == 0 for ch, v in fired.items() if ch != channel)):
            fail(f"(g) backpressure {bp}: fired {fired}, conserved "
                 f"{conserves(out)}")
        if not expect(counts, dp_forward_batched=TD, dp_epilogue=TD):
            fail(f"(g) backpressure {bp} launched {counts}")
        print(f"   backpressure {bp} (queue 1, arrivals x3): "
              f"{led['total_arrivals']} arrivals, {fired}, "
              f"{led['total_dispatched']} dispatched, ledger conserved; "
              f"{wall / TD * 1e3:.3f} ms a slot", flush=True)

    cached = CachedSolver(get_solver("cuda"))
    eng = dispatch_engine(EngineConfig(variants=ab_variants(cached)),
                          failures=FailureModel(p_crash=0.1, redundancy=2))
    out, counts, wall = timed_run(eng.run)
    fv, st = out.failures["per_variant"], out.solve_stats
    if not (out.mode == "lockstep" and set(fv) == {"esdp", "hswf"}
            and st is not None and st["esdp"]["scope"] == "esdp"
            and st["esdp"]["hits"] + st["esdp"]["misses"] == TD):
        fail(f"(g) failures: mode {out.mode}, per-variant ledgers "
             f"{sorted(fv)}, solve_stats {st}")
    for name, led in fv.items():
        if not np.allclose(led["dispatched"], led["completed"] + led["lost"]
                           + led["salvaged"], rtol=1e-6, atol=1e-6):
            fail(f"(g) failures: variant {name}'s ledger is not conserved")
    if not (conserves(out) and expect(
            counts, dp_forward_batched=st["esdp"]["misses"],
            dp_epilogue=st["esdp"]["misses"])):
        fail(f"(g) failures: launched {counts}, cache {st['esdp']}")
    print(f"   failures (p_crash 0.1, 2-way redundancy, CachedSolver "
          f"scope {st['esdp']['scope']!r}): lockstep, per-variant ledgers "
          f"conserved (esdp lost {fv['esdp']['total_lost']:.1f} of "
          f"{fv['esdp']['total_dispatched']:.1f}), cache hits "
          f"{st['esdp']['hits']}, misses {st['esdp']['misses']} = "
          f"K1 launches; {wall / TD * 1e3:.3f} ms a slot", flush=True)

    Tg = 200
    w0 = time.perf_counter()
    for label, card_cfg, cpu_cfg in (
            ("esdp", EngineConfig(),
             EngineConfig(variants=(VariantSpec("esdp",
                                                solver="reference"),))),
            ("ab", EngineConfig(variants=ab_variants()),
             EngineConfig(variants=ab_variants("reference")))):
        on_card = dispatch_engine(card_cfg, horizon=Tg).run(mode="stream")
        on_cpu = dispatch_engine(cpu_cfg, "cpu", horizon=Tg).run(
            mode="stream")
        bad = same_trace(on_card, on_cpu, ENGINE_EXACT)
        if bad:
            fail(f"(g) {label}, T={Tg}: card and CPU differ in {bad}")
    print(f"   card and CPU (reference solver, plain versions) agree "
          f"bitwise on x, n, sumz, the queue, the routing and every ledger "
          f"entry at T={Tg}, ESDP and A/B "
          f"({time.perf_counter() - w0:.1f} s)", flush=True)

    # where an A/B stream slot's time goes: the profiler over a whole run
    from torch.profiler import ProfilerActivity, profile
    eng = dispatch_engine(EngineConfig(variants=ab_variants()))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            eng.run(mode="stream")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
    g_kernels = sorted(
        ((getattr(e, "device_time_total", 0.0) / 1e3, e.count, e.key)
         for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
        reverse=True)
    busy = sum(ms for ms, _, _ in g_kernels)
    g_launch = sum(n for _, n, _ in g_kernels) / TD
    g_idle = max(0.0, 1 - busy / wall) * 100
    print(f"   A/B stream under the profiler: {wall / TD:.3f} ms a slot, "
          f"kernels {busy / TD:.4f} ms and {g_launch:.1f} launches a slot, "
          f"device idle {g_idle:.1f}% ({card})", flush=True)
    for ms, n, key in g_kernels[:6]:
        print(f"      {ms / TD:8.4f} ms a slot {n / TD:6.1f}x  "
              f"{key[:80]}", flush=True)
    done(t0)

    # --------------------------------------- attention and SSD vs plain
    def rel_err(got, want):
        """max |got − want| / (1 + |want|) over the elements, in f32."""
        got, want = got.float(), want.float()
        return float(((got - want).abs() / (1 + want.abs())).max())

    def qkv(B, Sq, Sk, H, KH, hd, dtype, seed):
        g = torch.Generator(dev).manual_seed(seed)
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((B, Sq, H, hd), (B, Sk, KH, hd),
                                   (B, Sk, KH, hd)))

    worst_abs = {"flash_attention_wgmma": 0.0, "flash_attention_tf32": 0.0,
                 "ssd_scan": 0.0}
    stream0 = torch.cuda.current_stream().cuda_stream

    def cuda_core_attention(q, k, v, scale, causal, window):
        """The CUDA-core kernel, the f32-FMA referee that no input is routed
        to, on the wrapper's inputs: a raw launch, for the accuracy
        comparison."""
        B, Sq, H, hd = q.shape
        _, Sk, KH, _ = k.shape
        out = torch.empty_like(q)
        fa.LIBRARY.check(fa.LIBRARY.load().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KH, hd, scale,
            int(causal), window, stream0), "flash_attention")
        return out

    t0 = phase("flash attention (K6) vs its plain version on the card")
    # the f32 plain version's products stay f32: never TF32
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is True: the f32 plain "
             "version would run its products in TF32")
    # tests/test_kernels.py:28-58 as (B, Sq, Sk, H, KH, hd, causal,
    # window), the serving shape, dbrx-132b's (GQA 48:8, a group of 6
    # heads folded into the rows), a ragged GQA Sq < Sk, and bf16 head dims
    # over 128 (three and four 64-column boxes: deepseek-v3's q/k 192,
    # gemma-7b's 256), ragged GQA Sq < Sk and windowed among them; the
    # shapes of phase (j) in both dtypes — whisper-medium's cross-attention
    # in decode (one query row against 1500 frames) and in prefill (416
    # queries), its encoder's bidirectional 1500 frames (a ragged last key
    # tile) — and qwen2-vl-72b's prefill (GQA 64:8 over 3072 positions)
    fa_cases = [(2, 256, 256, 4, 4, 64, True, 0),
                (1, 256, 256, 8, 2, 64, True, 0),
                (2, 128, 128, 4, 1, 32, True, 0),
                (1, 512, 512, 2, 2, 128, True, 128),
                (2, 256, 256, 4, 4, 64, False, 0),
                (1, 128, 512, 4, 4, 64, True, 0)]
    fa_cases = ([(c, dt) for c in fa_cases for dt in ("f32", "bf16")]
                + [((SERVE_B, SERVE_S, SERVE_S, 32, 32, 112, True, 0),
                    "bf16"),
                   ((SERVE_B, SERVE_S, SERVE_S, 48, 8, 128, True, 0),
                    "bf16"),
                   ((2, 333, 1000, 8, 2, 112, True, 0), "bf16"),
                   ((2, 333, 1000, 8, 2, 112, True, 0), "f32")]
                + [((SERVE_B, Sq, 1500, 16, 16, 64, False, 0), dt)
                   for Sq in (1, WHISPER_S, 1500) for dt in ("bf16", "f32")]
                + [((SERVE_B, 1024 + SERVE_S, 1024 + SERVE_S, 64, 8, 128,
                     True, 0), "bf16")]
                + [(c, "bf16") for c in (
                    (2, 512, 512, 8, 2, 136, True, 0),
                    (1, 333, 1000, 16, 4, 192, True, 0),
                    (2, 256, 256, 4, 4, 192, True, 100),
                    (1, 300, 777, 8, 2, 200, True, 0),
                    (2, 512, 512, 16, 16, 256, True, 0),
                    (1, 333, 1000, 8, 2, 256, True, 0),
                    (1, 512, 512, 4, 4, 256, True, 128))])
    tols = {"f32": 2e-5, "bf16": 2e-2}
    for (B, Sq, Sk, H, KH, hd, causal, window), dt in fa_cases:
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        q, k, v = qkv(B, Sq, Sk, H, KH, hd, dtype, Sq + Sk + hd)
        kw = dict(scale=hd ** -0.5, causal=causal, window=window)
        name = fa.kernel_for(dtype, hd)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        worst_abs[name] = max(worst_abs[name],
                              float((got.float() - want.float()).abs().max()))
        # both kernels' distance from the plain version run in f64, beside
        # the CUDA-core referee's; in bf16 a gate (1.25x), in f32 a report
        exact = fa.flash_attention_ref(q.double(), k.double(), v.double(),
                                       **kw)
        core = cuda_core_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        e_new, e_core = rel_err(got, exact), rel_err(core, exact)
        extra = (f"; from the f64 plain version: {name} {e_new:.4g}, "
                 f"CUDA-core kernel {e_core:.4g}" + (
                     f" (limit 1.25x: {1.25 * e_core:.4g})"
                     if dt == "bf16" else ""))
        del exact, core
        print(f"   {dt} {name} B={B} Sq={Sq} Sk={Sk} H={H} KH={KH} hd={hd} "
              f"causal={causal} window={window}: max |kernel - plain| / "
              f"(1 + |plain|) {err:.3g} (tolerance {tols[dt]}){extra}",
              flush=True)
        if not err <= tols[dt]:
            fail(f"flash attention {dt} {(B, Sq, Sk, H, KH, hd)} differs "
                 "from its plain version")
        if dt == "bf16" and not e_new <= 1.25 * e_core:
            fail(f"flash attention bf16 {(B, Sq, Sk, H, KH, hd)}: the "
                 f"wgmma kernel is {e_new:.4g} from the f64 plain "
                 f"version, over 1.25x the CUDA-core kernel's {e_core:.4g}")
    del q, k, v, got, want
    done(t0)

    t0 = phase("attention_vh: a v head dim other than q/k's (zero columns "
               "up to the kernel's width) vs the plain version on the card")
    # deepseek-v3's MLA widths (q/k 192, v 128, at a cut of its 128 heads)
    # and q/k 64, v 32, both on the wgmma kernel
    for B, S, H, KH, hd, vh, name in (
            (1, 1024, 16, 16, 192, 128, "flash_attention_wgmma"),
            (2, 512, 8, 2, 64, 32, "flash_attention_wgmma")):
        g = torch.Generator(dev).manual_seed(hd + vh)
        q, k = (torch.randn(shape, generator=g, device=dev).bfloat16()
                for shape in ((B, S, H, hd), (B, S, KH, hd)))
        v = torch.randn((B, S, KH, vh), generator=g, device=dev).bfloat16()
        before = dict(fa.LAUNCHES)
        got = fa.flash_attention(q, k, v, scale=hd ** -0.5)
        torch.cuda.synchronize()
        launched = {kk: fa.LAUNCHES[kk] - before[kk] for kk in fa.LAUNCHES}
        want = fa.flash_attention_ref(q, k, v, scale=hd ** -0.5)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        print(f"   bf16 B={B} S={S} H={H} KH={KH} q/k {hd} v {vh}: output "
              f"{tuple(got.shape)}, launches {launched}, max |kernel - "
              f"plain| / (1 + |plain|) {err:.3g} (tolerance {tols['bf16']})",
              flush=True)
        if tuple(got.shape) != (B, S, H, vh) or launched[name] != 1 or \
                sum(launched.values()) != 1:
            fail(f"attention_vh q/k {hd} v {vh}: shape {tuple(got.shape)}, "
                 f"launches {launched}")
        if not err <= tols["bf16"]:
            fail(f"attention_vh q/k {hd} v {vh}: kernel differs from its "
                 "plain version")
    del q, k, v, got, want
    done(t0)

    def ssd_inputs(B, S, H, P, N, seed):
        """x, B and C as strided views of one (B, S, H·P + 2N) tensor, as
        the Mamba2 block splits its conv output; dt post-softplus."""
        g = torch.Generator(dev).manual_seed(seed)
        xbc = torch.randn((B, S, H * P + 2 * N), generator=g, device=dev)
        xs, Bm, Cm = xbc.split([H * P, N, N], dim=-1)
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=g, device=dev))
        A = -torch.exp(torch.randn(H, generator=g, device=dev) * 0.3)
        return xs.reshape(B, S, H, P), dt, A, Bm, Cm

    t0 = phase("SSD scan (K7) vs its plain version on the card")
    # f32 cannot hold every shape to 1e-4: at Q = 128 the plain version
    # itself is ~1e-4 from the exact answer.  So the kernel is held to
    # the plain version run in f64 on the same inputs: within 1e-4 (the
    # JAX tests' tolerance), or no more than twice as far from it as the
    # plain version in f32
    # tests/test_kernels.py:66-71 (the third pads 80 steps to chunks of
    # 32), the serving shape on three seeds, and Mamba2-2.7B's heads
    # (80 × P 64, N 128, configs/mamba2_2_7b.py) over a ragged length on
    # four seeds and at the serving length; each case's distance over its
    # limit is printed, and the largest of them for each N
    worst_ratio = {}
    for B, S, H, P, N, Q, seed in (
            (2, 128, 2, 32, 16, 32, 0), (1, 96, 4, 64, 32, 32, 0),
            (2, 80, 2, 32, 16, 32, 0), (1, 256, 2, 64, 64, 64, 0),
            (SERVE_B, SERVE_S, 112, 64, 64, 128, 0),
            (SERVE_B, SERVE_S, 112, 64, 64, 128, 1),
            (SERVE_B, SERVE_S, 112, 64, 64, 128, 2),
            (2, 1000, 80, 64, 128, 128, 0), (2, 1000, 80, 64, 128, 128, 1),
            (2, 1000, 80, 64, 128, 128, 2), (2, 1000, 80, 64, 128, 128, 3),
            (SERVE_B, SERVE_S, 80, 64, 128, 128, 0)):
        args = ssd_inputs(B, S, H, P, N, S + H + 7919 * seed)
        got = ssd.ssd_scan(*args, chunk=Q)
        want = ssd.ssd_ref(*args, chunk=Q)
        exact = ssd.ssd_ref(*(a.double() for a in args), chunk=Q)
        torch.cuda.synchronize()
        err = max(rel_err(a, b) for a, b in zip(got, want))
        err_k = max(rel_err(a, b) for a, b in zip(got, exact))
        err_p = max(rel_err(a, b) for a, b in zip(want, exact))
        worst_abs["ssd_scan"] = max(
            [worst_abs["ssd_scan"]] + [float((a - b).abs().max())
                                       for a, b in zip(got, want)])
        limit = max(1e-4, 2 * err_p)
        worst_ratio[N] = max(worst_ratio.get(N, 0.0), err_k / limit)
        print(f"   B={B} S={S} H={H} P={P} N={N} Q={Q} seed {seed}, max over "
              "y and the state of |a - b| / (1 + |b|): kernel - plain "
              f"{err:.3g}; from the f64 plain version: kernel {err_k:.3g}, "
              f"plain {err_p:.3g} (the kernel's tolerance {limit:.3g}, "
              f"{err_k / limit:.3f} of it)", flush=True)
        if not err_k <= limit:
            fail(f"SSD scan {(B, S, H, P, N, Q)} seed {seed}: the kernel is "
                 f"{err_k:.3g} from the f64 plain version, the f32 plain one "
                 f"{err_p:.3g}")
    print("   largest distance over its limit, by N: " + ", ".join(
        f"N={n} {r:.3f}" for n, r in sorted(worst_ratio.items())),
        flush=True)
    del args, got, want, exact
    done(t0)

    # ------------------------------------------------------ serving path
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.models.transformer import hybrid_layout
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime import (greedy_generate, make_decode_step,
                                     make_prefill_step)

    @contextlib.contextmanager
    def plain_versions():
        """The model's attention and SSD scan through their plain versions
        on the card, for the comparison only."""
        saved = attn_mod.chunked_attention, ssm_mod.ssd_chunked

        def attention_plain(q, k, v, *, scale, causal=True, window=None, chunk=1024):
            return fa.flash_attention_ref(q, k, v, scale=scale,
                                          causal=causal, window=window or 0,
                                          chunk=chunk)

        attn_mod.chunked_attention = attention_plain
        ssm_mod.ssd_chunked = ssd.ssd_ref
        try:
            yield
        finally:
            attn_mod.chunked_attention, ssm_mod.ssd_chunked = saved

    t0 = phase("serving path: FULL zamba2-7b, bf16, batch "
               f"{SERVE_B} x prompt {SERVE_S} + {SERVE_GEN} tokens")
    cfg = get_config("zamba2-7b")
    model = build_model(cfg)
    w0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"   {n_params} parameters ({cfg.param_dtype}) drawn on the card "
          f"in {time.perf_counter() - w0:.2f} s", flush=True)
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (SERVE_B, SERVE_S)), device=dev)
    s_max = SERVE_S + SERVE_GEN
    G, M, tail = hybrid_layout(cfg)
    per_prefill = dict(flash_attention_wgmma=G, ssd_scan=G * M + tail)
    torch.cuda.reset_peak_memory_stats()
    reset()
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    tokens_out = greedy_generate(model, params, {"tokens": prompt},
                                 steps=SERVE_GEN, s_max=s_max)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - w0
    serve_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"   greedy_generate: launches {serve_counts}; {gen_wall:.3f} s "
          "(first call)", flush=True)
    if not expect(serve_counts, **per_prefill):
        fail(f"greedy_generate launched {serve_counts}, expected "
             f"{per_prefill} (one prefill, no kernel in decode)")
    toks = tokens_out.cpu().numpy()
    if toks.shape != (SERVE_B, SERVE_GEN) or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        fail(f"greedy_generate returned shape {toks.shape}, tokens in "
             f"[{toks.min()}, {toks.max()}]")
    prefill_step = make_prefill_step(model)
    decode_step = make_decode_step(model)
    cache = model.alloc_cache(SERVE_B, s_max, dev)
    reset()
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    logits_k, cache = prefill_step(params, {"tokens": prompt}, cache=cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - w0) * 1e3
    prefill_counts = read_counts()
    if not expect(prefill_counts, **per_prefill):
        fail(f"prefill launched {prefill_counts}, expected {per_prefill}")
    tok = torch.argmax(logits_k, dim=-1).to(torch.int32)[:, None]
    reset()
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for i in range(SERVE_GEN - 1):
        nxt, logits_d, cache = decode_step(params, {
            "token": tok, "cache": cache,
            "pos": torch.full((SERVE_B,), SERVE_S + i, device=dev)})
        tok = nxt[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - w0) * 1e3 / (SERVE_GEN - 1)
    decode_counts = read_counts()
    if not expect(decode_counts):
        fail(f"decode launched {decode_counts}, expected no kernel")
    if not torch.isfinite(logits_k).all() or not torch.isfinite(
            logits_d).all() or tuple(logits_k.shape) != (SERVE_B,
                                                          cfg.vocab):
        fail("non-finite or misshapen serving logits")
    tok_per_s = SERVE_B * SERVE_GEN / (prefill_ms + (SERVE_GEN - 1)
                                       * decode_ms) * 1e3
    print(f"   prefill {prefill_ms:.1f} ms (launches {prefill_counts}); "
          f"decode {decode_ms:.2f} ms per token over {SERVE_GEN - 1} steps "
          f"(launches {decode_counts}); {tok_per_s:.1f} generated tokens/s "
          f"(batch {SERVE_B}); greedy_generate {SERVE_B * SERVE_GEN / gen_wall:.1f} "
          f"tokens/s on its first call; peak memory "
          f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)",
          flush=True)
    done(t0)

    t0 = phase("serving path: where the time goes (torch.profiler over one "
               "prefill and one decode step; the profiler slows the host)")

    def device_breakdown(label, fn):
        """Kernel time by name over one call of ``fn``, and the device's
        busy share of the call's wall time (one stream: kernels do not
        overlap)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - w0) * 1e3
        kernels = sorted(
            ((getattr(e, "device_time_total", 0.0) / 1e3, e.count, e.key)
             for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")), reverse=True)
        busy = sum(ms for ms, _, _ in kernels)
        print(f"   {label}: wall {wall:.1f} ms under the profiler, kernels "
              f"{busy:.1f} ms ({len(kernels)} names, "
              f"{sum(n for _, n, _ in kernels)} launches), device idle "
              f"{max(0.0, 1 - busy / wall) * 100:.1f}%", flush=True)
        for ms, n, key in kernels[:8]:
            print(f"      {ms:9.3f} ms {n:6d}x  {key[:90]}", flush=True)

    device_breakdown("prefill", lambda: prefill_step(
        params, {"tokens": prompt}, cache=cache))
    device_breakdown("decode step", lambda: decode_step(params, {
        "token": tok, "cache": cache,
        "pos": torch.full((SERVE_B,), s_max - 1, device=dev)}))
    del cache
    done(t0)

    t0 = phase("serving path: the kernels' prefill logits against the "
               "plain versions' on the same weights and tokens")
    reset()
    with plain_versions():
        logits_p, _ = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    if any(read_counts().values()):
        fail(f"the plain-version prefill launched {read_counts()}")
    params.float()  # in place: the same weights, exactly, in f32
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    prefill32 = make_prefill_step(build_model(cfg32))
    reset()
    logits_k32, _ = prefill32(params, {"tokens": prompt})
    torch.cuda.synchronize()
    f32_counts = read_counts()
    per_prefill32 = dict(flash_attention_tf32=G, ssd_scan=G * M + tail)
    print(f"   f32 prefill through the kernels: launches {f32_counts}",
          flush=True)
    if not expect(f32_counts, **per_prefill32):
        fail(f"the f32 prefill launched {f32_counts}, expected "
             f"{per_prefill32}")
    reset()
    with plain_versions():
        logits_p32, _ = prefill32(params, {"tokens": prompt})
    torch.cuda.synchronize()
    if any(read_counts().values()):
        fail(f"the plain-version prefill launched {read_counts()}")

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    serve_err = l2(logits_k32, logits_p32)
    bf16_k, bf16_p = l2(logits_k, logits_p32), l2(logits_p, logits_p32)
    print(f"   f32: ‖kernels − plain‖ / ‖plain‖ = {serve_err:.3g} "
          "(tolerance 1e-3: summation order only, ~1e-6 per op, which 81 "
          "layers amplify a few times)", flush=True)
    print(f"   bf16 against the f32 plain logits: kernels {bf16_k:.4g}, "
          f"plain {bf16_p:.4g} (the kernels may be at most 1.5x + 1e-3 as "
          "far: bf16 rounding sets both, and 81 layers amplify where two "
          "paths round differently); bf16 kernels vs bf16 plain "
          f"{l2(logits_k, logits_p):.4g}, top-1 agreement "
          f"{float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean()):.2f}",
          flush=True)
    if not serve_err <= 1e-3:
        fail(f"f32 prefill logits: kernels and plain versions differ by "
             f"{serve_err:.3g}")
    if not bf16_k <= 1.5 * bf16_p + 1e-3:
        fail(f"bf16 prefill logits: the kernels are {bf16_k:.4g} from the "
             f"f32 logits, the plain versions {bf16_p:.4g}")
    del params, logits_k32, logits_p32
    torch.cuda.empty_cache()
    done(t0)

    # -------------------------------------------- the new model families
    # (h) mamba2-2.7b (ssm) FULL, gemma-7b (dense) FULL and gemma3-27b
    # (dense) at full width with 6 of its 62 layers (one 5 local : 1
    # global cycle); (i) the moe family at full width: dbrx-132b with 4 of
    # its 40 layers and deepseek-v3-671b (MLA) with 3 dense + 1 moe of its
    # 61 (n_layers 4 keeps moe_layer_start 3); (j) qwen2-vl-72b (vlm) at
    # full width with 8 of its 80 layers, 1024 patch embeddings before the
    # prompt at Qwen2-VL's grid positions (t = 0, h = row, w = col on a
    # 32 x 32 grid, the text from 32 on all three M-RoPE streams), and
    # whisper-medium (encdec) FULL over 1500 frame embeddings, its decoder
    # prompt 416 (416 + 32 = 448, whisper's decoder context).  bf16, batch
    # 4 x prompt 2048 (whisper 416) + 32 tokens: launches a prefill and a
    # decode token, prefill and decode ms (whisper's encoder alone too),
    # and the kernels' prefill logits against the plain versions' (the
    # Zamba2 phase's tolerances; whisper's decode runs K6 too, so one f32
    # decode step is held the same way); for the moe family also two bf16
    # prefills bitwise equal (the combine has no atomics) and, per moe
    # layer, the routed experts and kept tokens that differ between the
    # kernels' run and the plain versions' (a near tie that flips shows
    # there)
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr_mod
    family_counts, family_ms = {}, {}
    family_shapes = {}  # arch: attention calls by (Sq, Sk, causal), in
    # the timed prefill and in the timed decode steps

    @contextlib.contextmanager
    def attention_shapes(tally):
        """Tally the model's attention calls by (Sq, Sk, causal): on the
        card each is one K6 launch (the counts hold the total to it)."""
        saved = attn_mod.chunked_attention

        def recording(q, k, v, **kw):
            key = (q.shape[1], k.shape[1], kw.get("causal", True))
            tally[key] = tally.get(key, 0) + 1
            return saved(q, k, v, **kw)

        attn_mod.chunked_attention = recording
        try:
            yield tally
        finally:
            attn_mod.chunked_attention = saved
    TAIL = 64  # positions a row whose logits the moe family's check reads

    @contextlib.contextmanager
    def routing(calls):
        """Record the index output of every ``stable_top_k`` call of the
        moe layers: per layer the routed experts, then the kept tokens."""
        saved = moe_mod.stable_top_k

        def recording(x, k):
            out = saved(x, k)
            calls.append(out[1])
            return out

        moe_mod.stable_top_k = recording
        try:
            yield calls
        finally:
            moe_mod.stable_top_k = saved

    def routing_diff(a, b):
        """Per moe layer: ((token, expert) routes of run a that run b does
        not take, of all of a's; (expert, token) pairs a's experts keep at
        capacity that b's do not, of all)."""
        def members(idx, n):
            m = torch.zeros(idx.shape[:2] + (n,), dtype=torch.bool,
                            device=idx.device)
            return m.scatter_(-1, idx, True)

        out = []
        for i in range(0, len(a), 2):
            n_e = int(max(a[i].max(), b[i].max())) + 1
            n_t = int(max(a[i + 1].max(), b[i + 1].max())) + 1
            ra, rb = members(a[i], n_e), members(b[i], n_e)
            ka, kb = members(a[i + 1], n_t), members(b[i + 1], n_t)
            out.append((int((ra & ~rb).sum()), a[i].numel(),
                        int((ka & ~kb).sum()), a[i + 1].numel()))
        return out

    @contextlib.contextmanager
    def last_hidden(out):
        """Keep in out[0] the hidden states the prefill's last block
        returns (the final norm's input, every position)."""
        saved = tr_mod._dense_block_train

        def recording(*args, **kw):
            h, kv, aux = saved(*args, **kw)
            out[:] = [h]
            return h, kv, aux

        tr_mod._dense_block_train = recording
        try:
            yield out
        finally:
            tr_mod._dense_block_train = saved

    def tail_logits(params_, cfg_, h):
        """The f32 logits of the last TAIL positions of each row."""
        return tr_mod._logits(params_, cfg_, tr_mod._norm(
            params_["final_norm"], cfg_, h[:, -TAIL:]))

    def serving_batch(fcfg, S_):
        """The prefill's inputs at batch SERVE_B and prompt S_ (for vlm
        after the patches), the first decode position, and a function of
        the decode step i that gives its batch entries besides the token
        and the cache."""
        prompt_ = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, fcfg.vocab, (SERVE_B, S_)), device=dev)
        batch_ = {"tokens": prompt_}
        g = torch.Generator(dev).manual_seed(SEED + 1)
        pos0_ = S_
        if fcfg.family == "vlm":
            nv = fcfg.n_vision_tokens
            grid = int(round(nv ** 0.5))
            r = torch.arange(nv, device=dev)
            vision = torch.stack([torch.zeros_like(r), r // grid, r % grid])
            text = torch.arange(S_, device=dev).expand(3, S_) + grid
            batch_["positions"] = torch.cat([vision, text], dim=1)[
                :, None].expand(3, SERVE_B, nv + S_)
            batch_["patch_embeds"] = torch.randn(
                (SERVE_B, nv, fcfg.d_model), generator=g, device=dev)
            pos0_ = S_ + nv
        if fcfg.family == "encdec":
            batch_["enc_embeds"] = torch.randn(
                (SERVE_B, fcfg.enc_len, fcfg.d_model), generator=g,
                device=dev)

        def decode_extra(i):  # greedy_generate's rule
            extra = {"pos": torch.full((SERVE_B,), pos0_ + i, device=dev)}
            if fcfg.family == "vlm":
                extra["positions"] = torch.full((3, SERVE_B, 1), pos0_ + i,
                                                device=dev)
            return extra

        return batch_, pos0_, decode_extra

    for arch, n_layers, S_arch, ph in (
            ("mamba2-2.7b", None, SERVE_S, "h"),
            ("gemma-7b", None, SERVE_S, "h"),
            ("gemma3-27b", 6, SERVE_S, "h"),
            ("dbrx-132b", 4, SERVE_S, "i"),
            ("deepseek-v3-671b", 4, SERVE_S, "i"),
            ("qwen2-vl-72b", 8, SERVE_S, "j"),
            ("whisper-medium", None, WHISPER_S, "j")):
        fcfg = get_config(arch)
        if n_layers is not None:
            fcfg = fcfg.replace(n_layers=n_layers)
        moe = fcfg.family == "moe"
        encdec = fcfg.family == "encdec"
        t0 = phase(f"({ph}) serving {arch} ({fcfg.family}, "
                   f"{fcfg.n_layers} layers"
                   + (f" + {fcfg.n_enc_layers} encoder layers over "
                      f"{fcfg.enc_len} frames" if encdec else "")
                   + (f", {fcfg.n_vision_tokens} patch embeddings"
                      if fcfg.family == "vlm" else "")
                   + f"), bf16, batch {SERVE_B} x prompt {S_arch} + "
                   f"{SERVE_GEN} tokens")
        per_decode, per_decode32 = {}, {}
        if fcfg.family == "ssm":
            per_prefill = dict(ssd_scan=fcfg.n_layers)
            per_prefill32 = per_prefill
        elif encdec:
            # the encoder's, the decoder's self- and cross-attention; a
            # decode token's cross-attention (its self-attention reads
            # the cache without K6)
            n_fa = fcfg.n_enc_layers + 2 * fcfg.n_layers
            per_prefill = dict(flash_attention_wgmma=n_fa)
            per_prefill32 = dict(flash_attention_tf32=n_fa)
            per_decode = dict(flash_attention_wgmma=fcfg.n_layers)
            per_decode32 = dict(flash_attention_tf32=fcfg.n_layers)
        else:
            per_prefill = dict(flash_attention_wgmma=fcfg.n_layers)
            per_prefill32 = dict(flash_attention_tf32=fcfg.n_layers)
        if fcfg.mla:
            qk = fcfg.nope_head_dim + fcfg.rope_head_dim
            print(f"   MLA: K6 {fa.kernel_for(torch.bfloat16, qk)} at width "
                  f"{max(qk, fcfg.v_head_dim)} (q/k {qk}; v "
                  f"{fcfg.v_head_dim}, zero-padded to {qk}), "
                  f"{fcfg.n_heads} heads", flush=True)
        model = build_model(fcfg)
        w0 = time.perf_counter()
        params = model.init(torch.Generator(dev).manual_seed(SEED))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"   {n_params} parameters drawn on the card in "
              f"{time.perf_counter() - w0:.2f} s", flush=True)
        batch, pos0, decode_extra = serving_batch(fcfg, S_arch)
        s_max = pos0 + SERVE_GEN
        per_generate = {k: per_prefill.get(k, 0)
                        + (SERVE_GEN - 1) * per_decode.get(k, 0)
                        for k in set(per_prefill) | set(per_decode)}
        reset()
        tokens_out = greedy_generate(model, params, batch, steps=SERVE_GEN,
                                     s_max=s_max)
        torch.cuda.synchronize()
        counts = read_counts()
        if not expect(counts, **per_generate):
            fail(f"{arch} greedy_generate launched {counts}, expected "
                 f"{per_generate} (one prefill, {SERVE_GEN - 1} decode "
                 "steps)")
        toks = tokens_out.cpu().numpy()
        if toks.shape != (SERVE_B, SERVE_GEN) or toks.min() < 0 or \
                toks.max() >= fcfg.vocab:
            fail(f"{arch} greedy_generate returned shape {toks.shape}")
        prefill_step, decode_step = (make_prefill_step(model),
                                     make_decode_step(model))
        e_txt = ""
        if encdec:  # the encoder alone, with its launches
            model.encode(params, batch["enc_embeds"])  # warm
            reset()
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            model.encode(params, batch["enc_embeds"])
            torch.cuda.synchronize()
            e_ms = (time.perf_counter() - w0) * 1e3
            e_counts = read_counts()
            if not expect(e_counts, flash_attention_wgmma=fcfg.n_enc_layers):
                fail(f"{arch} encoder launched {e_counts}")
            e_txt = (f"; encoder alone {e_ms:.1f} ms "
                     f"({e_counts['flash_attention_wgmma']} launches)")
            device_breakdown(f"{arch} encoder", lambda: model.encode(
                params, batch["enc_embeds"]))
        cache = model.alloc_cache(SERVE_B, s_max, dev)
        reset()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        with attention_shapes({}) as p_shapes:
            logits_k, cache = prefill_step(params, batch, cache=cache)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - w0) * 1e3
        counts = read_counts()
        if not expect(counts, **per_prefill):
            fail(f"{arch} prefill launched {counts}, expected {per_prefill}")
        family_counts[arch] = counts
        tok = torch.argmax(logits_k, dim=-1).to(torch.int32)[:, None]
        reset()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        with attention_shapes({}) as d_shapes:
            for i in range(SERVE_GEN - 1):
                nxt, logits_d, cache = decode_step(params, {
                    "token": tok, "cache": cache, **decode_extra(i)})
                tok = nxt[:, None]
        torch.cuda.synchronize()
        d_ms = (time.perf_counter() - w0) * 1e3 / (SERVE_GEN - 1)
        dec_counts = read_counts()
        family_shapes[arch] = (p_shapes, d_shapes)
        # every attention call of the prefill and of the decode steps that
        # goes through the wrapper is one launch (MLA's absorbed decode
        # and the self-attention decode read the cache without it)
        for label_, shapes_, counts_ in (("prefill", p_shapes, counts),
                                         ("decode", d_shapes, dec_counts)):
            n_fa = counts_["flash_attention_wgmma"]
            if n_fa and sum(shapes_.values()) != n_fa:
                fail(f"{arch} {label_}: attention calls {shapes_}, "
                     f"{n_fa} launches")
        if not expect(dec_counts, **{k: (SERVE_GEN - 1) * n
                                     for k, n in per_decode.items()}):
            fail(f"{arch} decode launched {dec_counts}, expected "
                 f"{per_decode} a token")
        if not (torch.isfinite(logits_k).all() and torch.isfinite(
                logits_d).all() and tuple(logits_k.shape) == (SERVE_B,
                                                              fcfg.vocab)):
            fail(f"{arch}: non-finite or misshapen serving logits")
        del cache
        family_ms[arch] = (p_ms, d_ms)
        if encdec:
            print(f"   attention launches by (Sq, Sk, causal): prefill "
                  f"{p_shapes}; decode steps {d_shapes}", flush=True)
        print(f"   prefill {p_ms:.1f} ms (launches {counts}); decode "
              f"{d_ms:.2f} ms a token over {SERVE_GEN - 1} steps ("
              + (f"{per_decode} a token" if per_decode else "no kernel")
              + f"){e_txt}; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
              f" GiB; {card}", flush=True)
        if moe:
            again, _ = prefill_step(params, batch)
            torch.cuda.synchronize()
            if not torch.equal(again, logits_k):
                fail(f"{arch}: two bf16 prefills on the same inputs differ "
                     f"(largest |difference| "
                     f"{float((again - logits_k).abs().max()):.3g})")
            print("   two bf16 prefills on the same inputs: bitwise equal "
                  "logits", flush=True)
            del again
        # the logits check: for the moe family its own bf16 prefill too,
        # and, at deepseek, at batch 2: beside its f32 weights (4 bytes
        # times 15.8 B) an 80 GB card has too little room at batch 4 for
        # the plain attention's f32 chunk logits (B·H·S·1024·4 bytes)
        check = {"tokens": batch["tokens"][:2]} if fcfg.mla else batch
        if moe:
            with routing([]) as route_k, last_hidden([]) as h_k:
                logits_k, _ = prefill_step(params, check)
            tail_k = tail_logits(params, fcfg, h_k[0])
        reset()
        with plain_versions(), routing([]) as route_p, \
                last_hidden([]) as h_p:
            logits_p, _ = prefill_step(params, check)
        torch.cuda.synchronize()
        if any(read_counts().values()):
            fail(f"{arch}: the plain-version prefill launched "
                 f"{read_counts()}")
        tail_p = tail_logits(params, fcfg, h_p[0]) if moe else None
        del h_p
        params.float()  # in place: the same weights, exactly, in f32
        torch.cuda.empty_cache()
        cfg32 = fcfg.replace(param_dtype="float32", compute_dtype="float32")
        prefill32 = make_prefill_step(build_model(cfg32))
        reset()
        with routing([]) as route_k32, last_hidden([]) as h_k32:
            logits_k32, _ = prefill32(params, check)
        torch.cuda.synchronize()
        if not expect(read_counts(), **per_prefill32):
            fail(f"{arch}: the f32 prefill launched {read_counts()}, "
                 f"expected {per_prefill32}")
        tail_k32 = tail_logits(params, cfg32, h_k32[0]) if moe else None
        del h_k32
        with plain_versions(), routing([]) as route_p32, \
                last_hidden([]) as h_p32:
            logits_p32, _ = prefill32(params, check)
        torch.cuda.synchronize()
        tail_p32 = tail_logits(params, cfg32, h_p32[0]) if moe else None
        del h_p32
        err32 = l2(logits_k32, logits_p32)
        bf16_k, bf16_p = l2(logits_k, logits_p32), l2(logits_p, logits_p32)
        print(f"   batch {check['tokens'].shape[0]}: f32: ‖kernels − plain‖ / ‖plain‖ "
              f"= {err32:.3g} (tolerance 1e-3); bf16 against the f32 plain "
              f"logits: kernels {bf16_k:.4g}, plain {bf16_p:.4g}"
              + ("" if moe else " (at most 1.5x + 1e-3)")
              + "; top-1 agreement bf16 kernels vs plain "
              f"{float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean()):.2f}; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
              "GiB", flush=True)
        if not err32 <= 1e-3:
            fail(f"{arch} f32 prefill logits: kernels and plain versions "
                 f"differ by {err32:.3g}")
        if moe:
            # routing is discrete: bf16's rounding moves some tokens to
            # other experts, in either run, so the last position's logits
            # of a few rows are a draw; the bf16 check reads the last TAIL
            # positions of each row
            err32 = l2(tail_k32, tail_p32)
            bf16_k, bf16_p = l2(tail_k, tail_p32), l2(tail_p, tail_p32)
            agree_k, agree_p = (float((t.argmax(-1) == tail_p32.argmax(
                -1)).float().mean()) for t in (tail_k, tail_p))
            print(f"   the last {TAIL} positions of each row: f32 "
                  f"‖kernels − plain‖ / ‖plain‖ = {err32:.3g} (tolerance "
                  f"1e-3); bf16 against the f32 plain logits: kernels "
                  f"{bf16_k:.4g}, plain {bf16_p:.4g} (at most 1.5x + 1e-3); "
                  f"top-1 agreement with the f32 plain logits: kernels "
                  f"{agree_k:.3f}, plain {agree_p:.3f}", flush=True)
            for label, a, b in (
                    ("bf16 kernels vs bf16 plain", route_k, route_p),
                    ("f32 kernels vs f32 plain", route_k32, route_p32),
                    ("bf16 kernels vs f32 plain", route_k, route_p32),
                    ("bf16 plain vs f32 plain", route_p, route_p32)):
                print(f"   routing, {label}, per moe layer (routes not "
                      "taken by the second run / of all; kept tokens not "
                      "kept by it / of all): " + "; ".join(
                          f"{r}/{n_r}, {c}/{n_c}"
                          for r, n_r, c, n_c in routing_diff(a, b)),
                      flush=True)
            if not err32 <= 1e-3:
                fail(f"{arch} f32 logits of the last {TAIL} positions: "
                     f"kernels and plain versions differ by {err32:.3g}")
            del route_k, route_p, route_k32, route_p32
            del tail_k, tail_p, tail_k32, tail_p32
        if not bf16_k <= 1.5 * bf16_p + 1e-3:
            fail(f"{arch} bf16 prefill logits: the kernels are {bf16_k:.4g} "
                 f"from the f32 logits, the plain versions {bf16_p:.4g}")
        if per_decode32:
            # a decode step that launches K6 (whisper's cross-attention,
            # one query row against the 1500 frames): one f32 step through
            # the kernels against the plain versions on copies of one cache
            model32 = build_model(cfg32)
            cache_k = model32.alloc_cache(SERVE_B, pos0 + 1, dev)
            logits32, cache_k = model32.prefill(params, batch, cache=cache_k)
            cache_p = {k: v.clone() for k, v in cache_k.items()}
            step = {"token": torch.argmax(logits32, dim=-1)[:, None],
                    **decode_extra(0)}
            reset()
            dec_k, _ = model32.decode(params, {**step, "cache": cache_k})
            torch.cuda.synchronize()
            if not expect(read_counts(), **per_decode32):
                fail(f"{arch}: the f32 decode step launched {read_counts()}, "
                     f"expected {per_decode32}")
            with plain_versions():
                dec_p, _ = model32.decode(params, {**step, "cache": cache_p})
            err_d = l2(dec_k, dec_p)
            print(f"   one f32 decode step ({per_decode32} a token): "
                  f"‖kernels − plain‖ / ‖plain‖ = {err_d:.3g} (tolerance "
                  "1e-3)", flush=True)
            if not err_d <= 1e-3:
                fail(f"{arch} f32 decode logits: kernels and plain versions "
                     f"differ by {err_d:.3g}")
            del cache_k, cache_p, logits32, dec_k, dec_p
        del params, model, logits_k32, logits_p32, logits_k, logits_p
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        done(t0)

    # ------------------------------------------------------------ training
    # (k) training on the card, no fallback: the attention (K6) and SSD
    # (K7) backward kernels against their plain versions (and the plain
    # versions run in f64), bitwise repeatable; qwen2.5-32b at full width
    # with 4 of its 64 layers and FULL mamba2-2.7b through
    # make_train_step, bf16, 5 AdamW steps on one 2 x 2049-token batch of
    # SyntheticLM, the loss falling, the launches of each step counted
    # (remat "full": the forward, its recompute and one backward a layer),
    # the first step's loss and gradient norm against the same step under
    # plain_versions(), and every gradient leaf of the attention layers and
    # the Mamba2 mixers in f32, each gate beside a planted fault that it
    # must see; launch.train on the reduced qwen2.5-32b with a scheduled
    # failure, restarted once from its checkpoint
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainState, make_train_step
    torch.cuda.empty_cache()
    bwd_err = {"flash_attention_bwd": 0.0, "flash_attention_bwd f32": 0.0,
               "ssd_bwd": 0.0}

    def grad_dist(got, want):
        """max |got − want| / (1 + |want|) over one gradient, in f64."""
        return float(((got.double() - want).abs() / (1 + want.abs())).max())

    t0 = phase("(k) training: the attention backward (K6) against its plain "
               "version and the f64 plain version")
    # label, B, Sq, Sk, H, KH, q/k and v head dims, causal, window, dtype
    for (label, B, Sq, Sk, H, KH, hd, vh, causal, window, dtype) in (
            ("qwen2.5-32b", 2, 2048, 2048, 40, 8, 128, 128, True, 0,
             torch.bfloat16),
            ("gemma-7b", 2, 2048, 2048, 16, 16, 256, 256, True, 0,
             torch.bfloat16),
            ("gemma3-27b local", 2, 2048, 2048, 32, 16, 128, 128, True, 1024,
             torch.bfloat16),
            ("whisper encoder", 2, 1500, 1500, 16, 16, 64, 64, False, 0,
             torch.bfloat16),
            ("whisper cross", 2, 448, 1500, 16, 16, 64, 64, False, 0,
             torch.bfloat16),
            ("deepseek-v3 MLA", 1, 2048, 2048, 128, 128, 192, 128, True, 0,
             torch.bfloat16),
            ("zamba2-7b", 2, 2048, 2048, 32, 32, 112, 112, True, 0,
             torch.float32),
            ("qwen2.5-32b", 2, 2048, 2048, 40, 8, 128, 128, True, 0,
             torch.float32),
            ("tiny-100m", 16, 256, 256, 8, 4, 64, 64, True, 0,
             torch.float32)):
        g = torch.Generator(dev).manual_seed(Sq + hd + vh)
        q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                       for s in ((B, Sq, H, hd), (B, Sk, KH, hd),
                                 (B, Sk, KH, vh), (B, Sq, H, vh)))
        kw = dict(scale=hd ** -0.5, causal=causal, window=window)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        if not torch.equal(o, fa.flash_attention(q, k, v, **kw)):
            fail(f"K6 {label}: the output with the log-sum-exp differs from "
                 "the output without it")
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K6 backward {label}: two runs differ")
        po, plse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
        plain = fa.flash_attention_bwd_ref(q, k, v, po, plse, do, **kw)
        del po, plse
        d64 = [t.double() for t in (q, k, v, do)]
        o64, l64 = fa.flash_attention_ref(*d64[:3], return_lse=True,
                                          chunk=512, **kw)
        exact = fa.flash_attention_bwd_ref(*d64[:3], o64, l64, d64[3],
                                           chunk=512, **kw)
        del d64, o64, l64
        dt_ = "bf16" if dtype == torch.bfloat16 else "f32"
        lse_err = float((lse.double() - fa.flash_attention_ref(
            q.double(), k.double(), v.double(), return_lse=True, chunk=512,
            **kw)[1]).abs().max())
        parts = []
        err_key = "flash_attention_bwd" + (" f32" if dtype == torch.float32
                                           else "")
        for name, a, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            err_k, err_p = grad_dist(a, e), grad_dist(p, e)
            bwd_err[err_key] = max(bwd_err[err_key],
                                   float((a.float() - p.float()).abs().max()))
            limit = (2 * err_p + 1e-5 if dtype == torch.float32
                     else 1.5 * err_p + 2e-3)
            parts.append(f"{name} {err_k:.3g} (plain {err_p:.3g}, limit "
                         f"{limit:.3g})")
            if not err_k <= limit:
                fail(f"K6 backward {label} {dt_}: {name} is {err_k:.4g} from "
                     f"the f64 plain version, over {limit:.4g}")
        print(f"   {label} {dt_} B={B} Sq={Sq} Sk={Sk} H={H} KH={KH} q/k {hd} "
              f"v {vh} {'causal' if causal else 'bidirectional'}"
              + (f" window {window}" if window else "") + ": from the f64 "
              "plain backward, max |a − exact| / (1 + |exact|): "
              + "; ".join(parts) + f"; lse {lse_err:.3g} from f64; two runs "
              "bitwise equal", flush=True)
        del q, k, v, do, o, lse, got, again, plain, exact
        torch.cuda.empty_cache()
    done(t0)

    t0 = phase("(k) training: the SSD backward (K7) against its plain "
               "version and the f64 plain version")
    # the last case is the Mamba2 training path's: 16 whole chunks and no
    # final-state gradient (the model drops the final state)
    for label, (B, S, H, P, N, Q), with_dst in (
            ("mamba2-2.7b, S % Q = 1", (2, 2049, 80, 64, 128, 128), True),
            ("zamba2-7b", (2, 2048, 112, 64, 64, 128), True),
            ("mamba2-2.7b training, no final-state gradient",
             (2, 2048, 80, 64, 128, 128), False)):
        args = ssd_inputs(B, S, H, P, N, 23)
        g = torch.Generator(dev).manual_seed(29)
        dy = torch.randn((B, S, H, P), generator=g, device=dev)
        dst = (torch.randn((B, H, N, P), generator=g, device=dev)
               if with_dst else None)
        _, _, states, cum = ssd.ssd_scan_saved(*args, Q)
        got = ssd.ssd_bwd(*args, Q, dy, dst, states, cum)
        again = ssd.ssd_bwd(*args, Q, dy, dst, states, cum)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K7 backward {label}: two runs differ")
        plain = ssd.ssd_bwd_ref(*args, Q, dy, dst)
        exact = ssd.ssd_bwd_ref(*(t.double() for t in args), Q, dy.double(),
                                None if dst is None else dst.double())
        parts = []
        for name, a, p, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, plain,
                                 exact):
            scale = float(e.abs().max())  # dA sums every step of every row
            err_k = grad_dist(a / scale, e / scale)
            err_p = grad_dist(p / scale, e / scale)
            bwd_err["ssd_bwd"] = max(bwd_err["ssd_bwd"],
                                     float((a - p).abs().max()))
            limit = 2 * err_p + 1e-5
            parts.append(f"{name} {err_k:.3g} (plain {err_p:.3g})")
            if not err_k <= limit:
                fail(f"K7 backward {label}: {name} is {err_k:.4g} from the "
                     f"f64 plain version, over {limit:.4g}")
        print(f"   {label} B={B} S={S} H={H} P={P} N={N} Q={Q}: from the f64 "
              "plain backward, max |a − exact| / (1 + |exact|) over the "
              "gradient scaled to max |exact| = 1 (limit twice the f32 plain "
              "version's + 1e-5): " + "; ".join(parts) + "; two runs bitwise "
              "equal", flush=True)
        del args, dy, dst, states, cum, got, again, plain, exact
        torch.cuda.empty_cache()
    done(t0)

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    @contextlib.contextmanager
    def planted_fault():
        """For the controls only: the backward kernels' dK (attention) and
        dB (SSD) set to zero, faults that the gradient gates must see."""
        saved = fa_ops.flash_attention_bwd, ssd_ops.ssd_bwd

        def attention_bwd(*args, **kw):
            dq, dk, dv = saved[0](*args, **kw)
            return dq, torch.zeros_like(dk), dv

        def scan_bwd(*args, **kw):
            dx, ddt, dA, dB, dC = saved[1](*args, **kw)
            return dx, ddt, dA, torch.zeros_like(dB), dC

        fa_ops.flash_attention_bwd, ssd_ops.ssd_bwd = attention_bwd, scan_bwd
        try:
            yield
        finally:
            fa_ops.flash_attention_bwd, ssd_ops.ssd_bwd = saved

    def first_grads(model_t, params_t, batch_t, keep=lambda name: False):
        """One forward and backward of the loss: the loss, the global
        gradient norm (f32) and the gradients of the leaves ``keep``
        names."""
        named = list(params_t.named_parameters())
        loss, _ = model_t.loss(params_t, batch_t, remat="full")
        gs = torch.autograd.grad(loss, [p for _, p in named],
                                 allow_unused=True)
        norm = float(torch.sqrt(sum(torch.sum(torch.square(x.float()))
                                    for x in gs if x is not None)))
        return (float(loss.detach()), norm,
                {n: x for (n, _), x in zip(named, gs) if keep(n)})

    def leaf_gap(got, want):
        """The largest ‖got − want‖₂ / ‖want‖₂ over the leaves, and its
        leaf."""
        return max((float(torch.linalg.vector_norm(got[n].float() - w.float())
                          / torch.linalg.vector_norm(w.float())), n)
                   for n, w in want.items())

    def train_batch(cfg_t):
        tokens = SyntheticLM(vocab=cfg_t.vocab, seq_len=2048, global_batch=2,
                             seed=SEED).batch(0)["tokens"]
        return {"tokens": torch.as_tensor(tokens, device=dev).long()}

    # every gradient leaf that the backward kernels feed, in f32, where the
    # kernels and the plain versions agree to ~1e-5 and a wrong gradient
    # stands out; bf16's rounding spreads over the layers (its leaves
    # differ by several percent between two sound paths), so there the
    # gate is the global norm below
    LEAF_LIMIT = 1e-3
    for arch, n_layers, keep, what in (
            ("qwen2.5-32b", 4,
             # the key bias's gradient is zero in exact arithmetic (a
             # softmax does not see a shift common to its row), so both
             # paths hold only rounding there
             lambda n: ".attn." in n and not n.endswith(".bk"),
             "the attention leaves"),
            ("mamba2-2.7b", 16, lambda n: ".mixer." in n,
             "the Mamba2 mixers' leaves")):
        cfg_l = dataclasses.replace(get_config(arch), n_layers=n_layers,
                                    param_dtype="float32",
                                    compute_dtype="float32")
        t0 = phase(f"(k) training: {what} of {arch} ({n_layers} layers, "
                   "full width, f32), one step's gradient through the "
                   "kernels against the plain versions, and a planted fault")
        model_l = build_model(cfg_l)
        params_l = model_l.init(torch.Generator(dev).manual_seed(SEED),
                                trainable=True)
        batch_l = train_batch(cfg_l)
        with plain_versions():
            _, _, want = first_grads(model_l, params_l, batch_l, keep)
        _, _, got = first_grads(model_l, params_l, batch_l, keep)
        sound = leaf_gap(got, want)
        del got
        with planted_fault():
            _, _, bad = first_grads(model_l, params_l, batch_l, keep)
        control = leaf_gap(bad, want)
        del bad
        print(f"   {len(want)} leaves; the largest ‖Δg‖₂ / ‖g‖₂ from the "
              f"plain versions': kernels {sound[0]:.3g} ({sound[1]}), "
              f"planted fault {control[0]:.3g} ({control[1]}); limit "
              f"{LEAF_LIMIT:g}", flush=True)
        if not sound[0] <= LEAF_LIMIT:
            fail(f"{arch} f32: the gradient of {sound[1]} is {sound[0]:.4g} "
                 f"from the plain versions', over {LEAF_LIMIT:g}")
        if not control[0] > LEAF_LIMIT:
            fail(f"{arch} f32: the planted fault stays within {LEAF_LIMIT:g} "
                 f"({control[0]:.4g}): the leaf gate cannot see it")
        del model_l, params_l, batch_l, want
        torch.cuda.empty_cache()
        done(t0)

    train_counts, train_ms = {}, {}
    # what phase (l) holds the dry run's plan against: each cell's config,
    # its state's bytes, the step's own peak (the process's peak less what
    # was allocated before the cell's model was built) and FLOPs
    train_cfg, train_state_bytes, train_own_peak, train_flops = {}, {}, {}, {}
    train_steps = {}
    TRAIN_STEPS, TRAIN_LR = 5, 1e-4
    STEP_LIMIT = 1e-3  # relative, for the first step's loss and norm

    def train_phase(arch, n_layers, per_step):
        """``TRAIN_STEPS`` steps of ``arch`` (``n_layers`` of them, or
        FULL) at full width in bf16 on one batch; ``per_step``: the
        launches a step must make."""
        cfg_t = get_config(arch)
        if n_layers:
            cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
        base_t = torch.cuda.memory_allocated()
        t0 = phase(f"(k) training: {arch} ({cfg_t.n_layers} layers, full "
                   f"width), bf16, {TRAIN_STEPS} AdamW steps on a 2 x 2049-"
                   "token SyntheticLM batch, remat full")
        model_t = build_model(cfg_t)
        params_t = model_t.init(torch.Generator(dev).manual_seed(SEED),
                                trainable=True)
        n_par = sum(p.numel() for p in params_t.parameters())
        batch_t = train_batch(cfg_t)
        # the first step's loss and gradient norm through the plain
        # versions, before any update, and the norm under a planted fault
        reset()
        with plain_versions():
            loss_p, gnorm_p, _ = first_grads(model_t, params_t, batch_t)
        if not expect(read_counts()):
            fail(f"{arch}: the plain-version step launched {read_counts()}")
        with planted_fault():
            _, gnorm_c, _ = first_grads(model_t, params_t, batch_t)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt_t = AdamW(lr=TRAIN_LR)
        state_t = TrainState(params=params_t, opt=opt_t.init(params_t),
                             err=None)
        step_t = make_train_step(model_t, opt_t, remat="full")
        losses, step_ms, gnorms = [], [], []
        reset()
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            state_t, m = step_t(state_t, batch_t)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - w0) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        gnorm_k = gnorms[0]
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        train_own_peak[arch] = torch.cuda.max_memory_allocated() - base_t
        train_state_bytes[arch] = sum(
            t.nbytes for t in (*params_t.parameters(), state_t.opt.step,
                               *state_t.opt.m.values(),
                               *state_t.opt.v.values()))
        want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
        print(f"   {n_par} parameters; launches over {TRAIN_STEPS} steps "
              f"{counts}; losses {[round(x, 4) for x in losses]}; step ms "
              f"{[round(x, 1) for x in step_ms]}; peak memory {peak:.2f} GiB",
              flush=True)
        gap_l = abs(losses[0] - loss_p) / abs(loss_p)
        gap_n, gap_c = (abs(x - gnorm_p) / gnorm_p for x in (gnorm_k, gnorm_c))
        print(f"   first step: loss {losses[0]:.6f} (plain versions "
              f"{loss_p:.6f}, {gap_l:.3g} relative), gradient norm "
              f"{gnorm_k:.6f} (plain {gnorm_p:.6f}, {gap_n:.3g}); limit "
              f"{STEP_LIMIT:g} relative for each (bf16: the plain attention "
              "rounds q·k and p to bf16, the kernels do not); the planted "
              f"fault's norm {gnorm_c:.6f} ({gap_c:.3g})", flush=True)
        if not expect(counts, **want):
            fail(f"{arch} training launched {counts}, expected {want}")
        if not losses[-1] < losses[0] or not all(map(np.isfinite, losses)):
            fail(f"{arch}: the loss did not fall over {TRAIN_STEPS} steps: "
                 f"{losses}")
        if not gap_c > STEP_LIMIT:
            fail(f"{arch}: the planted fault moves the gradient norm by "
                 f"{gap_c:.4g}, within {STEP_LIMIT:g}: the gate cannot see it")
        if not (gap_l <= STEP_LIMIT and gap_n <= STEP_LIMIT):
            fail(f"{arch}: the first step's loss {losses[0]} / gradient norm "
                 f"{gnorm_k} differ from the plain versions' {loss_p} / "
                 f"{gnorm_p}")
        # one more step under torch.profiler: where a step's device time
        # goes, by operation
        from torch.profiler import ProfilerActivity, profile
        with warnings.catch_warnings():  # its note on clearing events
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                state_t, _ = step_t(state_t, batch_t)
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - w0) * 1e3
        evts = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0.0) > 0]
        dev_ms = sum(e.device_time_total for e in evts) / 1e3
        top = sorted(evts, key=lambda e: e.device_time_total, reverse=True)
        print(f"   one step under torch.profiler: {host_ms:.1f} ms on the "
              f"host clock, {dev_ms:.1f} ms of device time in "
              f"{sum(e.count for e in evts)} launches; the ten device "
              "operations with the most total time:", flush=True)
        for e in top[:10]:
            print(f"      {e.device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
                  f"{e.key[:110]}", flush=True)
        # one more step under FlopCounterMode: the aten products and the
        # kernels' own work (kernels.work), which phase (l) holds the dry
        # run's count against
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as flop_mode:
            state_t, _ = step_t(state_t, batch_t)
        train_flops[arch] = flop_mode.get_total_flops()
        train_cfg[arch] = cfg_t
        print(f"   one more step under FlopCounterMode: {train_flops[arch]} "
              f"FLOPs; the state {train_state_bytes[arch]} bytes; the step's "
              f"own peak {train_own_peak[arch]} bytes (the process's "
              f"{peak:.2f} GiB less {base_t} bytes held before the model "
              "was built)", flush=True)
        train_counts[arch] = counts
        train_ms[arch] = (sorted(step_ms[1:])[len(step_ms[1:]) // 2], peak)
        train_steps[arch] = (losses, gnorms)  # what phase (m) is held to
        del model_t, params_t, state_t, step_t, opt_t, batch_t, m
        torch.cuda.empty_cache()
        done(t0)

    q_layers = 4
    train_phase("qwen2.5-32b", q_layers, {
        "flash_attention_wgmma": 2 * q_layers,
        "flash_attention_bwd": q_layers})
    m_layers = get_config("mamba2-2.7b").n_layers
    train_phase("mamba2-2.7b", 0, {"ssd_scan": 2 * m_layers,
                                   "ssd_bwd": m_layers})

    t0 = phase("(k) training: launch.train on the card, reduced qwen2.5-32b, "
               "30 steps, a failure at step 12, a checkpoint every 5")
    import tempfile
    with tempfile.TemporaryDirectory() as ckdir:
        reset()
        summary = train_mod.main([
            "--arch", "qwen2.5-32b", "--reduced", "--steps", "30", "--batch",
            "2", "--seq", "64", "--fail-at", "12", "--save-every", "5",
            "--ckpt-dir", ckdir])
        torch.cuda.synchronize()
        counts = read_counts()
    ran = summary["steps"] + summary["lost_steps"]
    n_l = get_config("qwen2.5-32b", reduced=True).n_layers
    print(f"   summary {summary}; launches {counts} over {ran} steps run",
          flush=True)
    if summary["restarts"] != 1 or summary["steps"] != 30 or not (
            summary["last_loss"] < summary["first_loss"]):
        fail(f"launch.train: {summary}")
    if not expect(counts, flash_attention_tf32=n_l * ran,
                  flash_attention_bwd=n_l * ran):
        fail(f"launch.train launched {counts}, expected {n_l * ran} of each "
             "attention kernel")
    k_launch = (summary, counts)  # what (m3) is held to
    done(t0)

    # the training milestone, examples/train_tiny_lm.py, through the port:
    # its config registered by name in the registry at run time, its
    # parameters counted without allocation, then launch.train with its
    # flags on the card (f32, as qwen2.5-32b's REDUCED config: the split-
    # TF32 forward and backward of K6 in each of its 8 layers a step)
    from repro_torch import configs as configs_mod
    from repro_torch.runtime import init_train_state
    from repro_torch.optim import linear_warmup_cosine
    TINY_STEPS = 300
    # examples/train_tiny_lm.py asserts last_loss < 0.7 x first_loss, which
    # the JAX package itself misses on these flags: the example run with
    # JAX on the CPU ends at 7.1773 from 9.4892, 0.7564 of it.  The port is
    # held to that reference ratio, with 0.02 for its other draw of the
    # initial weights, and to a falling loss; the example's 0.7 is printed
    TINY_REF_RATIO = 0.7564
    tiny = get_config("qwen2.5-32b", reduced=True).replace(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=8192)
    t0 = phase(f"(k) training: the tiny-100m milestone (examples/"
               f"train_tiny_lm.py: {tiny.n_layers} layers, d "
               f"{tiny.d_model}, heads {tiny.n_heads}:{tiny.n_kv_heads} of "
               f"{tiny.head_dim}, vocab {tiny.vocab}, {tiny.param_dtype}), "
               f"launch.train {TINY_STEPS} steps at batch 16 x 256, a failure "
               "at step 120, a checkpoint every 50")
    n_tiny = sum(p.numel() for p in build_model(tiny).abstract().parameters())
    print(f"   model: {n_tiny / 1e6:.1f}M params (build_model(cfg).abstract(),"
          " meta device)", flush=True)
    configs_mod._MODULES["tiny-100m"] = type("M", (), {"FULL": tiny,
                                                       "REDUCED": tiny})
    try:
        with tempfile.TemporaryDirectory() as ckdir:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset()
            summary = train_mod.main([
                "--arch", "tiny-100m", "--steps", str(TINY_STEPS), "--batch",
                "16", "--seq", "256", "--lr", "1e-3", "--fail-at", "120",
                "--save-every", "50", "--ckpt-dir", ckdir])
            torch.cuda.synchronize()
            tiny_counts = read_counts()
            tiny_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        del configs_mod._MODULES["tiny-100m"]
    ran = summary["steps"] + summary["lost_steps"]
    print(f"   summary {summary}; launches {tiny_counts} over {ran} steps "
          f"run; {summary['wall_s'] * 1e3 / ran:.1f} ms a step run on the "
          f"driver's clock (checkpoints and the restart included); peak "
          f"memory {tiny_peak:.2f} GiB", flush=True)
    if summary["restarts"] != 1 or summary["steps"] != TINY_STEPS:
        fail(f"the tiny-100m milestone: {summary}")
    ratio = summary["last_loss"] / summary["first_loss"]
    print(f"   last loss / first loss {ratio:.4f}: the JAX package's own run "
          f"of the example {TINY_REF_RATIO} (limit {TINY_REF_RATIO + 0.02:.4f})"
          f"; the example's assertion, under 0.7: "
          f"{'met' if ratio < 0.7 else 'not met'} (by JAX: not met)",
          flush=True)
    if not ratio <= TINY_REF_RATIO + 0.02:
        fail(f"the tiny-100m milestone: the last loss {summary['last_loss']}"
             f" is {ratio:.4f} of the first {summary['first_loss']}, over "
             f"the JAX package's {TINY_REF_RATIO} + 0.02")
    want = tiny.n_layers * ran
    if not expect(tiny_counts, flash_attention_tf32=want,
                  flash_attention_bwd=want):
        fail(f"the tiny-100m milestone launched {tiny_counts}, expected "
             f"{want} of each attention kernel")
    # its step alone, as the driver builds it: ms a step (median of 10
    # after 3), then one step under torch.profiler for the device's idle
    # share
    model_m = build_model(tiny)
    opt_m = AdamW(lr=linear_warmup_cosine(1e-3, 10, TINY_STEPS))
    step_m = make_train_step(model_m, opt_m, remat="none")
    state_m = init_train_state(model_m, torch.Generator(dev).manual_seed(0),
                               opt_m)
    batch_m = {"tokens": torch.as_tensor(SyntheticLM(
        vocab=tiny.vocab, seq_len=256, global_batch=16, seed=0).batch(0)[
            "tokens"], device=dev).long()}
    tiny_ms = []
    for i in range(13):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        state_m, _ = step_m(state_m, batch_m)
        torch.cuda.synchronize()
        if i >= 3:
            tiny_ms.append((time.perf_counter() - w0) * 1e3)
    tiny_ms = sorted(tiny_ms)[len(tiny_ms) // 2]
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():  # its note on clearing events
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            state_m, _ = step_m(state_m, batch_m)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - w0) * 1e3
    evts = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) > 0]
    dev_ms = sum(e.device_time_total for e in evts) / 1e3
    tiny_idle = max(0.0, 1.0 - dev_ms / host_ms)
    print(f"   its step alone: {tiny_ms:.2f} ms (median of 10 after 3 warm-"
          f"up steps); one step under torch.profiler: {host_ms:.2f} ms on "
          f"the host clock, {dev_ms:.2f} ms of device time in "
          f"{sum(e.count for e in evts)} launches, the device idle "
          f"{100 * tiny_idle:.1f}% of it", flush=True)
    del model_m, opt_m, step_m, state_m, batch_m
    torch.cuda.empty_cache()
    done(t0)

    execution_across_ranks(
        dev, train_steps, train_ms, k_launch, STEP_LIMIT, train_batch, reset,
        read_counts, expect, serve=lambda mesh: serving_across_ranks(
            mesh, dev, card, serving_batch, reset, read_counts, expect))

    # ------------------------------------------- the dry run against the card
    # (l) the ported dry run plans phase (k)'s two training cells on a
    # one-device mesh of the card and is held against their measurements
    # (plan_against_card); then the FULL multi-pod cell plans
    from repro_torch.configs import Shape
    t0 = phase("(l) the dry run against the card: qwen2.5-32b (4 layers) and "
               "FULL mamba2-2.7b planned at 2 x 2049 tokens, remat full, "
               "beside phase (k)'s measured state, FLOPs and peak; the FULL "
               "multi-pod qwen2.5-32b train_4k cell planned")
    plan_against_card(
        [(arch, train_cfg[arch], train_state_bytes[arch],
          train_own_peak[arch], train_flops[arch], train_ms[arch][0],
          arch == "mamba2-2.7b") for arch in ("qwen2.5-32b", "mamba2-2.7b")],
        Shape("train_2k", 2048, 2, "train"))
    done(t0)

    # ------------------------------------------------------------ timing
    t0 = phase("times at the main paths' shapes (profiler device time, "
               "CUDA events over back-to-back launches)")
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    keep = []  # outputs of the raw launches, alive while they are timed
    rows_out = []

    def checked(launch, args):
        def call():
            err = launch(*args)
            if err:
                fail(f"raw launch returned CUDA error {err}")
        return call

    def floor_ms(gx, gy, threads):
        """Device ms of an empty kernel on a grid of (gx, gy) blocks of
        ``threads``: the floor no launch of that shape beats."""
        ms, _ = profiled_ms(checked(lib.dp_empty_launch,
                                    (gx, gy, threads, stream)), 500,
                            "empty_kernel")
        return ms

    def row(
        name,
        replaces,
        shapes,
        launches,
        err,
        timed,
        p_ms,
        bound,
        source=SOURCE,
        ops_per_s=INT32_OPS_PER_S,
        ops_kind="int32",
        library_ms=None,
        floor=None,
    ):
        ev_ms, w_ms, prof_ms = timed
        nbytes, nops = bound
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / ops_per_s * 1e3
        # a launch takes no less than the bound, and no longer than the
        # span of back-to-back launches over their number (one stream)
        if prof_ms is not None and not (
                max(t_bytes, t_ops) <= prof_ms <= 1.1 * ev_ms):
            print(f"   {name}: the trace's device time {prof_ms:.4f} ms lies "
                  f"outside [the bound, 1.1 x the CUDA events' {ev_ms:.4f} "
                  "ms]: timed by CUDA events instead", flush=True)
            prof_ms = None
        # back-to-back launches of a kernel shorter than one host launch
        # time the host; the trace's device time is the kernel's own
        k_ms = ev_ms if prof_ms is None else prof_ms
        rows_out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms})
        prof = "not measured" if prof_ms is None else f"{prof_ms:.4f} ms"
        lib_txt = ("" if library_ms is None
                   else f", library call {library_ms:.4f} ms")
        lib_txt += ("" if floor is None else
                    f", an empty kernel on its grid {floor:.5f} ms")
        print(f"   {name} {shapes}: kernel {k_ms:.4f} ms (profiler device "
              f"time {prof}, CUDA events over back-to-back launches "
              f"{ev_ms:.4f} ms), through the wrapper {w_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms{lib_txt}, bound "
              f"{max(t_bytes, t_ops) * 1e3:.4f} us ({nbytes} bytes, {nops} "
              f"{ops_kind} ops), launches {launches}", flush=True)

    def timed(raw, wrapper, kernel_names, calls, launches_per_call=1):
        prof_ms, shares = profiled_ms(raw, calls, kernel_names,
                                      launches_per_call)
        if len(shares) > 1:
            print("   device ms per call by kernel: " + ", ".join(
                f"{k} {v:.4f}" for k, v in shares.items()), flush=True)
        return per_call_ms(raw, calls), per_call_ms(wrapper, calls), prof_ms

    # whole plane and epilogue: Table 2, T = 2000
    s_cap = stats.s_cap_for_horizon(T, table2.m)
    S, C, E = s_cap + 1, tables2.n_states, table2.n_edges
    feas, offs, v0 = operands(tables2, s_cap)
    W = kernel.packed_words(E)

    def raw_forward(u, s, a, B):
        """The forward's C entry point on outputs allocated once: one
        launch without the wrapper's checks and allocations."""
        out = (torch.empty((B, S, C), dtype=torch.int32, device=dev),
               torch.empty((B, W, S, C), dtype=torch.int32, device=dev))
        keep.append(out)
        return checked(lib.dp_forward_launch, (
            u.data_ptr(), s.data_ptr(), a.data_ptr(), feas.data_ptr(),
            offs.data_ptr(), v0.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), B, E, S, C, stream))

    def fwd_bound(B):
        nbytes = 4 * (3 * B * E + E * C + E + S * C + B * S * C
                      + B * W * S * C)
        return nbytes, FWD_OPS_PER_CELL * B * E * S * C

    def epi_bound(x):
        """Per instance: the V column at full_state (S) and the value row
        (S), one word and one x per edge (2E), s_limit and s* (2); Υ̂ of
        each taken edge, and each offset that some instance's walk uses."""
        B = x.shape[0]
        nbytes = 4 * (B * (2 * S + 2 * E + 2) + int(x.sum())
                      + int(x.any(0).sum()))
        return nbytes, B * (5 * S + 6 * E)

    ups, sig, slim, alw = stats_case(table2, FLEET, 99)
    alw_i = alw.to(torch.int32)
    for B, launches in ((1, counts_single), (FLEET, counts_fleet)):
        u, s, a = (t[:B].contiguous() for t in (ups, sig, alw_i))
        t_k = timed(raw_forward(u, s, a, B),
                    lambda: kernel.dp_forward_batched(u, s, a, feas, offs,
                                                      v0),
                    "dp_forward_kernel", 200)
        p_k = per_call_ms(lambda: ref.dp_forward_ref(u, s, a, feas, offs,
                                                     v0), 3, reps=3)
        row(f"dp_forward_batched B={B} "
            f"({'K1 _dp_kernel' if B == 1 else 'K2 _dp_kernel_batched'})",
            TPU + ("kernel.py:409" if B == 1 else "kernel.py:484"),
            f"B={B} S={S} C={C} E={E}", launches["dp_forward_batched"],
            worst["dp_forward_batched"], t_k, p_k, fwd_bound(B))
    V, Wd = kernel.dp_forward_batched(ups, sig, alw_i, feas, offs, v0)
    epi_out = (torch.empty((FLEET, E), dtype=torch.int32, device=dev),
               torch.empty((FLEET,), dtype=torch.int32, device=dev),
               torch.empty((FLEET, S), dtype=torch.int32, device=dev))
    keep.append(epi_out)
    t3 = timed(checked(lib.dp_epilogue_launch, (
        V.data_ptr(), Wd.data_ptr(), ups.data_ptr(), offs.data_ptr(),
        slim.data_ptr(), None, None, tables2.full_state, FLEET, E, W, S, C,
        epi_out[0].data_ptr(), epi_out[1].data_ptr(), epi_out[2].data_ptr(),
        stream)),
        lambda: kernel.dp_epilogue(V, Wd, ups, offs, slim,
                                   tables2.full_state),
        "dp_epilogue_kernel", 500)
    p3 = per_call_ms(lambda: ref.dp_epilogue_ref(V, Wd, ups, offs, slim,
                                                 tables2.full_state), 3,
                     reps=3)
    x_epi = kernel.dp_epilogue(V, Wd, ups, offs, slim, tables2.full_state)[0]
    if not torch.equal(epi_out[0], x_epi):
        fail("the raw epilogue launch and the wrapper disagree in x")
    # the row names the fleet's shapes, so it counts the fleet run's launches
    print(f"   dp_epilogue launches: simulate {counts_single['dp_epilogue']}, "
          f"simulate_batch {counts_fleet['dp_epilogue']}", flush=True)
    row("dp_epilogue (s* + backtrack)", TPU + "ops.py:231",
        f"B={FLEET} S={S} C={C} E={E}", counts_fleet["dp_epilogue"],
        worst["dp_epilogue"], t3, p3, epi_bound(x_epi),
        floor=floor_ms(FLEET, 1, 256))

    # the walk's cost an edge: B = 1, walks cut to E' edges (E' = 0: the
    # s* rule alone)
    def epi_raw(V_, W_, u_, o_, l_, full_, B_, E_, S_, C_):
        """One raw launch of the (default) epilogue."""
        o3 = (torch.empty((B_, E_), dtype=torch.int32, device=dev),
              torch.empty((B_,), dtype=torch.int32, device=dev),
              torch.empty((B_, S_), dtype=torch.int32, device=dev))
        keep.append(o3)
        return checked(lib.dp_epilogue_launch, (
            V_.data_ptr(), W_.data_ptr(), u_.data_ptr(), o_.data_ptr(),
            l_.data_ptr(), None, None, full_, B_, E_, W_.shape[1], S_, C_,
            o3[0].data_ptr(), o3[1].data_ptr(), o3[2].data_ptr(), stream))

    pts = [(n, profiled_ms(epi_raw(
        V[:1], Wd[:1], ups[:1, :n].contiguous(), offs[:n].contiguous(),
        slim[:1], tables2.full_state, 1, n, S, C), 300,
        "dp_epilogue_kernel")[0]) for n in (0, 1, 9, 17, 25, 33)]
    if all(ms is not None for _, ms in pts):
        slope = float(np.polyfit([n for n, _ in pts[1:]],
                                 [ms for _, ms in pts[1:]], 1)[0])
        print(f"   dp_epilogue B=1 S={S} C={C}: device ms at E' = "
              + ", ".join(f"{n}: {ms:.5f}" for n, ms in pts)
              + f"; {slope * 1e3:.5f} us an edge (least squares over "
              "E' >= 1)", flush=True)

    # the whole-plane forward's tiled sweep on the fig-6 planes that ESDP's
    # main path sends to it (c_hi = 4 at T = 2000, c_hi = 5 at T = 1500):
    # the layout dp_forward_launch picks there (one capacity column a
    # thread) against a column a cell, each forced through
    # dp_forward_sweep_launch on the same inputs and bit-equal to the plain
    # version
    for c_hi, inst_w, tables_w, horizon in ((4, fig6, tables6, T),
                                            (5, fig5, tables5, T6)):
        s_cap_w = stats.s_cap_for_horizon(horizon, inst_w.m)
        S_w, C_w, E_w = s_cap_w + 1, tables_w.n_states, inst_w.n_edges
        feas_w, offs_w, v0_w = operands(tables_w, s_cap_w)
        ups_w, sig_w, _, alw_w = stats_case(inst_w, FLEET, 98,
                                            horizon=horizon)
        alw_w = alw_w.to(torch.int32)
        for B in (1, FLEET):
            u, s, a = (t[:B].contiguous() for t in (ups_w, sig_w, alw_w))
            Vp, Wp = ref.dp_forward_ref(u, s, a, feas_w, offs_w, v0_w)
            ms = {}
            for one_col in (1, 0):
                out = (torch.empty((B, S_w, C_w), dtype=torch.int32,
                                   device=dev),
                       torch.empty((B, kernel.packed_words(E_w), S_w, C_w),
                                   dtype=torch.int32, device=dev))
                keep.append(out)
                raw = checked(lib.dp_forward_sweep_launch, (
                    u.data_ptr(), s.data_ptr(), a.data_ptr(),
                    feas_w.data_ptr(), offs_w.data_ptr(), v0_w.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(), B, E_w, S_w, C_w,
                    one_col, stream))
                raw()
                torch.cuda.synchronize()
                if not (torch.equal(out[0], Vp) and torch.equal(out[1], Wp)):
                    fail(f"fig6 c_hi={c_hi} B={B}: the tiled sweep "
                         f"(one_col={one_col}) differs from its plain "
                         "version")
                prof_ms, _ = profiled_ms(raw, 100, "dp_forward_kernel")
                ms[one_col] = (per_call_ms(raw, 100) if prof_ms is None
                               else prof_ms)
            print(f"   whole-plane tiled sweep, fig6 c_hi={c_hi} "
                  f"T={horizon} (S={S_w} C={C_w} E={E_w}) B={B}, device ms "
                  f"a launch: one capacity column a thread (the launcher's "
                  f"pick) {ms[1]:.4f}, a column a cell {ms[0]:.4f}; both "
                  "bit-equal to the plain version", flush=True)

    # the tiled forwards: fig-6 c_hi = 6, T = 1500
    S, C = s_cap6 + 1, big6_tables.n_states
    feas, offs, v0 = operands(big6_tables, s_cap6)
    off_max = int(offs.max())
    W = kernel.packed_words(E6)
    ups, sig, alw = fig6_stats(FLEET, 99)
    alw_i = alw.to(torch.int32)

    # dp_chunk: the auto tiling of the main path, one chunk of E6 edges,
    # one cooperative launch (the tiles only pick the pipeline)
    n_e = min(auto6[0], E6)
    n_words = (E6 - 1) // 32 - (E6 - n_e) // 32 + 1  # words the chunk sets
    for B, launches in ((1, counts_single6), (FLEET, counts_fleet6)):
        u, s, a = (t[:B].contiguous() for t in (ups, sig, alw_i))
        out = (torch.empty((B, S, C), dtype=torch.int32, device=dev),
               torch.empty((B, S, C), dtype=torch.int32, device=dev),
               torch.zeros((B, W, S, C), dtype=torch.int32, device=dev))
        keep.append(out)
        raw = checked(lib.dp_chunk_launch, (
            u.data_ptr(), s.data_ptr(), a.data_ptr(), feas.data_ptr(),
            offs.data_ptr(), v0.data_ptr(), 0, out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), B, E6, S, C, E6 - n_e, E6,
            stream))

        def wrapped(u=u, s=s, a=a, B=B):
            V = torch.empty((B, S, C), dtype=torch.int32, device=dev)
            Wz = torch.zeros((B, W, S, C), dtype=torch.int32, device=dev)
            kernel.dp_chunk(v0, V, Wz, u, s, a, feas, offs, E6 - n_e, E6,
                            u_max=u_max6, off_max=off_max, block_s=auto6[1],
                            block_c=auto6[2])

        t_k = timed(raw, wrapped, "dp_chunk_kernel", 20)
        words_p = torch.zeros((B, W, S, C), dtype=torch.int32, device=dev)
        p_k = per_call_ms(lambda: ref.dp_chunk_ref(
            v0, words_p, u, s, a, feas, offs, E6 - n_e, E6), 3, reps=3)
        # the function's operands: Υ̂, Σ̂², allowed, the chunk's feasible
        # rows and offsets, the shared input plane read once, the output
        # plane and the chunk's words written once
        nbytes = 4 * (3 * B * n_e + n_e * C + n_e + S * C + B * S * C
                      + B * n_words * S * C)
        row(f"dp_chunk B={B} ({'K4 _fused_chunk_kernel' if B == 1 else 'K5 _batched_fused_kernel'})",
            TPU + ("kernel.py:697" if B == 1 else "kernel.py:935"),
            f"B={B} S={S} C={C} edges {E6 - n_e}..{E6 - 1}, one "
            "cooperative launch", launches["dp_chunk"],
            worst["dp_chunk"], t_k, p_k,
            (nbytes, FWD_OPS_PER_CELL * B * n_e * S * C))

    # dp_edge: the per-edge path (u_max = s_cap + 1), B = 1
    u, s, a = (t[:1].contiguous() for t in (ups, sig, alw_i))
    vin = torch.empty((1, S, C), dtype=torch.int32, device=dev)
    vin.copy_(v0)
    out = (torch.empty((1, S, C), dtype=torch.int32, device=dev),
           torch.zeros((1, W, S, C), dtype=torch.int32, device=dev))
    keep.append((vin, out))
    e_mid = E6 // 2
    raw = checked(lib.dp_edge_launch, (
        u.data_ptr(), s.data_ptr(), a.data_ptr(), feas.data_ptr(),
        offs.data_ptr(), vin.data_ptr(), S * C, out[0].data_ptr(),
        out[1].data_ptr(), 1, E6, S, C, e_mid, stream))
    t_k = timed(raw, lambda: kernel.dp_edge(
        vin, out[0], out[1], u, s, a, feas, offs, e_mid),
        "dp_edge_kernel", 200)
    p_k = per_call_ms(lambda: ref.dp_edge_ref(vin, out[1], u, s, a, feas,
                                              offs, e_mid), 3, reps=3)
    row("dp_edge B=1 (K3 _edge_tile_kernel/_edge_stile_kernel)",
        TPU + "kernel.py:555", f"B=1 S={S} C={C} one edge, four cells a "
        "thread", counts_edge["dp_edge"], worst["dp_edge"], t_k,
        p_k, (4 * (3 + C + 3 * S * C), FWD_OPS_PER_CELL * S * C),
        floor=floor_ms(-(-S * C // 1024), 1, 256))
    # the per-edge pipeline's span a solve (its words' zero fill and E6
    # launches): as the solver registry's host loop issues them, and
    # queued behind a sleeping kernel so that they wait on the device; its
    # launches chained (programmatic dependent launch, the pipeline's) and
    # one at a time.  tools/dp_kernel_probe.py reads the same spans, first
    # start to last end of the launches, from a profiler trace
    def unchained_solve():
        Wz = torch.zeros((1, W, S, C), dtype=torch.int32, device=dev)
        bufs = [torch.empty((1, S, C), dtype=torch.int32, device=dev)
                for _ in range(2)]
        Vu = v0
        for n, e in enumerate(range(E6 - 1, -1, -1)):
            Vu, Wz = kernel.dp_edge(Vu, bufs[n % 2], Wz, u, s, a, feas, offs,
                                    e)

    spans = {}
    for how, fn in (("chained", lambda: kernel.dp_forward_blocked(
            u, s, a, feas, offs, v0)), ("one launch at a time",
                                        unchained_solve)):
        for where in ("host loop", "queued"):
            spans[how, where] = span_ms(fn, 20, where == "queued")
    print(f"   per-edge pipeline (dp_forward_blocked, {E6} dp_edge launches, "
          f"B=1 S={S} C={C}), span a solve between CUDA events around it "
          "(its words' zero fill included; mean of 20 solves): " + "; ".join(
              f"{how}, {where} {ms:.5f} ms"
              for (how, where), ms in spans.items()), flush=True)
    # the dispatch path's kernels at its plane (S 201, C 216, E 15): the
    # whole-plane forward at B = 1 (run) and B = 8 (run_batch), and the
    # epilogue's tabled instance on the warm solver's segmented words;
    # dp_chunk on one warm segment of the fig-6 c_hi = 6 plane
    d_tables = build_tables(d_inst.A, d_inst.c)
    d_s_cap, d_E = d_S - 1, d_inst.n_edges
    d_u_max = stats.u_max_for_horizon(TD, d_inst.m)
    feas, offs, v0 = operands(d_tables, d_s_cap)
    d_W = kernel.packed_words(d_E)
    ups, sig, slim, alw = stats_case(d_inst, 8, 97, horizon=TD)
    alw_i = alw.to(torch.int32)
    for B, label, launches in ((1, "esdp cold", d_counts["esdp cold"]),
                               (8, "run_batch", d_fleet_counts)):
        u, s, a = (t[:B].contiguous() for t in (ups, sig, alw_i))
        Vk, Wk = kernel.dp_forward_batched(u, s, a, feas, offs, v0)
        Vp, Wp = ref.dp_forward_ref(u, s, a, feas, offs, v0)
        torch.cuda.synchronize()
        err = max(max_err(Vk, Vp), max_err(Wk, Wp))
        if err:
            fail(f"dispatch plane B={B}: the forward differs from its plain "
                 "version")
        out = (torch.empty((B, d_S, d_C), dtype=torch.int32, device=dev),
               torch.empty((B, d_W, d_S, d_C), dtype=torch.int32,
                           device=dev))
        keep.append(out)
        raw = checked(lib.dp_forward_launch, (
            u.data_ptr(), s.data_ptr(), a.data_ptr(), feas.data_ptr(),
            offs.data_ptr(), v0.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), B, d_E, d_S, d_C, stream))
        t_k = timed(raw, lambda: kernel.dp_forward_batched(u, s, a, feas,
                                                           offs, v0),
                    "dp_forward_kernel", 200)
        p_k = per_call_ms(lambda: ref.dp_forward_ref(u, s, a, feas, offs,
                                                     v0), 3, reps=3)
        nbytes = 4 * (3 * B * d_E + d_E * d_C + d_E + d_S * d_C
                      + B * d_S * d_C + B * d_W * d_S * d_C)
        row(f"dp_forward_batched B={B} "
            f"({'K1 _dp_kernel' if B == 1 else 'K2 _dp_kernel_batched'}, "
            f"dispatch {label})",
            TPU + ("kernel.py:409" if B == 1 else "kernel.py:484"),
            f"B={B} S={d_S} C={d_C} E={d_E}",
            launches["dp_forward_batched"], err, t_k, p_k,
            (nbytes, FWD_OPS_PER_CELL * B * d_E * d_S * d_C))
    warm_d = ops.WarmCudaSolver(d_tables, d_s_cap, u_max=d_u_max,
                                checkpoint_every=8, device=dev)
    warm_d(ups[0], sig[0], d_tables, d_s_cap, slim[0], allowed=alw[0])
    V_d = warm_d._planes[-1][None]
    words_d = warm_d._words_cat
    u1, s1 = ups[:1].contiguous(), slim[:1].contiguous()
    got = kernel.dp_epilogue(V_d, words_d, u1, offs, s1, d_tables.full_state,
                             warm_d._w_rows, warm_d._bits)
    err = epilogue_err(V_d, words_d, u1, offs, s1, d_tables.full_state,
                       warm_d._w_rows, warm_d._bits)
    if err:
        fail("the tabled epilogue differs from its plain version")
    epi_out = (torch.empty((1, d_E), dtype=torch.int32, device=dev),
               torch.empty((1,), dtype=torch.int32, device=dev),
               torch.empty((1, d_S), dtype=torch.int32, device=dev))
    keep.append(epi_out)
    raw = checked(lib.dp_epilogue_launch, (
        V_d.data_ptr(), words_d.data_ptr(), u1.data_ptr(), offs.data_ptr(),
        s1.data_ptr(), warm_d._w_rows.data_ptr(), warm_d._bits.data_ptr(),
        d_tables.full_state, 1, d_E, words_d.shape[1], d_S, d_C,
        epi_out[0].data_ptr(), epi_out[1].data_ptr(), epi_out[2].data_ptr(),
        stream))
    t_k = timed(raw, lambda: kernel.dp_epilogue(
        V_d, words_d, u1, offs, s1, d_tables.full_state, warm_d._w_rows,
        warm_d._bits), "dp_epilogue_kernel", 500)
    p_k = per_call_ms(lambda: ref.dp_epilogue_ref(
        V_d, words_d, u1, offs, s1, d_tables.full_state, warm_d._w_rows,
        warm_d._bits), 3, reps=3)
    # the default epilogue on the same plane shape, for comparison
    Vc, Wc = kernel.dp_forward_batched(u1, sig[:1].contiguous(),
                                       alw_i[:1].contiguous(), feas, offs, v0)
    keep.append((Vc, Wc))
    default_ms, _ = profiled_ms(checked(lib.dp_epilogue_launch, (
        Vc.data_ptr(), Wc.data_ptr(), u1.data_ptr(), offs.data_ptr(),
        s1.data_ptr(), None, None, d_tables.full_state, 1, d_E, d_W, d_S,
        d_C, epi_out[0].data_ptr(), epi_out[1].data_ptr(),
        epi_out[2].data_ptr(), stream)), 500, "dp_epilogue_kernel")
    err_c = epilogue_err(Vc, Wc, u1, offs, s1, d_tables.full_state)
    if err_c:
        fail("the default epilogue differs from its plain version on the "
             "dispatch plane")
    print(f"   the default epilogue at the same shape (B=1 S={d_S} C={d_C} "
          f"E={d_E}): {default_ms} ms (profiler device time), equal to its "
          "plain version", flush=True)
    # as the default epilogue's bound, plus the table (2E words)
    x_t = got[0]
    nbytes = 4 * ((2 * d_S + 4 * d_E + 2) + int(x_t.sum())
                  + int(x_t.any(0).sum()))
    row("dp_epilogue tabled (warm segments: word row, bit per edge)",
        TPU + "ops.py:687", f"B=1 S={d_S} C={d_C} E={d_E}, "
        f"{words_d.shape[1]} word rows", d_counts["esdp incremental=warm"][
            "dp_epilogue"], err, t_k, p_k, (nbytes, 5 * d_S + 6 * d_E),
        floor=floor_ms(1, 1, 256))
    # dp_chunk on one warm segment: the first WARM_K fold steps of the
    # fig-6 c_hi = 6 plane, from the cold-start plane
    S, C = s_cap6 + 1, big6_tables.n_states
    feas6, offs6, v06 = operands(big6_tables, s_cap6)
    lo6 = E6 - WARM_K
    u6, s6, a6 = fig6_stats(1, 96)
    seg = [t[:, lo6:].contiguous() for t in (u6, s6, a6.to(torch.int32))]
    f_seg, o_seg = feas6[lo6:].contiguous(), offs6[lo6:].contiguous()
    Vp, Wp = ref.dp_forward_ref(*seg, f_seg, o_seg, v06)
    Vk = torch.empty((1, S, C), dtype=torch.int32, device=dev)
    Wk = torch.zeros((1, 1, S, C), dtype=torch.int32, device=dev)
    kernel.dp_chunk(v06, Vk, Wk, *seg, f_seg, o_seg, 0, WARM_K,
                    u_max=u_max6, off_max=int(offs6.max()), block_s=auto6[1],
                    block_c=auto6[2])
    torch.cuda.synchronize()
    err = max(max_err(Vk, Vp), max_err(Wk, Wp))
    if err:
        fail("dp_chunk on a warm segment differs from its plain version")
    out = (torch.empty((1, S, C), dtype=torch.int32, device=dev),
           torch.empty((1, S, C), dtype=torch.int32, device=dev),
           torch.zeros((1, 1, S, C), dtype=torch.int32, device=dev))
    keep.append((out, seg, f_seg, o_seg))
    raw = checked(lib.dp_chunk_launch, (
        seg[0].data_ptr(), seg[1].data_ptr(), seg[2].data_ptr(),
        f_seg.data_ptr(), o_seg.data_ptr(), v06.data_ptr(), 0,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), 1, WARM_K,
        S, C, 0, WARM_K, stream))

    def seg_wrapped():
        kernel.dp_chunk(v06, torch.empty((1, S, C), dtype=torch.int32,
                                         device=dev),
                        torch.zeros((1, 1, S, C), dtype=torch.int32,
                                    device=dev), *seg, f_seg, o_seg, 0,
                        WARM_K, u_max=u_max6, off_max=int(offs6.max()),
                        block_s=auto6[1], block_c=auto6[2])

    t_k = timed(raw, seg_wrapped, "dp_chunk_kernel", 20)
    p_k = per_call_ms(lambda: ref.dp_forward_ref(*seg, f_seg, o_seg, v06), 3,
                      reps=3)
    nbytes = 4 * (3 * WARM_K + WARM_K * C + WARM_K + 2 * S * C + S * C)
    row(f"dp_chunk B=1 (K4 _fused_chunk_kernel, one warm segment of "
        f"{WARM_K} edges)", TPU + "kernel.py:697",
        f"B=1 S={S} C={C} {WARM_K} edges, one cooperative launch",
        warm_counts["dp_chunk"], err, t_k, p_k,
        (nbytes, FWD_OPS_PER_CELL * WARM_K * S * C))
    print(f"   dispatch slot (ms, host clock, T={TD}): "
          + ", ".join(f"{k} {v[1]:.3f}" for k, v in d_runs.items())
          + f"; run_batch B=8 {d_fleet_ms:.3f}; warm_tiled device ms a "
          f"solve: warm {warm_ms}, cold {cold_ms}", flush=True)

    # K6 at the Zamba2-7B serving shape in bf16 (the serving path's wgmma
    # kernel) and in f32 (the f32 prefill's split-TF32 kernel), and the
    # wgmma kernel at gemma-7b's attention (configs/gemma_7b.py: 16 heads,
    # hd 256), gemma3-27b's local layers, dbrx-132b's (48:8 heads, hd 128)
    # and deepseek-v3's MLA (configs/deepseek_v3_671b.py: 128 heads, q/k
    # 192 = nope 128 + rope 64, v 128), batch 4, prompt 2048, causal;
    # qwen2-vl-72b's (64:8, hd 128, causal over 1024 patches + 2048
    # tokens) and whisper-medium's four (16 heads of 64: the encoder's
    # bidirectional 1500 frames, the decoder's causal 416 tokens, and
    # cross-attention from 416 queries and from one, a decode token's,
    # to the 1500 frames); then K7 at its serving shape
    B, S = SERVE_B, SERVE_S

    def sdpa(q, k, v, scale, window=0, causal=True):
        """scaled_dot_product_attention's ms on the same inputs (causal or
        not; GQA and a sliding window through ``enable_gqa`` and a
        boolean mask), and the backend it takes: a yardstick, never
        called by the port."""
        import torch.nn.attention
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kw = dict(scale=scale)
        if k.shape[2] != q.shape[2]:
            kw["enable_gqa"] = True
        if window:
            i = torch.arange(q.shape[1], device=dev)
            kw["attn_mask"] = (i[None] <= i[:, None]) & (
                i[:, None] - i[None] < window)
        elif causal:
            kw["is_causal"] = True
        try:  # a private helper: where it is missing, say so
            backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(
                qt, kt, vt, **kw)).name
        except Exception as err:
            backend = f"not known ({type(err).__name__})"
        ms = per_call_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, **kw), 20)
        return ms, backend

    def referee_ms(qp, kp, vp, scale):
        """The CUDA-core kernel (no input routed to it) raw on the same
        padded inputs: the time of what the tensor-core routes replaced."""
        Bq, Sq_, Hq, width = qp.shape
        o = torch.empty_like(qp)
        keep.append(o)
        raw = checked(fa.LIBRARY.load().flash_attention_launch, (
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            int(qp.dtype == torch.bfloat16), Bq, Sq_, Sq_, Hq, Hq, width,
            scale, 1, 0, stream))
        prof_ms, _ = profiled_ms(raw, 5, "flash_fwd_kernel")
        return per_call_ms(raw, 3, reps=3) if prof_ms is None else prof_ms

    wgmma = "flash_attention_wgmma"
    nv = get_config("qwen2-vl-72b").n_vision_tokens
    wm = get_config("whisper-medium")
    wp, wd = family_shapes["whisper-medium"]
    Se = wm.enc_len
    # label, B, Sq, Sk, H, KH, q/k and v head dims, causal, window, dtype,
    # launches on the main path (a prefill; whisper's cross-attention in
    # decode: the 31 timed decode steps), the referee's time beside it?
    for (label, Bf, Sq, Sk, H, KH, hd, vh, causal, window, dtype, launches,
         with_referee) in (
            ("Zamba2-7B", SERVE_B, S, S, 32, 32, 112, 112, True, 0,
             torch.bfloat16, serve_counts[wgmma], False),
            ("Zamba2-7B", SERVE_B, S, S, 32, 32, 112, 112, True, 0,
             torch.float32, f32_counts["flash_attention_tf32"], True),
            ("gemma-7b", SERVE_B, S, S, 16, 16, 256, 256, True, 0,
             torch.bfloat16, family_counts["gemma-7b"][wgmma], True),
            ("gemma3-27b local", SERVE_B, S, S, 32, 16, 128, 128, True, 1024,
             torch.bfloat16, family_counts["gemma3-27b"][wgmma], False),
            ("dbrx-132b", SERVE_B, S, S, 48, 8, 128, 128, True, 0,
             torch.bfloat16, family_counts["dbrx-132b"][wgmma], False),
            ("deepseek-v3 MLA", SERVE_B, S, S, 128, 128, 192, 128, True, 0,
             torch.bfloat16, family_counts["deepseek-v3-671b"][wgmma],
             True),
            ("qwen2-vl-72b", SERVE_B, nv + S, nv + S, 64, 8, 128, 128, True,
             0, torch.bfloat16, family_counts["qwen2-vl-72b"][wgmma], False),
            ("whisper encoder", SERVE_B, Se, Se, 16, 16, 64, 64, False, 0,
             torch.bfloat16, wp.get((Se, Se, False), 0), False),
            ("whisper decoder self", SERVE_B, WHISPER_S, WHISPER_S, 16, 16,
             64, 64, True, 0, torch.bfloat16,
             wp.get((WHISPER_S, WHISPER_S, True), 0), False),
            ("whisper cross, prefill", SERVE_B, WHISPER_S, Se, 16, 16, 64, 64,
             False, 0, torch.bfloat16, wp.get((WHISPER_S, Se, False), 0),
             False),
            (f"whisper cross, decode ({SERVE_GEN - 1} steps)", SERVE_B, 1, Se,
             16, 16, 64, 64, False, 0, torch.bfloat16,
             wd.get((1, Se, False), 0), False)):
        q, k, v = qkv(Bf, Sq, Sk, H, KH, hd, dtype, 7)
        if vh != hd:
            v = v[..., :vh].contiguous()
        scale = hd ** -0.5
        width = max(hd, vh)
        qp, kp, vp = fa.zero_pad(q, k, v, width)  # the wrapper's, if vh < hd
        o = torch.empty_like(qp)
        keep.append(o)
        name = fa.kernel_for(dtype, width)
        args = (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
                None, Bf, Sq, Sk, H, KH, width, scale, int(causal), window,
                stream)  # no log-sum-exp: the serving forward
        if name == "flash_attention_wgmma":
            raw = checked(fa.WGMMA_LIBRARY.load().flash_attention_wgmma_launch,
                          args)
            kname, src = "flash_fwd_wgmma_kernel", FAW_SOURCE
        else:
            raw = checked(fa.TF32_LIBRARY.load().flash_attention_tf32_launch,
                          args)
            kname, src = "flash_fwd_tf32_kernel", FAT_SOURCE
        t_k = timed(raw, lambda: fa.flash_attention(q, k, v, scale=scale,
                                                    causal=causal,
                                                    window=window), kname, 20)
        p_k = per_call_ms(lambda: fa.flash_attention_ref(q, k, v,
                                                         scale=scale,
                                                         causal=causal,
                                                         window=window),
                          2, reps=3)
        lib_ms, backend = sdpa(q, k, v, scale, window, causal)
        # q·k and p·v over the pairs scored (the function's own widths,
        # not the padded one); q, k, v read and o written once
        # (fa.fwd_work, which the dry run counts too).  f32 runs each
        # product as three TF32 products on the tensor cores
        f_ops, f_bytes = fa.fwd_work(Bf, Sq, Sk, H, KH, hd, vh, causal,
                                     window, q.element_size())
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        if dt == "f32":
            ops, rate, kind = (3 * f_ops, TF32_OPS_PER_S,
                               "TF32 tensor-core (3 per f32 product)")
        else:
            ops, rate, kind = f_ops, BF16_OPS_PER_S, "bf16 tensor-core"
        row(f"{name} (K6 _flash_kernel, {dt}, {label})",
            "src/repro/kernels/flash_attention/kernel.py:24",
            f"B={Bf} Sq={Sq} Sk={Sk} H={H} KH={KH} q/k {hd} v {vh} (kernel "
            f"width {width}) {dt} {'causal' if causal else 'bidirectional'}"
            + (f", window {window}" if window else ""), launches,
            worst_abs[name],
            t_k, p_k, (f_bytes, ops), source=src, ops_per_s=rate,
            ops_kind=kind, library_ms=lib_ms)
        core = (f"{referee_ms(qp, kp, vp, scale):.4f} ms" if with_referee
                and KH == H and not window else "not timed")
        print(f"   {label} {dt}: SDPA backend {backend}; f32-FMA bound "
              f"{f_ops / F32_OPS_PER_S * 1e3:.4f} ms; the CUDA-core "
              f"referee flash_fwd_kernel at width {width}: {core}",
              flush=True)
        del q, k, v, qp, kp, vp
    # K7 at the Zamba2-7B serving shape and at Mamba2-2.7B's (H 80, N 128)
    m2 = get_config("mamba2-2.7b")
    for label, (H, P, N, Q), launches in (
            ("Zamba2-7B", (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                           cfg.ssm_chunk), serve_counts["ssd_scan"]),
            ("Mamba2-2.7B", (m2.n_ssm_heads, m2.ssm_head_dim, m2.ssm_state,
                             m2.ssm_chunk),
             family_counts["mamba2-2.7b"]["ssd_scan"])):
        xs, dts, As, Bs, Cs = ssd_inputs(B, S, H, P, N, 11)
        n_chunks = -(-S // Q)
        y = torch.empty((B, S, H, P), device=dev)
        st = torch.empty((B, H, N, P), device=dev)
        # the scratch the wrapper allocates: each chunk's state, and cum
        states = torch.empty((B, H, n_chunks, N, P), device=dev)
        cum = torch.empty((B, H, n_chunks, -(-Q // 16) * 16, 2), device=dev)
        keep.append((y, st, states, cum))
        raw = checked(ssd.LIBRARY.load().ssd_scan_launch, (
            xs.data_ptr(), *xs.stride()[:3], dts.data_ptr(), *dts.stride(),
            As.data_ptr(), Bs.data_ptr(), *Bs.stride()[:2], Cs.data_ptr(),
            *Cs.stride()[:2], y.data_ptr(), st.data_ptr(), states.data_ptr(),
            cum.data_ptr(), B, S, H, P, N, Q, stream))
        # one call of the entry point is its three kernels
        t_k = timed(raw, lambda: ssd.ssd_scan(xs, dts, As, Bs, Cs, Q),
                    ssd.KERNELS, 20)
        p_k = per_call_ms(lambda: ssd.ssd_ref(xs, dts, As, Bs, Cs, Q), 2,
                          reps=3)
        # what these inputs need: C·Bᵀ on the lower triangle once per
        # (b, chunk) (B and C are per batch row), and per (b, h, chunk)
        # the masked product with x, C·state and the chunk state, 2 flops
        # per multiply-add; the shipped route runs each as three TF32
        # products (split form) on the tensor cores.  x, dt, A, B, C read
        # and y and the state written once; the chunk states are the
        # design's own traffic
        ssd_ops, ssd_bytes = ssd.scan_work(B, S, H, P, N, Q)
        row(f"ssd_scan (K7 _ssd_kernel, {label})",
            "src/repro/kernels/ssd/kernel.py:28",
            f"B={B} S={S} H={H} P={P} N={N} Q={Q} f32, "
            f"{len(ssd.KERNELS)} kernels a call", launches,
            worst_abs["ssd_scan"], t_k, p_k, (ssd_bytes, 3 * ssd_ops),
            source=SSD_SOURCE, ops_per_s=TF32_OPS_PER_S,
            ops_kind="TF32 tensor-core (3 per f32 product)")
        del xs, dts, As, Bs, Cs
    # the backward kernels at phase (k)'s training shapes: K6's at
    # qwen2.5-32b's attention (bf16, B 2, S 2048, GQA 40:8, D 128, causal),
    # beside torch autograd of scaled_dot_product_attention (its backward
    # alone); K7's at mamba2-2.7b's (B 2, S 2048, H 80, P 64, N 128)
    q, k, v = qkv(2, 2048, 2048, 40, 8, 128, torch.bfloat16, 31)
    do = torch.randn_like(q)
    kw = dict(scale=128 ** -0.5, causal=True, window=0)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((2, 40, 2048), device=dev)
    keep.append((o, lse, dq, dk, dv, delta, do))
    bwd_entry, bwd_kernels = fa.bwd_route(torch.bfloat16)
    raw = checked(getattr(fa.BWD_LIBRARY.load(), bwd_entry), (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), 2, 2048, 2048, 40, 8, 128,
        kw["scale"], 1, 0, stream))
    t_k = timed(raw, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw), bwd_kernels, 5)
    p_k = per_call_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                         **kw), 1, reps=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, scale=kw["scale"], is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = per_call_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    # the five products (S recomputed, dV, dP, dQ, dK) over the causal
    # pairs; q, k, v, o, dO and lse read, dq, dk, dv written once
    b_ops, b_bytes = fa.bwd_work(2, 2048, 2048, 40, 8, 128, 128, True, 0,
                                 q.element_size())
    row("flash_attention_bwd (the gradient of K6's function; bf16, "
        "qwen2.5-32b training)", "src/repro/kernels/flash_attention/"
        "kernel.py:24 (its gradient; JAX differentiates the pure-JAX "
        "chunked_attention)",
        "B=2 Sq=Sk=2048 H=40 KH=8 D=128 bf16 causal, three kernels a call",
        train_counts["qwen2.5-32b"]["flash_attention_bwd"],
        bwd_err["flash_attention_bwd"], t_k, p_k, (b_bytes, b_ops),
        source=FAB_SOURCE, ops_per_s=BF16_OPS_PER_S, ops_kind="bf16",
        library_ms=lib_ms)
    print(f"   flash_attention_bwd: SDPA's backward (torch autograd of "
          f"scaled_dot_product_attention, enable_gqa) {lib_ms:.4f} ms; "
          f"f32-FMA bound {b_ops / F32_OPS_PER_S * 1e3:.4f} ms (the bf16 "
          "route runs its products on the tensor cores, mma.sync; the f32 "
          "route on the CUDA cores)", flush=True)
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    # its f32 route at the same shape in f32: split TF32 on mma.sync,
    # beside the CUDA-core referee it replaced (launched raw), the plain
    # version and SDPA's f32 backward; its launches those of the tiny-100m
    # milestone's run
    q, k, v = qkv(2, 2048, 2048, 40, 8, 128, torch.float32, 31)
    do = torch.randn_like(q)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    keep.append((o, lse, dq, dk, dv, do))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), 2, 2048, 2048, 40, 8, 128,
            kw["scale"], 1, 0, stream)
    bwd_entry, bwd_kernels = fa.bwd_route(torch.float32)
    raw = checked(getattr(fa.BWD_LIBRARY.load(), bwd_entry), args)
    t_k = timed(raw, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw), bwd_kernels, 5)
    raw_ref = checked(getattr(fa.BWD_LIBRARY.load(), fa.BWD_REFEREE[0]),
                      args)
    ref_prof, _ = profiled_ms(raw_ref, 3, fa.BWD_REFEREE[1])
    ref_ev = per_call_ms(raw_ref, 3, reps=3)
    ref_ms = ref_ev if ref_prof is None or not ref_prof <= 1.1 * ref_ev \
        else ref_prof
    p_k = per_call_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                         **kw), 1, reps=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, scale=kw["scale"], is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = per_call_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    # the same five products, each as three TF32 products on the tensor
    # cores; f32 tensors
    b_bytes = fa.bwd_work(2, 2048, 2048, 40, 8, 128, 128, True, 0,
                          q.element_size())[1]
    row("flash_attention_bwd (the gradient of K6's function; f32 in split "
        "TF32, qwen2.5-32b's training shape)",
        "src/repro/kernels/flash_attention/kernel.py:24 (its gradient; JAX "
        "differentiates the pure-JAX chunked_attention)",
        "B=2 Sq=Sk=2048 H=40 KH=8 D=128 f32 causal, three kernels a call",
        tiny_counts["flash_attention_bwd"], bwd_err["flash_attention_bwd f32"],
        t_k, p_k, (b_bytes, 3 * b_ops), source=FAB_SOURCE,
        ops_per_s=TF32_OPS_PER_S,
        ops_kind="TF32 tensor-core (3 per f32 product)", library_ms=lib_ms)
    k_ms = rows_out[-1]["ms"]
    ref_txt = ("not measured" if ref_prof is None
               else f"{ref_prof:.4f} ms")
    print(f"   flash_attention_bwd f32: the CUDA-core referee "
          f"({', '.join(fa.BWD_REFEREE[1][1:])}, launched raw) {ref_ms:.4f} "
          f"ms (profiler {ref_txt}, CUDA events {ref_ev:.4f} ms), "
          f"{ref_ms / k_ms:.2f}x the route's "
          f"{k_ms:.4f} ms; SDPA's f32 backward (torch autograd of "
          f"scaled_dot_product_attention, enable_gqa, TF32 off) "
          f"{lib_ms:.4f} ms, {k_ms / lib_ms:.2f}x; bound "
          f"{3 * b_ops / TF32_OPS_PER_S * 1e3:.4f} ms (TF32 x 3), f32-FMA "
          f"bound {b_ops / F32_OPS_PER_S * 1e3:.4f} ms; launches: "
          f"{tiny_counts['flash_attention_bwd']} in the tiny-100m milestone "
          f"({tiny.n_layers} a step run), {n_l} a step of launch.train at "
          "REDUCED", flush=True)
    if not k_ms < ref_ms:
        fail(f"flash_attention_bwd f32: the split-TF32 route ({k_ms:.4f} ms) "
             f"is not faster than the CUDA-core referee ({ref_ms:.4f} ms)")
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    B, S, H, P, N, Q = 2, 2048, m2.n_ssm_heads, m2.ssm_head_dim, \
        m2.ssm_state, m2.ssm_chunk
    xs, dts, As, Bs, Cs = ssd_inputs(B, S, H, P, N, 37)
    dy = torch.randn((B, S, H, P), device=dev)
    _, _, states, cum = ssd.ssd_scan_saved(xs, dts, As, Bs, Cs, Q)
    n_chunks = -(-S // Q)
    f32 = dict(device=dev)
    outs = (torch.empty((B, S, H, P), **f32), torch.empty((B, S, H), **f32),
            torch.empty((H,), **f32), torch.empty((B, S, N), **f32),
            torch.empty((B, S, N), **f32), torch.empty_like(states),
            torch.empty((ssd.bwd_shares(H), B, S, N), **f32),
            torch.empty((ssd.bwd_shares(H), B, S, N), **f32),
            torch.empty((B, H, n_chunks), **f32))
    keep.append((dy, states, cum, outs))
    dx_, ddt_, dA_, dB_, dC_, gbuf, dBp, dCp, dAp = outs
    raw = checked(ssd.BWD_LIBRARY.load().ssd_bwd_launch, (
        xs.data_ptr(), *xs.stride()[:3], dts.data_ptr(), *dts.stride(),
        As.data_ptr(), Bs.data_ptr(), *Bs.stride()[:2], Cs.data_ptr(),
        *Cs.stride()[:2], dy.data_ptr(), None, states.data_ptr(),
        cum.data_ptr(), gbuf.data_ptr(), dx_.data_ptr(), ddt_.data_ptr(),
        dA_.data_ptr(), dB_.data_ptr(), dC_.data_ptr(), dBp.data_ptr(),
        dCp.data_ptr(), dAp.data_ptr(), B, S, H, P, N, Q, stream))
    t_k = timed(raw, lambda: ssd.ssd_bwd(xs, dts, As, Bs, Cs, Q, dy, None,
                                         states, cum),
                ssd.BWD_KERNELS, 10, ssd.BWD_LAUNCHES_PER_CALL)
    p_k = per_call_ms(lambda: ssd.ssd_bwd_ref(xs, dts, As, Bs, Cs, Q, dy),
                      1, reps=3)
    # what these inputs need: C·Bᵀ on the lower triangle once per (b,
    # chunk); per (b, h, chunk) dy·xᵀ and Mᵀ·dy on the triangle, R·C and
    # R·B (dB, dC), and four Q·N·P products with the chunk-boundary
    # states (the state gradient's chunk term, Gᵀ·B, G·x, S_in·dy), 2
    # flops a multiply-add, at the rate K7's forward row takes: three TF32
    # products a f32 product on the tensor cores, which the port's own
    # forward shows the card reaches; x, dt, A, B, C, dy read and dx, ddt,
    # dA, dB, dC written once
    sb_ops, sb_bytes = ssd.bwd_work(B, S, H, P, N, Q)
    row("ssd_bwd (the gradient of K7's function; mamba2-2.7b training)",
        "src/repro/kernels/ssd/kernel.py:28 (its gradient; JAX "
        "differentiates the pure-JAX ssd_chunked)",
        f"B={B} S={S} H={H} P={P} N={N} Q={Q} f32, "
        f"{len(ssd.BWD_KERNELS) + 1} launches a call",
        train_counts["mamba2-2.7b"]["ssd_bwd"], bwd_err["ssd_bwd"], t_k, p_k,
        (sb_bytes, 3 * sb_ops), source=SSB_SOURCE, ops_per_s=TF32_OPS_PER_S,
        ops_kind="TF32 tensor-core (3 per f32 product)")
    print(f"   ssd_bwd: f32-FMA bound {sb_ops / F32_OPS_PER_S * 1e3:.4f} ms "
          "(the kernels run their products on the tensor cores in split "
          f"TF32, C·Bᵀ once a group of {ssd.BWD_HEAD_GROUP} heads)",
          flush=True)
    del xs, dts, As, Bs, Cs, dy, states, cum, outs
    print("   training (k): " + "; ".join(
        f"{a} {ms:.1f} ms a step (median of steps 2-{TRAIN_STEPS}), peak "
        f"{peak:.2f} GiB" for a, (ms, peak) in train_ms.items())
        + f"; the tiny-100m milestone {tiny_ms:.2f} ms a step, peak "
        f"{tiny_peak:.2f} GiB, device idle {100 * tiny_idle:.1f}%",
          flush=True)
    print(f"   serving prefill {prefill_ms:.1f} ms: "
          f"{serve_counts['flash_attention_wgmma']} flash launches and "
          f"{serve_counts['ssd_scan']} SSD launches", flush=True)
    print(f"   fig6 c_hi=6 slot: simulate {ms_single6:.3f} ms, "
          f"simulate_batch (B={FLEET}) {ms_fleet6:.3f} ms", flush=True)
    print("   new families: " + "; ".join(
        f"{a} prefill {p:.1f} ms, decode {d:.2f} ms a token"
        for a, (p, d) in family_ms.items())
        + "; engine ms a slot: " + ", ".join(
            f"{k[0]} {k[1]} {v:.3f}" for k, v in g_ms.items()), flush=True)
    print(f"   card: {card}", flush=True)
    done(t0)

    t0 = phase(f"fig6 c_hi=6, T={T6}: the card's decisions against the CPU "
               "int32 reference run alongside (simulate, simulate_batch rows "
               f"0, {ref6_rows})")
    try:
        got6 = ref6_conn.recv()
    except EOFError:
        fail(f"the CPU reference worker ended with exit code "
             f"{ref6.exitcode} and sent nothing")
    ref6.join()
    if isinstance(got6, str):
        fail(f"the CPU reference worker failed:\n{got6}")
    cpu6_x, cpu6_rows_x, cpu6_s = got6
    if not np.array_equal(single6.x, cpu6_x):
        slot = int(np.flatnonzero((single6.x != cpu6_x).any(axis=1))[0])
        fail(f"fig6 c_hi=6: card and CPU reference ESDP differ at slot "
             f"{slot + 1}")
    if not np.array_equal(fleet6.x[ref6_rows], cpu6_rows_x):
        slot = int(np.flatnonzero((fleet6.x[ref6_rows] != cpu6_rows_x).any(
            axis=(0, 2)))[0])
        fail(f"fig6 c_hi=6: simulate_batch rows {ref6_rows} differ from the "
             f"CPU reference at slot {slot + 1}")
    print(f"   card simulate and simulate_batch rows 0, {ref6_rows} make the "
          f"CPU int32 reference's decisions in each of the {T6} slots on the "
          f"same draws and schedule (the worker took {cpu6_s:.1f} s; its "
          f"result read {time.perf_counter() - ref6_t0:.1f} s after it "
          "started)", flush=True)
    done(t0)

    print(json.dumps({"kernels": rows_out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(HERE)
    main()
