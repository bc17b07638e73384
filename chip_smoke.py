"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``repro_torch`` from
``src/``).  Phases, each asserted; any failure exits non-zero:

1. build the budgeted-DP CUDA kernels with nvcc (timed);
2. each kernel against its plain PyTorch version on the card, bitwise
   (tolerance 0): the paper's Table-2 instance at B = 1, 7 and 64 with
   random ``allowed`` masks, one case whose DP sums reach [2^24, 2^29),
   and the fig-6 c_hi = 4 instance (a 160 KB plane);
3. the shared-memory gate raises ValueError on the fig-6 c_hi = 6 plane;
4. the main path: ESDP ``simulate`` (T = 2000) and ``simulate_batch``
   (B = 64, T = 2000) on Table 2, each with the kernels' launch counts
   set to 0 just before and read just after (each must equal T); rows of
   the batch equal single runs in x for three seeds; on a small horizon
   the card's ESDP decisions equal the CPU reference's on the same draws;
   HSWF/LCF/LWTF at T = 2000 with the quickstart's ASW lines;
5. kernel and plain-version times at the main path's shapes: each
   kernel's device time per launch from a ``torch.profiler`` trace of many
   launches of its C entry point (CUDA events around the same back-to-back
   launches, divided by their number, where the trace has no device
   time), beside the least time the card could take.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.  Without a GPU, or outside a checkout,
it exits non-zero and prints no result.
"""
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

HERE = pathlib.Path(__file__).resolve().parent
T = 2000
FLEET = 64
SEED = 42
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT32_OPS_PER_S = 67e12  # the card's non-tensor 32-bit rate (FP32 table)
# int32 operations per plane cell and edge of the forward: the budget shift
# (sub, max), the capacity shift (sub), the mask (two compares, and), the
# add, the take > V compare, the max and the bit OR
FWD_OPS_PER_CELL = 10


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)


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


def profiled_ms(fn, calls, kernel_name):
    """Device milliseconds per launch of the CUDA kernel ``kernel_name``
    over ``calls`` calls of ``fn``, read from a ``torch.profiler`` trace;
    None when the trace holds no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():  # its note on clearing events per cycle
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def main():
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {HERE / 'chip_smoke.py'}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")

    from repro_torch.core import (build_tables, esdp, generate_instance,
                                  make_draws, simulate, simulate_batch,
                                  stats)
    from repro_torch.core import baselines
    from repro_torch.core.dp import initial_plane
    from repro_torch.kernels.budgeted_dp import build, kernel, ops, ref

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print("kernels: dp_forward (K1 _dp_kernel), dp_forward_batched "
          "(K2 _dp_kernel_batched), dp_epilogue (s* + backtrack) from "
          "src/repro_torch/kernels/budgeted_dp/csrc/budgeted_dp.cu",
          flush=True)

    # ------------------------------------------------------------- build
    t0 = phase("build")
    lib_path = build.build()
    build.load()
    print(f"   built {lib_path.name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ----------------------------------------------- kernels vs plain
    def instance(c_hi, seed):
        inst = generate_instance(seed=seed, c_lo=1, c_hi=c_hi)
        return inst, build_tables(inst.A, inst.c)

    def stats_case(inst, B, seed, big=False):
        """Realistic (B, E) statistics: scale_statistics at random slots,
        with some channels unexplored; ``big`` draws Σ̂² in [2^22, 2^25]."""
        rng = np.random.default_rng(seed)
        E, m = inst.n_edges, inst.m
        xi_tab, g_tab, _ = stats.schedule_table(T, m, device=dev)
        t = torch.as_tensor(rng.integers(0, T, B), device=dev)
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

    worst = {"dp_forward": 0, "dp_forward_batched": 0, "dp_epilogue": 0}

    def max_err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    def compare(label, inst, tables, B, seed, big=False):
        s_cap = stats.s_cap_for_horizon(T, inst.m)
        feas, offs, v0 = operands(tables, s_cap)
        ups, sig, slim, alw = stats_case(inst, B, seed, big)
        alw_i = alw.to(torch.int32)
        Vk, Wk = kernel.dp_forward_batched(ups, sig, alw_i, feas, offs, v0)
        Vp, Wp = ref.dp_forward_ref(ups, sig, alw_i, feas, offs, v0)
        ek = kernel.dp_epilogue(Vk, Wk, ups, offs, slim, tables.full_state)
        ep = ref.dp_epilogue_ref(Vp, Wp, ups, offs, slim, tables.full_state)
        torch.cuda.synchronize()
        err_f = max(max_err(Vk, Vp), max_err(Wk, Wp))
        err_e = max(max_err(a, b) for a, b in zip(ek, ep))
        worst["dp_forward_batched"] = max(worst["dp_forward_batched"], err_f)
        worst["dp_epilogue"] = max(worst["dp_epilogue"], err_e)
        errs = [err_f, err_e]
        if B == 1:
            V1, W1 = kernel.dp_forward(ups[0], sig[0], feas * alw_i[0][:, None],
                                       offs, v0)
            torch.cuda.synchronize()
            err_1 = max(max_err(V1, Vp[0]), max_err(W1, Wp[0]))
            worst["dp_forward"] = max(worst["dp_forward"], err_1)
            errs.append(err_1)
        top = int(ep[2].max())
        print(f"   {label}: S={s_cap + 1} C={tables.n_states} "
              f"E={inst.n_edges} B={B} max value {top} "
              f"max |kernel - plain| {max(errs)}", flush=True)
        if max(errs) != 0:
            fail(f"{label}: kernel differs from its plain version")
        return top

    t0 = phase("kernels vs plain versions on the card (bitwise)")
    table2, tables2 = instance(2, 0)
    for B in (1, 7, FLEET):
        compare(f"table2 B={B}", table2, tables2, B, seed=B)
    top = compare("table2 sums in [2^24, 2^29)", table2, tables2, 7, seed=5,
                  big=True)
    if not 2 ** 24 <= top < 2 ** 29:
        fail(f"large-value case reached {top}, not [2^24, 2^29)")
    fig6, tables6 = instance(4, 2)
    S6 = stats.s_cap_for_horizon(T, fig6.m) + 1
    print(f"   fig6 c_hi=4 plane: {kernel.smem_bytes(S6, tables6.n_states)} "
          "bytes of shared memory", flush=True)
    for B in (1, 7):
        compare(f"fig6 c_hi=4 B={B}", fig6, tables6, B, seed=10 + B)
    done(t0)

    t0 = phase("shared-memory gate")
    big_inst, big_tables = instance(6, 2)
    s_cap = stats.s_cap_for_horizon(T, big_inst.m)
    E = big_inst.n_edges
    try:
        ops.solve_budgeted_dp_kernel(
            torch.zeros(E, dtype=torch.int32, device=dev),
            torch.ones(E, dtype=torch.int32, device=dev), big_tables, s_cap,
            s_cap)
    except ValueError as err:
        print(f"   fig6 c_hi=6 ({s_cap + 1} x {big_tables.n_states}) raises "
              f"ValueError: {str(err)[:70]}...", flush=True)
    else:
        fail("the fig6 c_hi=6 plane did not raise at the gate")
    done(t0)

    # --------------------------------------------------------- main path
    t0 = phase(f"main path: ESDP simulate, T={T}, Table 2")
    policy = esdp.make_esdp_policy(table2, T, tables=tables2)
    for k in kernel.LAUNCHES:
        kernel.LAUNCHES[k] = 0
    w0 = time.perf_counter()
    single = simulate(table2, policy, T, seed=SEED, tables=tables2)
    wall_single = time.perf_counter() - w0
    counts_single = dict(kernel.LAUNCHES)
    print(f"   launches {counts_single}; {wall_single:.2f} s, "
          f"{wall_single / T * 1e3:.3f} ms per slot", flush=True)
    if counts_single != {"dp_forward": T, "dp_forward_batched": 0,
                         "dp_epilogue": T}:
        fail(f"simulate launched {counts_single}, expected T={T} forwards "
             "and epilogues")
    done(t0)

    t0 = phase(f"main path: ESDP simulate_batch, B={FLEET}, T={T}")
    seeds = [SEED] + list(range(1, FLEET))
    for k in kernel.LAUNCHES:
        kernel.LAUNCHES[k] = 0
    w0 = time.perf_counter()
    fleet = simulate_batch(table2, policy, T, seeds, tables=tables2)
    wall_fleet = time.perf_counter() - w0
    counts_fleet = dict(kernel.LAUNCHES)
    print(f"   launches {counts_fleet}; {wall_fleet:.2f} s, "
          f"{wall_fleet / T * 1e3:.3f} ms per slot", flush=True)
    if counts_fleet != {"dp_forward": 0, "dp_forward_batched": T,
                        "dp_epilogue": T}:
        fail(f"simulate_batch launched {counts_fleet}, expected one "
             f"batched forward and one epilogue per slot (T={T})")
    done(t0)

    t0 = phase("checks of the main path's output")
    E = table2.n_edges
    for name, r, shape in (("simulate", single, (T,)),
                           ("simulate_batch", fleet, (FLEET, T))):
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
    print("   simulate_batch rows 0-2 equal simulate(seed) in x", flush=True)
    Ts = 60
    small = esdp.make_esdp_policy(table2, Ts, tables=tables2)
    draws = make_draws(table2, Ts, 7, dev)
    # one schedule for both: the card's and the CPU's float32 log may
    # differ by an ulp, which would move a ceiling in the statistics
    sched = stats.schedule_table(Ts, table2.m, device="cpu")
    on_card = simulate(table2, small, Ts, tables=tables2, draws=draws,
                       schedule=sched)
    cpu_draws = type(draws)(*(t.cpu() for t in (draws.arr_u, draws.val_n,
                                                draws.pol_u)))
    on_cpu = simulate(table2, small, Ts, tables=tables2, device="cpu",
                      draws=cpu_draws, schedule=sched)
    if not np.array_equal(on_card.x, on_cpu.x):
        fail("ESDP on the card and the CPU reference disagree on the same "
             f"draws (T={Ts})")
    print(f"   T={Ts}: card (CUDA kernels) and CPU (int32 reference) ESDP "
          "make the same decisions on the same draws", flush=True)
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
    done(t0)

    # ------------------------------------------------------------ timing
    t0 = phase("times at the main path's shapes (profiler device time, "
               "CUDA events over back-to-back launches)")
    s_cap = stats.s_cap_for_horizon(T, table2.m)
    S, C = s_cap + 1, tables2.n_states
    feas, offs, v0 = operands(tables2, s_cap)
    W = kernel.packed_words(E)
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    keep = []  # outputs of the raw launches, alive while they are timed
    rows = []

    def checked(launch, args):
        def call():
            err = launch(*args)
            if err:
                fail(f"raw launch returned CUDA error {err}")
        return call

    def raw_forward(u, s, a, f, B):
        """The forward's C entry point on outputs allocated once: one
        launch without the wrapper's checks and allocations."""
        out = (torch.empty((B, S, C), dtype=torch.int32, device=dev),
               torch.empty((B, W, S, C), dtype=torch.int32, device=dev))
        keep.append(out)
        return checked(lib.dp_forward_launch, (
            u.data_ptr(), s.data_ptr(), None if a is None else a.data_ptr(),
            f.data_ptr(), offs.data_ptr(), v0.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), B, E, S, C, stream))

    def raw_epilogue(V, Wd, u, sl, B):
        out = (torch.empty((B, E), dtype=torch.int32, device=dev),
               torch.empty((B,), dtype=torch.int32, device=dev),
               torch.empty((B, S), dtype=torch.int32, device=dev))
        keep.append(out)
        return checked(lib.dp_epilogue_launch, (
            V.data_ptr(), Wd.data_ptr(), u.data_ptr(), offs.data_ptr(),
            sl.data_ptr(), tables2.full_state, B, E, S, C, out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), stream))

    def fwd_bound(B, with_alw):
        nbytes = 4 * (B * E * (3 if with_alw else 2) + E * C + E + S * C
                      + B * S * C + B * W * S * C)
        nops = FWD_OPS_PER_CELL * B * E * S * C
        return nbytes, nops

    def epi_bound(x):
        """Per instance: the V column at full_state (S) and the value row
        (S), one word and one x per edge (2E), s_limit and s* (2); Υ̂ of
        each taken edge, and each offset that some instance's walk uses."""
        B = x.shape[0]
        nbytes = 4 * (B * (2 * S + 2 * E + 2) + int(x.sum())
                      + int(x.any(0).sum()))
        nops = B * (5 * S + 6 * E)
        return nbytes, nops

    def row(name, source_line, shapes, launches, err, timed, p_ms, bound):
        ev_ms, w_ms, prof_ms = timed
        # back-to-back launches of a kernel shorter than one host launch
        # time the host; the trace's device time is the kernel's own
        k_ms = ev_ms if prof_ms is None else prof_ms
        nbytes, nops = bound
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/budgeted_dp/csrc/budgeted_dp.cu",
            "replaces": source_line, "launches": launches,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        prof = "not measured" if prof_ms is None else f"{prof_ms:.4f} ms"
        print(f"   {name} {shapes}: kernel {k_ms:.4f} ms (profiler device "
              f"time {prof}, CUDA events over back-to-back launches "
              f"{ev_ms:.4f} ms), through the wrapper {w_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.4f} us "
              f"({nbytes} bytes, {nops} int32 ops)", flush=True)

    def timed(raw, wrapper, kernel_name, calls):
        return (per_call_ms(raw, calls), per_call_ms(wrapper, calls),
                profiled_ms(raw, calls, kernel_name))

    ups, sig, slim, alw = stats_case(table2, FLEET, 99)
    alw_i = alw.to(torch.int32)
    f1 = feas * alw_i[0][:, None]
    u1, s1 = ups[0].contiguous(), sig[0].contiguous()
    t1 = timed(raw_forward(u1, s1, None, f1, 1),
               lambda: kernel.dp_forward(u1, s1, f1, offs, v0),
               "dp_forward_kernel", 200)
    p1 = per_call_ms(lambda: ref.dp_forward_ref(ups[:1], sig[:1], None, f1,
                                                offs, v0), 3, reps=3)
    row("dp_forward", "src/repro/kernels/budgeted_dp/kernel.py:409",
        f"B=1 S={S} C={C} E={E}", counts_single["dp_forward"],
        worst["dp_forward"], t1, p1, fwd_bound(1, False))
    t2 = timed(raw_forward(ups, sig, alw_i, feas, FLEET),
               lambda: kernel.dp_forward_batched(ups, sig, alw_i, feas,
                                                 offs, v0),
               "dp_forward_kernel", 200)
    p2 = per_call_ms(lambda: ref.dp_forward_ref(ups, sig, alw_i, feas, offs,
                                                v0), 3, reps=3)
    row("dp_forward_batched", "src/repro/kernels/budgeted_dp/kernel.py:484",
        f"B={FLEET} S={S} C={C} E={E}", counts_fleet["dp_forward_batched"],
        worst["dp_forward_batched"], t2, p2, fwd_bound(FLEET, True))
    V, Wd = kernel.dp_forward_batched(ups, sig, alw_i, feas, offs, v0)
    t3 = timed(raw_epilogue(V, Wd, ups, slim, FLEET),
               lambda: kernel.dp_epilogue(V, Wd, ups, offs, slim,
                                          tables2.full_state),
               "dp_epilogue_kernel", 500)
    p3 = per_call_ms(lambda: ref.dp_epilogue_ref(V, Wd, ups, offs, slim,
                                                 tables2.full_state), 3, reps=3)
    x_epi = kernel.dp_epilogue(V, Wd, ups, offs, slim, tables2.full_state)[0]
    if not torch.equal(keep[-1][0], x_epi):
        fail("the raw epilogue launch and the wrapper disagree in x")
    # the row names the fleet's shapes, so it counts the fleet run's launches
    print(f"   dp_epilogue launches: simulate {counts_single['dp_epilogue']}, "
          f"simulate_batch {counts_fleet['dp_epilogue']}", flush=True)
    row("dp_epilogue", "src/repro/kernels/budgeted_dp/ops.py:231",
        f"B={FLEET} S={S} C={C} E={E}", counts_fleet["dp_epilogue"],
        worst["dp_epilogue"], t3, p3, epi_bound(x_epi))
    print(f"   card: {card}", flush=True)
    done(t0)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(HERE)
    main()
