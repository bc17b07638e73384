"""Device times of the budgeted DP's small kernels on one NVIDIA GPU: the
epilogue (s* rule and backtrack, plain and tabled) and K3, the per-edge
forward, for whichever tree of the port ``--src`` names.

    python3 tools/dp_kernel_probe.py [--src DIR] [--label NAME]

``--src`` is the ``src/`` directory to import ``repro_torch`` from (by
default this checkout's), so that two trees, built each into its own
``build/``, are timed in one run on one card.  It uses only entry points
that every tree since the per-edge forward has (``dp_epilogue_launch``,
``dp_edge_launch``, ``dp_forward_blocked``, ``WarmCudaSolver``) and times
what a tree has beyond them where it has it (the empty kernel, the
per-edge pipeline without chained launches).

It prints, each from a ``torch.profiler`` trace of back-to-back launches:
- the default epilogue at B = 1 on the paper's Table-2 plane (S 919, C 12)
  with its walk cut to E' = 0 (the s* rule alone), 1, 9, 17, 25 and 33
  edges, and the slope of the device time over E' ≥ 1 (least squares):
  the per-edge cost of the walk;
- the three rows of the kernel table at the main paths' shapes: the
  epilogue at Table 2, B = 64, E 33; the tabled epilogue on the dispatch
  plane (S 201, C 216, E 15, the warm solver's two segments), B = 1; K3
  at fig-6 c_hi = 6 (S 801, C 126), B = 1, one edge;
- the per-solve span of the per-edge pipeline (``dp_forward_blocked``,
  31 ``dp_edge`` launches at fig-6 c_hi = 6, B = 1): the first kernel's
  start to the last one's end in the trace, averaged over solves, once
  as the host loop issues them and once queued behind a sleeping kernel,
  so that the launches wait on the device and not on the host;
- with ``dp_empty_launch``, the device time of an empty kernel on each
  row's grid and block: the floor no launch beats;
- the dispatch slot end to end (``ClusterSim`` on the dispatch
  configuration, T = 800: ESDP cold, with the solve cache, warm-started),
  host clock a slot.
The last line is one JSON object of these numbers.  Without a GPU it
exits non-zero.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import warnings

HERE = pathlib.Path(__file__).resolve().parents[1]


def profile_trace(fn, calls):
    """The kernel events ({name, ts, dur} in µs) of ``calls`` calls of
    ``fn`` from a chrome trace of ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return [e for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel" and "dur" in e]


def device_ms(fn, calls, name):
    """Device ms per call of the kernels named ``name`` (None if the trace
    holds none)."""
    evts = [e for e in profile_trace(fn, calls) if name in e["name"]]
    return sum(e["dur"] for e in evts) / calls / 1e3 if evts else None


def span_ms(fn, solves, per_solve, name):
    """Mean ms from the first ``name`` kernel's start to the last one's end
    of each of ``solves`` calls of ``fn`` (``per_solve`` kernels each)."""
    evts = sorted((e for e in profile_trace(fn, solves) if name in e["name"]),
                  key=lambda e: e["ts"])
    if len(evts) != solves * per_solve:
        return None
    spans = []
    for i in range(solves):
        grp = evts[i * per_solve:(i + 1) * per_solve]
        spans.append(max(e["ts"] + e["dur"] for e in grp) - grp[0]["ts"])
    return sum(spans) / len(spans) / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(HERE / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("dp_kernel_probe: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    from repro_torch.core import build_tables, generate_instance, stats
    from repro_torch.core.dp import initial_plane
    from repro_torch.kernels.budgeted_dp import build, kernel, ops, ref
    from repro_torch.launch.dispatch import T as TD
    from repro_torch.launch.dispatch import dispatch_instance

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    empty = getattr(lib, "dp_empty_launch", None)
    out = {"label": args.label, "src": args.src, "card": card}
    print(f"{args.label}: {args.src}; {card}; torch {torch.__version__}",
          flush=True)

    def floor(gx, gy, threads):
        if empty is None:
            return None
        return device_ms(lambda: empty(gx, gy, threads, stream), 500,
                         "empty_kernel")

    def stats_case(inst, B, seed, horizon):
        rng = np.random.default_rng(seed)
        E, m = inst.n_edges, inst.m
        xi_tab, g_tab, _ = stats.schedule_table(horizon, m, device=dev)
        t = torch.as_tensor(rng.integers(0, horizon, B), device=dev)
        vhat = torch.as_tensor(rng.random((B, E)), dtype=torch.float32,
                               device=dev)
        n = torch.as_tensor(rng.integers(0, 30, (B, E)) * (
            rng.random((B, E)) < 0.9), dtype=torch.int32, device=dev)
        ups, sig, slim = stats.scale_statistics(
            vhat, n, xi_tab[t][:, None], g_tab[t][:, None], m)
        alw = torch.as_tensor(rng.random((B, E)) < 0.7,
                              device=dev).to(torch.int32)
        return ups, sig, slim[:, 0].contiguous(), alw

    def operands(tables, s_cap):
        feas, offs = ops.prepare_tables(tables)
        return (torch.as_tensor(feas, device=dev),
                torch.as_tensor(offs, device=dev),
                initial_plane(s_cap, tables.n_states, dev))

    def epilogue_raw(
        V, W, ups, offs, slim, full, B, E, S, C, rows=None, bits=None, n_words=None
    ):
        res = (torch.empty((B, E), dtype=torch.int32, device=dev),
               torch.empty((B,), dtype=torch.int32, device=dev),
               torch.empty((B, S), dtype=torch.int32, device=dev))
        head = (V.data_ptr(), W.data_ptr(), ups.data_ptr(), offs.data_ptr(),
                slim.data_ptr(), None if rows is None else rows.data_ptr(),
                None if bits is None else bits.data_ptr(), full, B, E,
                n_words or kernel.packed_words(E), S, C, res[0].data_ptr(),
                res[1].data_ptr(), res[2].data_ptr())

        def call():
            err = lib.dp_epilogue_launch(*head, stream)
            if err:
                raise RuntimeError(f"epilogue launch: CUDA error {err}")
        return call, res

    # the epilogue on Table 2's plane (T = 2000), walks of E' edges
    inst2 = generate_instance(seed=0)
    tables2 = build_tables(inst2.A, inst2.c)
    s_cap = stats.s_cap_for_horizon(2000, inst2.m)
    S, C, E = s_cap + 1, tables2.n_states, inst2.n_edges
    feas, offs, v0 = operands(tables2, s_cap)
    ups, sig, slim, alw = stats_case(inst2, 64, 99, 2000)
    V, W = kernel.dp_forward_batched(ups, sig, alw, feas, offs, v0)
    pts = []
    for e_cut in (0, 1, 9, 17, 25, 33):
        call, _ = epilogue_raw(V[:1], W[:1], ups[:1, :e_cut].contiguous(),
                               offs[:e_cut].contiguous(), slim[:1],
                               tables2.full_state, 1, e_cut, S, C)
        pts.append((e_cut, device_ms(call, 300, "dp_epilogue_kernel")))
    xs = np.array([p[0] for p in pts[1:]], float)
    ys = np.array([p[1] for p in pts[1:]], float)
    slope = float(np.polyfit(xs, ys, 1)[0]) * 1e3  # µs an edge
    out["walk"] = {"ms": {str(x): y for x, y in pts},
                   "slope_us_per_edge": slope}
    print("   epilogue B=1 Table 2: device ms at E' = "
          + ", ".join(f"{x}: {y:.5f}" for x, y in pts)
          + f"; slope {slope:.5f} us an edge", flush=True)
    rows = {}
    call, res = epilogue_raw(V, W, ups, offs, slim, tables2.full_state, 64,
                             E, S, C)
    ms = device_ms(call, 500, "dp_epilogue_kernel")
    call()
    want = ref.dp_epilogue_ref(V, W, ups, offs, slim, tables2.full_state)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(res, want))
    rows["epilogue B=64 Table 2"] = ms
    print(f"   epilogue B=64 S={S} C={C} E={E}: {ms:.5f} ms, equal to the "
          f"plain version: {same}", flush=True)
    if not same:
        sys.exit(1)
    rows["empty B=64 x 256"] = floor(64, 1, 256)

    # the tabled epilogue on the dispatch plane: the warm solver's packing
    d_inst = dispatch_instance()
    d_tables = build_tables(d_inst.A, d_inst.c)
    d_s_cap = stats.s_cap_for_horizon(TD, d_inst.m)
    d_S, d_C, d_E = d_s_cap + 1, d_tables.n_states, d_inst.n_edges
    d_feas, d_offs, d_v0 = operands(d_tables, d_s_cap)
    du, ds, dl, da = stats_case(d_inst, 1, 97, TD)
    warm = ops.WarmCudaSolver(d_tables, d_s_cap,
                              u_max=stats.u_max_for_horizon(TD, d_inst.m),
                              checkpoint_every=8, device=dev)
    warm(du[0], ds[0], d_tables, d_s_cap, dl[0], allowed=da[0])
    Vw, Ww = warm._planes[-1][None], warm._words_cat
    call, res = epilogue_raw(Vw, Ww, du, d_offs, dl, d_tables.full_state, 1,
                             d_E, d_S, d_C, warm._w_rows, warm._bits,
                             Ww.shape[1])
    ms = device_ms(call, 500, "dp_epilogue_kernel")
    call()
    want = ref.dp_epilogue_ref(Vw, Ww, du, d_offs, dl, d_tables.full_state,
                               warm._w_rows, warm._bits)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(res, want))
    rows["tabled epilogue B=1 dispatch"] = ms
    print(f"   tabled epilogue B=1 S={d_S} C={d_C} E={d_E}: {ms:.5f} ms, "
          f"equal to the plain version: {same}", flush=True)
    if not same:
        sys.exit(1)
    rows["empty B=1 x 256"] = floor(1, 1, 256)

    # K3 at fig-6 c_hi = 6, T = 1500, B = 1
    inst6 = generate_instance(seed=2, c_lo=1, c_hi=6)
    tables6 = build_tables(inst6.A, inst6.c)
    s_cap6 = stats.s_cap_for_horizon(1500, inst6.m)
    S6, C6, E6 = s_cap6 + 1, tables6.n_states, inst6.n_edges
    feas6, offs6, v06 = operands(tables6, s_cap6)
    u6, g6, _, a6 = stats_case(inst6, 1, 96, 1500)
    vin = v06[None].contiguous()
    vout = torch.empty_like(vin)
    words = torch.zeros((1, kernel.packed_words(E6), S6, C6),
                        dtype=torch.int32, device=dev)
    e_mid = E6 // 2

    def edge():
        err = lib.dp_edge_launch(
            u6.data_ptr(), g6.data_ptr(), a6.data_ptr(), feas6.data_ptr(),
            offs6.data_ptr(), vin.data_ptr(), S6 * C6, vout.data_ptr(),
            words.data_ptr(), 1, E6, S6, C6, e_mid, stream)
        if err:
            raise RuntimeError(f"dp_edge launch: CUDA error {err}")
    rows["dp_edge B=1 fig6"] = device_ms(edge, 500, "dp_edge_kernel")
    print(f"   dp_edge B=1 S={S6} C={C6} one edge: "
          f"{rows['dp_edge B=1 fig6']:.5f} ms", flush=True)
    grid = (S6 * C6 + 1023) // 1024 if empty is not None else 0
    rows[f"empty {grid} x 256"] = floor(grid, 1, 256)
    Vp, Wp = ref.dp_forward_ref(u6, g6, a6, feas6, offs6, v06)
    Vk, Wk = kernel.dp_forward_blocked(u6, g6, a6, feas6, offs6, v06)
    torch.cuda.synchronize()
    if not (torch.equal(Vk, Vp) and torch.equal(Wk, Wp)):
        print("   the per-edge pipeline differs from its plain version",
              file=sys.stderr)
        sys.exit(1)

    def unchained():
        words_u = torch.zeros_like(Wp)
        bufs = [torch.empty_like(Vp) for _ in range(2)]
        Vu = v06
        for n, e in enumerate(range(E6 - 1, -1, -1)):
            Vu, words_u = kernel.dp_edge(Vu, bufs[n % 2], words_u, u6, g6,
                                         a6, feas6, offs6, e, chained=False)

    pipelines = {"dp_forward_blocked": lambda: kernel.dp_forward_blocked(
        u6, g6, a6, feas6, offs6, v06)}
    if "chained" in kernel.dp_edge.__code__.co_varnames:
        pipelines["every launch unchained"] = unchained
    spans = {}
    for name, fn in pipelines.items():
        for queued in (False, True):
            def solve(fn=fn, queued=queued):
                if queued:  # the host issues all launches while it sleeps
                    torch.cuda._sleep(20_000_000)
                fn()
            ms = span_ms(solve, 20, E6, "dp_edge_kernel")
            key = f"{name}, {'queued' if queued else 'host loop'}"
            spans[key] = ms
            print(f"   per-edge pipeline span ({key}): "
                  f"{'not measured' if ms is None else f'{ms:.5f}'} ms a "
                  f"solve of {E6} launches", flush=True)
    out["rows"] = rows
    out["spans"] = spans

    # the dispatch slot end to end: ClusterSim on the dispatch
    # configuration (T = 800, pod-b browned out), ESDP cold, with the solve
    # cache and warm-started, host clock a slot after one untimed run
    from repro_torch.launch.dispatch import SEED, brownout
    from repro_torch.sched import ClusterSim
    d_sched = stats.schedule_table(TD, d_inst.m, stats.delta_default,
                                   stats.g_logt_only, "cpu")

    def dispatch_ms(**kw):
        sim = ClusterSim(d_inst, TD, speed_fn=brownout(TD, d_inst.n_servers),
                         seed=SEED, device=dev, schedule=d_sched, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run("esdp", tiebreak=0.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TD * 1e3

    dispatch_ms()
    slots = {label: dispatch_ms(**kw) for label, kw in (
        ("esdp cold", {}), ("incremental=cache", {"incremental": "cache"}),
        ("incremental=warm", {"incremental": "warm"}))}
    print("   dispatch slot (ms, host clock, T=800): " + ", ".join(
        f"{k} {v:.3f}" for k, v in slots.items()), flush=True)
    out["dispatch_slot_ms"] = slots
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
