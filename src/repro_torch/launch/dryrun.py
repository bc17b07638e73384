"""Multi-pod dry run: plan every (arch × shape × mesh) cell on meta tensors
(the port of the JAX package's ``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all      # subprocess per cell, resumable

Each cell writes results/dryrun_torch/{arch}_{shape}_{mesh}[_tag].json
(apart from the JAX package's results/dryrun/) with the memory, cost,
collective wire bytes and roofline terms.  Failures land in the JSON as
"error" and fail the sweep summary.

Nothing runs on a device: the step — ``runtime.make_train_step``'s step
for a train shape, ``Model.prefill`` or ``Model.decode`` otherwise — runs
on meta tensors, whose ops compute shapes only.  The hand-written kernels
take their meta route there (they allocate what they allocate on the
card, compute nothing and launch nothing).  The mesh is a ``DeviceMesh``
over torch's fake process group (``launch/mesh.py``); only its axis
names and sizes are read.

The record keeps the JAX schema where a key means the same; where it does
not, the key is renamed or dropped:
  - ``trace_s`` / ``cost_traces_s`` in place of ``compile_s`` /
    ``cost_compiles_s``: seconds of the meta traces.
  - ``memory``: ``argument_bytes`` is exact — the ``Rules.local_shape``
    bytes of the parameters, the AdamW state (train) or the cache
    (decode), and the batch (``params_bytes``, ``opt_state_bytes``,
    ``cache_bytes``, ``batch_bytes`` split it).  ``temp_bytes`` is the
    peak of the live tensors the step allocates, traced at one device's
    local batch (the global batch over the mesh axes that ``batch``
    shards).  Activations are not divided over ``model``: prefill and
    decode trace through the models' sharding hook (``rules=``, as the
    JAX package lowers them), which is the identity on meta tensors; the
    train step traces without it.  A parameter's gradient, and the
    AdamW temporaries of its shape, count at its shard's share once the
    gradient is complete (FSDP reduce-scatters it).  ``peak_est_bytes``
    = argument + temp: the step updates the state in place, so nothing
    is aliased (no ``alias_bytes``), and what it returns is live at its
    end, inside temp (no ``output_bytes``).  No ``transcendentals``.
  - ``cost_global`` in place of ``cost``: GLOBAL FLOPs (``aten`` ops by
    ``FlopCounterMode``, the kernels by their own formulas,
    ``kernels.work``) and bytes (each op's tensor inputs read and outputs
    written once, views free; the kernels by their formulas), traced at
    the global batch at 2–4 reduced depths and extrapolated
    (``cost_model``).  The roofline divides them by ``n_devices``: an
    even split.
  - ``collectives``: a model of the collectives the ``Rules`` placements
    imply (:func:`collective_records`), not a count of collectives that
    run: the models carry the ``rules`` hook, but the plan traces the
    unsharded step.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, SHAPES, Shape, get_config, shape_applicable
from ..kernels.work import KERNEL_WORK
from ..models import build_model
from ..models.layers import DTYPES, spec_leaves
from ..optim import AdamW
from ..runtime import TrainState, make_train_step
from ..runtime.sharding import Rules, make_rules, mesh_axes
from .cost_model import cost_variants, solve_costs
from .mesh import make_production_mesh
from .roofline import collective_bytes, roofline_terms
from .specs import input_specs

__all__ = ["RESULTS", "plan_cell", "lower_cell", "collective_records",
           "step_cost", "step_memory", "run_one", "run_all", "main"]

RESULTS = pathlib.Path("results/dryrun_torch")

aten = torch.ops.aten
_MATMULS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
# factories that write nothing
_UNWRITTEN = (aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
              aten.new_empty_strided)


def _preset_for(shape) -> str:
    if shape.name == "long_500k":
        return "long"
    if shape.kind == "decode":
        return "decode"
    return "train"


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# the traced step
# ---------------------------------------------------------------------------

def _step(model, shape: Shape, remat: str, microbatches: int, rules: Rules):
    """(the step on meta tensors as a thunk, its parameters, the AdamW
    state (train) or None, the batch).  Prefill and decode take ``rules``
    (``launch/dryrun.py:67-73`` of the JAX package)."""
    params = model.abstract()
    batch, _ = input_specs(model.config, shape, model)
    if shape.kind == "train":
        for p in params.parameters():
            p.requires_grad_(True)
        opt = AdamW(lr=3e-4)
        state = TrainState(params=params, opt=opt.init(params), err=None)
        step = make_train_step(model, opt, remat=remat,
                               microbatches=microbatches)
        return (lambda: step(state, batch)), params, state.opt, batch
    if shape.kind == "prefill":
        return (lambda: model.prefill(params, batch, rules=rules)), params, \
            None, batch
    return (lambda: model.decode(params, batch, rules=rules)), params, None, \
        batch


class _LiveBytes(TorchDispatchMode):
    """The live bytes of the storages the traced ops allocate, and their
    peak.  A storage is counted when an op first returns it and released
    when it dies (a finalizer on the storage); the storages that exist
    before the trace (the arguments) are never counted.  ``share(t, f)``
    counts t's storage at the fraction f of its bytes, and ops that are
    not products inherit that fraction for an output of the shape of an
    input it tags (a parameter's gradient and its AdamW temporaries, on
    a sharded mesh)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.live = self.peak = 0
        self.counted: dict[int, int] = {}
        self.frac: dict[int, float] = {}
        self.kept = [t.untyped_storage() for t in arguments]
        for st in self.kept:
            self.counted[st._cdata] = 0

    def _release(self, key):
        self.live -= self.counted.pop(key, 0)
        self.frac.pop(key, None)

    def _count(self, t, frac=1.0):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.counted:
            return
        n = int(st.nbytes() * frac)
        self.counted[key] = n
        if frac != 1.0:
            self.frac[key] = frac
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def share(self, t, frac: float):
        key = _key(t)
        self.frac[key] = frac
        if self.counted.get(key):
            n = int(t.untyped_storage().nbytes() * frac)
            self.live += n - self.counted[key]
            self.counted[key] = n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inherit = {}
        if self.frac and func.overloadpacket not in _MATMULS:
            for t in _tensors((args, kwargs)):
                f = self.frac.get(_key(t))
                if f is not None:
                    inherit[tuple(t.shape)] = f
        for t in _tensors(out):
            self._count(t, inherit.get(tuple(t.shape), 1.0))
        return out


def step_memory(
    model, shape: Shape, rules: Rules, remat: str = "full", microbatches: int = 1
) -> dict:
    """{"temp_bytes": the peak, "live_at_end_bytes"} of one step traced at
    ``shape``'s batch (pass one device's local batch)."""
    run, params, opt, batch = _step(model, shape, remat, microbatches, rules)
    moments = (opt.m, opt.v) if opt is not None else ()
    tracker = _LiveBytes(list(params.parameters())
                         + _tensors((opt.step, *moments) if opt else ())
                         + _tensors(batch))
    spec = dict(spec_leaves(model.spec))
    hooks = []
    for name, p in params.named_parameters():
        leaf = spec[name]
        frac = (math.prod(rules.local_shape(leaf.shape, leaf.axes))
                / math.prod(leaf.shape))
        if frac == 1.0:
            continue
        for t in (p, *(m[name] for m in moments if name in m)):
            tracker.frac[_key(t)] = frac
        if p.requires_grad:
            hooks.append(p.register_hook(
                lambda g, f=frac: tracker.share(g, f)))
    try:
        with tracker:
            out = run()
        live_end = tracker.live
        del out
    finally:
        for h in hooks:
            h.remove()
    return {"temp_bytes": tracker.peak, "live_at_end_bytes": live_end}


class _Counter(TorchDispatchMode):
    """Bytes each op moves (its tensor inputs read and outputs written
    once; views and empty factories free; a kernel by its formula), and
    the activations' collectives of the products over parameters (see
    :func:`collective_records`)."""

    def __init__(
        self, model, params, rules: Rules, batch_shards: int, tokens_local: int
    ):
        super().__init__()
        self.bytes = 0
        self.records: list = []
        self.cfg = model.config
        self.batch_shards, self.tokens_local = batch_shards, tokens_local
        self.sizes = mesh_axes(rules.mesh) if rules.mesh is not None else {}
        spec = dict(spec_leaves(model.spec))
        # parameter storage -> (the parameter, its axes, its spec)
        self.params = {}
        for name, p in params.named_parameters():
            leaf = spec[name]
            self.params[_key(p)] = (p, leaf.axes,
                                    rules.spec(leaf.shape, leaf.axes))

    def _moved(self, func, args, kwargs, out) -> int:
        packet = func.overloadpacket
        if packet in KERNEL_WORK:
            return KERNEL_WORK[packet](*args, **kwargs)[1]
        if packet in _UNWRITTEN or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns):
            return 0
        return sum(_nbytes(t) for t in _tensors((args, kwargs, out)))

    def _group(self, entry) -> int:
        return math.prod(self.sizes[a] for a in Rules.dim_axes(entry))

    def _products(self, func, args, out):
        a, b = (args[0], args[1]) if func.overloadpacket in (aten.mm, aten.bmm) \
            else (args[1], args[2])
        for t, other, cd in ((a, b, a.dim() - 1), (b, a, b.dim() - 2)):
            hit = self.params.get(_key(t))
            if hit is None:
                continue
            p, axes, spec = hit
            dims = [d for d in range(p.dim()) if p.stride(d) == t.stride(cd)
                    and p.size(d) == t.size(cd)]
            if not dims:
                continue
            d = dims[0]
            share = 1 / self.batch_shards
            on_model = ["model" in Rules.dim_axes(e) for e in spec]
            if axes[d] == "vocab" and on_model[d]:
                # a vocab-parallel head contracted: partial sums
                self.records.append(("all-reduce", _nbytes(out) * share,
                                     self._group(spec[d])))
            elif p.dim() == 2 and axes[-1] == "embed" and axes[0] != "embed" \
                    and on_model[0]:
                # the end of a product pair sharded over model: its output
                # in the forward, the gradient of the pair's input in the
                # backward (dy · Wᵀ, the same size)
                moved = out if d == 0 else other
                self.records.append(("all-reduce", _nbytes(moved) * share,
                                     self._group(spec[0])))
            elif (p.dim() == 3 and axes[0] == "expert" and axes[-1] == "embed"
                  and d == 1 and on_model[0]):
                # the expert down projection, experts over model: combine
                if self.cfg.moe_combine == "scatter_ar":
                    self.records.append((
                        "all-reduce", self.tokens_local * self.cfg.d_model
                        * out.element_size(), self._group(spec[0])))
                else:
                    self.records.append(("all-gather", _nbytes(out) * share,
                                         self._group(spec[0])))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.bytes += self._moved(func, args, kwargs, out)
        if func.overloadpacket in _MATMULS and self.sizes:
            self._products(func, args, out)
        return out


def collective_records(model, rules: Rules, kind: str, remat: str) -> list:
    """(kind, per-device out bytes, group size) of the collectives the
    parameters' placements imply in one step:

    - a leaf sharded over its "embed" dims' mesh axes (FSDP): an
      all-gather of it before the forward, another before the backward
      under remat "full", and a reduce-scatter of its gradient;
    - a leaf replicated over mesh axes that ``batch`` shards: an
      all-reduce of its gradient over them.

    The activations' come from the trace (:class:`_Counter`), one for
    each product that runs, recomputed ones included: an all-reduce of
    the output of a product pair's end (a 2-D leaf from a dim sharded
    over model to "embed": the attention, Mamba2 and MLP output
    projections) in the forward and of the pair's input gradient in the
    backward (Megatron's g and f); an all-reduce of the output of a
    product that contracts a vocab dim sharded over model (the LM head's
    backward); and for the expert down projection with the experts over
    model, the combine (an all-reduce of the tokens under
    ``moe_combine="scatter_ar"``, else an all-gather of the experts'
    outputs).  The expert dispatch is not modelled.
    """
    if rules.mesh is None:
        return []
    sizes = mesh_axes(rules.mesh)
    itemsize = DTYPES[model.config.param_dtype].itemsize
    batch_axes = [a for a in rules.table.get("batch", ()) if a in sizes]
    recs = []
    for _, leaf in spec_leaves(model.spec):
        spec = rules.spec(leaf.shape, leaf.axes)
        local = math.prod(rules.local_shape(leaf.shape, leaf.axes)) * itemsize
        fsdp = {a for d, name in enumerate(leaf.axes) if name == "embed"
                for a in Rules.dim_axes(spec[d])}
        g = math.prod(sizes[a] for a in fsdp)
        if g > 1:
            recs.append(("all-gather", local * g, g))
            if kind == "train":
                if remat == "full":
                    recs.append(("all-gather", local * g, g))
                recs.append(("reduce-scatter", local, g))
        if kind == "train":
            used = {a for e in spec for a in Rules.dim_axes(e)}
            n = math.prod(sizes[a] for a in batch_axes if a not in used)
            if n > 1:
                recs.append(("all-reduce", local, n))
    return recs


def _batch_shards(rules: Rules, B: int) -> int:
    if rules.mesh is None:
        return 1
    sizes = mesh_axes(rules.mesh)
    entry = rules.spec((B,), ("batch",))[0]
    return math.prod(sizes[a] for a in Rules.dim_axes(entry))


def step_cost(
    model,
    shape: Shape,
    rules: Rules,
    remat: str = "full",
    microbatches: int = 1,
    n_devices: int = 1,
) -> dict:
    """One step traced at ``shape``'s (global) batch: {"flops", "bytes
    accessed", "wire:<kind>", "wire:total", "count:<kind>"}."""
    run, params, _, _ = _step(model, shape, remat, microbatches, rules)
    shards = _batch_shards(rules, shape.global_batch)
    tokens = shape.global_batch // shards * (
        1 if shape.kind == "decode" else shape.seq_len)
    counter = _Counter(model, params, rules, shards, tokens)
    with FlopCounterMode(display=False) as flops, counter:
        run()
    coll = collective_bytes(
        counter.records + collective_records(model, rules, shape.kind, remat),
        n_devices)
    vals = {"flops": flops.get_total_flops(), "bytes accessed": counter.bytes,
            "wire:total": coll["total_wire_bytes"]}
    for kind, b in coll["by_kind"].items():
        vals[f"wire:{kind}"] = b
    for kind, c in coll["counts"].items():
        vals[f"count:{kind}"] = c
    return vals


def _argument_bytes(model, shape: Shape, rules: Rules) -> dict:
    """The exact per-device bytes of the step's arguments."""
    cfg = model.config

    def local_bytes(shape_, axes, itemsize):
        return math.prod(rules.local_shape(shape_, axes)) * itemsize

    pbytes = DTYPES[cfg.param_dtype].itemsize
    spec = dict(spec_leaves(model.spec))
    out = {"params_bytes": sum(local_bytes(l.shape, l.axes, pbytes)
                               for l in spec.values()),
           "opt_state_bytes": 0, "cache_bytes": 0}
    if shape.kind == "train":
        # the optimizer's own state, each moment placed as its leaf
        opt = AdamW(lr=3e-4).init(model.abstract())
        out["opt_state_bytes"] = _nbytes(opt.step) + sum(
            local_bytes(t.shape, spec[name].axes, t.element_size())
            for moments in (opt.m, opt.v) for name, t in moments.items())
    batch, axes = input_specs(cfg, shape, model)
    cache, cache_axes = batch.pop("cache", None), axes.pop("cache", None)
    out["batch_bytes"] = sum(
        local_bytes(batch[k].shape, axes[k], batch[k].element_size())
        for k in batch)
    if cache is not None:
        out["cache_bytes"] = sum(
            local_bytes(t.shape, ax, t.element_size())
            for t, ax in zip(_tensors(cache), _axes_leaves(cache_axes)))
    out["argument_bytes"] = sum(out.values())
    return out


def _axes_leaves(axes):
    if isinstance(axes, tuple) and all(a is None or isinstance(a, str)
                                       for a in axes):
        return [axes]
    items = axes.values() if isinstance(axes, dict) else axes
    return [leaf for v in items for leaf in _axes_leaves(v)]


def plan_cell(
    cfg,
    shape: Shape,
    mesh,
    *,
    preset: str | None = None,
    overrides: dict | None = None,
    remat: str = "full",
    microbatches: int = 1,
) -> dict:
    """The dry-run record of ``cfg`` at ``shape`` on ``mesh`` (a
    ``DeviceMesh``, a one-device one included, or any object with axis
    names and sizes): memory, global cost, collectives and roofline."""
    rules = make_rules(mesh, preset or _preset_for(shape), overrides)
    n_dev = math.prod(mesh_axes(mesh).values())
    model = build_model(cfg)
    local = Shape(shape.name, shape.seq_len,
                  shape.global_batch // _batch_shards(rules,
                                                      shape.global_batch),
                  shape.kind)

    t0 = time.perf_counter()
    memory = _argument_bytes(model, shape, rules)
    memory.update(step_memory(model, local, rules, remat, microbatches))
    memory["peak_est_bytes"] = memory["argument_bytes"] + memory["temp_bytes"]
    t_full = time.perf_counter() - t0

    t0 = time.perf_counter()
    variants, solve = cost_variants(cfg, shape.seq_len, shape.kind)
    vals = [step_cost(build_model(v), shape, rules, remat, microbatches,
                      n_dev) for v in variants]
    corrected = solve_costs(vals, solve)
    t_cost = time.perf_counter() - t0

    cost = {"flops": corrected["flops"],
            "bytes accessed": corrected["bytes accessed"]}
    coll = {"by_kind": {k.split(":", 1)[1]: v for k, v in corrected.items()
                        if k.startswith("wire:") and k != "wire:total"},
            "counts": {k.split(":", 1)[1]: v for k, v in corrected.items()
                       if k.startswith("count:")},
            "total_wire_bytes": corrected["wire:total"]}
    per_device = {k: v / n_dev for k, v in cost.items()}
    return {
        "n_devices": n_dev, "remat": remat, "microbatches": microbatches,
        "overrides": overrides or {},
        "trace_s": round(t_full, 2), "cost_traces_s": round(t_cost, 2),
        "memory": memory, "cost_global": cost, "collectives": coll,
        "roofline": roofline_terms(per_device, coll, n_dev, model, shape),
    }


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    remat: str = "full",
    microbatches: int = 1,
    overrides: dict | None = None,
    return_artifacts: bool = False,
    config_overrides: dict | None = None,
):
    """Plan one cell on a production mesh; returns the result record (and,
    with ``return_artifacts``, the sharding rules and the model, in place
    of the JAX package's compiled executable)."""
    cfg = get_config(arch)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": True, "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    rec.update(plan_cell(cfg, shape, mesh, overrides=overrides, remat=remat,
                         microbatches=microbatches))
    rec["config_overrides"] = config_overrides or {}
    if return_artifacts:
        rules = make_rules(mesh, _preset_for(shape), overrides)
        return rec, rules, build_model(cfg)
    return rec


def run_one(args) -> int:
    RESULTS.mkdir(parents=True, exist_ok=True)
    tag = f"_{args.tag}" if args.tag else ""
    out = RESULTS / f"{args.arch}_{args.shape}_{args.mesh}{tag}.json"
    try:
        rec = lower_cell(args.arch, args.shape, args.mesh == "multi",
                         remat=args.remat, microbatches=args.microbatches,
                         overrides=json.loads(args.overrides)
                         if args.overrides else None,
                         config_overrides=json.loads(args.config_overrides)
                         if args.config_overrides else None)
    except Exception as e:  # noqa: BLE001 — recorded, sweep summary fails
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "error": f"{type(e).__name__}: {e}"}
    out.write_text(json.dumps(rec, indent=1, default=str))
    if rec.get("error"):
        print(f"FAIL {out.name}: {rec['error'][:300]}")
        return 1
    if rec.get("skipped"):
        print(f"SKIP {out.name}: {rec['reason']}")
        return 0
    r = rec["roofline"]
    print(f"OK   {out.name} trace={rec['trace_s']}s "
          f"mem={rec['memory']['peak_est_bytes']/2**30:.2f}GiB/dev "
          f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
          f"coll={r['collective_s']:.4f}s -> {r['bottleneck']}")
    return 0


def run_all(args) -> int:
    RESULTS.mkdir(parents=True, exist_ok=True)
    cells = [(a, s, m)
             for a in ARCHS for s in SHAPES for m in ("single", "multi")]
    fails = 0
    for arch, shape, mesh_kind in cells:
        out = RESULTS / f"{arch}_{shape}_{mesh_kind}.json"
        if out.exists() and not args.force:
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
               "--remat", args.remat]
        print(">>", " ".join(cmd[3:]), flush=True)
        try:
            proc = subprocess.run(cmd, timeout=args.cell_timeout)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            out.write_text(json.dumps(
                {"arch": arch, "shape": shape, "mesh": mesh_kind,
                 "error": f"trace timeout > {args.cell_timeout}s"}))
            print(f"FAIL {out.name}: timeout", flush=True)
            rc = 1
        fails += int(rc != 0)
    print(f"sweep done, {fails} failures")
    return int(fails > 0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--overrides", default="",
                    help="JSON dict of sharding-rule overrides")
    ap.add_argument("--config-overrides", default="",
                    help="JSON dict of ModelConfig field overrides")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--cell-timeout", type=int, default=3600)
    args = ap.parse_args()
    if args.all:
        sys.exit(run_all(args))
    if not (args.arch and args.shape):
        ap.error("--arch/--shape required without --all")
    sys.exit(run_one(args))


if __name__ == "__main__":
    main()
