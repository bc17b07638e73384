"""Multi-rank helpers of the port's CPU tests, and the placement of full
tensors on a mesh.

``run_ranks(fn, world, tmp_path)`` spawns ``world`` processes (one torch
thread each), joins them in a gloo group through a ``FileStore`` under
``tmp_path`` (never a fixed port: several test workers run at once), runs
``fn(rank)`` on each and returns the results by rank; a rank's exception
fails the caller with its traceback.  ``sharded_step_case`` is one
rank's side of the sharded-training tests (``test_torch_mesh_train*.py``):
the same state and batch through the port's unsharded step and through
``make_train_step(rules=make_rules(mesh, "train"))`` on ``DTensor``s,
with what the attention and SSD operators received and the collectives
that ran.  ``serve_case`` is one rank's side of the sharded-serving tests
(``test_torch_mesh_serve*.py``): ``greedy_generate`` unsharded and with
``rules=make_rules(mesh, preset)`` from the same parameters, every step's
logits, the placed cache's local shapes, the operators' calls and what
each decode step's collectives sent.  This module imports no JAX: the
spawned ranks import it.

The one case here: a failing rank's traceback reaches the test.
"""
import dataclasses
import datetime
import math
import os
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=180)
# AdamW of the sharded-step cases: eps 1e-4 as in
# tests/test_torch_train_step.py, whose docstring says why
LR, EPS = 1e-2, 1e-4


def _rank_main(rank, world, store_path, out_dir, fn):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = fn(rank)
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, meanwhile=None):
    """``fn(rank)`` on ``world`` spawned gloo ranks; their results, by
    rank.  ``fn`` must be importable by the spawned processes.
    ``meanwhile()``, when given, runs in this process while the ranks
    work."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(_rank_main, args=(world, str(tmp_path / "store"),
                                     str(tmp_path), fn), nprocs=world,
                   join=False)
    try:
        if meanwhile is not None:
            meanwhile()
    finally:
        while not ctx.join():
            pass
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
    for r, out in enumerate(outs):
        if isinstance(out, dict) and "error" in out:
            raise AssertionError(f"rank {r}:\n{out['error']}")
    return outs


class Recorder:
    """Wraps the plain versions that the K6/K7 operators call on the CPU
    and records the head counts (and batch rows) each call received."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.ssd import ref as ssd_ref
        self.calls = {"fa_fwd": [], "fa_bwd": [], "ssd": [], "ssd_bwd": []}
        self._undo = []
        for mod, name, key, dims in (
                (fa_ref, "flash_attention_ref", "fa_fwd", (0, 2)),
                (fa_ref, "flash_attention_bwd_ref", "fa_bwd", (0, 2)),
                (ssd_ref, "ssd_ref", "ssd", (0, 2)),
                (ssd_ref, "ssd_bwd_ref", "ssd_bwd", (0, 2))):
            orig = getattr(mod, name)

            def wrapped(*a, _orig=orig, _key=key, _dims=dims, **kw):
                # (rows, q heads, kv heads) of attention; (rows, heads) of SSD
                shapes = tuple(a[0].shape[d] for d in _dims)
                if _key.startswith("fa"):
                    shapes += (a[1].shape[2],)
                self.calls[_key].append(shapes)
                return _orig(*a, **kw)
            setattr(mod, name, wrapped)
            self._undo.append((mod, name, orig))

    def close(self):
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)


def _comm_counts(comm) -> dict:
    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
           "all_to_all": 0}
    for op, n in comm.get_comm_counts().items():
        for k in out:
            if k in str(op):
                out[k] += n
    return out


def sharded_step_case(cfg, params_np, batch_np, mesh_shape, record=True):
    """One rank's side of a sharded-step case: the port's unsharded step
    and the sharded one (``mesh_shape`` over ("data", "model")) from the
    JAX parameters ``params_np`` on ``batch_np``.  Returns the metrics of
    both, every parameter's local shape beside ``Rules.local_shape``, the
    operators' calls, the collectives, and the full updated state (params,
    AdamW's m and v) of both steps."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.models.layers import spec_leaves
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.runtime import init_train_state, make_rules, make_train_step
    from repro_torch.runtime.sharding import full
    from repro_torch.runtime.train_step import (TrainState, shard_batch,
                                                shard_train_state)

    model = build_model(cfg)
    opt = AdamW(lr=linear_warmup_cosine(LR, 2, 10), grad_clip=1.0, eps=EPS)

    def fresh():
        state = init_train_state(model, torch.Generator().manual_seed(0), opt)
        return TrainState(params=from_jax_params(cfg, params_np,
                                                 trainable=True),
                          opt=state.opt, err=None)

    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    batch["tokens"] = batch["tokens"].long()
    if "positions" in batch:
        batch["positions"] = batch["positions"].long()
    plain, pm = make_train_step(model, opt, remat="full")(fresh(), batch)

    mesh = make_mesh_shape(mesh_shape, ("data", "model"))
    rules = make_rules(mesh, "train")
    state = shard_train_state(fresh(), model, rules)
    axes = dict(spec_leaves(model.spec))
    shapes = {n: (tuple(p.to_local().shape),
                  rules.local_shape(tuple(p.shape), axes[n].axes))
              for n, p in state.params.named_parameters()}
    step = make_train_step(model, opt, rules=rules, remat="full")
    rec = Recorder() if record else None
    try:
        with CommDebugMode() as comm:
            state, sm = step(state, shard_batch(batch, rules))
    finally:
        if rec is not None:
            rec.close()

    def whole(tree):
        return {n: full(t.detach()).clone() for n, t in tree.items()}
    return {"plain": {"loss": float(pm["loss"]),
                      "grad_norm": float(pm["grad_norm"]),
                      "params": whole(dict(plain.params.named_parameters())),
                      "m": whole(plain.opt.m), "v": whole(plain.opt.v)},
            "sharded": {"loss": float(sm["loss"]),
                        "grad_norm": float(sm["grad_norm"]),
                        "params": whole(dict(state.params.named_parameters())),
                        "m": whole(state.opt.m), "v": whole(state.opt.v),
                        "step": int(state.opt.step)},
            "shapes": shapes, "calls": rec.calls if rec else None,
            "comm": _comm_counts(comm)}


def check_against_plain(case, tol=1e-5, floor=1e-5):
    """The sharded step against the unsharded one: the loss and the
    gradient norm within ``tol`` relative; every parameter within ``tol``
    of its largest entry plus ``floor`` (a thousandth of lr: see
    ``tests/test_torch_train_step.py``), every moment within 1e-4 of its
    largest entry plus 1e-12."""
    p, s = case["plain"], case["sharded"]
    assert abs(s["loss"] - p["loss"]) <= tol * abs(p["loss"]), (s, p)
    assert abs(s["grad_norm"] - p["grad_norm"]) <= tol * abs(p["grad_norm"])
    for part, t, fl in (("params", tol, floor), ("m", 1e-4, 1e-12),
                        ("v", 1e-4, 1e-12)):
        assert p[part].keys() == s[part].keys()
        for n, want in p[part].items():
            err = float((s[part][n] - want).abs().max())
            assert err <= t * float(want.abs().max()) + fl, (part, n, err)


def check_local_shapes(case):
    for n, (got, want) in case["shapes"].items():
        assert got == tuple(want), (n, got, want)
    # a step that sharded nothing would keep every parameter whole
    assert any(got != tuple(case["plain"]["params"][n].shape)
               for n, (got, _) in case["shapes"].items())


def check_collectives(case):
    """The sharded step gathered or reduce-scattered, and all-reduced: a
    step that replicated everything has no gather or reduce-scatter."""
    c = case["comm"]
    assert c["all_gather"] + c["reduce_scatter"] > 0, c
    assert c["all_reduce"] > 0, c


def _failing_case(rank):
    if rank == 1:
        raise ZeroDivisionError("rank one fails")
    return rank


def test_run_ranks_reports_a_failing_rank(tmp_path):
    with pytest.raises(AssertionError, match="rank one fails"):
        run_ranks(_failing_case, 2, tmp_path)


def jax_inputs(arch, S=16, seed=0, **overrides):
    """(JAX config, port config, JAX parameters as numpy, a numpy batch of
    four rows) of a reduced arch: the parameters from the JAX package's
    ``Model.init`` (jitted), the batch two of ``tests/test_torch_loss_dense.py``'s
    (seeds ``seed`` and ``seed`` + 1) stacked.  Imports JAX: called in the
    test process only.  ``overrides``: config fields changed in both
    packages."""
    import jax

    from repro.models import build_model as jax_build_model
    from test_torch_loss_dense import configs, make_batch
    jcfg, cfg = configs(arch, **overrides)
    a, b = make_batch(cfg, S, seed=seed), make_batch(cfg, S, seed=seed + 1)
    batch = {k: np.concatenate([a[k], b[k]], axis=1 if k == "positions"
                               else 0) for k in a}
    params = jax.device_get(jax.jit(jax_build_model(jcfg).init)(
        jax.random.PRNGKey(seed)))
    return jcfg, cfg, jax.tree.map(np.asarray, params), batch


def cases_on_ranks(path, rank):
    """Every sharded-step case of a test module on this rank, by name;
    ``path``: a file of (name, (config, JAX params, batch, mesh shape))
    pairs (a file, not spawn's arguments: those are written down a pipe
    that each rank reads only once it has started, one after another)."""
    cases = torch.load(path, weights_only=False)
    return {name: sharded_step_case(*args) for name, args in cases}


# ---------------------------------------------------------------------------
# serving across ranks
# ---------------------------------------------------------------------------

def _sent_shapes(args, kwargs):
    from torch.utils._pytree import tree_leaves
    return [tuple(a.shape) for a in tree_leaves((args, kwargs))
            if isinstance(a, torch.Tensor)]


def collective_recorder():
    """The sharded-step cases' ``CommDebugMode`` that also keeps, for each
    collective, its name and the shapes of the tensors it sends
    (``.sent``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveSizes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.sent = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = str(func)
            if out is not NotImplemented and "c10d" in name and not any(
                    w in name for w in ("wait", "wrap")):
                self.sent.append((name, _sent_shapes(args, kwargs)))
            return out
    return CollectiveSizes()


def _recording(model, logits, caches, sent=None):
    """``model`` whose prefill and decode keep each call's whole logits
    (and the prefill's cache); with ``sent``, each decode step's
    collectives too."""
    from repro_torch.runtime.sharding import full

    def prefill(*a, **kw):
        out = model.prefill(*a, **kw)
        logits.append(full(out[0]).clone())
        caches.append(out[1])
        return out

    def decode(*a, **kw):
        if sent is None:
            out = model.decode(*a, **kw)
        else:
            with collective_recorder() as rec:
                out = model.decode(*a, **kw)
            sent.append(rec.sent)
        logits.append(full(out[0]).clone())
        return out
    return dataclasses.replace(model, prefill=prefill, decode=decode)


def _leaves(cache, axes):
    """(name, leaf, its axes) of a cache tree."""
    for k, ax in axes.items():
        if isinstance(ax, tuple) and all(isinstance(a, tuple) for a in ax):
            for i, a in enumerate(ax):
                yield f"{k}/{i}", cache[k][i], a
        else:
            yield k, cache[k], ax


def serve_case(cfg, params_np, batch_np, preset, steps, s_max):
    """One rank's side of a sharded-serving case: ``greedy_generate`` of
    ``steps`` tokens at ``s_max`` from the JAX parameters ``params_np`` on
    the prompt ``batch_np``, unsharded and with ``make_rules(mesh,
    preset)`` on a 2 × 2 (data, model) mesh (the parameters placed as
    ``shard_train_state`` places ``model.axes()``).  Returns both runs'
    tokens and every step's logits, each cache leaf's local shape beside
    ``Rules.local_shape`` and its whole shape, the operators' calls, the
    shapes each decode step's collectives sent, and the parameters' local
    shapes."""
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.runtime import (TrainState, greedy_generate,
                                     make_prefill_step, make_rules)
    from repro_torch.runtime.sharding import full
    from repro_torch.runtime.train_step import shard_batch, shard_train_state

    model = build_model(cfg)
    params = from_jax_params(cfg, params_np)
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    for k in ("tokens", "positions"):
        if k in batch:
            batch[k] = batch[k].long()
    plain_logits, sharded_logits, caches, sent = [], [], [], []
    plain = greedy_generate(_recording(model, plain_logits, []), params,
                            batch, steps, s_max)
    mesh = make_mesh_shape((2, 2), ("data", "model"))
    rules = make_rules(mesh, preset)
    sharded_params = shard_train_state(
        TrainState(params=params, opt=None, err=None), model, rules).params
    rec = Recorder()
    try:
        sharded = greedy_generate(
            _recording(model, sharded_logits, caches, sent), sharded_params,
            batch, steps, s_max, rules=rules)
    finally:
        rec.close()
    # the prefill step given no cache allocates one on the mesh
    alone, _ = make_prefill_step(model, rules)(sharded_params,
                                               shard_batch(batch, rules))
    abstract, axes = model.cache_spec(batch["tokens"].shape[0], s_max)
    shapes = {name: (tuple(leaf.to_local().shape),
                     rules.local_shape(tuple(leaf.shape), ax),
                     tuple(leaf.shape), ax)
              for name, leaf, ax in _leaves(caches[0], axes)}
    return {"plain": (plain, plain_logits),
            "sharded": (sharded, sharded_logits),
            "prefill_alone": full(alone),
            "cache": shapes, "calls": rec.calls, "sent": sent,
            "params": [tuple(p.to_local().shape)
                       for p in sharded_params.parameters()]}


def serve_cases_on_ranks(path, rank, extra=None):
    """Every sharded-serving case of a test module on this rank, by name
    (``path``: a file of (name, ``serve_case`` arguments) pairs); with
    ``extra``, also ``extra()``'s results under "extra"."""
    cases = torch.load(path, weights_only=False)
    out = {name: serve_case(*args) for name, args in cases}
    if extra is not None:
        out["extra"] = extra()
    return out


def check_serving_against_plain(case, tol=1e-5, floor=1e-5):
    """The sharded tokens equal the unsharded ones; every step's logits
    within ``tol`` of the step's largest |logit| plus ``floor`` (f32,
    summation order only), and so the sharded prefill step's given no
    cache."""
    (pt, pl), (st, sl) = case["plain"], case["sharded"]
    assert torch.equal(pt, st), (pt, st)
    assert len(pl) == len(sl) == pt.shape[1]
    for i, (a, b) in enumerate(zip(pl + pl[:1],
                                   sl + [case["prefill_alone"]])):
        err = float((a - b).abs().max())
        assert err <= tol * float(a.abs().max()) + floor, (i, err)


def check_cache_shapes(case):
    """Each cache leaf's local shape is ``Rules.local_shape``; every leaf
    with a ``cache_seq`` axis is sharded along it."""
    for name, (got, want, whole, ax) in case["cache"].items():
        assert got == tuple(want), (name, got, want)
        if "cache_seq" in ax:
            i = ax.index("cache_seq")
            assert got[i] < whole[i], (name, got, whole)


def _layer_shard(got, ax):
    return got[ax.index("batch"):]


def check_decode_collectives(case):
    """No decode step gathers a cache leaf.  Each collective sends neither
    a cache leaf's local shard nor one layer's of it (their shapes up to a
    permutation: a gather sends the local shard, moved to put its dim
    first).  Beyond that, where the cache has sequence-sharded leaves,
    every send but a parameter's own shard (the presets' FSDP placement
    over ``embed`` gathers weights) carries fewer elements than one
    layer's local shard of the largest of them, the k-cache (MLA's
    c_kv): what remains are partials, (batch, heads, width)-sized."""
    def key(shape):
        return tuple(sorted(shape))
    leaves = {}
    for name, (got, _, _, ax) in case["cache"].items():
        leaves[key(got)] = leaves[key(_layer_shard(got, ax))] = name
    seq = [math.prod(_layer_shard(got, ax))
           for got, _, _, ax in case["cache"].values() if "cache_seq" in ax]
    limit = max(seq) if seq else None
    params = {key(s) for s in case["params"]}
    assert case["sent"] and all(case["sent"])
    for step, sent in enumerate(case["sent"]):
        for op, shapes in sent:
            for s in shapes:
                assert key(s) not in leaves, (step, op, s, leaves[key(s)])
                if limit is not None and key(s) not in params:
                    assert math.prod(s) < limit, (step, op, s, limit)


def serve_units():
    """On this rank of a 2 × 2 (data, model) mesh: (1) the greedy token of
    vocab-sharded logits with ties planted within a shard and across the
    vocab shards, beside ``torch.argmax`` of the whole logits (the first
    maximum); (2) the sequence-sharded decode attention (S_max 16) where
    slices are wholly masked — row 0 at position 5 (the upper positions
    not yet written), row 1 at 14 with window 4 (the lower ones outside
    it) — beside the plain decode on the whole cache; (3) a prefill's
    prefix and a decode's rows written into a sequence-sharded cache,
    beside the same writes into the whole cache.  (2) and (3) with the
    sequence over model (the rows over data) and over both mesh dims
    (four slices, as the ``long`` preset lays it over (pod, data))."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models.local import (argmax_last,
                                          decode_attention_on_shards,
                                          gqa_decode, write_prefix,
                                          write_rows)
    from repro_torch.runtime.sharding import full, shard_tensor
    mesh = make_mesh_shape((2, 2), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 16, generator=g)
    logits[0, [3, 11]] = 9.0  # tied across the vocab shards [0, 8), [8, 16)
    logits[1, [9, 12]] = 9.0  # tied within the upper shard
    logits[2, [0, 8, 15]] = 9.0
    got = {pl: full(argmax_last(shard_tensor(logits, mesh, pl)))
           for pl in ((Shard(0), Shard(1)), (Shard(1), Shard(1)))}
    want = torch.argmax(logits, dim=-1)

    q = torch.randn(2, 1, 8, 16, generator=g)
    k, v = (torch.randn(2, 16, 2, 16, generator=g) for _ in range(2))
    pos, window = torch.tensor([5, 14]), 4
    plain = gqa_decode(q, k, v, pos, window=window).reshape(2, 1, 8, 16)
    prefix, row = (torch.randn(2, n, 2, 16, generator=g) for n in (10, 1))
    whole = torch.zeros(2, 16, 2, 16)
    write_rows(write_prefix(whole, prefix), row, pos)
    attention, writes = {}, {}
    for pl in ((Shard(0), Shard(1)), (Shard(1), Shard(1))):
        kd, vd = (shard_tensor(t, mesh, pl) for t in (k, v))
        attention[pl] = (full(decode_attention_on_shards(
            q, kd, vd, pos, window=window)), plain)
        cache = shard_tensor(torch.zeros(2, 16, 2, 16), mesh, pl)
        write_rows(write_prefix(cache, prefix), row, pos)
        writes[pl] = (full(cache), whole)
    return {"argmax": (got, want), "attention": attention, "writes": writes}
