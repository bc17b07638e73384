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
that ran.  This module imports no JAX: the spawned ranks import it.

The one case here: a failing rank's traceback reaches the test.
"""
import datetime
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
