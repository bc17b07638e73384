"""Placing states on meshes, the elastic checkpoint and ``launch.train
--mesh`` on four gloo ranks of the CPU (one spawn for the module).

- ``shard_tensor`` keeps each rank's slice — the layout
  ``distribute_tensor`` makes — and ``full_tensor`` gives the full tensor
  back bitwise; ``place`` moves a parameter tree from a 2 × 2 to a 4 × 1
  mesh at ``Rules.local_shape``, still trainable.
- A REDUCED qwen2.5-32b train state (with compression's error feedback)
  after one sharded step on 2 × 2 is saved by ``CheckpointManager(mesh=)``
  (every rank gathers, the first writes) and restored onto 4 × 1 — into a
  state placed there, and through ``restore(shardings=)`` from a plain
  one — and onto one process without a mesh: every leaf bitwise equal.
- Top-k compression of ``DTensor`` gradients equals that of the same
  gradients whole, bitwise (ties at the top k's edge included); AdamW's
  gradient norm over them equals the whole gradients' (1e-6 relative)
  with one reduction for each distinct placements, not one a leaf; a
  sharded step of two microbatches cut from the global batch agrees with
  the unsharded one within 1e-5 (loss and gradient norm).
- ``launch.train --mesh 2,2`` (reduced qwen2.5-32b, 6 steps, a failure at
  step 5, a checkpoint every 3) on the four ranks against the unsharded
  run in this process: the same steps, restarts, lost steps and losses on
  every rank, the losses within 1e-5 relative of the unsharded run's.

The model throughout is REDUCED qwen2.5-32b cut to two layers (a DTensor
step's first run pays for every layer), registered by name for
``launch.train`` while the cases run.
"""
import contextlib
import dataclasses
import functools
import types

import pytest
import torch

from test_torch_ranks import run_ranks

ARCH = "qwen2.5-32b-two-layers"
# the batch of _elastic's step and of each of the two microbatches: the
# ranks' DTensor sharding propagation, paid once a shape, is shared
TRAIN = ["--arch", ARCH, "--reduced", "--steps", "6", "--batch", "4",
         "--seq", "16", "--fail-at", "5", "--save-every", "3",
         "--device", "cpu"]


@contextlib.contextmanager
def two_layers():
    """REDUCED qwen2.5-32b at two layers, registered as ``ARCH`` while the
    block runs (as ``tests/test_torch_registry.py`` registers one)."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_config("qwen2.5-32b", reduced=True),
                              n_layers=2)
    configs._MODULES[ARCH] = types.SimpleNamespace(FULL=cfg, REDUCED=cfg)
    try:
        yield cfg
    finally:
        del configs._MODULES[ARCH]


def _placements(cfg):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import build_model
    from repro_torch.models.layers import spec_leaves
    from repro_torch.runtime import make_rules
    from repro_torch.runtime.sharding import (full, place, shard_tensor,
                                              state_leaves)
    out = {}
    two = make_mesh_shape((2, 2), ("data", "model"))
    four = make_mesh_shape((4, 1), ("data", "model"))
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for pl in ((Shard(0), Shard(1)), (Shard(0), Shard(0)),
               (Replicate(), Shard(1))):
        d = shard_tensor(t, two, pl)
        out[str(pl)] = (tuple(d.to_local().shape), torch.equal(full(d), t),
                        torch.equal(d.to_local(), distribute_tensor(
                            t, two, pl).to_local()))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), trainable=True)
    whole = {n: p.detach().clone() for n, p in params.named_parameters()}
    axes = dict(spec_leaves(model.spec))
    r2, r4 = make_rules(two, "train"), make_rules(four, "train")

    def shardings(rules):
        return {n: rules.named(tuple(p.shape), axes[n].axes)
                for n, p in params.named_parameters()}
    on_four = place(place(params, shardings(r2)), shardings(r4))
    out["moved"] = all(
        torch.equal(full(p), whole[n]) and p.requires_grad
        and p.device_mesh == four and tuple(p.to_local().shape)
        == r4.local_shape(tuple(p.shape), axes[n].axes)
        for n, p in state_leaves(on_four))
    return out


def _elastic(cfg, ckpt_dir):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import init_train_state, make_rules, make_train_step
    from repro_torch.dtensor import is_dtensor
    from repro_torch.runtime.sharding import full, state_leaves
    from repro_torch.runtime.train_step import (shard_batch, shard_train_state,
                                                state_shardings)
    model = build_model(cfg)
    opt = AdamW(lr=1e-2)

    def fresh(seed):
        return init_train_state(model, torch.Generator().manual_seed(seed),
                                opt, compress=True)
    two = make_mesh_shape((2, 2), ("data", "model"))
    four = make_mesh_shape((4, 1), ("data", "model"))
    r2, r4 = make_rules(two, "train"), make_rules(four, "train")
    tokens = torch.as_tensor(SyntheticLM(vocab=model.config.vocab, seq_len=16,
                                         global_batch=4).batch(0)["tokens"])
    state = shard_train_state(fresh(0), model, r2)
    state, _ = make_train_step(model, opt, rules=r2, compress_ratio=0.1)(
        state, shard_batch({"tokens": tokens.long()}, r2))
    saved = {k: full(t).clone() for k, t in state_leaves(state)}
    saver = CheckpointManager(ckpt_dir, mesh=two)
    saver.save(1, state, async_=True)
    saver.wait()  # the write is the first rank's thread's

    def same(restored, mesh):
        leaves = dict(state_leaves(restored))
        return (leaves.keys() == saved.keys()
                and all(torch.equal(full(t), saved[k])
                        for k, t in leaves.items())
                and all(t.device_mesh == mesh for k, t in leaves.items()
                        if is_dtensor(t))
                and sum(is_dtensor(t) for t in leaves.values()) > 0
                if mesh is not None else
                all(not is_dtensor(t) for t in leaves.values()))

    out = {}
    like = shard_train_state(fresh(1), model, r4)
    got, step = CheckpointManager(ckpt_dir, mesh=four).restore(like)
    out["onto 4x1 in place"] = (step, got is like, same(got, four))
    plain = fresh(2)
    got, _ = CheckpointManager(ckpt_dir, mesh=four).restore(
        plain, shardings=state_shardings(model, r4, plain))
    out["onto 4x1 by shardings"] = (step, got is not plain, same(got, four))
    plain = fresh(3)
    got, _ = CheckpointManager(ckpt_dir).restore(plain)
    out["onto one process"] = (step, got is plain, same(got, None))
    return out


def _compression_and_microbatches(cfg):
    """Top-k compression on DTensor gradients against the same gradients
    whole (bitwise: the same global k entries, ties included), and a
    sharded step of two microbatches against the unsharded one."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, topk_compress_with_feedback
    from repro_torch.runtime import init_train_state, make_rules, make_train_step
    from repro_torch.runtime.sharding import full, shard_tensor
    from repro_torch.runtime.train_step import shard_batch, shard_train_state
    from torch.distributed.tensor import Replicate, Shard
    two = make_mesh_shape((2, 2), ("data", "model"))
    g = torch.Generator().manual_seed(5)
    grads = {"a": torch.randn(8, 12, generator=g),
             "b": torch.randn(6, generator=g),
             "c": torch.randn(4, 8, generator=g)}
    grads["c"][:, :4] = 0.5  # ties across the top k's edge
    err = {n: torch.randn(t.shape, generator=g) * 1e-3
           for n, t in grads.items()}
    groups = [["a", "c"], ["b"]]
    placements = {"a": (Shard(0), Shard(1)), "b": (Replicate(), Shard(0)),
                  "c": (Shard(1), Replicate())}
    want = topk_compress_with_feedback(grads, err, 0.2, groups)
    got = topk_compress_with_feedback(
        {n: shard_tensor(t, two, placements[n]) for n, t in grads.items()},
        {n: shard_tensor(t, two, placements[n]) for n, t in err.items()},
        0.2, groups)
    out = {"compression": all(
        torch.equal(full(x[n]), y[n]) and tuple(x[n].placements)
        == placements[n] for x, y in zip(got, want) for n in grads)}
    model = build_model(cfg)
    opt = AdamW(lr=1e-2, eps=1e-4)
    rules = make_rules(two, "train")
    tokens = torch.as_tensor(SyntheticLM(vocab=model.config.vocab, seq_len=16,
                                         global_batch=8).batch(0)["tokens"])
    batch = {"tokens": tokens.long()}

    def fresh():
        return init_train_state(model, torch.Generator().manual_seed(0), opt)
    _, plain = make_train_step(model, opt, microbatches=2)(fresh(), batch)
    _, sharded = make_train_step(model, opt, rules=rules, microbatches=2)(
        shard_train_state(fresh(), model, rules), shard_batch(batch, rules))
    out["microbatches"] = {k: (float(plain[k]), float(sharded[k]))
                           for k in ("loss", "grad_norm")}
    out["norm"] = _gradient_norm(two, grads, placements)
    return out


def _gradient_norm(mesh, grads, placements):
    """AdamW's gradient norm over ``DTensor`` gradients (two leaves share
    their placements) against the norm of the same gradients whole, and
    its all-reduces against those of one leaf's sum of squares for each
    distinct placements."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.optim import AdamW, OptState
    from repro_torch.runtime.sharding import shard_tensor
    grads = dict(grads, d=grads["a"] * 0.5)
    placements = dict(placements, d=placements["a"])
    sharded = {n: shard_tensor(t, mesh, placements[n])
               for n, t in grads.items()}
    params = {n: torch.zeros_like(t) for n, t in sharded.items()}
    state = OptState(step=torch.zeros((), dtype=torch.int32),
                     m={n: torch.zeros_like(t) for n, t in sharded.items()},
                     v={n: torch.zeros_like(t) for n, t in sharded.items()})
    with CommDebugMode() as comm:
        _, _, gnorm = AdamW().update(sharded, state, params)
    once = {}
    for n, pl in placements.items():
        once.setdefault(pl, n)
    with CommDebugMode() as one_each:
        for n in once.values():
            torch.sum(torch.square(sharded[n])).full_tensor()
    want = torch.sqrt(sum(torch.sum(torch.square(t)) for t in grads.values()))
    return {"norm": (float(gnorm), float(want)),
            "all_reduce": (_all_reduces(comm), _all_reduces(one_each))}


def _all_reduces(comm) -> int:
    return sum(n for op, n in comm.get_comm_counts().items()
               if "all_reduce" in str(op))


def _ranks_case(tmp, rank):
    from repro_torch.launch import train
    with two_layers() as cfg:
        return {"placements": _placements(cfg),
                "elastic": _elastic(cfg, f"{tmp}/elastic"),
                "optim": _compression_and_microbatches(cfg),
                "train": train.main(TRAIN + ["--mesh", "2,2", "--ckpt-dir",
                                             f"{tmp}/mesh_ckpt"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    plain = {}

    def unsharded():  # while the ranks work
        from repro_torch.launch import train
        with two_layers():
            plain.update(train.main(TRAIN + ["--ckpt-dir",
                                             str(tmp / "plain")]))
    ranks = run_ranks(functools.partial(_ranks_case, str(tmp)), 4,
                      tmp / "ranks", meanwhile=unsharded)
    return ranks, plain


def test_shard_tensor_and_place_keep_each_ranks_slice(runs):
    for out in runs[0]:
        got = dict(out["placements"])
        assert got.pop("moved")
        for key, (shape, same, layout) in got.items():
            assert same and layout, key
    first = runs[0][0]["placements"]
    assert first["(Shard(dim=0), Shard(dim=1))"][0] == (4, 6)
    assert first["(Shard(dim=0), Shard(dim=0))"][0] == (2, 12)
    assert first["(Replicate(), Shard(dim=1))"][0] == (8, 6)


@pytest.mark.parametrize("where", ["onto 4x1 in place",
                                   "onto 4x1 by shardings",
                                   "onto one process"])
def test_a_2x2_checkpoint_restores_elsewhere_bitwise(runs, where):
    for out in runs[0]:
        step, identity, same = out["elastic"][where]
        assert step == 1 and identity and same, (where, identity, same)


def test_compression_picks_the_same_global_top_k_on_dtensors(runs):
    for out in runs[0]:
        assert out["optim"]["compression"]


def test_the_gradient_norm_reduces_once_for_each_placements(runs):
    for out in runs[0]:
        (got, want), (n, n_groups) = (out["optim"]["norm"][k]
                                      for k in ("norm", "all_reduce"))
        assert abs(got - want) <= 1e-6 * want, (got, want)
        assert n == n_groups > 0, (n, n_groups)


def test_sharded_microbatches_are_cut_from_the_global_batch(runs):
    for out in runs[0]:
        for key, (plain, sharded) in out["optim"]["microbatches"].items():
            assert abs(sharded - plain) <= 1e-5 * abs(plain), key


def test_launch_train_mesh_2x2_restarts_as_the_unsharded_run(runs):
    ranks, plain = runs
    assert plain["restarts"] == 1 and plain["lost_steps"] == 2
    for out in ranks:  # wall_s and straggler_slow_steps read a clock
        got = out["train"]
        for key in ("steps", "restarts", "lost_steps", "first_loss",
                    "last_loss"):
            assert got[key] == ranks[0]["train"][key], key
        for key in ("steps", "restarts", "lost_steps"):
            assert got[key] == plain[key], key
        for key in ("first_loss", "last_loss"):
            assert abs(got[key] - plain[key]) <= 1e-5 * abs(plain[key]), key
