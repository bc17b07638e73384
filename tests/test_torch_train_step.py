"""The port's train step (``runtime.make_train_step`` with ``optim.AdamW``)
against the JAX package's, on the CPU, from one carried ``TrainState``:
the JAX parameters by ``from_jax_params``, its AdamW moments and step by
``opt_state_from_jax``, its error feedback by ``named_from_jax``; the
port's state carried back by ``to_jax_tree`` / ``opt_state_to_jax``.

Cases: one and three steps of AdamW under ``linear_warmup_cosine`` with
clipping (reduced qwen2.5-32b, f32); ``microbatches=2`` on the vlm
(qwen2-vl-72b), whose (3, B, S) positions split along their batch axis;
top-k compression with error feedback, as a function on a tied gradient
that ``torch.topk`` breaks otherwise than ``jax.lax.top_k``, and inside
the step (reduced gemma-7b, tied embeddings).

Tolerances (f32, summation order only): the loss and the gradient norm
within 1e-5 relative; every parameter within 1e-5 of its leaf's
largest entry plus 1e-5 (a thousandth of lr; see EPS below), every
moment within 1e-4 of its leaf's largest entry plus 1e-12, after each
step.  One jitted JAX step per case, compiled once per
module fixture.

torch runs single-threaded here (see ``tests/test_torch_serve.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import linear_warmup_cosine as jax_warmup_cosine
from repro.optim import topk_compress_with_feedback as jax_compress
from repro.runtime import init_train_state as jax_init_state
from repro.runtime import make_train_step as jax_make_step
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, from_jax_params, to_jax_tree
from repro_torch.models.convert import (jax_leaf_groups, named_from_jax,
                                        opt_state_from_jax, opt_state_to_jax)
from repro_torch.optim import AdamW, linear_warmup_cosine
from repro_torch.optim import compression
from repro_torch.runtime import TrainState, make_train_step
from test_torch_loss_dense import configs, leaves, make_batch, one_torch_thread  # noqa: F401

STEPS = 3
# AdamW's eps in both packages, and the parameters' absolute floor below.
# Where a gradient entry is near its own f32 summation noise (~1e-9: the
# k bias on qwen2.5's slowest rotary pairs, whose sums over the keys
# cancel; embedding rows), m/(√v + eps) turns that noise, equal in kind in
# both packages, into parameter steps of up to a few per cent of lr at the
# default eps of 1e-8 (3.4e-4 seen after three steps).  At eps 1e-4 the
# same noise moves a step by under 1e-3 of lr (≤ 7.7e-6 seen); the floor
# is 1e-5, a thousandth of lr.  The formula is the same for any eps.
EPS = 1e-4


def run_both(
    arch, S, batches, microbatches=1, compress_ratio=None, lr=1e-2, **overrides
):
    """Both packages' ``STEPS`` steps from one state; per step the loss,
    the gradient norm and the state in the JAX layout."""
    jcfg, cfg = configs(arch, **overrides)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jopt = JaxAdamW(lr=jax_warmup_cosine(lr, 2, 10), grad_clip=1.0, eps=EPS)
    opt = AdamW(lr=linear_warmup_cosine(lr, 2, 10), grad_clip=1.0, eps=EPS)
    jstate = jax_init_state(jmodel, jax.random.PRNGKey(0), jopt,
                            compress=compress_ratio is not None)
    jstep = jax.jit(jax_make_step(jmodel, jopt, remat="full",
                                  microbatches=microbatches,
                                  compress_ratio=compress_ratio))
    host = jax.device_get(jstate)
    state = TrainState(
        params=from_jax_params(cfg, host.params, trainable=True),
        opt=opt_state_from_jax(cfg, host.opt.step, host.opt.m, host.opt.v),
        err=None if host.err is None else named_from_jax(cfg, host.err))
    step = make_train_step(model, opt, remat="full",
                           microbatches=microbatches,
                           compress_ratio=compress_ratio)
    out = []
    for b in batches[:STEPS]:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        h = jax.device_get(jstate)
        want = {"params": h.params, "m": h.opt.m, "v": h.opt.v,
                "step": int(h.opt.step), "err": h.err}
        o = opt_state_to_jax(cfg, state.opt)
        got = {"params": to_jax_tree(cfg, state.params), "m": o["m"],
               "v": o["v"], "step": o["step"],
               "err": None if state.err is None else to_jax_tree(cfg,
                                                                 state.err)}
        out.append(((float(jm["loss"]), float(jm["grad_norm"]), want),
                    (float(m["loss"]), float(m["grad_norm"]), got)))
    return out


def check_step(want, got):
    (jl, jg, js), (pl, pg, ps) = want, got
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    assert abs(pg - jg) <= 1e-5 * abs(jg), (pg, jg)
    assert ps["step"] == js["step"]
    for part, tol, floor in (("params", 1e-5, 1e-5), ("m", 1e-4, 1e-12),
                             ("v", 1e-4, 1e-12), ("err", 1e-4, 1e-12)):
        if js[part] is None:
            assert ps[part] is None
            continue
        jf, pf = dict(leaves(js[part])), dict(leaves(ps[part]))
        assert jf.keys() == pf.keys()
        for k, w in jf.items():
            err = float(np.abs(pf[k] - w).max())
            assert err <= tol * float(np.abs(w).max()) + floor, (part, k, err)


def lm_batches(cfg, S, n=STEPS, B=2):
    ds = JaxSyntheticLM(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=3)
    return [ds.batch(i) for i in range(n)]


@pytest.fixture(scope="module")
def adamw_steps():
    _, cfg = configs("qwen2.5-32b")
    return run_both("qwen2.5-32b", 32, lm_batches(cfg, 32))


@pytest.fixture(scope="module")
def vlm_microbatch_steps():
    _, cfg = configs("qwen2-vl-72b")
    batches = [make_batch(cfg, 24, seed=i) for i in range(STEPS)]
    for b in batches:  # two rows a microbatch: four rows
        for k in b:
            b[k] = np.concatenate([b[k], b[k][..., ::-1, :] if k ==
                                   "positions" else b[k][::-1]],
                                  axis=1 if k == "positions" else 0)
    return run_both("qwen2-vl-72b", 24, batches, microbatches=2)


@pytest.fixture(scope="module")
def compressed_steps():
    _, cfg = configs("gemma-7b")
    return run_both("gemma-7b", 32, lm_batches(cfg, 32),
                    compress_ratio=0.05)


@pytest.mark.parametrize("i", range(STEPS))
def test_adamw_steps_match_jax(adamw_steps, i):
    """AdamW, the warmup-cosine schedule and the clip: steps 1..3."""
    check_step(*adamw_steps[i])


@pytest.mark.parametrize("i", range(STEPS))
def test_microbatched_vlm_steps_match_jax(vlm_microbatch_steps, i):
    check_step(*vlm_microbatch_steps[i])


@pytest.mark.parametrize("i", range(STEPS))
def test_compressed_steps_match_jax(compressed_steps, i):
    check_step(*compressed_steps[i])


def test_the_clip_and_the_schedule_bite(adamw_steps):
    """The gradient norm is over the clip of 1.0 and the step's learning
    rate is the warmup's, so both took part above."""
    (_, gnorm, _), _ = adamw_steps[0]
    assert gnorm > 1.0
    sched = linear_warmup_cosine(1e-2, 2, 10)
    assert float(sched(torch.tensor(1))) == pytest.approx(5e-3)
    assert float(sched(torch.tensor(2))) == pytest.approx(1e-2)


def tied_grads(cfg):
    """A gradient tree in the JAX layout whose values repeat: |g| takes
    four values, so every top k has ties at its edge."""
    spec = jax_leaf_groups(build_model(cfg).spec)
    rng = np.random.default_rng(7)
    jg = {}
    named = {}
    for key, items in spec.items():
        shape = None
        for idx, name in items:
            shape = tuple(build_model(cfg).init(
                torch.Generator().manual_seed(0)).get_parameter(name).shape)
            break
        full = (len(items),) + shape if items[0][0] else shape
        vals = rng.integers(-2, 3, full).astype(np.float32) * 0.5
        node = jg
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = vals
    named = named_from_jax(cfg, jg)
    return jg, named


@pytest.fixture(scope="module")
def tied():
    _, cfg = configs("qwen2.5-32b")
    jg, named = tied_grads(cfg)
    jcomp, jerr = jax_compress(jax.tree.map(jnp.asarray, jg), None, 0.03)
    groups = [[n for _, n in items] for items in
              jax_leaf_groups(build_model(cfg).spec).values()]
    return cfg, named, groups, jax.device_get(jcomp), jax.device_get(jerr)


def test_compression_on_tied_gradients_matches_jax(tied):
    cfg, named, groups, jcomp, jerr = tied
    comp, err = compression.topk_compress_with_feedback(named, None, 0.03,
                                                        groups)
    for got, want in ((to_jax_tree(cfg, comp), jcomp),
                      (to_jax_tree(cfg, err), jerr)):
        for (k, a), (_, b) in zip(sorted(leaves(got)), sorted(leaves(want))):
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_tied_gradients_tell_torch_topk_apart(tied, monkeypatch):
    """With ``torch.topk`` in place of the stable top-k, the kept entries
    move away from JAX's on the same tied gradient."""
    cfg, named, groups, jcomp, _ = tied
    monkeypatch.setattr(compression, "stable_top_k",
                        lambda x, k: torch.topk(x, k))
    comp, _ = compression.topk_compress_with_feedback(named, None, 0.03,
                                                      groups)
    got = dict(leaves(to_jax_tree(cfg, comp)))
    assert any(not np.array_equal(got[k], w) for k, w in leaves(jcomp))

