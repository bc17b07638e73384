"""The port's training loss of the dense family (qwen2.5-32b, and
gemma3-27b with its window) against ``jax.value_and_grad`` of the JAX
package's ``Model.loss`` on the CPU: the REDUCED configs in f32, the JAX
parameters carried across by ``from_jax_params``, the port's gradients
carried back by ``to_jax_tree``.

Tolerances (f32 in both packages, summation order only): the loss within
1e-5 of its magnitude; every gradient leaf within 1e-4 of the largest
entry of the JAX leaf, plus 1e-6, in max norm.  The helpers here
(``loss_parity``, ``check_parity``) serve the other families' loss files
too; each JAX ``value_and_grad`` compiles once per module fixture.

torch runs single-threaded here (see ``tests/test_torch_serve.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model, from_jax_params, to_jax_tree

LOSS_TOL = 1e-5
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-6
B = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **overrides):
    """(JAX config, port config) of the reduced ``arch``, with the same
    field overrides on both."""
    jcfg = jax_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        cfg = dataclasses.replace(cfg, **overrides)
    return jcfg, cfg


def make_batch(cfg, S, seed=0):
    """numpy inputs of a loss: tokens (B, S + 1), and the family's extras
    (vlm: patch embeddings and (3, B, n_vision + S) grid positions; encdec:
    frame embeddings)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        batch["patch_embeds"] = rng.standard_normal(
            (B, nv, cfg.d_model)).astype(np.float32)
        side = int(np.sqrt(nv))
        t = np.concatenate([np.zeros(nv), np.arange(1, S + 1)])
        hh = np.concatenate([np.arange(nv) // side, np.arange(1, S + 1)])
        ww = np.concatenate([np.arange(nv) % side, np.arange(1, S + 1)])
        pos = np.stack([t, hh, ww]).astype(np.int32)  # distinct streams
        batch["positions"] = np.broadcast_to(pos[:, None], (3, B, nv + S)).copy()
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return batch


def jax_value_and_grad(jcfg, batch, seed=0):
    """(JAX params as numpy, loss, metrics, grads as numpy) of one
    ``jax.value_and_grad`` of the JAX loss."""
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat="full"), has_aux=True))
    (loss, metrics), grads = vg(jparams, jax.tree.map(jnp.asarray, batch))
    return (jax.device_get(jparams), float(loss), jax.device_get(metrics),
            jax.device_get(grads))


def port_value_and_grad(cfg, jparams, batch, remat="full"):
    """(loss, metrics, grads in the JAX layout) of the port's loss on the
    carried parameters."""
    model = build_model(cfg)
    params = from_jax_params(cfg, jparams, trainable=True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = model.loss(params, tb, remat=remat)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return (float(loss.detach()),
            {k: float(torch.as_tensor(v).detach()) for k, v in metrics.items()},
            to_jax_tree(cfg, dict(zip(named, grads))))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree, np.float32)


def check_parity(want, got):
    """want/got: (loss, metrics, grads) of JAX and of the port."""
    (jl, jm, jg), (pl, pm, pg) = want, got
    assert abs(pl - jl) <= LOSS_TOL * abs(jl), (pl, jl)
    for k, v in pm.items():
        assert abs(v - float(jm[k])) <= LOSS_TOL * max(abs(float(jm[k])), 1.0), k
    jflat, pflat = dict(leaves(jg)), dict(leaves(pg))
    assert jflat.keys() == pflat.keys()
    for k, w in jflat.items():
        g = pflat[k]
        assert g.shape == w.shape, k
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()) + GRAD_FLOOR, (k, err)


def loss_parity(arch, S, **overrides):
    """JAX's and the port's (loss, metrics, grads) of the reduced arch."""
    jcfg, cfg = configs(arch, **overrides)
    batch = make_batch(cfg, S)
    jparams, jl, jm, jg = jax_value_and_grad(jcfg, batch)
    return (jl, jm, jg), port_value_and_grad(cfg, jparams, batch), (
        cfg, jparams, batch)


@pytest.fixture(scope="module")
def qwen():
    return loss_parity("qwen2.5-32b", 40)


@pytest.fixture(scope="module")
def gemma3():
    # 80 tokens outrun the reduced window of 64: the local layers' window
    # bites
    return loss_parity("gemma3-27b", 80)


@pytest.fixture(scope="module")
def qwen_chunked():
    # cross-entropy chunks of 16 over 40 positions: two whole chunks and a
    # padded, masked third
    return loss_parity("qwen2.5-32b", 40, xent_chunk=16)


@pytest.mark.parametrize("case", ["qwen", "gemma3", "qwen_chunked"])
def test_loss_and_every_gradient_leaf_match_jax(case, request):
    want, got, _ = request.getfixturevalue(case)
    check_parity(want, got)


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_remat_policies_give_the_full_remat_gradients(qwen, remat):
    """The checkpoint policy changes what is recomputed, not the result."""
    _, full, (cfg, jparams, batch) = qwen
    other = port_value_and_grad(cfg, jparams, batch, remat=remat)
    assert abs(other[0] - full[0]) <= 1e-6 * abs(full[0])
    for (k, a), (_, b) in zip(leaves(other[2]), leaves(full[2])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=k)


def test_loss_of_the_chunked_cross_entropy_equals_the_whole(qwen, qwen_chunked):
    """The seq-chunked cross-entropy (padded, masked, divided by B·S) is
    the whole sequence's mean."""
    assert abs(qwen[1][0] - qwen_chunked[1][0]) <= 1e-6 * abs(qwen[1][0])


def test_serving_builds_no_graph_on_trainable_parameters(qwen):
    """prefill and decode run under no_grad: their outputs and the caches
    they write do not require gradients, though the parameters do."""
    cfg, jparams, batch = qwen[2]
    model = build_model(cfg)
    params = from_jax_params(cfg, jparams, trainable=True)
    assert all(p.requires_grad for p in params.parameters())
    tokens = torch.as_tensor(batch["tokens"][:, :8])
    cache = model.alloc_cache(B, 9, tokens.device)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache=cache)
    assert not logits.requires_grad
    assert not any(t.requires_grad for pair in cache.values() for t in pair)
    dec, _ = model.decode(params, {"token": tokens[:, -1:], "cache": cache,
                                   "pos": torch.full((B,), 8)})
    assert not dec.requires_grad


def test_to_jax_tree_inverts_from_jax_params(qwen):
    cfg, jparams, _ = qwen[2]
    back = to_jax_tree(cfg, from_jax_params(cfg, jparams))
    want = dict(leaves(jparams))
    got = dict(leaves(back))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
