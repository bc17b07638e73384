"""The port's multi-head latent attention (``models/attention.py``:
``mla_train``, ``mla_decode``) against the JAX package's on the CPU, at
the REDUCED deepseek-v3-671b widths (4 heads, q/k 16 nope + 8 rope = 24,
v 16, kv_lora 32, q_lora 48), on the same weights and inputs.

The prefill's output and its compressed cache (c_kv, k_rope after RoPE),
and one absorbed-form decode step's output and written cache, are held to
1e-4 (rtol and atol; f32 in both, summation order only).  The prefill
runs through ``chunked_attention`` (on the CPU the plain version of K6)
with one KV chunk and with several.

torch runs single-threaded here (see ``tests/test_torch_serve.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jax_attention
from repro.models.layers import SpecTree, init_params
from repro_torch.configs import get_config
from repro_torch.models import attention

TOL = 1e-4
ARCH = "deepseek-v3-671b"
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def weights():
    spec = SpecTree("float32")
    jax_attention.mla_specs(spec, "attn", jax_config(ARCH, reduced=True))
    # the norms' weights drawn too, so that a swapped norm shows
    jp = init_params(spec, jax.random.PRNGKey(4))["attn"]
    rng = np.random.default_rng(5)
    jp = {**jp, "q_norm": jnp.asarray(1 + 0.1 * rng.standard_normal(
        jp["q_norm"].shape), jnp.float32),
        "kv_norm": jnp.asarray(1 + 0.1 * rng.standard_normal(
            jp["kv_norm"].shape), jnp.float32)}
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.fixture(scope="module")
def x():
    d = get_config(ARCH, reduced=True).d_model
    return np.random.default_rng(0).standard_normal(
        (B, S + 1, d)).astype(np.float32)


def test_mla_specs_match_jax():
    spec = SpecTree("float32")
    jax_attention.mla_specs(spec, "attn", jax_config(ARCH))
    want = {k: tuple(v["shape"]) for k, v in spec.tree["attn"].items()}
    got = {k: tuple(v.shape) for k, v in
           attention.mla_specs(get_config(ARCH)).items()}
    assert got == want


@pytest.mark.parametrize("chunk", [1024, 7], ids=["one_chunk", "chunks_of_7"])
def test_mla_train_matches_jax(weights, x, chunk):
    jp, tp = weights
    jcfg, cfg = jax_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jout, (jc, jr) = jax_attention.mla_train(
        jp, jcfg, jnp.asarray(x[:, :S]), jnp.asarray(pos), chunk=chunk)
    out, (c, r) = attention.mla_train(tp, cfg, torch.from_numpy(x[:, :S]),
                                      torch.from_numpy(pos.copy()),
                                      chunk=chunk)
    assert tuple(out.shape) == jout.shape == (B, S, cfg.d_model)
    assert tuple(c.shape) == jc.shape == (B, S, cfg.kv_lora_rank)
    assert tuple(r.shape) == jr.shape == (B, S, cfg.rope_head_dim)
    close(out, jout)
    close(c, jc)
    close(r, jr)


def test_mla_decode_matches_jax(weights, x):
    """One step at position S after a prefill of S, per-row positions
    (row 1 one behind), into caches of S_max = S + 3."""
    jp, tp = weights
    jcfg, cfg = jax_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    _, (jc, jr) = jax_attention.mla_train(jp, jcfg, jnp.asarray(x[:, :S]),
                                          jnp.asarray(pos))
    widths = ((0, 0), (0, 3), (0, 0))
    jcache = (jnp.pad(jc, widths), jnp.pad(jr, widths))
    step = np.array([S, S - 1], np.int32)
    jout, (jc2, jr2) = jax_attention.mla_decode(
        jp, jcfg, jnp.asarray(x[:, S:]), jnp.asarray(step), jcache)
    cache = tuple(torch.from_numpy(np.array(a)) for a in jcache)
    out, (c2, r2) = attention.mla_decode(
        tp, cfg, torch.from_numpy(x[:, S:]),
        torch.from_numpy(step.astype(np.int64)), cache)
    assert c2 is cache[0] and r2 is cache[1]  # written in place
    assert tuple(out.shape) == jout.shape == (B, 1, cfg.d_model)
    close(out, jout)
    close(c2, jc2)
    close(r2, jr2)
