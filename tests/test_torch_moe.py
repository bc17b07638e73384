"""The port's mixture-of-experts layer (``models/moe.py``) against the JAX
package's on the CPU, at the REDUCED dbrx-132b (4 experts top-2, no
shared expert) and deepseek-v3-671b (8 experts top-2, one shared expert)
widths, on the same weights and inputs.

The routed experts of each token (the first top-k) and the tokens each
expert keeps at capacity (the second) must be bitwise equal: both
packages record them at their top-k calls.  The output and the switch aux
loss are held to 1e-4 (rtol and atol; f32 in both, summation order only).
A router of zeros ties every token across every expert, so both choices
are decided by how ties break; there ``torch.topk`` picks other experts
and other tokens than ``jax.lax.top_k``, and the port's ``stable_top_k``
the same ones.

torch runs single-threaded here (see ``tests/test_torch_serve.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as jax_moe
from repro.models.layers import SpecTree, init_params
from repro_torch.configs import get_config
from repro_torch.models import moe

TOL = 1e-4
ARCHS = ("dbrx-132b", "deepseek-v3-671b")
SHAPES = {"4x64": (4, 64), "3x10": (3, 10), "1x7": (1, 7)}  # (B, S)


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


def _weights(arch, seed=1):
    """The JAX package's moe parameters of the REDUCED ``arch`` and the
    same arrays as torch tensors."""
    spec = SpecTree("float32")
    jax_moe.moe_specs(spec, "moe", jax_config(arch, reduced=True))
    jp = init_params(spec, jax.random.PRNGKey(seed))["moe"]
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _recording(fn, calls):
    def wrapped(x, k):
        out = fn(x, k)
        calls.append(np.asarray(out[1]))
        return out
    return wrapped


def run_both(arch, x, *, zero_router=False, port_top_k=None, monkeypatch=None):
    """Both packages' ``moe_apply`` on ``x`` (numpy (B, S, d)): (port out,
    port aux, port top-k indices, JAX out, JAX aux, JAX top-k indices),
    the indices as [routed experts (G, Tg, k), kept tokens (G, E, C)]."""
    jcfg, cfg = jax_config(arch, reduced=True), get_config(arch, reduced=True)
    jp, tp = _weights(arch)
    if zero_router:
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
        tp = {**tp, "router": torch.zeros_like(tp["router"])}
    jcalls, calls = [], []
    monkeypatch.setattr(jax.lax, "top_k",
                        _recording(jax.lax.top_k, jcalls))
    monkeypatch.setattr(moe, "stable_top_k",
                        _recording(port_top_k or moe.stable_top_k, calls))
    jout, jaux = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    out, aux = moe.moe_apply(tp, cfg, torch.from_numpy(x))
    return out, aux, calls, jout, jaux, jcalls


def _x(arch, shape, seed=0):
    d = get_config(arch, reduced=True).d_model
    return np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, shape, monkeypatch):
    out, aux, calls, jout, jaux, jcalls = run_both(
        arch, _x(arch, SHAPES[shape]), monkeypatch=monkeypatch)
    assert len(calls) == len(jcalls) == 2
    for got, want in zip(calls, jcalls):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tuple(out.shape) == jout.shape and out.dtype == torch.float32
    close(out, jout)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    close(aux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_matches_jax(arch, monkeypatch):
    """Zero router weights: every probability is 1/E, so each token routes
    to experts 0..k-1 and each expert keeps its group's first C tokens."""
    out, aux, calls, jout, jaux, jcalls = run_both(
        arch, _x(arch, (4, 64)), zero_router=True, monkeypatch=monkeypatch)
    cfg = get_config(arch, reduced=True)
    np.testing.assert_array_equal(calls[0], jcalls[0])
    np.testing.assert_array_equal(calls[1], jcalls[1])
    assert (calls[0] == np.arange(cfg.top_k)).all()
    C = calls[1].shape[-1]
    assert (calls[1][:, :cfg.top_k] == np.arange(C)).all()
    close(out, jout)
    close(aux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_tells_torch_topk_apart(arch, monkeypatch):
    """The tied router's input discriminates: with ``torch.topk`` in
    place of ``stable_top_k`` the kept tokens, and the output, move away
    from JAX's."""
    def topk(x, k):
        return torch.topk(x, k)

    out, _, calls, jout, _, jcalls = run_both(
        arch, _x(arch, (4, 64)), zero_router=True, port_top_k=topk,
        monkeypatch=monkeypatch)
    assert not all(np.array_equal(a, b) for a, b in zip(calls, jcalls))
    assert np.abs(out.numpy() - np.asarray(jout)).max() > 1e-2


def test_stable_top_k_breaks_ties_as_lax_top_k():
    """A (4, 8, 64) array whose every third entry is 0.5: ``lax.top_k``
    and ``stable_top_k`` take the lowest indices, in order."""
    x = np.zeros((4, 8, 64), np.float32)
    x[..., ::3] = 0.5
    rng = np.random.default_rng(3)
    y = rng.integers(0, 4, (16, 8, 64)).astype(np.float32)  # many ties
    for a, k in ((x, 20), (y, 20), (y, 64), (y, 1)):
        jv, ji = jax.lax.top_k(jnp.asarray(a), k)
        v, i = moe.stable_top_k(torch.from_numpy(a), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert moe.stable_top_k(torch.from_numpy(x), 5)[1][0, 0].tolist() == \
        [0, 3, 6, 9, 12]


def test_n_groups_matches_jax():
    for T in range(1, 301):
        assert moe._n_groups(T) == jax_moe._n_groups(T), T


def _shapes(node, path=""):
    """{path: shape} of a JAX spec tree (``__leaf__`` dicts) or a port
    spec (``Leaf`` tuples)."""
    if isinstance(node, dict) and not node.get("__leaf__", False):
        return {k2: v2 for k, v in node.items()
                for k2, v2 in _shapes(v, f"{path}/{k}").items()}
    return {path: tuple(node["shape"] if isinstance(node, dict)
                        else node.shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_specs_match_jax(arch):
    spec = SpecTree("float32")
    jax_moe.moe_specs(spec, "moe", jax_config(arch))
    assert _shapes(moe.moe_specs(get_config(arch))) == \
        _shapes(spec.tree["moe"])


def test_no_token_dropped_at_capacity_e_over_k():
    """At ``capacity_factor`` = E/k every expert keeps every token it was
    routed, so each token's output is its own top-k mixture."""
    cfg = get_config("dbrx-132b", reduced=True)
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    _, tp = _weights("dbrx-132b")
    x = torch.from_numpy(_x("dbrx-132b", (1, 64)))  # 32 groups of 2
    out, _ = moe.moe_apply(tp, cfg, x)
    one = torch.cat([moe.moe_apply(tp, cfg, x[:, t:t + 1])[0]
                     for t in range(64)], dim=1)
    close(out, one)
