"""The port's training loss of the moe family (dbrx-132b) and of MLA with
the multi-token-prediction head (deepseek-v3-671b) against
``jax.value_and_grad`` of the JAX loss on the CPU, at the tolerances of
``tests/test_torch_loss_dense.py``: the total (ce + 0.01 aux, + 0.3 mtp),
each metric, and every gradient leaf — the router, whose softmax, gate
weights and aux term carry gradient as JAX's do (the top-k indices carry
none), the experts, and the mtp block.  One JAX ``value_and_grad`` per
arch, compiled once per module fixture.
"""
import pytest

from test_torch_loss_dense import check_parity, loss_parity, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def dbrx():
    return loss_parity("dbrx-132b", 40)


@pytest.fixture(scope="module")
def deepseek():
    return loss_parity("deepseek-v3-671b", 40)


@pytest.mark.parametrize("case", ["dbrx", "deepseek"])
def test_loss_and_every_gradient_leaf_match_jax(case, request):
    want, got, _ = request.getfixturevalue(case)
    check_parity(want, got)


@pytest.mark.parametrize("case,keys", [
    ("dbrx", ("ce", "aux")), ("deepseek", ("ce", "aux", "mtp"))])
def test_the_loss_is_ce_plus_its_weighted_terms(case, keys, request):
    """total = ce + 0.01 aux (+ 0.3 mtp), the aux term positive: the moe
    layers' router statistics reach the loss."""
    (_, _, _), (loss, metrics, _), _ = request.getfixturevalue(case)
    assert set(keys) <= set(metrics)
    assert metrics["aux"] > 0
    total = metrics["ce"] + 0.01 * metrics["aux"] + 0.3 * metrics.get("mtp", 0)
    assert abs(loss - total) <= 1e-6 * abs(loss)


def test_router_and_mtp_leaves_get_gradient(deepseek):
    grads = deepseek[1][2]
    assert abs(grads["moe_blocks"]["moe"]["router"]).max() > 0
    assert abs(grads["mtp"]["proj"]).max() > 0
    assert abs(grads["mtp"]["block"]["attn"]["wq_a"]).max() > 0
