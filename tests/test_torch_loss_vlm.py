"""The port's training loss of the vlm family (qwen2-vl-72b) against
``jax.value_and_grad`` of the JAX loss on the CPU, at the tolerances of
``tests/test_torch_loss_dense.py``: patch embeddings before the text,
M-RoPE over three distinct position streams (a grid for the patches),
the cross-entropy over the text positions only (``h[:, n_vis:]``).
"""
import pytest

from test_torch_loss_dense import check_parity, loss_parity, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def qwen2_vl():
    return loss_parity("qwen2-vl-72b", 40)


def test_loss_and_every_gradient_leaf_match_jax(qwen2_vl):
    want, got, _ = qwen2_vl
    check_parity(want, got)


def test_the_cross_entropy_counts_text_positions_only(qwen2_vl):
    (_, jm, _), (_, metrics, _), (cfg, _, batch) = qwen2_vl
    B, S1 = batch["tokens"].shape
    assert metrics["ntok"] == B * (S1 - 1) == float(jm["ntok"])
