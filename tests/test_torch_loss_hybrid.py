"""The port's training loss of the hybrid family (zamba2-7b) against
``jax.value_and_grad`` of the JAX loss on the CPU, at the tolerances of
``tests/test_torch_loss_dense.py``.  zamba2's one shared attention block
is applied once a group and gathers its gradient from every group; the
SSD chunk of 32 over 40 positions leaves a ragged last chunk.
"""
import pytest

from test_torch_loss_dense import check_parity, loss_parity, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def zamba():
    return loss_parity("zamba2-7b", 40)


def test_loss_and_every_gradient_leaf_match_jax(zamba):
    want, got, _ = zamba
    check_parity(want, got)


def test_shared_block_is_applied_in_several_groups_and_gets_gradient(zamba):
    """The reduced config applies the one shared block in more than one
    group, so the parity above holds its gradient summed over them."""
    cfg = zamba[2][0]
    assert cfg.n_layers // cfg.hybrid_every > 1
    assert abs(zamba[1][2]["shared_attn"]["attn"]["wq"]).max() > 0
