"""The port's training loss of the ssm family (mamba2-2.7b) against
``jax.value_and_grad`` of the JAX loss on the CPU, at the tolerances of
``tests/test_torch_loss_dense.py``: 40 positions over the reduced SSD
chunk of 32, so the last chunk is ragged (S % Q ≠ 0) and its pad steps
are no-ops in the backward too.
"""
import pytest

from test_torch_loss_dense import check_parity, loss_parity, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def mamba():
    return loss_parity("mamba2-2.7b", 40)


def test_loss_and_every_gradient_leaf_match_jax(mamba):
    want, got, _ = mamba
    check_parity(want, got)


def test_every_mixer_leaf_gets_gradient(mamba):
    mixer = mamba[1][2]["blocks"]["mixer"]
    for name in ("wz", "wxbc", "wdt", "dt_bias", "A_log", "D", "conv_w",
                 "conv_b", "gate_norm", "wo"):
        assert abs(mixer[name]).max() > 0, name
