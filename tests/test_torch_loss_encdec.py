"""The port's training loss of the encdec family (whisper-medium) against
``jax.value_and_grad`` of the JAX loss on the CPU, at the tolerances of
``tests/test_torch_loss_dense.py``: the encoder (bidirectional attention
over the frame embeddings) runs inside the loss, so its leaves get
gradient through the decoder's cross-attention.
"""
import pytest

from test_torch_loss_dense import check_parity, loss_parity, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def whisper():
    return loss_parity("whisper-medium", 40)


def test_loss_and_every_gradient_leaf_match_jax(whisper):
    want, got, _ = whisper
    check_parity(want, got)


def test_encoder_leaves_get_gradient(whisper):
    grads = whisper[1][2]
    assert abs(grads["enc"]["attn"]["wq"]).max() > 0
    assert abs(grads["enc_final_ln"]["w"]).max() > 0
