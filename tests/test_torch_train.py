"""The port's training substrate around the step, on the CPU: the data
pipeline (``data.SyntheticLM``, bit for bit the JAX package's tokens), the
checkpoint manager over the port's train state (a round trip, async
saves, retention, ``latest_step``), and ``launch/train.main`` at REDUCED
with a scheduled failure and a restart from a checkpoint, whose summary
counts what the JAX package's driver counts for the same flags.
"""
import json

import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JaxSyntheticLM
from repro.data import make_batch_iterator as jax_batches
from repro.launch import train as jax_train
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime import init_train_state, make_train_step


@pytest.mark.parametrize("vocab,seq_len,batch,seed", [
    (512, 64, 4, 0), (152064, 2048, 2, 3), (97, 17, 3, 11)])
def test_synthetic_tokens_are_the_jax_packages_bit_for_bit(vocab, seq_len, batch, seed):
    ours = SyntheticLM(vocab=vocab, seq_len=seq_len, global_batch=batch,
                       seed=seed)
    theirs = JaxSyntheticLM(vocab=vocab, seq_len=seq_len, global_batch=batch,
                            seed=seed)
    for step in (0, 1, 57):
        a, b = ours.batch(step), theirs.batch(step)
        assert a["tokens"].dtype == b["tokens"].dtype
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(ours.batch(5, slice(1, 3))["tokens"],
                                  theirs.batch(5, slice(1, 3))["tokens"])
    it, jit = make_batch_iterator(ours, 4), jax_batches(theirs, 4)
    for _ in range(3):
        (s1, b1), (s2, b2) = next(it), next(jit)
        assert s1 == s2
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


def _state(seed=0, compress=True):
    cfg = get_config("mamba2-2.7b", reduced=True)
    model = build_model(cfg)
    opt = AdamW(lr=1e-3)
    return model, opt, init_train_state(
        model, torch.Generator().manual_seed(seed), opt, compress=compress)


def _flat(state):
    out = {f"p/{n}": p.detach().clone()
           for n, p in state.params.named_parameters()}
    out["step"] = state.opt.step.clone()
    for part in ("m", "v"):
        out.update({f"{part}/{n}": t.clone() for n, t in
                    getattr(state.opt, part).items()})
    out.update({f"err/{n}": t.clone() for n, t in state.err.items()})
    return out


@pytest.mark.parametrize("async_", [False, True])
def test_checkpoint_round_trip_restores_the_train_state(tmp_path, async_):
    model, opt, state = _state()
    step = make_train_step(model, opt, compress_ratio=0.1)
    batch = {"tokens": torch.as_tensor(SyntheticLM(
        vocab=model.config.vocab, seq_len=16, global_batch=2).batch(0)[
            "tokens"])}
    state, _ = step(state, batch)
    saved = _flat(state)
    ckpt = CheckpointManager(tmp_path / "ck")
    ckpt.save(1, state, async_=async_)
    state, _ = step(state, batch)  # moves every leaf on
    assert not torch.equal(_flat(state)["step"], saved["step"])
    restored, at = ckpt.restore(like=state)
    assert at == 1 and restored is state
    for k, v in _flat(restored).items():
        assert torch.equal(v, saved[k]), k
    meta = json.loads((tmp_path / "ck" / "step_00000001" /
                       "metadata.json").read_text())
    assert meta["step"] == 1
    assert meta["manifest"]["opt/step"][1] == "torch.int32"


def test_checkpoint_keeps_the_newest_n_and_never_a_partial_one(tmp_path):
    _, _, state = _state(compress=False)
    ckpt = CheckpointManager(tmp_path, keep_n=2)
    for s in (5, 10, 15):
        ckpt.save(s, state, async_=True)
    ckpt.wait()
    assert ckpt.all_steps() == [10, 15] and ckpt.latest_step() == 15
    (tmp_path / "step_00000020.tmp").mkdir()  # a save cut short
    assert ckpt.latest_step() == 15


def test_restore_without_a_checkpoint_raises(tmp_path):
    _, _, state = _state(compress=False)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(like=state)


ARGS = ["--arch", "qwen2.5-32b", "--reduced", "--steps", "30", "--batch",
        "2", "--seq", "32", "--fail-at", "12", "--save-every", "5"]


def test_launch_train_restarts_once_as_the_jax_driver_does(tmp_path, capsys):
    ours = train.main(ARGS + ["--device", "cpu", "--ckpt-dir",
                              str(tmp_path / "ours")])
    theirs = jax_train.main(ARGS + ["--ckpt-dir", str(tmp_path / "jax")])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == theirs
    for key in ("steps", "restarts", "lost_steps"):
        assert ours[key] == theirs[key], key
    assert ours["restarts"] == 1 and ours["lost_steps"] == 2
    assert np.isfinite(ours["first_loss"]) and np.isfinite(ours["last_loss"])
    assert ours["last_loss"] < ours["first_loss"]

