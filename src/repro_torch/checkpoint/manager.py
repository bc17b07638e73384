"""Atomic, async-capable checkpoint manager over the port's train state
(``repro/checkpoint/manager.py``).

  * atomicity   — written to step_XXXXXXXX.tmp/, then renamed; a crash
                  mid-save never corrupts the latest checkpoint;
  * async saves — the host snapshot is taken synchronously, and a thread
                  writes it while training goes on;
  * retention   — the keep_n newest checkpoints are kept;
  * self-describing — metadata.json carries the step and each array's
                  shape and torch dtype.

A state is any nesting of dataclasses (``TrainState``, ``OptState``),
``nn.Module`` parameter trees, dicts, lists and tensors; it is flattened
to "/"-joined keys ("params/blocks.0.attn.wq", "opt/m/embed", "opt/step").
Arrays are stored as numpy (bf16 through f32, exact) in one npz a
checkpoint, uncompressed: the JAX package compresses (``savez_compressed``),
which on the card's host took ~20 s a save of the tiny-100m milestone's
0.48 GB state, longer than the 50 steps between saves, so the loop waited
on it (520.6 ms a step against ~80 for the step itself, ``chip_smoke.py``);
``np.load`` reads either.  ``restore`` writes into the tensors of ``like`` in place, on
their devices and in their dtypes, so a restart holds one copy of the
state on the card.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _leaves(state, prefix=""):
    """(key, tensor) pairs of a state, in a fixed order."""
    if isinstance(state, torch.Tensor):
        yield prefix, state
    elif isinstance(state, torch.nn.Module):
        for name, p in state.named_parameters():
            yield f"{prefix}/{name}" if prefix else name, p
    elif dataclasses.is_dataclass(state):
        for f in dataclasses.fields(state):
            yield from _leaves(getattr(state, f.name),
                               f"{prefix}/{f.name}" if prefix else f.name)
    elif isinstance(state, dict):
        for k, v in state.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif state is not None:
        raise TypeError(f"{prefix}: cannot checkpoint a {type(state)}")


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep_n: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------- save ----------------

    def save(self, step: int, state: Any, async_: bool = False):
        """The host snapshot is taken now (correctness); the write and
        the rename run on a thread when ``async_``."""
        leaves = list(_leaves(state))
        flat = {k: _host(t) for k, t in leaves}
        meta = {"step": int(step),
                "manifest": {k: [list(t.shape), str(t.dtype)]
                             for k, t in leaves}}
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_logged, args=(step, flat, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta)

    def _write_logged(self, step: int, flat: dict, meta: dict):
        try:
            self._write(step, flat, meta)
        except BaseException as err:  # re-raised by wait()
            self._error = err

    def _write(self, step: int, flat: dict, meta: dict):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "metadata.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()

    def wait(self):
        """Join an async save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------- restore ----------------

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> tuple[Any, int]:
        """Load checkpoint ``step`` (the latest when None) into the
        tensors of ``like`` in place, each on its device in its dtype;
        returns (like, step).  Raises ``FileNotFoundError`` when there is
        no checkpoint, ``ValueError`` on a key or shape ``like`` lacks."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        with np.load(path / "arrays.npz") as data:
            with torch.no_grad():
                for key, t in _leaves(like):
                    if key not in data.files:
                        raise ValueError(f"checkpoint {step} has no {key}")
                    arr = data[key]
                    if tuple(arr.shape) != tuple(t.shape):
                        raise ValueError(f"{key}: checkpoint shape "
                                         f"{arr.shape}, state {tuple(t.shape)}")
                    t.copy_(torch.from_numpy(arr).to(t.device, t.dtype))
        return like, step
