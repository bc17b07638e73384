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

Across ranks (a manager made with ``mesh=``, every rank of the process
group calling every method in the same order): a ``DTensor`` leaf is
saved whole — every rank joins its gather, on the calling thread — and
only the mesh's first rank writes (on the thread under ``async_``);
``wait`` ends with a barrier, so every rank then sees the same newest
checkpoint.  ``restore(like, step, shardings)`` is the elastic path of
the JAX package's ``restore``: the full arrays go onto any mesh — each
leaf of ``like`` keeps its own placements, or takes those ``shardings``
gives it (a tree of ``runtime.sharding.Sharding``s nested as ``like``) —
so a state saved on 2 × 2 ranks restores onto 4 × 1 or onto one process.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..dtensor import is_dtensor
from ..runtime.sharding import (Sharding, full, local_chunk, map_state,
                                shard_tensor, state_leaves)

__all__ = ["CheckpointManager"]


def _host(t: torch.Tensor) -> np.ndarray:
    t = full(t.detach())
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep_n: int = 3, mesh=None):
        self.dir = pathlib.Path(directory)
        self.keep_n = keep_n
        self.mesh = mesh
        # the mesh's first rank writes; without a mesh, this process
        self.writer = True
        if mesh is not None:
            import torch.distributed as dist
            self.writer = dist.get_rank() == int(mesh.mesh.flatten()[0])
        if self.writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------- save ----------------

    def save(self, step: int, state: Any, async_: bool = False):
        """The host snapshot is taken now (correctness; every rank joins
        the gathers); the write and the rename run on a thread when
        ``async_``, on the writing rank only."""
        leaves = list(state_leaves(state))
        flat = {k: _host(t) for k, t in leaves}
        meta = {"step": int(step),
                "manifest": {k: [list(t.shape), str(t.dtype)]
                             for k, t in leaves}}
        if async_:
            self.wait()
        if not self.writer:
            return
        if async_:
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
        """Join an async save in flight; raise what it raised.  With a
        mesh, every rank then waits for every other (a barrier): the
        newest checkpoint is on disk for all."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self.mesh is not None:
            import torch.distributed as dist
            if self.mesh.device_type == "cuda":
                dist.barrier(device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------- restore ----------------

    def all_steps(self) -> list[int]:
        if not self.dir.exists():
            return []
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self, like: Any, step: Optional[int] = None, shardings: Any = None
    ) -> tuple[Any, int]:
        """Load checkpoint ``step`` (the latest when None) into ``like``;
        returns (the state, step).  Each tensor of ``like`` is written in
        place, on its device in its dtype — a ``DTensor`` its own shard —
        unless ``shardings`` (nested as ``like``) gives its leaf another
        mesh or placements: that leaf is then replaced by the full array
        placed there (the elastic path).  Raises ``FileNotFoundError``
        when there is no checkpoint, ``ValueError`` on a key or shape
        ``like`` lacks."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        table = {} if shardings is None else dict(
            state_leaves(shardings, leaf_type=Sharding))
        with np.load(path / "arrays.npz") as data:
            def load(key, t):
                if key not in data.files:
                    raise ValueError(f"checkpoint {step} has no {key}")
                arr = torch.from_numpy(data[key])
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"{key}: checkpoint shape "
                                     f"{tuple(arr.shape)}, state "
                                     f"{tuple(t.shape)}")
                sh = table.get(key)
                if sh is not None and sh.mesh is not None and not (
                        is_dtensor(t) and t.device_mesh == sh.mesh
                        and tuple(t.placements) == tuple(sh.placements)):
                    return shard_tensor(arr, sh.mesh, sh.placements, t.dtype)
                with torch.no_grad():
                    if is_dtensor(t):
                        t.to_local().copy_(local_chunk(
                            arr, t.device_mesh, t.placements))
                    else:
                        t.copy_(arr.to(t.device, t.dtype))
                return t
            state = map_state(like, load)
        return state, step
