"""Deterministic, shardable synthetic data pipeline: the port's own copy
of ``repro/data/pipeline.py`` (pure numpy; the port imports nothing of the
JAX package), which gives the same tokens bit for bit.  The training
driver moves each batch to the device itself.

Design: the stream is a pure function of (seed, step, batch-row index) —
no state on any host. That gives the three properties a 1000-node pipeline
needs for free:
  * restart-exactness : resuming at step k reproduces the same batches, so
    checkpoint/restart does not perturb training;
  * host sharding     : each host materializes only its batch rows
    (``host_slice``) — no cross-host data traffic;
  * elasticity        : re-sharding after a topology change is just a new
    host_slice of the same pure function.

The generator is a Markov-ish token process (mixture of n-gram-style
structure + noise) so tiny-model training has learnable signal — examples
train ~100M models on it and the loss visibly drops.

For the VLM/audio stubs the same stream yields deterministic pseudo
patch/frame embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "make_batch_iterator"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int  # tokens per example INCLUDING the label shift
    global_batch: int
    seed: int = 0
    structure: int = 97  # period of the learnable component

    def _tokens(self, step: int, rows: np.ndarray) -> np.ndarray:
        """(len(rows), seq_len+1) int32, pure function of (seed, step, row)."""
        rng_keys = (self.seed * 1_000_003 + step) * 131 + rows[:, None]
        t = np.arange(self.seq_len + 1)[None, :]
        # learnable structure: position-dependent affine walk mod vocab
        base = (rng_keys % self.structure + 1)
        walk = (base * t + (rng_keys // 7) % 13) % max(self.vocab - 3, 1)
        # deterministic "noise": xor-shift hash, 20% of positions
        h = (rng_keys * 2654435761 + t * 40503) & 0xFFFFFFFF
        h = (h ^ (h >> 13)) & 0xFFFFFFFF
        noisy = (h % 5) == 0
        noise_tok = h % max(self.vocab - 3, 1)
        out = np.where(noisy, noise_tok, walk) + 2  # reserve 0/1
        return out.astype(np.int32)

    def batch(self, step: int, host_slice: Optional[slice] = None) -> dict:
        rows = np.arange(self.global_batch)
        if host_slice is not None:
            rows = rows[host_slice]
        return {"tokens": self._tokens(step, rows)}


def make_batch_iterator(
    ds: SyntheticLM,
    start_step: int = 0,
    host_slice: Optional[slice] = None,
    extras=None,
) -> Iterator[dict]:
    """extras(step, batch) may attach modality stubs (patch/frame embeds)."""
    step = start_step
    while True:
        b = ds.batch(step, host_slice)
        if extras is not None:
            b = extras(step, b)
        yield step, b
        step += 1
