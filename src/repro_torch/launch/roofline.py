"""Roofline terms of a dry-run record: the port of the JAX package's
``launch/roofline.py``, on the figures of one NVIDIA H100.

Three terms (seconds, per device; the dry run divides global counts by
the device count, an even split):
    compute    = FLOPs / peak_FLOPs            (989 TFLOP/s dense bf16)
    memory     = bytes / HBM_bw                (3.35 TB/s)
    collective = wire_bytes / link_bw          (50 GB/s)

``HW`` holds the NVIDIA H100 SXM5 80 GB data sheet's figures (700 W
part), not measurements.  The link rate is one 400 Gb/s NDR InfiniBand
port per GPU: a node holds 8 H100s, so a ring over any 16-wide axis of
the production meshes crosses nodes.  A ring inside one node would see
NVLink's 450 GB/s per direction; no production-mesh axis is such a ring.

Collective wire bytes come from records of (kind, per-device result
bytes, group size), converted to ring-algorithm wire traffic:
    all-gather        : out_bytes · (N-1)/N        (receives all other shards)
    reduce-scatter    : out_bytes · (N-1)          (N-1 chunk passes)
    all-reduce        : out_bytes · 2(N-1)/N       (RS + AG at full size)
    all-to-all        : out_bytes · (N-1)/N
    collective-permute: out_bytes
The JAX package parses them from XLA's compiled HLO; the port has no HLO,
and the dry run derives the records from the sharding rules' placements
(``dryrun.collective_records``).

MODEL_FLOPS uses the 6·N_active·D (train) / 2·N_active·D (inference)
convention with N_active counted from the spec tree (routed expert tensors
scaled by top_k/E; embedding gather excluded, tied head counted once).
"""
from __future__ import annotations

import math

from ..models.layers import spec_leaves

__all__ = ["HW", "collective_bytes", "active_param_count", "roofline_terms",
           "model_flops"]

HW = {
    "peak_flops": 989e12,  # dense bf16 / device (H100 SXM5 data sheet)
    "hbm_bw": 3.35e12,  # B/s (data sheet)
    "link_bw": 50e9,  # B/s: one 400 Gb/s NDR InfiniBand port per GPU
}

_WIRE_FACTOR = {
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: float(n - 1),
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def collective_bytes(records, total_devices: int) -> dict:
    """Per-device wire bytes by collective kind and op counts, from
    (kind, out_bytes, group_size) records; a group size of None spans
    all ``total_devices``."""
    out_bytes = {k: 0.0 for k in _WIRE_FACTOR}
    counts = {k: 0 for k in _WIRE_FACTOR}
    for kind, nbytes, group in records:
        if nbytes == 0:
            continue
        n = total_devices if group is None else max(int(group), 1)
        out_bytes[kind] += nbytes * _WIRE_FACTOR[kind](n)
        counts[kind] += 1
    total = sum(out_bytes.values())
    return {"by_kind": out_bytes, "counts": counts, "total_wire_bytes": total}


# ---------------------------------------------------------------------------
# MODEL_FLOPS
# ---------------------------------------------------------------------------

def active_param_count(model) -> tuple[int, int]:
    """(total_params, active_params): routed experts scaled by top_k/E,
    embedding gather excluded (tied head counted once as the head matmul)."""
    cfg = model.config
    total = 0
    active = 0
    for name, leaf in spec_leaves(model.spec):
        n = math.prod(leaf.shape)
        total += n
        if name == "embed":
            if cfg.tie_embeddings:
                active += n  # used as the output head matmul
            continue
        if name == "pos_embed":
            continue
        if "expert" in leaf.axes:  # routed expert tensor (E, d, f)
            active += int(n * cfg.top_k / cfg.n_experts)
            continue
        active += n
    return total, active


def model_flops(model, shape) -> float:
    """6·N_active·D for train, 2·N_active·D for inference shapes (global)."""
    _, active = active_param_count(model)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch * 1  # decode: one token per row
    return 2.0 * active * tokens


def roofline_terms(
    cost: dict, coll: dict, n_devices: int, model=None, shape=None
) -> dict:
    """``cost`` holds per-device "flops" and "bytes accessed"; ``coll`` a
    :func:`collective_bytes` record."""
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    wire = float(coll["total_wire_bytes"])
    terms = {
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "wire_bytes_per_device": wire,
        "compute_s": flops / HW["peak_flops"],
        "memory_s": bytes_ / HW["hbm_bw"],
        "collective_s": wire / HW["link_bw"],
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    if model is not None and shape is not None:
        mf = model_flops(model, shape)
        terms["model_flops_global"] = mf
        terms["model_flops_per_device"] = mf / n_devices
        terms["useful_flops_ratio"] = (
            mf / n_devices / flops if flops > 0 else 0.0)
        step_s = max(terms["compute_s"], terms["memory_s"],
                     terms["collective_s"])
        terms["roofline_fraction"] = (
            (mf / n_devices / HW["peak_flops"]) / step_s if step_s > 0 else 0.0)
    return terms
