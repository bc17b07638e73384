"""Wrappers of the budgeted-DP CUDA kernels (``csrc/budgeted_dp.cu``).

``dp_forward`` is the counterpart of the JAX package's
``dp_forward_pallas`` (Pallas kernel ``_dp_kernel``, K1): one instance,
``allowed`` already folded into the feasibility plane.
``dp_forward_batched`` is the counterpart of ``dp_forward_pallas_batched``
(``_dp_kernel_batched``, K2): B instances in ONE launch with shared
feasibility/offsets/v0 and per-instance ``allowed`` masked in the kernel.
``dp_epilogue`` runs the eq.-17 s* rule and the backtrack on the card.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
CUDA tensor launches the kernel or raises — there is no fallback.  Each
wrapper counts its launches in ``LAUNCHES``.

The whole plane must fit one block's shared memory (``smem_bytes``);
larger planes need the blocked and edge-fused pipelines (the JAX
package's K3–K5), which are not ported yet, and raise ``ValueError``.
"""
from __future__ import annotations

import torch

from . import build, ref
from .ref import packed_words

__all__ = ["SMEM_LIMIT_BYTES", "LAUNCHES", "smem_bytes", "dp_forward",
           "dp_forward_batched", "dp_epilogue", "packed_words"]

# dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT_BYTES = 232448

# launches of each CUDA kernel wrapper (plain-version calls are not counted)
LAUNCHES = {"dp_forward": 0, "dp_forward_batched": 0, "dp_epilogue": 0}


def smem_bytes(S: int, C: int) -> int:
    """Shared memory of the forward kernel: the (S, C) int32 plane."""
    return 4 * S * C


def _gate(S: int, C: int) -> None:
    need = smem_bytes(S, C)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"the ({S}, {C}) value plane needs {need} bytes of shared memory, "
            f"over the {SMEM_LIMIT_BYTES}-byte limit of one block; planes "
            "this large need the blocked and edge-fused pipelines (the JAX "
            "package's _edge_tile_kernel/_fused_chunk_kernel/"
            "_batched_fused_kernel), which are not ported yet")


def _check(name, t, shape, device):
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = build.load().dp_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _forward(upsilon, sigma2, allowed, feasible, offsets, v0, counter):
    B, E = upsilon.shape
    S, C = v0.shape
    dev = v0.device
    _check("upsilon", upsilon, (B, E), dev)
    _check("sigma2", sigma2, (B, E), dev)
    if allowed is not None:
        _check("allowed", allowed, (B, E), dev)
    _check("feasible", feasible, (E, C), dev)
    _check("offsets", offsets, (E,), dev)
    _check("v0", v0, (S, C), dev)
    _gate(S, C)
    if dev.type == "cpu":
        return ref.dp_forward_ref(upsilon, sigma2, allowed, feasible,
                                  offsets, v0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    V = torch.empty((B, S, C), dtype=torch.int32, device=dev)
    words = torch.empty((B, packed_words(E), S, C), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):  # the library launches on the current one
        err = build.load().dp_forward_launch(
            upsilon.data_ptr(), sigma2.data_ptr(),
            None if allowed is None else allowed.data_ptr(),
            feasible.data_ptr(), offsets.data_ptr(), v0.data_ptr(),
            V.data_ptr(), words.data_ptr(), B, E, S, C,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "dp_forward")
    LAUNCHES[counter] += 1
    return V, words


def dp_forward(upsilon, sigma2, feasible, offsets, v0):
    """One DP forward (K1's counterpart).

    ``upsilon``/``sigma2``/``offsets`` (E,) int32, ``feasible`` (E, C)
    int32 0/1 with the slot's eligibility already folded in, ``v0``
    (S, C) int32.  Returns ``V`` (S, C) int32 and the packed decision
    words (⌈E/32⌉, S, C) int32 — bit e % 32 of word e // 32 is edge e.
    """
    V, words = _forward(upsilon[None], sigma2[None], None, feasible, offsets,
                        v0, "dp_forward")
    return V[0], words[0]


def dp_forward_batched(upsilon, sigma2, allowed, feasible, offsets, v0):
    """B DP forwards in one launch (K2's counterpart).

    ``upsilon``/``sigma2``/``allowed`` (B, E) int32 per instance;
    ``feasible`` (E, C), ``offsets`` (E,) and ``v0`` (S, C) int32 shared.
    Returns ``V`` (B, S, C) and the words (B, ⌈E/32⌉, S, C), int32.
    """
    return _forward(upsilon, sigma2, allowed, feasible, offsets, v0,
                    "dp_forward_batched")


def dp_epilogue(V, words, upsilon, offsets, s_limit, full_state: int):
    """s* (eq. 17), the backtrack and the value row for B instances.

    ``V`` (B, S, C), ``words`` (B, ⌈E/32⌉, S, C), ``upsilon`` (B, E),
    ``offsets`` (E,), ``s_limit`` (B,), all int32 on one device.  Returns
    ``x`` (B, E), ``s_star`` (B,) and ``value_row`` (B, S) int32, the
    value row NEG at budget-infeasible entries.
    """
    B, S, C = V.shape
    E = upsilon.shape[1]
    dev = V.device
    _check("V", V, (B, S, C), dev)
    _check("words", words, (B, packed_words(E), S, C), dev)
    _check("upsilon", upsilon, (B, E), dev)
    _check("offsets", offsets, (E,), dev)
    _check("s_limit", s_limit, (B,), dev)
    if not 0 <= full_state < C:
        raise ValueError(f"full_state={full_state} outside [0, {C})")
    if dev.type == "cpu":
        return ref.dp_epilogue_ref(V, words, upsilon, offsets, s_limit,
                                   full_state)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    x = torch.empty((B, E), dtype=torch.int32, device=dev)
    s_star = torch.empty((B,), dtype=torch.int32, device=dev)
    value_row = torch.empty((B, S), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = build.load().dp_epilogue_launch(
            V.data_ptr(), words.data_ptr(), upsilon.data_ptr(),
            offsets.data_ptr(), s_limit.data_ptr(), full_state, B, E, S, C,
            x.data_ptr(), s_star.data_ptr(), value_row.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "dp_epilogue")
    LAUNCHES["dp_epilogue"] += 1
    return x, s_star, value_row
