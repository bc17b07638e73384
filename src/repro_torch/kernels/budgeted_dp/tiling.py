"""Which forward pipeline runs a plane, and on which tiles.

Counterpart of the JAX package's sizing layer (``packed_words``, the
``*_vmem_bytes`` models, ``_tile_candidates`` and ``choose_tiling`` in
``kernels/budgeted_dp/kernel.py``), rederived for one H100 block's shared
memory (232,448 bytes) instead of the TPU's 12 MB VMEM budget.

Three forward pipelines, preferred in this order:

- **whole plane** (``kernel.dp_forward_batched``): one block per instance
  holds the (S, C) int32 plane in shared memory for all E edges;
- **edge-fused** (``kernel.dp_forward_fused``): one cooperative launch
  per chunk of ``block_e`` edges over the whole card, the planes in
  device memory and a grid barrier between edges.  Its grid does not
  follow the tiles; the JAX package's tile model (a (block_s, block_c)
  tile with an up halo of u_max rows when the plane has several S-tiles
  and a left halo of off_max columns when it has several C-tiles) is
  still sized against one block's shared memory, so that a plane takes
  the pipeline the earlier tile-walking kernel took;
- **per-edge** (``kernel.dp_forward_blocked``): one launch per edge, four
  cells a thread, that reads and writes the plane in device memory; auto
  picks it only when no fused tile fits.

No grid of the tiled pipelines follows the tiles, so the tiles are only
checked for legality (and, on the fused pipeline, against the model).

The halo floors are the JAX package's legality rules: ``block_c ≥
off_max`` and ``block_s ≥ u_max``, so a halo reaches into one neighbour
tile only.  Tiling never changes a result.
"""
from __future__ import annotations

import functools

from ..nvcc import SMEM_LIMIT_BYTES

__all__ = ["SMEM_LIMIT_BYTES", "MAX_BLOCK_E", "whole_plane_smem_bytes",
           "fused_smem_bytes", "choose_tiling", "check_tiling"]

# the JAX package's chunk cap (there: one int32 bit plane per chunk); kept
# so that a tiling legal in one package is legal in the other
MAX_BLOCK_E = 32

# auto tile units: whole rows of 8 budgets, and 32 capacity states so a
# warp reads one row segment of consecutive cells
S_UNIT = 8
C_UNIT = 32


def whole_plane_smem_bytes(S: int, C: int) -> int:
    """Shared memory of the whole-plane forward: the (S, C) int32 plane."""
    return 4 * S * C


def fused_smem_bytes(
    S: int, C: int, u_max: int, off_max: int, block_s, block_c: int
) -> int:
    """Shared memory of one fused-forward block: the (block_s, block_c)
    int32 tile, plus u_max halo rows when the plane has several S-tiles
    and off_max halo columns when it has several C-tiles.  ``block_s=None``
    is a full-height tile; tiles larger than the plane are cut to it."""
    bs = S if block_s is None else min(block_s, S)
    bc = min(block_c, C)
    rows = bs + (u_max if bs < S else 0)
    cols = bc + (off_max if bc < C else 0)
    return 4 * rows * cols


def _tile_candidates(extent: int, unit: int, floor: int) -> list:
    """Descending tile extents along one axis: the full extent, then every
    multiple of ``unit`` below it that is at least ``floor``."""
    first = max(-(-floor // unit), 1) * unit
    return [extent] + list(range(first, extent, unit))[::-1]


@functools.lru_cache(maxsize=256)
def choose_tiling(S: int, C: int, n_edges: int, u_max: int, off_max: int):
    """Pick ``(block_e, block_s, block_c)`` as the JAX package's
    ``choose_tiling`` shapes it.

    - The whole plane when it fits one block: ``(None, None, None)``.
    - Else the fused pipeline on the legal tile of largest area that fits
      (ties to the wider ``block_c``), with ``block_e = min(32, E)``: the
      whole solve is one launch per 32 edges.  ``block_s`` is ``None`` for
      a full-height tile.
    - Else the per-edge pipeline on one full-plane tile, ``(None, None,
      C)``: its grid does not depend on the tile, so any legal one will do.
    """
    if whole_plane_smem_bytes(S, C) <= SMEM_LIMIT_BYTES:
        return None, None, None
    s_cands = _tile_candidates(S, S_UNIT, max(u_max, 1))
    c_cands = _tile_candidates(C, C_UNIT, max(off_max, 1))
    best = None
    for bc in c_cands:
        for bs in s_cands:  # tallest first
            if (bs < S or bc < C) and fused_smem_bytes(
                    S, C, u_max, off_max, bs, bc) <= SMEM_LIMIT_BYTES:
                if best is None or bs * bc > best[0] * best[1]:
                    best = (bs, bc)
                break
    if best is None:
        return None, None, C
    bs, bc = best
    return min(MAX_BLOCK_E, max(n_edges, 1)), None if bs >= S else bs, bc


def check_tiling(
    S: int, C: int, u_max: int, off_max: int, block_e, block_s, block_c
) -> None:
    """Raise ``ValueError`` on a tiling no pipeline can run: the JAX
    package's checks (with its messages), and a whole plane or a fused
    tile that needs more shared memory than one block has."""
    if block_s is not None and block_c is None:
        raise ValueError(
            "block_s tiles the budget axis of the blocked pipeline and "
            "needs block_c (pass block_c=C for a single full-width tile)")
    if block_e is not None and block_c is None:
        raise ValueError(
            "block_e fuses edges into the blocked pipeline's grid and "
            "needs block_c (pass block_c=C for a single full-width tile)")
    if block_c is None:
        need = whole_plane_smem_bytes(S, C)
        if need > SMEM_LIMIT_BYTES:
            raise ValueError(
                f"the ({S}, {C}) value plane needs {need} bytes of shared "
                f"memory, over the {SMEM_LIMIT_BYTES}-byte limit of one "
                "block: leave block_c='auto' or pass a tiling, so that the "
                "tiled pipelines run it")
        return
    if block_c < 1 or (block_s is not None and block_s < 1):
        raise ValueError(
            f"block_c={block_c} and block_s={block_s} must be positive")
    if block_c < off_max:
        raise ValueError(
            f"block_c={block_c} < off_max={off_max}: the offset shift "
            "would reach past the left-neighbor halo")
    if block_s is not None and block_s < u_max:
        raise ValueError(
            f"block_s={block_s} < u_max={u_max}: the budget shift "
            "would reach past the up-neighbor halo")
    if block_e is None:
        return
    if not 1 <= block_e <= MAX_BLOCK_E:
        raise ValueError(
            f"block_e={block_e} outside [1, {MAX_BLOCK_E}]: a fused chunk "
            f"holds at most {MAX_BLOCK_E} edges, as in the JAX package")
    need = fused_smem_bytes(S, C, u_max, off_max, block_s, block_c)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"the fused tile (block_s={block_s}, block_c={block_c}) with "
            f"its halos needs {need} bytes of shared memory, over the "
            f"{SMEM_LIMIT_BYTES}-byte limit of one block: pass a smaller "
            "tile, or block_e=None for the per-edge pipeline")
