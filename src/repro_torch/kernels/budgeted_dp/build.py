"""The budgeted-DP CUDA library: ``csrc/budgeted_dp.cu`` built by the
port's one build path (``kernels/nvcc.py``) and its C signatures."""
from __future__ import annotations

import ctypes
import pathlib

from ..nvcc import CudaLibrary

__all__ = ["SOURCE", "LIBRARY", "library_path", "build", "load"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "budgeted_dp.cu"


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dp_forward_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.dp_forward_launch.restype = i
    lib.dp_forward_sweep_launch.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.dp_forward_sweep_launch.restype = i
    for name in ("dp_edge_launch", "dp_edge_chain_launch"):
        getattr(lib, name).argtypes = [p] * 6 + [i, p, p] + [i] * 5 + [p]
        getattr(lib, name).restype = i
    lib.dp_chunk_launch.argtypes = [p] * 6 + [i] + [p] * 3 + [i] * 6 + [p]
    lib.dp_chunk_launch.restype = i
    lib.dp_epilogue_launch.argtypes = [p] * 7 + [i] * 6 + [p] * 4
    lib.dp_epilogue_launch.restype = i
    lib.dp_empty_launch.argtypes = [i, i, i, p]
    lib.dp_empty_launch.restype = i


LIBRARY = CudaLibrary(SOURCE, _declare, "dp_error_string")
library_path = LIBRARY.path
build = LIBRARY.build
load = LIBRARY.load
