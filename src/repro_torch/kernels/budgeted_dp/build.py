"""Build ``csrc/budgeted_dp.cu`` with ``nvcc`` at first use, load it with
``ctypes``.

The shared library has a plain C interface (no PyTorch headers), so it
builds in seconds.  It lands in ``build/repro_torch/`` at the root of the
checkout, named by a hash of the source and the flags, and is reused
while both stay the same.  A failed build raises.

No ``--use_fast_math``: the epilogue's eq.-17 score ``s + sqrtf(v)`` needs
the IEEE-rounded ``sqrtf`` to pick the same s* as the reference.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["SOURCE", "NVCC_FLAGS", "nvcc_argv", "library_path", "build",
           "load"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "budgeted_dp.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_BUILD_DIR = (pathlib.Path(__file__).resolve().parents[4] / "build"
              / "repro_torch")

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the budgeted-DP CUDA kernels cannot be built")
    return found


def nvcc_argv(nvcc: str, source: pathlib.Path, out: pathlib.Path) -> list:
    """The compiler command line for ``source`` → shared library ``out``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source)]


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"budgeted_dp-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the source unless its library already exists; returns the
    library's path.  Raises ``RuntimeError`` with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_argv(_nvcc(), SOURCE, pathlib.Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once per process and declare the C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dp_forward_launch.argtypes = [p, p, p, p, p, p, p, p,
                                          i, i, i, i, p]
        lib.dp_forward_launch.restype = i
        lib.dp_edge_launch.argtypes = [p] * 6 + [i, p, p] + [i] * 5 + [p]
        lib.dp_edge_launch.restype = i
        lib.dp_chunk_launch.argtypes = [p] * 6 + [i] + [p] * 4 + [i] * 10 + [p]
        lib.dp_chunk_launch.restype = i
        lib.dp_epilogue_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                           p, p, p, p]
        lib.dp_epilogue_launch.restype = i
        lib.dp_error_string.argtypes = [i]
        lib.dp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
