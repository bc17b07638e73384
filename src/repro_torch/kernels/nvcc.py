"""Build a kernel source with ``nvcc`` at first use and load it with
``ctypes``: the one build path of every CUDA library of the port.

Each library has a plain C interface (no PyTorch headers), so it builds in
seconds.  It lands in ``build/repro_torch/`` at the root of the checkout,
named by the source's stem and a hash of the source and the flags, and is
reused while both stay the same.  A failed build raises.

No ``--use_fast_math``: the budgeted DP's eq.-17 score needs the
IEEE-rounded ``sqrtf``, and the attention and SSD kernels hold their f32
``expf`` to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["NVCC_FLAGS", "SMEM_LIMIT_BYTES", "CudaLibrary", "nvcc_argv",
           "build_all"]

# dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT_BYTES = 232448

# -Xptxas -v: ptxas reports each kernel's registers and spills; the
# report is kept beside the library (CudaLibrary.build_log)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def nvcc_argv(nvcc: str, source: pathlib.Path, out: pathlib.Path) -> list:
    """The compiler command line for ``source`` → shared library ``out``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source)]


class CudaLibrary:
    """One ``csrc/*.cu`` source and its shared library.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of the library's C
    entry points; ``error_fn`` names its ``const char* (int)`` function
    that spells a ``cudaError_t``.
    """

    def __init__(self, source: pathlib.Path, declare, error_fn: str):
        self.source = pathlib.Path(source)
        self._declare = declare
        self._error_fn = error_fn
        self._lib = None

    def path(self) -> pathlib.Path:
        """Where the library for the current source and flags lives."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return _BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _start(self):
        """(process, temporary output, final path), or None if built."""
        out = self.path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            proc = subprocess.Popen(
                nvcc_argv(_nvcc(), self.source, pathlib.Path(tmp)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except BaseException:
            os.unlink(tmp)
            raise
        return proc, tmp, out

    def _finish(self, started) -> None:
        proc, tmp, out = started
        try:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building "
                    f"{self.source.name}:\n{log}")
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent build never sees half
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def build(self) -> pathlib.Path:
        """Compile the source unless its library already exists; returns the
        library's path.  Raises ``RuntimeError`` with nvcc's output on
        failure."""
        started = self._start()
        if started is not None:
            self._finish(started)
        return self.path()

    def build_log(self) -> str:
        """nvcc's output of the build of the current source and flags
        (ptxas's register and spill report), or "" if it was not kept."""
        log = self.path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    def load(self) -> ctypes.CDLL:
        """Build if needed, load once per process and declare the C
        signatures."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._declare(lib)
            err = getattr(lib, self._error_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise ``RuntimeError`` for a nonzero ``cudaError_t`` of a
        launch of ``what``."""
        if err != 0:
            msg = getattr(self.load(), self._error_fn)(err).decode()
            raise RuntimeError(
                f"{what} launch failed: CUDA error {err} ({msg})")


def build_all(libraries) -> None:
    """Build every library that is not built yet, one ``nvcc`` each, all
    started together; raises for the first that fails, after all end."""
    started = []
    try:
        for lib in libraries:
            s = lib._start()
            if s is not None:
                started.append((lib, s))
    finally:
        errors = []
        for lib, s in started:
            try:
                lib._finish(s)
            except RuntimeError as err:
                errors.append(err)
    if errors:
        raise errors[0]
