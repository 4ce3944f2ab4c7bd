"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles ``nbodyax_torch/csrc/pair_kernel.cu`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library is
built at first use into ``build/nbodyax_torch/`` beside the package, keyed
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads in milliseconds. Nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pair_kernel.cu"
BUILD_DIR = _PKG.parent / "build" / "nbodyax_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the nbodyax_torch CUDA kernels")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.nbodyax_pair_accumulators
    fn.argtypes = [p, i, p, i, i, i, i, f, f, p, p, p]
    fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"pair_kernel_{key[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build beside the target and rename, so another process
            # building at the same time never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                res = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({res.returncode}) on {SOURCE}:\n"
                        f"{res.stdout}{res.stderr}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        _lib = _bind(ctypes.CDLL(str(so)))
        return _lib
