"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles each source under ``nbodyax_torch/csrc/`` into a shared
library with a plain C interface, loaded with ``ctypes``: ``pair_kernel.cu``
(the all-pairs forward pass) and ``pair_bwd_kernel.cu`` (its analytic
backward pass). The libraries are built at first use into
``build/nbodyax_torch/`` beside the package, one ``nvcc`` a source, all
started together, and keyed by a hash of both sources and the flags, so an
edited source rebuilds and unchanged ones load in milliseconds. Nothing is
compiled at import.
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
from types import SimpleNamespace

__all__ = ["load_library", "SOURCES", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "pair_kernel.cu",
           _PKG / "csrc" / "pair_bwd_kernel.cu")
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


def _bind(fwd: ctypes.CDLL, bwd: ctypes.CDLL) -> SimpleNamespace:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    acc = fwd.nbodyax_pair_accumulators
    acc.argtypes = [p, i, p, i, i, i, i, f, f, p, p, p]
    acc.restype = ctypes.c_int
    back = bwd.nbodyax_pair_backward
    back.argtypes = [p, i, p, i, i, i, p, i, i, f, f, p, p]
    back.restype = ctypes.c_int
    return SimpleNamespace(nbodyax_pair_accumulators=acc,
                           nbodyax_pair_backward=back)


def _build_all(targets) -> None:
    """Run one ``nvcc`` a missing library, all at once. Each builds beside
    its target and is renamed into place, so another process building at
    the same time never loads a half-written library."""
    jobs = []
    try:
        for src, so in targets:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, so, tmp, proc))
        failed = []
        for src, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n"
                              f"{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def load_library() -> SimpleNamespace:
    """Compile (once per hash of the sources and flags) and load both
    kernel libraries; returns their two bound entry points."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES:
            h.update(src.read_bytes())
        key = h.hexdigest()[:16]
        targets = [(src, BUILD_DIR / f"{src.stem}_{key}.so")
                   for src in SOURCES]
        missing = [(src, so) for src, so in targets if not so.exists()]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build_all(missing)
        _lib = _bind(*(ctypes.CDLL(str(so)) for _, so in targets))
        return _lib
