"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles each source under ``nbodyax_torch/csrc/`` into a shared
library with a plain C interface, loaded with ``ctypes``: ``pair_kernel.cu``
(the all-pairs forward pass), ``pair_bwd_kernel.cu`` (its analytic
backward pass), ``near_kernel.cu`` (the bh near field) and
``slotpack_kernel.cu`` (the bh slot-grid pack and finest moments); the two
all-pairs sources share ``pair_common.cuh``. The libraries are built at
first use into ``build/nbodyax_torch/`` beside the package, one ``nvcc`` a
source, all started together, and keyed by a hash of every source, header
and flag, so an edit rebuilds and unchanged ones load in milliseconds.
Each build leaves ``ptxas``'s report (registers, spills) beside its
library as ``<name>_<key>.log``. Nothing is compiled at import.
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

__all__ = ["load_library", "build_log", "SOURCES", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "pair_kernel.cu", "pair_bwd_kernel.cu", "near_kernel.cu",
    "slotpack_kernel.cu"))
HEADERS = (_PKG / "csrc" / "pair_common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "nbodyax_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_key = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the nbodyax_torch CUDA kernels")


def _bind(fwd: ctypes.CDLL, bwd: ctypes.CDLL, near: ctypes.CDLL,
          pack: ctypes.CDLL) -> SimpleNamespace:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    fns = {}
    for lib, name, args in (
            (fwd, "nbodyax_pair_accumulators",
             [p, i, p, i, i, i, i, i, f, f, i, p, p, p, p, p]),
            (fwd, "nbodyax_pair_launch_shape", [i, i, ip, ip]),
            (bwd, "nbodyax_pair_backward",
             [p, i, p, i, i, i, p, i, i, f, f, i, i, p, p, p, p, p]),
            (bwd, "nbodyax_pair_backward_launch_shape", [i, i, ip, ip]),
            (near, "nbodyax_slots_near",
             [p, i, i, i, i, i, i, i, i, f, f, p, p]),
            (near, "nbodyax_near_shared_bytes", [i, i, i]),
            (pack, "nbodyax_slot_pack", [p, i, p, p, i, i, p, p]),
            (pack, "nbodyax_slot_pack_moments",
             [p, i, p, p, i, i, i, i, p, i, p, p, p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[name] = fn
    return SimpleNamespace(**fns)


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
                so.with_suffix(".log").write_text(out)
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
    """Compile (once per hash of the sources and flags) and load every
    kernel library; returns their bound entry points."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        global _key
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in SOURCES + HEADERS:
            h.update(src.read_bytes())
        key = _key = h.hexdigest()[:16]
        targets = [(src, BUILD_DIR / f"{src.stem}_{key}.so")
                   for src in SOURCES]
        missing = [(src, so) for src, so in targets if not so.exists()]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build_all(missing)
        _lib = _bind(*(ctypes.CDLL(str(so)) for _, so in targets))
        return _lib


def build_log(source: str) -> str | None:
    """``nvcc``'s output (with ``ptxas``'s register and spill report) for
    the library of ``source`` (e.g. "pair_kernel.cu") that load_library
    loaded, or None if that library was built by another process."""
    if _key is None:
        return None
    log = BUILD_DIR / f"{Path(source).stem}_{_key}.log"
    return log.read_text() if log.exists() else None
