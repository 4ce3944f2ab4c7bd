"""The C++ scene fill (``csrc/scene_fill.cpp``), bound with ctypes.

``rng.scene_arrays`` draws the reference scene through it: the generator's
recurrence is sequential, so a 1M-body scene takes seconds in pure Python
and milliseconds here, with the same bits (``tests/test_torch_native.py``).
The library is built with ``g++ -O3`` at first use into
``build/nbodyax_torch/``, keyed by a hash of the source and the flags, by
``physics/_build.py``'s ``cached_build``, as the CUDA sources are. It is
host code, not a kernel: without a compiler, or if the build fails,
``available()`` is False and ``rng.scene_arrays`` draws in pure Python,
its source of truth.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from typing import Optional

import numpy as np

from nbodyax_torch.physics._build import KernelCompileError, cached_build

__all__ = ["available", "ival64_sequence", "scene_arrays", "SOURCE"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "scene_fill.cpp")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _gxx() -> str:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise KernelCompileError("no C++ compiler for the scene fill")
    return gxx


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            (target,) = cached_build(_gxx, FLAGS, (SOURCE,))
        except (KernelCompileError, OSError):
            return None
        lib = ctypes.CDLL(str(target))
        lib.nbx_abi_version.restype = ctypes.c_int32
        if lib.nbx_abi_version() != _ABI_VERSION:
            return None
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.nbx_ival64_sequence.argtypes = [ctypes.c_uint64, ctypes.c_int64,
                                            u64p]
        lib.nbx_ival64_sequence.restype = None
        lib.nbx_scene_fill.argtypes = [
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            f32p, f32p, f32p, f32p]
        lib.nbx_scene_fill.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ fill is built and loaded (building it if need be)."""
    return _load() is not None


def ival64_sequence(seed: int, n: int) -> np.ndarray:
    """The first ``n`` raw uint64 draws of the generator seeded ``seed``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the C++ scene fill is not available")
    out = np.empty(n, np.uint64)
    lib.nbx_ival64_sequence(seed, n, out)
    return out


def scene_arrays(seed: int, n: int, field_width: int, field_height: int,
                 min_mass: float, max_mass: float,
                 min_radius: float, max_radius: float):
    """``rng.scene_arrays``'s draw in C++: (pos [n, 2], vel [n, 2],
    mass [n], radius [n]) as float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the C++ scene fill is not available")
    pos = np.empty((n, 2), np.float32)
    vel = np.empty((n, 2), np.float32)
    mass = np.empty(n, np.float32)
    radius = np.empty(n, np.float32)
    lib.nbx_scene_fill(seed, n, field_width, field_height,
                       np.float32(min_mass), np.float32(max_mass),
                       np.float32(min_radius), np.float32(max_radius),
                       pos.reshape(-1), vel.reshape(-1), mass, radius)
    return pos, vel, mass, radius
