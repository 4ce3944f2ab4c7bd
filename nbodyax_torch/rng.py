"""Deterministic RNG, bit-compatible with the reference scene generator.

A pure-Python copy of ``nbodyax/rng.py``: the reference's combined
xorshift / LCG / multiply-with-carry generator (``jbutil::randgen``) and the
draw order of its scene (x, y, mass, radius per body, each value computed in
double and narrowed to float32). The recurrence is sequential, so large
scenes go through the C++ fill of ``nbodyax_torch.native`` when it builds;
the pure-Python draw here stays the source of truth, bit for bit the
same.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RefRandgen", "scene_arrays"]

_M64 = (1 << 64) - 1


class RefRandgen:
    """Bit-exact reimplementation of ``jbutil::randgen``.

    Three-component combined generator: 64-bit LCG (u), 64-bit xorshift (v),
    32-bit multiply-with-carry (w); output is a xorshifted mix of u added to v,
    xored with w. All arithmetic mod 2^64.
    """

    __slots__ = ("u", "v", "w")

    def __init__(self, s: int = 0):
        self.seed(s)

    def seed(self, s: int) -> None:
        self.v = 4101842887655102017
        self.w = 1
        self.u = (s ^ self.v) & _M64
        self.ival64()
        self.v = self.u
        self.ival64()
        self.w = self.v
        self.ival64()

    def _advance(self) -> None:
        self.u = (self.u * 2862933555777941757 + 7046029254386353087) & _M64
        v = self.v
        v ^= v >> 17
        v ^= (v << 31) & _M64
        v ^= v >> 8
        self.v = v
        self.w = (4294957665 * (self.w & 0xFFFFFFFF) + (self.w >> 32)) & _M64

    def ival64(self) -> int:
        self._advance()
        x = self.u ^ ((self.u << 21) & _M64)
        x ^= x >> 35
        x = x ^ ((x << 4) & _M64)
        return ((x + self.v) ^ self.w) & _M64

    def fval(self) -> float:
        """Double in [0, 1)."""
        return 5.42101086242752217e-20 * self.ival64()

    def fval_range(self, a: float, b: float) -> float:
        return self.fval() * (b - a) + a


def scene_arrays(seed: int, n: int, field_width: int, field_height: int,
                 min_mass: float, max_mass: float,
                 min_radius: float, max_radius: float, *,
                 native: bool = True):
    """The reference's random scene as float32 numpy arrays
    ``(pos [n, 2], vel [n, 2], mass [n], radius [n])``.

    Draw order per body: x, y, mass, radius, each computed in double and
    narrowed to float32 on store. Bodies start at rest. With ``native``
    (the default) the C++ fill draws it where it is available; else, or
    with ``native=False``, this module's pure-Python generator.
    """
    if native:
        from nbodyax_torch import native as _native
        if _native.available():
            return _native.scene_arrays(seed, n, field_width, field_height,
                                        min_mass, max_mass, min_radius,
                                        max_radius)
    g = RefRandgen(seed)
    pos = np.empty((n, 2), np.float32)
    mass = np.empty((n,), np.float32)
    radius = np.empty((n,), np.float32)
    dw, dh = field_width * 2, field_height * 2
    # the reference stores the ranges as C++ float: narrowed to float32
    # before being widened to double inside fval_range
    min_mass = float(np.float32(min_mass))
    max_mass = float(np.float32(max_mass))
    min_radius = float(np.float32(min_radius))
    max_radius = float(np.float32(max_radius))
    for i in range(n):
        pos[i, 0] = np.float32(g.fval_range(0, dw) - field_width)
        pos[i, 1] = np.float32(g.fval_range(0, dh) - field_height)
        mass[i] = np.float32(g.fval_range(min_mass, max_mass))
        radius[i] = np.float32(g.fval_range(min_radius, max_radius))
    vel = np.zeros((n, 2), np.float32)
    return pos, vel, mass, radius
