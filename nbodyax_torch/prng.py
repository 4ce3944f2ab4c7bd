"""``jax.random``'s threefry draw, bit for bit, in plain torch.

``nbodyax`` draws its galaxy, Plummer and ``parity=False`` uniform scenes
from ``jax.random`` with the default threefry2x32 key. This module is the
port's own copy of what those scenes need of it (``jax/_src/prng.py`` and
``jax/_src/random.py``), so a config gives the port ``nbodyax``'s bodies:

- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds, as
  ``_threefry2x32_lowering``.
- ``prng_key``: ``jax.random.PRNGKey`` (``_threefry_seed``).
- ``split``: ``jax.random.split`` in its fold-like form.
- ``random_bits``: ``jax.random.bits``, 32 bits wide.
- ``uniform``: ``jax.random.uniform`` in float32.

It follows ``jax_threefry_partitionable=True``, the default since jax 0.5,
which ``nbodyax`` does not change: ``split`` and ``random_bits`` hash the
flat element index as the 64-bit count ``(i >> 32, i & 0xFFFFFFFF)``. The
older non-partitionable form is not reproduced.

Words are uint32 values held in int64 tensors and masked to 32 bits after
every operation that can carry past them (torch lacks full uint32
arithmetic). Integer work gives the same bits on every device, so draws
may run on the device that will hold them. XLA fuses ``uniform``'s
``floats * (maxval - minval) + minval`` into one fused multiply-add; the
port rounds it once too, exactly, through float64 rounded to odd.

A key is an int64 tensor of shape (2,) on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["threefry2x32", "prng_key", "split", "random_bits", "uniform"]

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements hashed at a time on the CPU: each round's operands stay in
# cache, and at torch's grain size (32,768) each op runs on one thread,
# with no parallel region to wait for on a busy host
_CPU_BLOCK = 1 << 15


def _rounds(x0: torch.Tensor, x1: torch.Tensor, rotations) -> None:
    """Four Threefry rounds on (x0, x1), in place."""
    for r in rotations:
        x0.add_(x1).bitwise_and_(_M)
        low = x1 >> (32 - r)
        x1.bitwise_left_shift_(r).bitwise_and_(_M).bitwise_or_(low)
        x1.bitwise_xor_(x0)


def _hash(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor) -> None:
    """Threefry-2x32 of the counts (x0, x1) under the key (k1, k2), in
    place."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(_M)
    x1.add_(ks[1]).bitwise_and_(_M)
    for i in range(5):
        _rounds(x0, x1, _ROTATIONS[i % 2])
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M)


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the count words (x1, x2) under the key
    (k1, k2), each a uint32 value: two int64 tensors of x1's shape."""
    y1, y2 = (y.contiguous() for y in torch.broadcast_tensors(
        x1.to(torch.int64) & _M, x2.to(torch.int64) & _M))
    _blocked_hash(int(k1) & _M, int(k2) & _M, y1.view(-1), y2.view(-1))
    return y1, y2


def _blocked_hash(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
                  ) -> None:
    """``_hash`` on flat tensors, in cache-sized blocks on the CPU."""
    step = _CPU_BLOCK if x0.device.type == "cpu" else max(x0.numel(), 1)
    for s in range(0, x0.numel(), step):
        _hash(k1, k2, x0[s:s + step], x1[s:s + step])


def _key_words(key: torch.Tensor) -> tuple[int, int]:
    k1, k2 = (int(w) for w in key.reshape(2).tolist())
    return k1 & _M, k2 & _M


def _counts(num: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat indices 0..num-1 as (high, low) uint32 words."""
    i = torch.arange(num, dtype=torch.int64, device=device)
    return i >> 32, i & _M


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & M) of
    the seed as jax holds it without x64, a 32-bit integer, whose logical
    shift by 32 is 0."""
    return torch.tensor([0, int(seed) & _M], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: num keys, shape (num, 2)."""
    k1, k2 = _key_words(key)
    hi, lo = _counts(num, "cpu")
    _hash(k1, k2, hi, lo)
    return torch.stack([hi, lo], 1)


def random_bits(key: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 on ``device``."""
    shape = tuple(shape)
    num = 1
    for s in shape:
        num *= int(s)
    k1, k2 = _key_words(key)
    hi, lo = _counts(num, device)
    _blocked_hash(k1, k2, hi, lo)
    return hi.bitwise_xor_(lo).view(shape)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The float64 product of two float32 values is exact; the float64 sum
    is rounded to odd (TwoSum's error says whether it was inexact and on
    which side), which leaves no double rounding in the final cast.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)`` on
    ``device``; ``minval`` and ``maxval`` broadcast against ``shape``."""
    shape = tuple(shape)
    lo = torch.as_tensor(minval, dtype=torch.float32).to(device)
    hi = torch.as_tensor(maxval, dtype=torch.float32).to(device)
    bits = random_bits(key, shape, device)
    one = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, _fma_f32(floats, hi - lo, lo))
