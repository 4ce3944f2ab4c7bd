"""Backend selection: which all-pairs engine computes the accumulators.

Counterpart of ``nbodyax/backends.py``. The config's ``backend`` values map
to the port's engines:

- ``auto``   — ``pair_accumulators_kernel``: on a CUDA device it launches
               the hand-written kernel; on the CPU its wrapper runs the
               kernel's plain PyTorch version.
- ``pallas`` — the hand-written kernel; raises on a device without one.
- ``jnp``    — the chunked torch oracle (physics/pairwise.py).
"""

from __future__ import annotations

from functools import partial

import torch

from nbodyax_torch.physics.kernels import pair_accumulators_kernel
from nbodyax_torch.physics.pairwise import pair_accumulators
from nbodyax_torch.physics.step import PhysicsParams

__all__ = ["build_accum_fn"]


def build_accum_fn(backend: str, p: PhysicsParams, device: torch.device):
    """Returns accum_fn(pos, vel, mass, radius) -> PairAccumulators."""
    kw = dict(eps=p.eps, growth_rate=p.growth_rate, mode=p.collision_mode)
    if backend == "jnp":
        return partial(pair_accumulators, **kw)
    if backend == "pallas" and torch.device(device).type != "cuda":
        raise ValueError(f"backend=pallas is the CUDA kernel; device "
                         f"{device} has none (use auto or jnp)")
    if backend in ("auto", "pallas"):
        return partial(pair_accumulators_kernel, **kw)
    raise ValueError(f"unknown backend {backend!r}")
