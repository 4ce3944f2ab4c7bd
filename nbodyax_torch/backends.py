"""Backend selection: which all-pairs engine computes the accumulators.

Counterpart of ``nbodyax/backends.py``. The config's ``backend`` values map
to the port's engines:

- ``auto``   — ``pair_accumulators_kernel``: on a CUDA device it launches
               the hand-written kernel; on the CPU its wrapper runs the
               kernel's plain PyTorch version.
- ``pallas`` — the hand-written kernel; raises on a device without one.
- ``jnp``    — the chunked torch oracle (physics/pairwise.py).

``forceModel=bh`` takes ``physics/barneshut.py``'s ``bh_accumulators``
instead, whatever the backend; its ``bhPallas`` knob picks the near-field
engine: ``auto`` the CUDA kernels (B3, B4/B5) on a CUDA device and their
plain versions on the CPU, ``on`` the kernels (an error without a card),
``off`` the plain torch engine.
"""

from __future__ import annotations

from functools import partial

import torch

from nbodyax_torch.physics.kernels import pair_accumulators_kernel
from nbodyax_torch.physics.pairwise import pair_accumulators
from nbodyax_torch.physics.step import PhysicsParams

__all__ = ["build_accum_fn"]


def _bh_accum_fn(p: PhysicsParams, device, cfg):
    """``cfg``'s knobs must be resolved (``driver.resolve_bh_config``)."""
    from nbodyax_torch.physics.barneshut import (bh_accumulators,
                                                 resolve_near_kernel)
    resolve_near_kernel(cfg.bh_pallas, cfg.bh_near, device)  # on: a card
    return partial(bh_accumulators, eps=p.eps, growth_rate=p.growth_rate,
                   mode=p.collision_mode, levels=cfg.bh_levels,
                   ring=cfg.bh_ring, neighbor_k=cfg.bh_neighbor_k,
                   order=cfg.bh_order, far=cfg.bh_far, near=cfg.bh_near,
                   comp_cap=cfg.bh_comp_cap, near_kernel=cfg.bh_pallas,
                   n_giants=cfg.bh_giants)


def build_accum_fn(backend: str, p: PhysicsParams, device: torch.device,
                   cfg=None):
    """Returns accum_fn(pos, vel, mass, radius) -> PairAccumulators; with a
    ``forceModel=bh`` config, the bh accumulators of its knobs."""
    if cfg is not None and cfg.force_model == "bh":
        return _bh_accum_fn(p, device, cfg)
    kw = dict(eps=p.eps, growth_rate=p.growth_rate, mode=p.collision_mode)
    if backend == "jnp":
        return partial(pair_accumulators, **kw)
    if backend == "pallas" and torch.device(device).type != "cuda":
        raise ValueError(f"backend=pallas is the CUDA kernel; device "
                         f"{device} has none (use auto or jnp)")
    if backend in ("auto", "pallas"):
        return partial(pair_accumulators_kernel, **kw)
    raise ValueError(f"unknown backend {backend!r}")
