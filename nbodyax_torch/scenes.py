"""Scene constructors.

Counterpart of ``nbodyax/scenes.py``. The port has the reference's random
scene (``uniform`` with ``parity=True``, 2-D), bit-exact through the RNG
port. The other scenes draw from ``jax.random``, which torch cannot
reproduce; they are still to port (ROADMAP item A3).
"""

from __future__ import annotations

import torch

from nbodyax_torch.config import SimConfig
from nbodyax_torch.rng import scene_arrays
from nbodyax_torch.state import SimState, make_state

__all__ = ["init_scene", "uniform_scene"]


def uniform_scene(cfg: SimConfig, *, device: torch.device | str,
                  parity: bool = True) -> SimState:
    """The reference's random scene: positions uniform over the field,
    bodies at rest, mass and radius uniform over their ranges."""
    if not parity or cfg.dimensions != 2:
        raise NotImplementedError(
            "only the 2-D uniform scene with parity=True is ported; the "
            "jax.random scenes are ROADMAP item A3")
    pos, vel, mass, radius = scene_arrays(
        cfg.seed, cfg.particle_count, cfg.field_width, cfg.field_height,
        cfg.min_body_mass, cfg.max_body_mass, cfg.min_radius, cfg.max_radius)
    return make_state(pos, vel, mass, radius, device=device)


def init_scene(cfg: SimConfig, *, device: torch.device | str,
               parity: bool = True) -> SimState:
    if cfg.scene == "uniform":
        return uniform_scene(cfg, device=device, parity=parity)
    if cfg.scene in ("three_body", "galaxy", "plummer"):
        raise NotImplementedError(
            f"scene={cfg.scene} is not ported yet (ROADMAP item A3)")
    raise ValueError(f"unknown scene {cfg.scene!r}")
