"""Scene constructors.

Counterpart of ``nbodyax/scenes.py``. The port has the reference's random
scene: in 2-D (``uniform`` with ``parity=True``) bit-exact through the RNG
port; in 3-D drawn from a ``torch.Generator`` (see ``uniform_scene``). The
other scenes draw from ``jax.random``, which torch cannot reproduce; they
are still to port (ROADMAP item A3).
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
    bodies at rest, mass and radius uniform over their ranges.

    2-D with ``parity=True`` is the reference's own draw, bit for bit. 3-D
    draws the same distributions as ``nbodyax``'s 3-D scene (positions
    uniform over [-ext, ext] on each axis, ext = (fieldWidth, fieldHeight,
    fieldDepth or fieldWidth)), but from a ``torch.Generator`` seeded with
    ``cfg.seed`` on the CPU: the same seed gives the same scene on every
    device, but not ``nbodyax``'s bits, which come from ``jax.random``. To
    run both packages on one 3-D state, carry ``nbodyax``'s state across
    with ``state.from_numpy``.
    """
    if cfg.dimensions == 3:
        return _uniform_scene_3d(cfg, device)
    if not parity:
        raise NotImplementedError(
            "the 2-D uniform scene is ported with parity=True only; the "
            "jax.random scenes are ROADMAP item A3")
    pos, vel, mass, radius = scene_arrays(
        cfg.seed, cfg.particle_count, cfg.field_width, cfg.field_height,
        cfg.min_body_mass, cfg.max_body_mass, cfg.min_radius, cfg.max_radius)
    return make_state(pos, vel, mass, radius, device=device)


def _uniform_scene_3d(cfg: SimConfig, device) -> SimState:
    n = cfg.particle_count
    gen = torch.Generator(device="cpu").manual_seed(int(cfg.seed))

    def uniform(shape, lo, hi):
        """float32 uniform over [lo, hi) per element."""
        lo, hi = (torch.as_tensor(x, dtype=torch.float32) for x in (lo, hi))
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    ext = torch.tensor([float(cfg.field_width), float(cfg.field_height),
                        float(cfg.field_depth or cfg.field_width)])
    pos = uniform((n, 3), -ext, ext)
    mass = uniform((n,), cfg.min_body_mass, cfg.max_body_mass)
    radius = uniform((n,), cfg.min_radius, cfg.max_radius)
    return make_state(pos, torch.zeros((n, 3)), mass, radius, device=device)


def init_scene(cfg: SimConfig, *, device: torch.device | str,
               parity: bool = True) -> SimState:
    if cfg.scene == "uniform":
        return uniform_scene(cfg, device=device, parity=parity)
    if cfg.scene in ("three_body", "galaxy", "plummer"):
        raise NotImplementedError(
            f"scene={cfg.scene} is not ported yet (ROADMAP item A3)")
    raise ValueError(f"unknown scene {cfg.scene!r}")
