"""One simulation step: forces -> collisions -> boundary -> integrate.

Counterpart of the euler path of ``nbodyax/physics/step.py``, in the
reference's order of operations:

1. pair accumulators from the step-start state;
2. merge bookkeeping commits to mass and radius;
3. ``accel = G * force`` (G = 6.67408e-11f);
4. ``boundaryMode=reference``: flip the velocity component where
   ``pos + accel*dt`` would leave ``[-(field - r), field - r]``, with the
   pre-merge radius (quirk Q6: the probe is accel*dt, not vel*dt, and the
   position is never clamped);
5. ``vel' = vel + accel*dt``; ``pos' = pos + vel'*dt`` (semi-implicit Euler);
6. dead slots are frozen.

``boundaryMode=clamp`` probes with the real displacement and clamps; ``none``
does neither. Leapfrog, yoshida4 and adaptive dt are not ported yet.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from nbodyax_torch.physics.collisions import resolve_collisions
from nbodyax_torch.physics.pairwise import PairAccumulators, pair_accumulators
from nbodyax_torch.state import SimState

__all__ = ["PhysicsParams", "make_step", "finish_euler", "GRAV_CONSTANT"]

GRAV_CONSTANT = float(np.float32(6.67408e-11))


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Static physics configuration. ``dt`` and ``growth_rate`` hold
    float32-rounded values, as the reference's float config fields do."""

    dt: float = 0.2
    field_width: float = 100000.0
    field_height: float = 100000.0
    growth_rate: float = 0.1
    eps: float = 0.0
    collision_mode: str = "reference"
    restitution: float = 1.0
    boundary_mode: str = "reference"
    wall_restitution: float = 1.0
    integrator: str = "euler"
    adaptive_dt: bool = False

    @classmethod
    def from_config(cls, cfg) -> "PhysicsParams":
        return cls(dt=float(np.float32(cfg.timestep)),
                   field_width=float(cfg.field_width),
                   field_height=float(cfg.field_height),
                   growth_rate=float(np.float32(cfg.growth_rate)),
                   eps=float(cfg.softening),
                   collision_mode=cfg.collision_mode,
                   restitution=float(cfg.restitution),
                   boundary_mode=cfg.boundary_mode,
                   wall_restitution=float(cfg.wall_restitution),
                   integrator=cfg.integrator,
                   adaptive_dt=bool(cfg.adaptive_dt))


AccumFn = Callable[..., PairAccumulators]


def _limit(radius, p: PhysicsParams) -> torch.Tensor:
    """Per-axis interval half-width ``field - r``, f32[N, 2]."""
    return torch.stack([p.field_width - radius, p.field_height - radius], -1)


def _boundary_flip(pos, vel, radius, probe_disp, p: PhysicsParams):
    """Flip velocity components where ``pos + probe_disp`` would leave
    ``[-(field - r), field - r]``."""
    limit = _limit(radius, p)
    pred = pos + probe_disp
    out = (pred > limit) | (pred < -limit)
    if p.boundary_mode == "clamp" and p.wall_restitution != 1.0:
        # partially inelastic wall, clamp mode only (the reference-mode
        # sign flip is the spec)
        flipped = float(np.float32(-p.wall_restitution)) * vel
    else:
        flipped = -vel
    return torch.where(out, flipped, vel)


def finish_euler(pos2, vel2, mass2, radius2, pre_radius, force,
                 p: PhysicsParams):
    """Post-collision tail of a step: boundary -> kick -> drift -> dead-slot
    freeze. Takes the post-collision arrays, the pre-merge radius and the
    force sum before G; returns (pos, vel, mass, radius)."""
    dt = p.dt
    accel = force * GRAV_CONSTANT
    if p.boundary_mode == "reference":
        vel2 = _boundary_flip(pos2, vel2, pre_radius, accel * dt, p)
    new_vel = vel2 + accel * dt
    new_pos = pos2 + new_vel * dt
    if p.boundary_mode == "clamp":
        probe = new_pos - pos2
        new_vel = _boundary_flip(pos2, new_vel, radius2, probe, p)
        limit = _limit(radius2, p)
        new_pos = torch.clamp(pos2 + new_vel * dt, -limit, limit)
    alive = (mass2 > 0)[:, None]
    new_vel = torch.where(alive, new_vel, torch.zeros_like(new_vel))
    new_pos = torch.where(alive, new_pos, pos2)
    return new_pos, new_vel, mass2, radius2


def make_step(p: PhysicsParams, accum_fn: Optional[AccumFn] = None,
              chunk: Optional[int] = None) -> Callable[[SimState], SimState]:
    """Build the step function. ``accum_fn(pos, vel, mass, radius)`` picks
    the all-pairs engine (see ``backends``); the default is the chunked
    torch oracle."""
    if p.integrator != "euler":
        raise NotImplementedError(
            f"integrator={p.integrator} is not ported yet (ROADMAP item A5)")
    if p.adaptive_dt:
        raise NotImplementedError(
            "adaptiveDt is not ported yet (ROADMAP item A5)")
    if p.boundary_mode not in ("reference", "clamp", "none"):
        raise ValueError(f"unknown boundaryMode {p.boundary_mode!r}")
    if accum_fn is None:
        accum_fn = partial(pair_accumulators, eps=p.eps,
                           growth_rate=p.growth_rate, mode=p.collision_mode,
                           chunk=chunk)

    def euler_step(state: SimState) -> SimState:
        acc = accum_fn(state.pos, state.vel, state.mass, state.radius)
        pos2, vel2, mass2, radius2 = resolve_collisions(
            state.pos, state.vel, state.mass, state.radius, acc,
            mode=p.collision_mode, restitution=p.restitution)
        out = finish_euler(pos2, vel2, mass2, radius2, state.radius,
                           acc.force, p)
        return SimState(*out, state.step + 1, state.sim_time + p.dt)

    return euler_step
