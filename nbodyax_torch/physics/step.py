"""One simulation step: forces -> collisions -> boundary -> integrate.

Counterpart of ``nbodyax/physics/step.py`` at a fixed dt. The euler step
keeps the reference's order of operations:

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
does neither. Every step works on [N, D] state, D = 2 or 3; in 3-D the z
interval is ``fieldDepth`` (``fieldWidth`` when that is 0). ``integrator=leapfrog`` is kick-drift-kick with a second force
pass, and ``yoshida4`` the 4th-order composition of three leapfrog substeps
(three force passes beyond the first); both resolve collisions once, at the
step-start pass, and run the boundary and the dead-slot freeze once, at the
end. Adaptive dt is not ported yet.
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

__all__ = ["PhysicsParams", "make_step", "finish_euler", "half_kick_drift",
           "finish_leapfrog", "yoshida4_tail", "GRAV_CONSTANT"]

GRAV_CONSTANT = float(np.float32(6.67408e-11))


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Static physics configuration. ``dt`` and ``growth_rate`` hold
    float32-rounded values, as the reference's float config fields do."""

    dt: float = 0.2
    field_width: float = 100000.0
    field_height: float = 100000.0
    field_depth: float = 100000.0         # z half-extent (3-D runs)
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
                   field_depth=float(cfg.field_depth or cfg.field_width),
                   growth_rate=float(np.float32(cfg.growth_rate)),
                   eps=float(cfg.softening),
                   collision_mode=cfg.collision_mode,
                   restitution=float(cfg.restitution),
                   boundary_mode=cfg.boundary_mode,
                   wall_restitution=float(cfg.wall_restitution),
                   integrator=cfg.integrator,
                   adaptive_dt=bool(cfg.adaptive_dt))


AccumFn = Callable[..., PairAccumulators]


def _limit(radius, p: PhysicsParams, dim: int) -> torch.Tensor:
    """Per-axis interval half-width ``field - r``, f32[N, dim]: width and
    height, and depth in 3-D."""
    field = (p.field_width, p.field_height, p.field_depth)[:dim]
    return torch.stack([f - radius for f in field], -1)


def _boundary_flip(pos, vel, radius, probe_disp, p: PhysicsParams):
    """Flip velocity components where ``pos + probe_disp`` would leave
    ``[-(field - r), field - r]``."""
    limit = _limit(radius, p, pos.shape[-1])
    pred = pos + probe_disp
    out = (pred > limit) | (pred < -limit)
    if p.boundary_mode == "clamp" and p.wall_restitution != 1.0:
        # partially inelastic wall, clamp mode only (the reference-mode
        # sign flip is the spec)
        flipped = float(np.float32(-p.wall_restitution)) * vel
    else:
        flipped = -vel
    return torch.where(out, flipped, vel)


def _clamp_positions(pos, radius, p: PhysicsParams):
    limit = _limit(radius, p, pos.shape[-1])
    return torch.clamp(pos, -limit, limit)


def _freeze_dead(pos2, new_pos, new_vel, mass2):
    """Dead slots keep their position and get zero velocity."""
    alive = (mass2 > 0)[:, None]
    return (torch.where(alive, new_pos, pos2),
            torch.where(alive, new_vel, torch.zeros_like(new_vel)))


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
        new_pos = _clamp_positions(pos2 + new_vel * dt, radius2, p)
    new_pos, new_vel = _freeze_dead(pos2, new_pos, new_vel, mass2)
    return new_pos, new_vel, mass2, radius2


def half_kick_drift(pos2, vel2, force, p: PhysicsParams):
    """Leapfrog first half (post-collision): half kick and full drift.
    Returns (v_half, new_pos)."""
    v_half = vel2 + force * GRAV_CONSTANT * (p.dt / 2)
    return v_half, pos2 + v_half * p.dt


def _finish_kicked(pos2, new_pos, new_vel, mass2, radius2, accel,
                   p: PhysicsParams):
    """Boundary and dead-slot freeze after the last kick of a leapfrog or
    yoshida4 step. ``reference`` flips on an accel*dt probe and never
    clamps (quirk Q6); ``clamp`` probes with the real displacement and
    clamps."""
    if p.boundary_mode == "reference":
        new_vel = _boundary_flip(new_pos, new_vel, radius2, accel * p.dt, p)
    elif p.boundary_mode == "clamp":
        new_vel = _boundary_flip(new_pos, new_vel, radius2, new_vel * p.dt,
                                 p)
        new_pos = _clamp_positions(new_pos, radius2, p)
    new_pos, new_vel = _freeze_dead(pos2, new_pos, new_vel, mass2)
    return new_pos, new_vel, mass2, radius2


def finish_leapfrog(pos2, new_pos, v_half, mass2, radius2, force2,
                    p: PhysicsParams):
    """Leapfrog second half: the final half kick from the second force
    pass, then boundary and dead-slot freeze. Returns (pos, vel, mass,
    radius)."""
    accel2 = force2 * GRAV_CONSTANT
    new_vel = v_half + accel2 * (p.dt / 2)
    return _finish_kicked(pos2, new_pos, new_vel, mass2, radius2, accel2, p)


# Yoshida (1990) 4th-order symplectic composition: three leapfrog substeps
# scaled by (w1, w0, w1); the negative middle substep cancels the 2nd-order
# error. The coefficients are exact in f64, and each coefficient times dt is
# rounded once to f32, as in nbodyax.
_YOSH_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_YOSH_W0 = 1.0 - 2.0 * _YOSH_W1
_YOSH_KICK = (_YOSH_W1 / 2, (_YOSH_W0 + _YOSH_W1) / 2,
              (_YOSH_W0 + _YOSH_W1) / 2, _YOSH_W1 / 2)
_YOSH_DRIFT = (_YOSH_W1, _YOSH_W0, _YOSH_W1)


def yoshida4_tail(pos2, vel2, mass2, radius2, force1, accum_fn,
                  p: PhysicsParams):
    """4th-order symplectic tail (post-collision): the three scaled
    leapfrog substeps merged into a kick-drift chain with kick coefficients
    (w1/2, (w0+w1)/2, (w0+w1)/2, w1/2) and drift coefficients (w1, w0, w1).
    ``force1`` is the step-start pass's force; ``accum_fn`` supplies the
    three further passes. Boundary and dead-slot freeze run once, at the
    end. Returns (pos, vel, mass, radius)."""
    dt = np.float32(p.dt)
    kick = [float(np.float32(c) * dt) for c in _YOSH_KICK]
    drift = [float(np.float32(d) * dt) for d in _YOSH_DRIFT]
    v = vel2 + force1 * GRAV_CONSTANT * kick[0]
    x = pos2 + v * drift[0]
    for i in (1, 2):
        acc = accum_fn(x, v, mass2, radius2)
        v = v + acc.force * GRAV_CONSTANT * kick[i]
        x = x + v * drift[i]
    a4 = accum_fn(x, v, mass2, radius2).force * GRAV_CONSTANT
    new_vel = v + a4 * kick[3]
    return _finish_kicked(pos2, x, new_vel, mass2, radius2, a4, p)


def make_step(p: PhysicsParams, accum_fn: Optional[AccumFn] = None,
              chunk: Optional[int] = None) -> Callable[[SimState], SimState]:
    """Build the step function. ``accum_fn(pos, vel, mass, radius)`` picks
    the all-pairs engine (see ``backends``); the default is the chunked
    torch oracle."""
    if p.integrator not in ("euler", "leapfrog", "yoshida4"):
        raise ValueError(f"unknown integrator {p.integrator!r}")
    if p.adaptive_dt:
        raise NotImplementedError(
            "adaptiveDt is not ported yet (ROADMAP item A5)")
    if p.boundary_mode not in ("reference", "clamp", "none"):
        raise ValueError(f"unknown boundaryMode {p.boundary_mode!r}")
    if accum_fn is None:
        accum_fn = partial(pair_accumulators, eps=p.eps,
                           growth_rate=p.growth_rate, mode=p.collision_mode,
                           chunk=chunk)

    def collide(state: SimState):
        """The step-start pass and the collision commit."""
        acc = accum_fn(state.pos, state.vel, state.mass, state.radius)
        return acc, resolve_collisions(
            state.pos, state.vel, state.mass, state.radius, acc,
            mode=p.collision_mode, restitution=p.restitution)

    def euler_step(state: SimState) -> SimState:
        acc, (pos2, vel2, mass2, radius2) = collide(state)
        out = finish_euler(pos2, vel2, mass2, radius2, state.radius,
                           acc.force, p)
        return SimState(*out, state.step + 1, state.sim_time + p.dt)

    def leapfrog_step(state: SimState) -> SimState:
        """Kick-drift-kick; collisions resolve at the first kick."""
        acc, (pos2, vel2, mass2, radius2) = collide(state)
        v_half, new_pos = half_kick_drift(pos2, vel2, acc.force, p)
        acc2 = accum_fn(new_pos, v_half, mass2, radius2)
        out = finish_leapfrog(pos2, new_pos, v_half, mass2, radius2,
                              acc2.force, p)
        return SimState(*out, state.step + 1, state.sim_time + p.dt)

    def yoshida_step(state: SimState) -> SimState:
        """4th-order composition; collisions resolve at the first kick."""
        acc, (pos2, vel2, mass2, radius2) = collide(state)
        out = yoshida4_tail(pos2, vel2, mass2, radius2, acc.force, accum_fn,
                            p)
        return SimState(*out, state.step + 1, state.sim_time + p.dt)

    return {"euler": euler_step, "leapfrog": leapfrog_step,
            "yoshida4": yoshida_step}[p.integrator]
