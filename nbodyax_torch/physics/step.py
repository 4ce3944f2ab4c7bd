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
end.

``adaptiveDt``: each step integrates with one lockstep dt from ``step_dt``,
a 0-d f32 tensor on the state's device computed from the post-collision
state and the step-start force, so the step reads nothing back to the host
and a CUDA graph can capture it. ``sim_time`` advances by the dt used. At a
fixed dt the tails take the configured dt as a Python float, the same f32
value.
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

__all__ = ["PhysicsParams", "make_step", "step_dt", "finish_euler",
           "half_kick_drift", "finish_leapfrog", "yoshida4_tail",
           "GRAV_CONSTANT"]

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
    # adaptive lockstep dt: clip(min over alive bodies of
    # min(eta*sqrt(r/|a|), eta*r/|v|), dt_min, dt_max)
    adaptive_dt: bool = False
    dt_eta: float = 0.25
    dt_min: float = 0.0                   # 0 -> dt_max / 1024
    dt_max: float = 0.0                   # 0 -> the configured fixed dt

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
                   adaptive_dt=bool(cfg.adaptive_dt),
                   dt_eta=float(cfg.dt_eta), dt_min=float(cfg.dt_min),
                   dt_max=float(cfg.dt_max))

    @property
    def dt_bounds(self):
        """Resolved (dt_min, dt_max) for the adaptive clip."""
        hi = self.dt_max or self.dt
        return (self.dt_min or hi / 1024.0, hi)


AccumFn = Callable[..., PairAccumulators]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis, the squares summed left to right."""
    s = x[..., 0] * x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k] * x[..., k]
    return torch.sqrt(s)


def step_dt(vel, mass, radius, force, p: PhysicsParams, group=None):
    """The dt a step integrates with: the configured dt (a Python float),
    or under ``adaptive_dt`` one global value from the post-collision
    arrays and the step-start force, a 0-d f32 tensor on their device:
    clip(min over alive bodies of min(eta*sqrt(r/|a|), eta*r/|v|), dt_min,
    dt_max). An all-dead state clips to dt_max. No host read. ``group``
    (a ``sharding.ShardGroup``): the arrays are this rank's rows, and the
    minimum is taken over every rank (nbodyax's ``pmin``), so all ranks
    step with the same dt."""
    if not p.adaptive_dt:
        return p.dt
    amag = _norm(force * GRAV_CONSTANT)
    vmag = _norm(vel)
    tiny = 1e-30
    dt_a = p.dt_eta * torch.sqrt(radius / torch.clamp(amag, min=tiny))
    dt_v = p.dt_eta * radius / torch.clamp(vmag, min=tiny)
    dt_i = torch.where(mass > 0, torch.minimum(dt_a, dt_v),
                       torch.full_like(dt_a, float("inf")))
    dt = dt_i.min()
    if group is not None:
        dt = group.all_min(dt)
    lo, hi = p.dt_bounds
    return torch.clamp(dt, lo, hi)


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
                 p: PhysicsParams, dt=None):
    """Post-collision tail of a step: boundary -> kick -> drift -> dead-slot
    freeze. Takes the post-collision arrays, the pre-merge radius and the
    force sum before G; returns (pos, vel, mass, radius). ``dt`` overrides
    the configured value (``step_dt``)."""
    dt = p.dt if dt is None else dt
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


def half_kick_drift(pos2, vel2, force, p: PhysicsParams, dt=None):
    """Leapfrog first half (post-collision): half kick and full drift.
    Returns (v_half, new_pos). ``dt`` (``step_dt``) holds for the whole
    kick-drift-kick step."""
    dt = p.dt if dt is None else dt
    v_half = vel2 + force * GRAV_CONSTANT * (dt / 2)
    return v_half, pos2 + v_half * dt


def _finish_kicked(pos2, new_pos, new_vel, mass2, radius2, accel,
                   p: PhysicsParams, dt):
    """Boundary and dead-slot freeze after the last kick of a leapfrog or
    yoshida4 step. ``reference`` flips on an accel*dt probe and never
    clamps (quirk Q6); ``clamp`` probes with the real displacement and
    clamps."""
    if p.boundary_mode == "reference":
        new_vel = _boundary_flip(new_pos, new_vel, radius2, accel * dt, p)
    elif p.boundary_mode == "clamp":
        new_vel = _boundary_flip(new_pos, new_vel, radius2, new_vel * dt, p)
        new_pos = _clamp_positions(new_pos, radius2, p)
    new_pos, new_vel = _freeze_dead(pos2, new_pos, new_vel, mass2)
    return new_pos, new_vel, mass2, radius2


def finish_leapfrog(pos2, new_pos, v_half, mass2, radius2, force2,
                    p: PhysicsParams, dt=None):
    """Leapfrog second half: the final half kick from the second force
    pass, then boundary and dead-slot freeze. Returns (pos, vel, mass,
    radius). ``dt`` must be the one the first half used."""
    dt = p.dt if dt is None else dt
    accel2 = force2 * GRAV_CONSTANT
    new_vel = v_half + accel2 * (dt / 2)
    return _finish_kicked(pos2, new_pos, new_vel, mass2, radius2, accel2, p,
                          dt)


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
                  p: PhysicsParams, dt=None):
    """4th-order symplectic tail (post-collision): the three scaled
    leapfrog substeps merged into a kick-drift chain with kick coefficients
    (w1/2, (w0+w1)/2, (w0+w1)/2, w1/2) and drift coefficients (w1, w0, w1).
    ``force1`` is the step-start pass's force; ``accum_fn`` supplies the
    three further passes. Boundary and dead-slot freeze run once, at the
    end. ``dt`` overrides the configured value (``step_dt``): each
    coefficient times dt is rounded to f32 either way. Returns (pos, vel,
    mass, radius)."""
    dt = p.dt if dt is None else dt
    if isinstance(dt, torch.Tensor):
        kick = [float(np.float32(c)) * dt for c in _YOSH_KICK]
        drift = [float(np.float32(d)) * dt for d in _YOSH_DRIFT]
    else:
        kick = [float(np.float32(c) * np.float32(dt)) for c in _YOSH_KICK]
        drift = [float(np.float32(d) * np.float32(dt)) for d in _YOSH_DRIFT]
    v = vel2 + force1 * GRAV_CONSTANT * kick[0]
    x = pos2 + v * drift[0]
    for i in (1, 2):
        acc = accum_fn(x, v, mass2, radius2)
        v = v + acc.force * GRAV_CONSTANT * kick[i]
        x = x + v * drift[i]
    a4 = accum_fn(x, v, mass2, radius2).force * GRAV_CONSTANT
    new_vel = v + a4 * kick[3]
    return _finish_kicked(pos2, x, new_vel, mass2, radius2, a4, p, dt)


def make_step(p: PhysicsParams, accum_fn: Optional[AccumFn] = None,
              chunk: Optional[int] = None) -> Callable[[SimState], SimState]:
    """Build the step function. ``accum_fn(pos, vel, mass, radius)`` picks
    the all-pairs engine (see ``backends``); the default is the chunked
    torch oracle."""
    if p.integrator not in ("euler", "leapfrog", "yoshida4"):
        raise ValueError(f"unknown integrator {p.integrator!r}")
    if p.boundary_mode not in ("reference", "clamp", "none"):
        raise ValueError(f"unknown boundaryMode {p.boundary_mode!r}")
    if accum_fn is None:
        accum_fn = partial(pair_accumulators, eps=p.eps,
                           growth_rate=p.growth_rate, mode=p.collision_mode,
                           chunk=chunk)

    def collide(state: SimState):
        """The step-start pass, the collision commit and the step's dt."""
        acc = accum_fn(state.pos, state.vel, state.mass, state.radius)
        post = resolve_collisions(
            state.pos, state.vel, state.mass, state.radius, acc,
            mode=p.collision_mode, restitution=p.restitution)
        return acc, post, step_dt(post[1], post[2], post[3], acc.force, p)

    def euler_step(state: SimState) -> SimState:
        acc, (pos2, vel2, mass2, radius2), dt = collide(state)
        out = finish_euler(pos2, vel2, mass2, radius2, state.radius,
                           acc.force, p, dt)
        return SimState(*out, state.step + 1, state.sim_time + dt)

    def leapfrog_step(state: SimState) -> SimState:
        """Kick-drift-kick; collisions resolve at the first kick."""
        acc, (pos2, vel2, mass2, radius2), dt = collide(state)
        v_half, new_pos = half_kick_drift(pos2, vel2, acc.force, p, dt)
        acc2 = accum_fn(new_pos, v_half, mass2, radius2)
        out = finish_leapfrog(pos2, new_pos, v_half, mass2, radius2,
                              acc2.force, p, dt)
        return SimState(*out, state.step + 1, state.sim_time + dt)

    def yoshida_step(state: SimState) -> SimState:
        """4th-order composition; collisions resolve at the first kick."""
        acc, (pos2, vel2, mass2, radius2), dt = collide(state)
        out = yoshida4_tail(pos2, vel2, mass2, radius2, acc.force, accum_fn,
                            p, dt)
        return SimState(*out, state.step + 1, state.sim_time + dt)

    return {"euler": euler_step, "leapfrog": leapfrog_step,
            "yoshida4": yoshida_step}[p.integrator]
