"""Simulation state.

Counterpart of ``nbodyax/state.py``: a fixed-capacity set of float32 tensors
that stays on one device for the whole run. A dead body keeps its slot with
``mass == 0``, the reference kernel's in-band death marker, and is masked
out of the physics and the rendering, so shapes never change as bodies
merge.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SimState", "make_state", "alive_mask", "alive_count", "to_numpy",
           "from_numpy", "compact_state", "shrink_due", "MIN_CAPACITY",
           "SLACK"]

# ``compact_state``'s bucket: the power of 2 above the live count times
# SLACK, and never below MIN_CAPACITY (nbodyax's defaults)
MIN_CAPACITY = 256
SLACK = 1.25


class SimState(NamedTuple):
    """Body state as tensors on one device.

    pos:      f32[N, D]  positions (field coordinates, origin-centred), D = 2
                         or 3
    vel:      f32[N, D]  velocities
    mass:     f32[N]     masses; 0 marks a dead slot
    radius:   f32[N]     radii
    step:     int        completed step count (host-side)
    sim_time: f32[]      simulated time, the f32 sum of every step's dt
    """

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    radius: torch.Tensor
    step: int
    sim_time: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def make_state(pos, vel, mass, radius, step: int = 0, sim_time: float = 0.0,
               *, device: torch.device | str) -> SimState:
    """Build a SimState on ``device`` from numpy arrays or tensors."""
    return SimState(pos=_f32(pos, device), vel=_f32(vel, device),
                    mass=_f32(mass, device), radius=_f32(radius, device),
                    step=int(step),
                    sim_time=_f32(np.float32(sim_time), device))


def alive_mask(state: SimState) -> torch.Tensor:
    """bool[N]: which slots hold live bodies."""
    return state.mass > 0


def alive_count(state: SimState) -> int:
    return int(alive_mask(state).sum())


def to_numpy(state: SimState) -> dict:
    """Host copies of every field, keyed and typed like
    ``nbodyax.state.to_numpy`` (step as a 0-d int32 array)."""
    return {"pos": state.pos.cpu().numpy(), "vel": state.vel.cpu().numpy(),
            "mass": state.mass.cpu().numpy(),
            "radius": state.radius.cpu().numpy(),
            "step": np.asarray(state.step, np.int32),
            "sim_time": state.sim_time.cpu().numpy()}


def from_numpy(d: dict, device) -> SimState:
    """The inverse of ``to_numpy``; also takes exactly what
    ``nbodyax.state.to_numpy`` returns, to carry a JAX state across."""
    return make_state(d["pos"], d["vel"], d["mass"], d["radius"],
                      step=int(np.asarray(d["step"])),
                      sim_time=float(np.asarray(d.get("sim_time", 0.0))),
                      device=device)


def _bucket(n_alive: int) -> int:
    """The capacity ``compact_state`` picks for ``n_alive`` live bodies:
    nbodyax's numpy expression, so the two packages never pick different
    sizes."""
    return max(MIN_CAPACITY,
               1 << int(np.ceil(np.log2(max(1, n_alive) * SLACK))))


def shrink_due(n_alive: int, capacity: int) -> bool:
    """The driver's merger-phase trigger, nbodyax's: compact as soon as
    ``compact_state`` would at least halve a power-of-2 ``capacity``, i.e.
    ``n_alive * 2 * SLACK <= capacity`` above MIN_CAPACITY."""
    return n_alive * 2 * SLACK <= capacity and capacity > MIN_CAPACITY


def compact_state(state: SimState) -> SimState:
    """Shrink the capacity to the power-of-2 bucket above the live count.

    Counterpart of ``nbodyax.state.compact_state`` at its defaults: the
    bucket is ``max(MIN_CAPACITY, 1 << ceil(log2(alive * SLACK)))``.
    Survivors keep their order, and the slots past them are zero. Returns
    the input itself when no smaller bucket fits. The gather runs on the
    state's device; only the live count is read to the host.
    """
    alive = state.mass > 0
    new_cap = _bucket(int(alive.sum()))
    if new_cap >= state.capacity:
        return state
    take = torch.nonzero(alive).squeeze(1)[:new_cap]

    def gather(x):
        out = x.new_zeros((new_cap,) + tuple(x.shape[1:]))
        out[:take.shape[0]] = x[take]
        return out

    return SimState(gather(state.pos), gather(state.vel),
                    gather(state.mass), gather(state.radius), state.step,
                    state.sim_time.clone())
