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
           "from_numpy"]


class SimState(NamedTuple):
    """Body state as tensors on one device.

    pos:      f32[N, 2]  positions (field coordinates, origin-centred)
    vel:      f32[N, 2]  velocities
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
