"""Conservation scalars, the step meter and JSONL logging.

Counterpart of ``nbodyax/metrics.py``. ``StepMeter`` times on the device's
own clock: CUDA events on a card, the host clock on the CPU.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

import numpy as np
import torch

from nbodyax_torch.state import SimState

__all__ = ["conservation_vec", "scalars_from_vec", "conservation_scalars",
           "potential_energy", "StepMeter", "JsonlLogger"]

GRAV_CONSTANT = float(np.float32(6.67408e-11))


def conservation_vec(state: SimState) -> torch.Tensor:
    """f32[4 + D] on the state's device: alive count, total mass, kinetic
    energy, momentum x, y (and z in 3-D), simulated time. One tensor, so a
    log point costs one host copy."""
    alive = state.mass > 0
    m = torch.where(alive, state.mass, torch.zeros_like(state.mass))
    mom = (m[:, None] * state.vel).sum(0)
    ke = 0.5 * (m * (state.vel * state.vel).sum(1)).sum()
    return torch.cat([torch.stack([alive.sum().to(torch.float32), m.sum(),
                                   ke]), mom, state.sim_time.reshape(1)])


def scalars_from_vec(v, dim: int) -> dict:
    """Unpack a fetched ``conservation_vec`` of a ``dim``-D state into the
    log fields (``nbodyax.metrics.scalars_from_vec``'s)."""
    v = np.asarray(v, dtype=np.float64)
    out = {"alive": int(v[0]), "total_mass": v[1], "momentum_x": v[3],
           "momentum_y": v[4], "kinetic_energy": v[2]}
    if dim == 3:
        out["momentum_z"] = v[5]
    out["sim_time"] = v[-1]
    return out


def conservation_scalars(state: SimState) -> dict:
    """Alive count, total mass, momentum, kinetic energy and simulated time
    of ``state`` (``nbodyax.metrics.conservation_scalars``'s keys), from
    one host copy of ``conservation_vec``. The alive count rides the f32
    vector: exact below 2^24 live bodies."""
    return scalars_from_vec(conservation_vec(state).cpu(),
                            state.vel.shape[-1])


def potential_energy(state: SimState, eps: float = 0.0) -> torch.Tensor:
    """The O(N^2) pair potential -G * sum_{i<j} m_i m_j / sqrt(d^2 + eps^2)
    of live pairs, a 0-d f32 tensor on the state's device: the counterpart
    of ``nbodyax.metrics.potential_energy`` (plain array ops there too),
    in any dimension. Rows go in chunks of (1 << 22) // N, at least 8, so a
    chunk's pair temporaries stay near 2^22 elements; each chunk's sum is
    added in chunk order. No host read."""
    pos, mass = state.pos, state.mass
    n = pos.shape[0]
    chunk = max(8, min(n, (1 << 22) // max(n, 1)))
    eps32 = np.float32(eps)
    eps2 = float(eps32 * eps32)
    idx = torch.arange(n, device=pos.device)
    parts = []
    for s in range(0, n, chunk):
        pi, mi, ii = pos[s:s + chunk], mass[s:s + chunk], idx[s:s + chunk]
        dp = pos[None, :, :] - pi[:, None, :]
        d2 = (dp * dp).sum(-1) + eps2
        valid = ((mi[:, None] > 0) & (mass[None, :] > 0)
                 & (ii[:, None] != idx[None, :]) & (d2 > 0))
        inv = torch.where(valid, torch.rsqrt(torch.where(valid, d2, 1.0)),
                          0.0)
        parts.append((mi[:, None] * mass[None, :] * inv).sum())
    return -0.5 * GRAV_CONSTANT * torch.stack(parts).sum()


class StepMeter:
    """Elapsed time and throughput over metered windows of steps.

    Pairs are counted as capacity^2 a step, the work the all-pairs pass
    does, dead slots included. On a CUDA device ``start``/``stop`` record
    events on the current stream and ``stop`` waits for the end event, so
    the time is the device's; on the CPU it is the host clock.
    """

    def __init__(self, capacity: int, device: torch.device):
        self.capacity = capacity
        self.cuda = torch.device(device).type == "cuda"
        self.steps = 0
        self.pairs = 0.0
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, steps: int = 1) -> float:
        """Close the window opened by ``start``; returns its seconds."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self.steps += steps
        self.pairs += steps * float(self.capacity) ** 2
        self.elapsed += dt
        return dt

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.pairs / self.elapsed if self.elapsed else 0.0


class JsonlLogger:
    """One JSON object per line, to stdout and/or a file."""

    def __init__(self, path: str = "", echo: bool = True):
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self._fh: Optional[IO] = open(path, "a") if path else None
        self._echo = echo

    def log(self, **record):
        def scalar(v):
            if isinstance(v, torch.Tensor):
                return v.item()
            if isinstance(v, (np.ndarray, np.generic)):
                return np.asarray(v).item()
            return v
        line = json.dumps({k: scalar(v) for k, v in record.items()})
        if self._echo:
            print(line)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
