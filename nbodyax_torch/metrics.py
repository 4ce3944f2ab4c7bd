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

__all__ = ["conservation_vec", "scalars_from_vec", "StepMeter",
           "JsonlLogger"]


def conservation_vec(state: SimState) -> torch.Tensor:
    """f32[6] on the state's device: alive count, total mass, kinetic
    energy, momentum x and y, simulated time. One tensor, so a log point
    costs one host copy."""
    alive = state.mass > 0
    m = torch.where(alive, state.mass, torch.zeros_like(state.mass))
    mom = (m[:, None] * state.vel).sum(0)
    ke = 0.5 * (m * (state.vel * state.vel).sum(1)).sum()
    return torch.cat([torch.stack([alive.sum().to(torch.float32), m.sum(),
                                   ke]), mom, state.sim_time.reshape(1)])


def scalars_from_vec(v) -> dict:
    """Unpack a fetched ``conservation_vec`` into the log fields."""
    v = np.asarray(v, dtype=np.float64)
    return {"alive": int(v[0]), "total_mass": v[1], "momentum_x": v[3],
            "momentum_y": v[4], "kinetic_energy": v[2], "sim_time": v[5]}


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
