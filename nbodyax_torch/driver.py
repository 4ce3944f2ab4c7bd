"""Simulation driver: scene, step loop, frames, logs, ``Time taken``.

Counterpart of ``nbodyax/driver.py`` for what the port runs so far. The
state stays on one device; each step is one call of the step function in a
plain Python loop (PyTorch queues the kernels asynchronously, so the loop
does not wait on the device); a frame renders on the device every k-th step
and a background thread writes it; the meter and the JSONL log run at
``logEvery``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from nbodyax_torch.backends import build_accum_fn
from nbodyax_torch.config import SimConfig
from nbodyax_torch.metrics import (JsonlLogger, StepMeter, conservation_vec,
                                   scalars_from_vec)
from nbodyax_torch.physics.step import PhysicsParams, make_step
from nbodyax_torch.render import FrameWriter, render_state
from nbodyax_torch.scenes import init_scene
from nbodyax_torch.state import SimState

__all__ = ["run_simulation", "RunResult", "resolve_device"]


@dataclass
class RunResult:
    state: SimState
    steps_per_sec: float
    pairs_per_sec: float
    wall_seconds: float
    frames_written: int


def _check_supported(cfg: SimConfig) -> None:
    """Raise on the config values the port does not run yet."""
    todo = [
        (cfg.checkpoint_every > 0, "checkpointEvery > 0", "A8"),
        (bool(cfg.resume_from), "resumeFrom", "A8"),
        (cfg.compact_every > 0, "compactEvery > 0", "A8"),
        (cfg.energy_every > 0, "energyEvery > 0", "A8"),
        (cfg.force_model == "bh", "forceModel=bh", "A10"),
        (cfg.shards > 1, "shards > 1", "A11"),
        (cfg.dimensions == 3, "dimensions=3", "A5"),
    ]
    for unsupported, what, item in todo:
        if unsupported:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP item {item})")


def resolve_device(device) -> torch.device:
    """The device to run on. Asking for CUDA without a card is an error."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asks for CUDA, but no CUDA "
                           "device is available")
    return dev


def run_simulation(cfg: SimConfig, *, device="cuda",
                   quiet: bool = False) -> RunResult:
    """Run ``cfg`` to ``totalIterations`` on ``device``."""
    t_start = time.perf_counter()
    _check_supported(cfg)
    dev = resolve_device(device)
    state = init_scene(cfg, device=dev)
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn(cfg.backend, p, dev))
    meter = StepMeter(state.capacity, dev)
    k_img = (cfg.save_image_every
             if cfg.save_images and cfg.save_image_every > 0 else 0)
    writer = FrameWriter(cfg.image_path) if k_img else None
    logger = JsonlLogger(cfg.log_path, echo=not quiet)
    frames = 0
    try:
        window = 0
        meter.start()
        for it in range(state.step, cfg.total_iterations):
            state = step(state)
            window += 1
            if k_img and it % k_img == 0:
                # frame iteration_j holds the state after 0-based step j
                writer.submit(it, render_state(state, cfg))
                frames += 1
            done = it + 1
            log_due = cfg.log_every and done % cfg.log_every == 0
            if not (log_due or done == cfg.total_iterations):
                continue
            win_wall = meter.stop(window)
            if log_due:
                scal = scalars_from_vec(conservation_vec(state).cpu())
                logger.log(step=done, wall_ms=win_wall / window * 1e3,
                           steps_per_sec=meter.steps_per_sec,
                           force_model=cfg.force_model,
                           pairs_per_sec=meter.pairs_per_sec, **scal)
            window = 0
            meter.start()
    finally:
        if writer is not None:
            writer.close()
        logger.close()

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start
    if not quiet:
        print(f"Time taken: {wall:.4f}")  # the reference's final line
    return RunResult(state=state, steps_per_sec=meter.steps_per_sec,
                     pairs_per_sec=meter.pairs_per_sec, wall_seconds=wall,
                     frames_written=frames)
