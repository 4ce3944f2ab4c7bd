"""Simulation driver: scene, step loop, frames, logs, ``Time taken``.

Counterpart of ``nbodyax/driver.py`` for what the port runs so far. The
state stays on one device; each step is one call of the step function in a
plain Python loop (PyTorch queues the kernels asynchronously, so the loop
does not wait on the device); a frame renders on the device every k-th step
and a background thread writes it; the meter and the JSONL log run at
``logEvery``.

``forceModel=bh``: ``resolve_bh_config`` resolves the auto knobs against
the starting state (``pick_levels``), each log point reads ``bh_health``
(logged as ``bh_overflow`` and ``bh_giant_excess``, with the pair rate
labelled ``equivalent_pairs_per_sec``), and ``bhAdapt`` retunes the knobs
between windows with nbodyax's ladder. A window ends at a log point, or
after ``DRIFT_WINDOW_STEPS`` steps while the run is merging fast. Torch has
nothing to recompile, so an adapt only builds a new accum_fn; nbodyax's
wall-clock window clips and checkpoint knob metadata (its TPU-relay
workarounds, ROADMAP A8) have no counterpart.
"""

from __future__ import annotations

import dataclasses
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

__all__ = ["run_simulation", "RunResult", "resolve_device",
           "resolve_bh_config"]

DRIFT_WINDOW_STEPS = 16     # window length while the run merges fast
DRIFT_ALIVE_FRAC = 0.005    # probe when alive fell >0.5% since the last one
DRIFT_K_HEADROOM = 1.5      # widen K past the measured need while drifting


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
        (cfg.shards > 1, "shards > 1", "A11"),
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


def resolve_bh_config(cfg: SimConfig, state: SimState,
                      quiet: bool = True) -> SimConfig:
    """Resolve the ``forceModel=bh`` auto knobs (bhLevels, bhNear,
    bhNeighborK, bhCompCap) against the starting ``state``, density-aware
    (``pick_levels``), preferring the slots engine where its kernels run
    (``bhPallas`` resolving to the kernels on the state's device) or from
    1.5M bodies. Idempotent on resolved configs; other configs pass
    through."""
    if cfg.force_model != "bh":
        return cfg
    from nbodyax_torch.physics.barneshut import (_SLOTS_PREFERRED_N,
                                                 auto_neighbor_k, pick_levels,
                                                 resolve_near_kernel)
    if cfg.bh_levels == 0 or cfg.bh_near == "auto":
        prefer_slots = (resolve_near_kernel(cfg.bh_pallas, "slots",
                                            state.pos.device)
                        or state.capacity >= _SLOTS_PREFERRED_N)
        lv, near, kk, comp = pick_levels(
            state.pos, state.mass, neighbor_k=cfg.bh_neighbor_k,
            ring=cfg.bh_ring, near=cfg.bh_near, levels=cfg.bh_levels,
            prefer_slots=prefer_slots)
        cfg = dataclasses.replace(
            cfg, bh_near=near, bh_levels=cfg.bh_levels or lv,
            bh_neighbor_k=kk, bh_comp_cap=cfg.bh_comp_cap or comp)
        if not quiet:
            print(f"bh auto-selected: bhLevels={cfg.bh_levels} "
                  f"bhNear={cfg.bh_near} bhNeighborK={kk}"
                  + (f" bhCompCap={cfg.bh_comp_cap}"
                     if cfg.bh_comp_cap else ""))
    if cfg.bh_neighbor_k == 0:
        cfg = dataclasses.replace(cfg, bh_neighbor_k=auto_neighbor_k(
            state.capacity, cfg.bh_levels, cfg.bh_ring, cfg.dimensions,
            cfg.bh_near))
        if not quiet:
            print(f"bhNeighborK auto-selected: {cfg.bh_neighbor_k}")
    return cfg


class _BhProbe:
    """The log-point ``bh_health`` read and nbodyax's ``bhAdapt`` response
    ladder (nbodyax/driver.py:486-673): widen bhNeighborK to the measured
    minimal cap on persistent partner-cap overflow (with headroom while the
    run merges), refine bhLevels or widen bhCompCap on completion-budget
    overflow, and coarsen bhLevels when grown radii outrun the ring (only
    with bhGiants=0). ``probe`` returns the health vector and the new
    config."""

    def __init__(self, alive_now: float):
        self.prev_overflow = 0.0
        self.prev_dropped = 0.0
        self.last_probe_alive = alive_now
        self.drift_mode = False

    def dropping(self, alive_now: float) -> bool:
        return alive_now < self.last_probe_alive * (1.0 - DRIFT_ALIVE_FRAC)

    def probe(self, cfg: SimConfig, s: SimState, alive_now: float,
              at_step: int, quiet: bool):
        from nbodyax_torch.physics.barneshut import (auto_neighbor_k,
                                                     bh_health, slot_cap)
        h = bh_health(s.pos, s.mass, s.radius, levels=cfg.bh_levels,
                      neighbor_k=cfg.bh_neighbor_k, ring=cfg.bh_ring,
                      near=cfg.bh_near, comp_cap=cfg.bh_comp_cap,
                      n_giants=cfg.bh_giants).tolist()
        dropping = self.dropping(alive_now)
        self.last_probe_alive = alive_now
        if not cfg.bh_adapt:
            return h, cfg
        new = {}
        cap_n = s.capacity
        noise = max(64.0, 1e-3 * alive_now)
        persistent = h[0] > noise or (h[0] > 0 and self.prev_overflow > 0)
        self.prev_overflow = h[0]
        if persistent:
            eff = cfg.bh_neighbor_k
            if cfg.bh_near == "slots":
                eff = max(eff, slot_cap(cap_n, (1 << cfg.bh_levels)
                                        ** cfg.dimensions))
            want = int(h[4])
            if dropping or h[0] > noise:
                want = int(want * DRIFT_K_HEADROOM)
            # the slot grid holds cells * max(K, slot_cap) rows: bound it
            k_budget = max(40, 8 * ((64 * (1 << 20)
                           >> (cfg.dimensions * cfg.bh_levels)) // 8))
            need = min(1024, k_budget, 8 * -(-want // 8))
            if eff < need:
                new["bh_neighbor_k"] = need
        cell = h[3] / (1 << cfg.bh_levels)
        max_adapt_lv = 7 if cfg.dimensions == 3 else 10
        occ_next = alive_now / (1 << (cfg.dimensions * (cfg.bh_levels - 1)))
        if (not cfg.bh_giants and 2.0 * h[2] > cfg.bh_ring * cell
                and cfg.bh_levels > 2 and occ_next * 2.5 <= 1024):
            new["bh_levels"] = cfg.bh_levels - 1
        elif ((h[1] > noise or (h[1] > 0 and self.prev_dropped > 0))
                and "bh_neighbor_k" not in new):
            pop = int(h[5])
            need_comp = min(cap_n, 1024 * -(-(pop + pop // 8) // 1024))
            default_comp = min(cap_n, max(1024, cap_n // 16))
            cells_f = 1 << (cfg.dimensions * (cfg.bh_levels + 1))
            k_f = auto_neighbor_k(cap_n, cfg.bh_levels + 1, cfg.bh_ring,
                                  cfg.dimensions, cfg.bh_near)
            refine_fits = (cells_f * max(k_f, slot_cap(cap_n, cells_f))
                           <= 64 * (1 << 20))
            need_drift = min(cap_n, 1024 * -(-(2 * pop) // 1024))
            if cfg.bh_comp_cap and need_comp <= default_comp:
                new["bh_comp_cap"] = need_comp
            elif (refine_fits and cfg.bh_levels < max_adapt_lv
                  and pop > cap_n // 8):
                new["bh_levels"] = cfg.bh_levels + 1
                new["bh_neighbor_k"] = k_f
            elif (dropping or self.drift_mode) and need_drift <= cap_n // 4:
                new["bh_comp_cap"] = need_drift
            elif cfg.bh_levels < max_adapt_lv and refine_fits:
                new["bh_levels"] = cfg.bh_levels + 1
                new["bh_neighbor_k"] = k_f
            elif need_comp > (cfg.bh_comp_cap or default_comp):
                new["bh_comp_cap"] = need_comp
        self.prev_dropped = h[1]
        if new:
            cfg = dataclasses.replace(cfg, **new)
            if not quiet:
                print(f"bh adapt at step {at_step}: {new}")
        self.drift_mode = bool(dropping or (h[0] + h[1]) > 0)
        return h, cfg


def run_simulation(cfg: SimConfig, *, device="cuda",
                   quiet: bool = False) -> RunResult:
    """Run ``cfg`` to ``totalIterations`` on ``device``."""
    t_start = time.perf_counter()
    _check_supported(cfg)
    dev = resolve_device(device)
    state = init_scene(cfg, device=dev)
    cfg = resolve_bh_config(cfg, state, quiet=quiet)
    bh = cfg.force_model == "bh"

    def build_step(c: SimConfig):
        p = PhysicsParams.from_config(c)
        return make_step(p, accum_fn=build_accum_fn(c.backend, p, dev, c))

    step = build_step(cfg)
    meter = StepMeter(state.capacity, dev)
    k_img = (cfg.save_image_every
             if cfg.save_images and cfg.save_image_every > 0 else 0)
    writer = FrameWriter(cfg.image_path) if k_img else None
    logger = JsonlLogger(cfg.log_path, echo=not quiet)
    # without bhAdapt the probe only reads bh_health and never drifts
    probe = _BhProbe(float((state.mass > 0).sum())) if bh else None
    pairs_key = "equivalent_pairs_per_sec" if bh else "pairs_per_sec"
    frames = 0
    try:
        window = since_boundary = 0
        meter.start()
        for it in range(state.step, cfg.total_iterations):
            state = step(state)
            window += 1
            since_boundary += 1
            if k_img and it % k_img == 0:
                # frame iteration_j holds the state after 0-based step j
                writer.submit(it, render_state(state, cfg))
                frames += 1
            done = it + 1
            log_due = cfg.log_every and done % cfg.log_every == 0
            if (probe is not None and probe.drift_mode and not log_due
                    and done < cfg.total_iterations
                    and since_boundary >= DRIFT_WINDOW_STEPS):
                # a drift window's end: probe while the run merges fast
                since_boundary = 0
                alive_now = float((state.mass > 0).sum())
                _, new_cfg = probe.probe(cfg, state, alive_now, done, quiet)
                if new_cfg is not cfg:
                    cfg, step = new_cfg, build_step(new_cfg)
            if not (log_due or done == cfg.total_iterations):
                continue
            since_boundary = 0
            win_wall = meter.stop(window)
            if log_due:
                scal = scalars_from_vec(conservation_vec(state).cpu(),
                                        cfg.dimensions)
                if probe is not None:
                    h, new_cfg = probe.probe(cfg, state, scal["alive"], done,
                                             quiet)
                    if new_cfg is not cfg:
                        cfg, step = new_cfg, build_step(new_cfg)
                    scal["bh_overflow"] = int(h[0] + h[1])
                    scal["bh_giant_excess"] = int(h[6])
                logger.log(step=done, wall_ms=win_wall / window * 1e3,
                           steps_per_sec=meter.steps_per_sec,
                           force_model=cfg.force_model,
                           **{pairs_key: meter.pairs_per_sec}, **scal)
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
