"""Simulation driver: scene, windowed step loop, frames, logs, checkpoints,
compaction, recovery and ``Time taken``.

Counterpart of ``nbodyax/driver.py``. The state stays on one device, or
with ``shards > 1`` is split over the ranks of a ``torch.distributed``
launch (below). The host touch-points (log, checkpoint, compaction and
energy points, the end of the run, and from a frame-misaligned start the
next frame boundary) cut the run into windows (``_Schedule``, nbodyax's
``next_window``), and each window runs as one unit:

- **CUDA** (``_GraphWindows``; under shards ``_ShardedGraphWindows``),
  the exact path and ``forceModel=bh``: a
  window is one replay of a captured ``torch.cuda.CUDAGraph``. The
  recurring window size (the stride) has its own graph, which also renders
  the window's frames into a static uint8 buffer and computes the
  conservation vector; a window of any other size, and every bh window,
  replays a one-step graph k times and renders its frames between
  replays. Every graph ends by copying its final state into the static
  buffers it starts from, so replays chain with no Python between them.
  The bh step reads nothing back to the host: its data-dependent budgets
  are CUDA-graph IF nodes (``physics/graph_if.py``), whose bodies the
  warm-up runs once each. A
  capture that fails raises ``GraphCaptureError``: there is no fallback.
- **CPU and the private ``_eager`` switch** (``_EagerWindows``): the step
  runs k times from Python, and a frame renders after each due step; the
  bh tiers decide on their predicates' values (nbodyax's ``_host_loop``).

A window's conservation vector is fetched once, at its end: the fetch is
the window's fence and the log line's payload. Checkpoints, compaction and
bh probes all run after that fence, between windows, so the capacity never
changes inside a window. ``StepMeter`` times each window on the device's
clock, and a log line's ``wall_ms`` is that window's time a step: the graph
a window replays is captured before its meter starts (``prepare``), so the
meter times replays only.
``adaptiveDt`` adds ``dt_mean`` (the mean dt since the last log line) and
``energyEvery`` the O(N^2) ``potential_energy`` and ``total_energy`` at its
cadence, with nbodyax's names. ``debug_nans`` tests each window's outputs
for NaN after its fence and, on a hit, re-runs the window eagerly a step at
a time to name the first step (``FloatingPointError``).

**Spans and counters** (``tracing.Recorder``, one an attempt): the run's
parts are spans (``run``, ``scene``, ``knobs``, ``runner``, ``window`` with
``capture`` inside it, ``frames``, ``probe``, ``log``, ``checkpoint``,
``compaction``, ``graph_free``), whose self seconds become
``RunResult.seconds``, and its counters (windows, replays, captures,
probes, adapts, ...) ``RunResult.counts``, with the pair kernel's
cold-path counter read once at the end (``b1_cold_subtiles`` of
``b1_subtiles``; ``physics.kernels.cold_counts``) and the bh annulus
kernel's launches in the run (``annulus_launches``, a graph's by its
replays, as ``graphs.add_counts`` counts them). Under a
``torch.profiler`` (the CLI's ``--profile``) each span is also a host
event ``nbodyax.<span>``.

**Checkpoints** (``checkpointEvery``; ``io/checkpoint.py``'s files, which
both packages read) carry the resolved bh knobs (``_bh_ck_extra``), and a
resume adopts them into the knobs the user left auto
(``_adopt_ck_knobs``): the knobs are the product of the probes and adapts
of the run so far, which a fresh ``pick_levels`` on the resumed state
would not repeat, so a resumed bh run steps with the knobs the straight run
had and can match it bit for bit. With ``autoResume`` the starting state is
saved too, and while the bh probe sees the run merging fast the cadence
tightens to ``max(8, checkpointEvery // 4)``.

**Compaction** (``compactEvery``, and at any window's end where the live
count guarantees a halving) gathers the survivors into the next
power-of-2 bucket (``state.compact_state``). A new capacity rebuilds the
step (``build_step``), re-resolves the bh knobs the user left auto, and on
the graph path replaces the runner: the frame writer is drained, every old
graph and static buffer is dropped (freeing the graphs' private memory
pools), and the graphs are captured again at the new size on first use.

**Recovery** (``run_simulation``): with ``autoResume`` and
``checkpointEvery`` a ``RuntimeError`` reloads the latest checkpoint and
runs again, up to ``maxRetries`` times. A frame-write, kernel-build or
graph-capture failure and a ``NotImplementedError`` are raised at once:
reloading a checkpoint mends none of them. A sticky CUDA error (an illegal
address) poisons the process's context, so its retries fail too and the
last one surfaces; restarting the process with ``--resume auto`` is the
recourse.

**Shards** (``shards > 1``, nbodyax/driver.py:144-167, :299-304): one
process a shard, under ``torch.distributed.run`` (``sharding.make_group``:
the world size must be the shard count). Every rank builds the same whole
state (scene or checkpoint), pads it to a multiple of the shard count and
keeps its rows; the step is the exact ring or the cell-range bh step
(``build_step``). On cards a window is one replay of a CUDA graph that
holds the NCCL collectives (``_ShardedGraphWindows``, nbodyax's one
dispatch a window); on the CPU (gloo) and under ``_eager`` it runs step by
step (``_ShardedWindows``). Every decision the ranks must share (the
window schedule, log and probe points, bhAdapt's knobs, compaction,
``debug_nans``, and with them each capture) is taken on the whole state,
which every rank gathers at each window's end, so all ranks take the same
collectives in the same order. The group's timeout does not cover a
replay (NCCL's watchdog does not track one): a rank that fails aborts its
NCCL group on its way out (``sharding.close_group``, from the CLI) and
exits, and torchrun ends its peers. Rank 0 alone prints, logs, profiles
and writes frames and checkpoints. autoResume cannot retry in the
process: a failed rank breaks the process group. So a sharded autoResume
run is launched with torchrun's ``--max-restarts`` of at least
``maxRetries`` (else ``ValueError``), a failure is raised, torchrun
relaunches every rank, and each relaunched rank resumes from the latest
checkpoint (``_relaunch_resume``), as ``--resume auto`` would; the
starting state is checkpointed as on one card. What one card does not retry (a failure that is no
``RuntimeError``, or one of ``_NOT_RETRIED``) is not retried here either:
the failing rank leaves a mark beside the checkpoints, and the relaunched
ranks raise ``RelaunchRefused`` before they run. On several hosts
``checkpointPath`` must be one that every rank reads.

``forceModel=bh``: ``resolve_bh_config`` resolves the auto knobs against
the starting state (``pick_levels``), each log point reads ``bh_health``
(logged as ``bh_overflow`` and ``bh_giant_excess``, with the pair rate
labelled ``equivalent_pairs_per_sec``), and ``bhAdapt`` retunes the knobs
between windows with nbodyax's ladder. With ``bhAdapt`` a probe also runs
after every window that ends off the log cadence while the run merges
(drift mode) or once the live count fell by more than ``DRIFT_ALIVE_FRAC``
since the last probe, and in drift mode a window is at most
``DRIFT_WINDOW_STEPS`` long (nbodyax/driver.py:694-697, :728-738).
An adapt builds a new step; on a card the runner goes with its graphs, as
after a compaction, and the new step is captured at its first window.
A bh run at a capacity of ``BOOTSTRAP_MIN_CAPACITY`` or more takes a
first window of at most ``BOOTSTRAP_WINDOW_STEPS`` at its start, its
resume and after each compaction that changes the capacity, as nbodyax's
bootstrap window does (nbodyax/driver.py:689-691, :846), and while it
drifts its windows are ``SCALE_DRIFT_WINDOW_STEPS`` (1) long, so it probes
after every step of a merger. nbodyax gets that cadence from its
wall-clock clip (``MAX_WINDOW_SECONDS`` = 75 s over the last window's
seconds a step, nbodyax/driver.py:692-693): its merger steps at 4M took
about a minute each (:781), so it probed almost every step. The port
keeps the cadence and not the clock, which would make the physics depend
on the card's speed. With 16-step windows a 4M galaxy on an H100 dropped
merges between probes and gained 5.5% of its mass by step 50 (PERF.md).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from nbodyax_torch.backends import build_accum_fn
from nbodyax_torch.config import SimConfig
from nbodyax_torch.graphs import GraphCaptureError, add_counts, capture
from nbodyax_torch.io.checkpoint import (latest_checkpoint, load_checkpoint,
                                         load_checkpoint_extra,
                                         save_checkpoint)
from nbodyax_torch.metrics import (JsonlLogger, StepMeter, conservation_vec,
                                   potential_energy, scalars_from_vec)
from nbodyax_torch.physics import graph_if
from nbodyax_torch.physics._build import KernelCompileError
from nbodyax_torch.physics.annulus_kernel import annulus_cells
from nbodyax_torch.physics.kernels import cold_counts, reset_cold_counts
from nbodyax_torch.physics.step import PhysicsParams, make_step
from nbodyax_torch.render import FrameWriteError, FrameWriter, render_state
from nbodyax_torch.scenes import init_scene
from nbodyax_torch.state import (SimState, compact_state, make_state,
                                 shrink_due)
from nbodyax_torch.tracing import Recorder

__all__ = ["run_simulation", "RunResult", "resolve_device",
           "resolve_bh_config", "build_step", "GraphCaptureError"]

BOOTSTRAP_WINDOW_STEPS = 8   # first window of a fresh or rebuilt bh run
BOOTSTRAP_MIN_CAPACITY = 1 << 20   # ... at this capacity or more
DRIFT_WINDOW_STEPS = 16     # window length while the run merges fast
SCALE_DRIFT_WINDOW_STEPS = 1   # ... at BOOTSTRAP_MIN_CAPACITY or more
DRIFT_ALIVE_FRAC = 0.005    # probe when alive fell >0.5% since the last one
DRIFT_K_HEADROOM = 1.5      # widen K past the measured need while drifting


@dataclass
class RunResult:
    state: SimState
    steps_per_sec: float
    pairs_per_sec: float
    wall_seconds: float
    frames_written: int
    windows: int = 0        # windows run (``counts["windows"]``)
    # host seconds of the run's parts, each span's self time (``tracing``):
    # run (the rest), scene (draw or checkpoint load), knobs (bh knob
    # resolution), runner (step build and runner), windows (the steps, to
    # each window's fence), capture (graph warm-ups and captures), frames
    # (queueing and the writer's drain), probe (bh_health and the adapt
    # ladder), log (scalars, energy, the log line), checkpoints, compaction
    # (the gather and its decisions), graph_free (graphs and pools let go)
    seconds: dict = dataclasses.field(default_factory=dict)
    # the run's counters (``tracing``): windows, one_step_windows, replays,
    # captures, graphs_freed, probes, adapts, compactions, checkpoints; and
    # the pair kernel's warp sub-tiles that took its cold path
    # (b1_cold_subtiles) of those it walked (b1_subtiles), 0 off a card;
    # the bh annulus kernel's launches (annulus_launches), 0 off a card
    counts: dict = dataclasses.field(default_factory=dict)
    # capacity after each compaction that changed it: [(step, capacity)]
    capacities: list = dataclasses.field(default_factory=list)
    shards: int = 1         # ranks the bodies were sharded over


# failures that reloading a checkpoint cannot mend: raised at once (a
# ``debug_nans`` hit, FloatingPointError, is no RuntimeError either)
_NOT_RETRIED = (FrameWriteError, NotImplementedError, KernelCompileError,
                GraphCaptureError, FloatingPointError)

# under shards, the file beside the checkpoints that tells a relaunched
# attempt the failure before it is not retried (``_mark_not_retried``)
_NOT_RETRIED_MARK = "not_retried.txt"


class RelaunchRefused(RuntimeError):
    """A relaunched sharded attempt found that the attempt before it failed
    in a way one card does not retry: it raises this instead of resuming."""

# the fields ``debug_nans`` checks after each window, in its message's terms
_NAN_FIELDS = ("pos", "vel", "mass", "radius", "conservation vec")


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


def build_step(cfg: SimConfig, device, group=None):
    """The step function of ``cfg`` on ``device``: physics params and the
    accumulator engine its backend and force model select. With
    ``shards > 1`` it is the sharded step on this rank's rows (the exact
    ring, or the cell-range bh step) of ``group`` (``make_group``'s by
    default); so it is with a ``group`` of one rank."""
    p = PhysicsParams.from_config(cfg)
    if cfg.shards > 1 or group is not None:
        from nbodyax_torch.sharding import (make_group, make_sharded_bh_step,
                                            make_sharded_step)
        group = group or make_group(cfg.shards, device)
        if cfg.force_model == "bh":
            return make_sharded_bh_step(cfg, p, group)
        return make_sharded_step(cfg, p, group)
    return make_step(p, accum_fn=build_accum_fn(cfg.backend, p, device, cfg))


def _bh_ck_extra(cfg: SimConfig):
    """Checkpoint metadata: the current (resolved or adapted) bh knobs."""
    if cfg.force_model != "bh":
        return None
    return {"bh_levels": cfg.bh_levels,
            "bh_neighbor_k": cfg.bh_neighbor_k,
            "bh_comp_cap": cfg.bh_comp_cap,
            "bh_near_slots": 1 if cfg.bh_near == "slots" else 0}


def _adopt_ck_knobs(cfg: SimConfig, path: str, quiet: bool = True):
    """Adopt a checkpoint's saved bh knobs into the user-auto fields of
    ``cfg``, so a resumed run steps with the knobs the interrupted one had
    reached (see the module docstring). Pinned knobs are never
    overridden."""
    if cfg.force_model != "bh":
        return cfg
    meta = load_checkpoint_extra(path)
    if "bh_levels" not in meta:
        return cfg
    new = {}
    if cfg.bh_levels == 0 and meta["bh_levels"]:
        new["bh_levels"] = int(meta["bh_levels"])
    if cfg.bh_neighbor_k == 0 and meta.get("bh_neighbor_k"):
        new["bh_neighbor_k"] = int(meta["bh_neighbor_k"])
    if cfg.bh_comp_cap == 0 and meta.get("bh_comp_cap"):
        new["bh_comp_cap"] = int(meta["bh_comp_cap"])
    if cfg.bh_near == "auto" and "bh_near_slots" in meta:
        new["bh_near"] = "slots" if meta["bh_near_slots"] else "rows"
    if new:
        cfg = dataclasses.replace(cfg, **new)
        if not quiet:
            print(f"resumed bh knobs from checkpoint: {new}")
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


class _Schedule:
    """nbodyax's window scheduler (nbodyax/driver.py:331-357): a window runs
    from step i to the nearest due event: a multiple of a cadence
    (``logEvery``, ``checkpointEvery``, ``compactEvery``, ``energyEvery``),
    the end of the run, or, from a frame-misaligned start, the next frame
    boundary. With no cadence the base is 16 frame cadences, or 64 steps.
    ``stride``, the gcd of the cadences (and of the frame cadence when it
    does not divide it), is the window size that recurs."""

    def __init__(self, cfg: SimConfig, k_img: int):
        self.total = cfg.total_iterations
        self.k_img = k_img
        self.cadences = [c for c in (cfg.log_every, cfg.checkpoint_every,
                                     cfg.compact_every, cfg.energy_every)
                         if c]
        base = (math.gcd(*self.cadences) if self.cadences
                else (16 * k_img if k_img else 64))
        if k_img and base % k_img:
            base = math.gcd(base, k_img)
        self.stride = base

    def next_window(self, i: int) -> int:
        k = self.total - i
        for c in self.cadences:
            k = min(k, c - i % c)
        if not self.cadences:
            k = min(k, self.stride - i % self.stride)
        if self.k_img and i % self.k_img:
            k = min(k, self.k_img - i % self.k_img)
        return k


def _copy_state(s: SimState) -> SimState:
    return SimState(*(t.clone() for t in s[:4]), s.step, s.sim_time.clone())


def _nan_fields(s: SimState, vec: torch.Tensor) -> list:
    """The fields of ``_NAN_FIELDS`` that hold a NaN (one host read)."""
    hits = torch.stack([t.isnan().any() for t in (*s[:4], vec)]).tolist()
    return [f for f, hit in zip(_NAN_FIELDS, hits) if hit]


def _raise_first_nan(step, start: SimState, k: int, full=None) -> None:
    """A window of k steps from ``start`` ended with a NaN: run it again a
    step at a time, eagerly, and raise ``FloatingPointError`` naming the
    first step whose state holds one and its fields (``nbodyax``'s
    ``--debug-nans`` re-runs the failing dispatch op by op). ``full`` maps
    a rank's state to the whole one (sharded runs), so every rank tests
    the same arrays and stops at the same step."""
    s = start
    for _ in range(k):
        s = step(s)
        whole = full(s) if full is not None else s
        bad = _nan_fields(whole, conservation_vec(whole))
        if bad:
            raise FloatingPointError(
                f"debug_nans: NaN in {', '.join(bad)} after step {s.step} "
                f"(in the {k}-step window from step {start.step})")
    raise FloatingPointError(
        f"debug_nans: the {k}-step window from step {start.step} ended with "
        "a NaN that its eager re-run does not repeat")


class _EagerWindows:
    """A window is k calls of the step from Python; a frame renders after
    each step j with j % k_img == 0 (frame iteration_j holds the state
    after 0-based step j)."""

    def __init__(self, step, state: SimState, cfg: SimConfig, k_img: int):
        self.step, self.state, self.cfg, self.k_img = step, state, cfg, k_img

    def prepare(self, k: int, frames: bool) -> None:
        """Nothing to make before a window: the steps run as called."""

    def advance(self, k: int, frames: bool):
        """Run k steps; returns (conservation vec, [(iteration, frame,
        ready event or None)])."""
        out = []
        for _ in range(k):
            it = self.state.step
            self.state = self.step(self.state)
            if frames and it % self.k_img == 0:
                out.append((it, render_state(self.state, self.cfg), None))
        return conservation_vec(self.state), out


def _gather(group, s: SimState) -> SimState:
    """The whole state of this rank's rows ``s``, by eager collectives."""
    return SimState(*(group.all_gather(t) for t in s[:4]), s.step,
                    s.sim_time)


class _ShardedWindows(_EagerWindows):
    """Eager windows on this rank's rows of a sharded state (``shards >
    1``). ``full`` is the whole state, gathered at the end of each window
    and at each frame step, on every rank: the conservation vector, the
    frames, the probes, the checkpoints and compaction read it, so every
    rank takes the same collectives in the same order and decides alike.
    Only rank 0 renders."""

    def __init__(self, step, full: SimState, cfg: SimConfig, k_img: int,
                 group):
        from nbodyax_torch.sharding import shard_state
        super().__init__(step, shard_state(full, group), cfg, k_img)
        self.group, self.full = group, full

    def gather(self, s: SimState) -> SimState:
        return _gather(self.group, s)

    def advance(self, k: int, frames: bool):
        out = []
        for _ in range(k):
            it = self.state.step
            self.state = self.step(self.state)
            full = None
            if frames and it % self.k_img == 0:
                full = self.gather(self.state)
                if self.group.rank == 0:
                    out.append((it, render_state(full, self.cfg), None))
        self.full = full if full is not None else self.gather(self.state)
        return conservation_vec(self.full), out


class _GraphWindows:
    """Windows as replays of CUDA graphs over static state buffers.

    ``buf`` holds the state every graph starts from and ends by writing.
    A graph is captured the first time its window size is needed: the
    stride with its frames (``frames``: the window starts at a frame
    boundary) or without, and a one-step graph for every other size. A bh
    window of any size replays the one-step graph: its IF bodies are then
    captured once, not once a step, and on an H100 at N = 1M it replays
    faster and captures in a tenth of the time (PERF.md). The
    kernel wrappers' launch counts only move while Python runs, that is
    during the capture: each graph keeps the counts its capture added,
    and every replay adds them again (no counted kernel runs inside an IF
    body). Warm-up and capture themselves count nothing. Every graph and
    buffer has the capacity and the step of the runner; ``close`` drops
    them all. ``prepare`` captures what the next window will replay, so
    that a window's meter times replays only; ``advance`` captures a
    missing graph itself. ``rec`` (the run's ``tracing.Recorder``, else
    one of the runner's own) takes the ``capture`` spans and the
    ``captures``, ``replays`` and ``graphs_freed`` counts.
    """

    def __init__(self, step, state: SimState, cfg: SimConfig, k_img: int,
                 stride: int, writer: Optional[FrameWriter],
                 rec: Optional[Recorder] = None):
        self.step, self.cfg, self.k_img = step, cfg, k_img
        self.stride, self.writer = stride, writer
        self.rec = rec if rec is not None else Recorder()
        self.stride_graph = cfg.force_model != "bh"
        self.buf = SimState(
            *(t.clone(memory_format=torch.contiguous_format)
              for t in state[:4]), state.step, state.sim_time.clone())
        self.graphs = {}
        # (window size, frames) -> (the graph's nodes with an IF node as
        # one, IF nodes, nodes inside their bodies): diagnostics
        self.nodes = {}

    def free_graphs(self) -> None:
        """Destroy every graph and release its IF bodies' pool."""
        bodies = [g[4] for g in self.graphs.values()]
        self.rec.count("graphs_freed", len(bodies))
        self.graphs.clear()
        for b in bodies:
            b.release()

    def close(self) -> None:
        """Drop every graph, static buffer and frame buffer, and hand the
        graphs' private memory pools back to the card before another
        runner captures: a dropped graph's pool is only marked freeable,
        and the allocator would keep it reserved beside the next one."""
        self.free_graphs()
        self.buf = None
        torch.cuda.empty_cache()

    @property
    def state(self) -> SimState:
        return self.buf

    @property
    def renders(self) -> bool:
        """Whether this runner renders frames (under shards, rank 0)."""
        return True

    def gather(self, s: SimState) -> SimState:
        """The whole state of ``s``, by eager calls (a warm-up's)."""
        return s

    def _whole_into(self, s: SimState) -> SimState:
        """The whole state of ``s`` as a window's graph holds it."""
        return s

    def body(self, k: int, frames: bool, vec: torch.Tensor,
             fbuf: Optional[torch.Tensor]) -> None:
        """What a k-step window's graph holds: k steps from ``buf``, every
        k_img-th rendered into ``fbuf`` (``frames`` and a renderer), the
        conservation vector into ``vec`` and the final state copied into
        ``buf``."""
        s = self.buf
        for j in range(k):
            s = self.step(s)
            if frames and j % self.k_img == 0:
                whole = self._whole_into(s)
                if fbuf is not None:
                    fbuf[j // self.k_img].copy_(render_state(whole, self.cfg))
        vec.copy_(conservation_vec(self._whole_into(s)))
        for dst, src in zip(self.buf[:4], s[:4]):
            dst.copy_(src)
        self.buf.sim_time.copy_(s.sim_time)

    def _capture(self, k: int, frames: bool):
        """Capture ``body``: k steps, their frames, the conservation vector
        into a static output and the copy of the final state into
        ``buf``."""
        if self.writer is not None:
            self.writer.drain()   # its thread copies frames off the card
        b, cfg = self.buf, self.cfg
        # the static outputs, made outside the graph's pool, which they
        # would otherwise hold after the graph is gone: conservation_vec's
        # f32[4 + D] and the frames
        vec = torch.empty(4 + b.pos.shape[1], dtype=torch.float32,
                          device=b.pos.device)
        fbuf = (torch.empty((-(-k // self.k_img), cfg.img_height,
                             cfg.img_width), dtype=torch.uint8,
                            device=b.pos.device)
                if frames and self.renders else None)

        def warm_up():
            # on a copy; every IF body runs, whatever its predicate
            with graph_if.warm():
                tmp = self.gather(self.step(_copy_state(b)))
                conservation_vec(tmp)
                if frames and self.renders:
                    render_state(tmp, cfg)

        def body(_):
            self.body(k, frames, vec, fbuf)
            self.nodes[k, frames] = (graph_if.capture_nodes(), bodies.ifs,
                                     bodies.nodes)

        with torch.no_grad(), graph_if.bodies() as bodies:
            try:
                graph, _, delta = capture(body, warm_up,
                                          f"a {k}-step window")
            except BaseException:
                bodies.release()
                raise
        # the IF bodies' pool lives as long as the graph
        return graph, vec, fbuf, delta, bodies

    def _key(self, k: int, frames: bool):
        """The (size, frames) of the graph a k-step window replays: the
        stride's, with frames from a frame boundary, else the one-step
        graph."""
        if k == self.stride and self.stride_graph:
            return k, frames and self.buf.step % self.k_img == 0
        return 1, False

    def prepare(self, k: int, frames: bool) -> None:
        """Capture the graph that a k-step window will replay, if there
        is none yet."""
        key = self._key(k, frames)
        if key not in self.graphs:
            with self.rec.span("capture"):
                self.graphs[key] = self._capture(*key)
            self.rec.count("captures")

    def _replay(self, k: int, frames: bool):
        self.prepare(k, frames)
        graph, vec, fbuf, delta, _ = self.graphs[k, frames]
        graph.replay()
        self.rec.count("replays")
        add_counts(delta)
        return vec, fbuf

    def advance(self, k: int, frames: bool):
        """Run k steps; returns (conservation vec, [(iteration, frame,
        ready event or None)]). The vec is a static output: fetch it
        before the next window."""
        i0 = self.buf.step
        out = []
        if k == self.stride and self.stride_graph:
            frames = self._key(k, frames)[1]
            vec, fbuf = self._replay(k, frames)
            if fbuf is not None:
                # the next replay overwrites fbuf: copy it out now, into
                # pinned memory the writer reads once the event has passed
                host = torch.empty(fbuf.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(fbuf, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
                out = [(i0 + m * self.k_img, host[m], ready)
                       for m in range(host.shape[0])]
        else:
            for j in range(k):
                vec, _ = self._replay(1, False)
                if frames and (i0 + j) % self.k_img == 0 and self.renders:
                    out.append((i0 + j, render_state(self.whole_state,
                                                     self.cfg), None))
        self.buf = self.buf._replace(step=i0 + k)
        return vec, out

    @property
    def whole_state(self) -> SimState:
        """The whole state after the last replay."""
        return self.buf


class _ShardedGraphWindows(_GraphWindows):
    """Graph windows on this rank's rows of a sharded state (``shards > 1``
    on cards): nbodyax's one compiled dispatch a window
    (nbodyax/driver.py:359-420). A window's graph holds its k sharded
    steps with their NCCL collectives (the ring's shifts, or the bh step's
    gathers and reduce_scatter), the whole state gathered into the static
    ``full`` buffers on each frame step and rendered into the static frame
    buffer (rank 0 alone renders), the window-end gather into ``full``
    and ``conservation_vec(full)``. After each replay ``full`` is what
    ``_ShardedWindows``'s gather gives, and the probes, checkpoints,
    compaction and ``debug_nans`` read it as they do there. The graphs are
    ``_GraphWindows``'s: the stride's with and without frames on the exact
    path, the one-step graph otherwise, which renders its frames from
    ``full`` between replays. Every rank captures and replays the same
    graphs in the same order, so they hold the same collectives in the
    same order: the schedule, adapts and compactions are decided on the
    gathered state, and only the rendering differs by rank. No collective
    runs inside a bh IF body. The warm-up before each capture runs the
    step and a gather eagerly on every rank."""

    def __init__(self, step, full: SimState, cfg: SimConfig, k_img: int,
                 stride: int, writer: Optional[FrameWriter], group,
                 rec: Optional[Recorder] = None):
        from nbodyax_torch.sharding import shard_state
        super().__init__(step, shard_state(full, group), cfg, k_img, stride,
                         writer, rec)
        self.group = group
        self.full = SimState(
            *(t.clone(memory_format=torch.contiguous_format)
              for t in full[:4]), full.step, full.sim_time.clone())

    def close(self) -> None:
        super().close()
        self.full = None

    @property
    def renders(self) -> bool:
        return self.group.rank == 0

    @property
    def whole_state(self) -> SimState:
        return self.full

    def gather(self, s: SimState) -> SimState:
        return _gather(self.group, s)

    def _whole_into(self, s: SimState) -> SimState:
        for dst, src in zip(self.full[:4], s[:4]):
            self.group.all_gather_into(dst, src)
        self.full.sim_time.copy_(s.sim_time)
        return self.full

    def advance(self, k: int, frames: bool):
        vec, out = super().advance(k, frames)
        self.full = self.full._replace(step=self.buf.step)
        return vec, out


def _runner_class(dev: torch.device, eager: bool):
    """Graph windows on a card, for the exact path and ``forceModel=bh``
    alike, sharded or not; the eager loop on the CPU and under the private
    ``_eager`` switch."""
    return (_GraphWindows if dev.type == "cuda" and not eager
            else _EagerWindows)


def run_simulation(cfg: SimConfig, *, device="cuda", quiet: bool = False,
                   state: Optional[SimState] = None,
                   profile_dir: Optional[str] = None,
                   debug_nans: bool = False,
                   _eager: bool = False, _group=None) -> RunResult:
    """Run ``cfg`` to ``totalIterations`` on ``device``, from the config's
    scene, from ``resumeFrom``'s checkpoint or from ``state`` (its ``step``
    is where the run starts). ``profile_dir``: a ``torch.profiler`` trace of
    the step loop is written there (``trace.json``). ``debug_nans``: after
    each window, test pos, vel, mass, radius and the conservation vector for
    NaN (not inf, as ``jax_debug_nans``); on a hit, re-run the window a step
    at a time from a copy of its start state and raise
    ``FloatingPointError`` naming the first step and field. The windows are
    the same with and without it. ``_eager`` runs the windows eagerly on a
    card too, for A/B checks against the graphs. ``_group`` runs the
    sharded path on that ``ShardGroup`` whatever ``shards`` says: with a
    one-rank NCCL group, the sharded runners on one card, for A/B checks
    against the single-device ones.

    With ``autoResume`` and ``checkpointEvery`` both set, a failed run
    reloads the latest checkpoint and runs again, up to ``maxRetries``
    times (see the module docstring for what is never retried). nbodyax
    sleeps 15 s before each retry to let a crashed TPU worker settle, a
    relay workaround that one card in one process has no use for.

    ``shards > 1``: every rank of a ``torch.distributed.run`` launch calls
    this with the same config (see the module docstring); each returns the
    whole final state. There autoResume retries by torchrun's relaunch:

        python -m torch.distributed.run --max-restarts <maxRetries> \\
            --nproc-per-node P -m nbodyax_torch.cli --set shards=P \\
            --set autoResume=1 --set checkpointEvery=K ...

    a failure is raised, every rank is started again, and the relaunched
    ranks resume from the latest checkpoint (``_relaunch_resume``). A
    failure that one card would not retry (not a ``RuntimeError``, or one
    of ``_NOT_RETRIED``) leaves a mark beside the checkpoints, and the
    relaunched ranks raise ``RelaunchRefused`` at once instead of running
    again."""
    dev = resolve_device(device)
    attempts = 1 + (cfg.max_retries if cfg.auto_resume and
                    cfg.checkpoint_every else 0)
    relaunch = cfg.shards > 1 and attempts > 1
    if relaunch:
        resumed = _relaunch_resume(cfg, quiet)
        if resumed is not cfg:
            cfg, state = resumed, None
        attempts = 1
    for attempt in range(attempts):
        try:
            return _run_simulation_once(cfg, dev, quiet=quiet, state=state,
                                        profile_dir=profile_dir,
                                        debug_nans=debug_nans, eager=_eager,
                                        group=_group)
        except Exception as e:
            retried = (isinstance(e, RuntimeError)
                       and not isinstance(e, _NOT_RETRIED))
            if relaunch and not retried:
                _mark_not_retried(cfg, e)
            if not retried or attempt + 1 >= attempts:
                raise
            ck = latest_checkpoint(cfg.checkpoint_path)
            if ck is None:
                raise
            if not quiet:
                print(f"Run failed ({type(e).__name__}: {e}); resuming from "
                      f"{ck} (attempt {attempt + 2}/{attempts})")
            # the next attempt loads the snapshot itself, adopting its bh
            # knobs as a resume from the command line does
            cfg = dataclasses.replace(cfg, resume_from=ck)
            state = None
    raise AssertionError("unreachable")


def _relaunch_resume(cfg: SimConfig, quiet: bool) -> SimConfig:
    """autoResume under ``shards > 1``: a rank that fails breaks the
    process group, so the retry is torchrun's relaunch of every rank
    (``--max-restarts``), which must allow ``maxRetries`` of them
    (``ValueError`` otherwise, before anything runs or is written). A
    relaunched rank (``TORCHELASTIC_RESTART_COUNT`` > 0) resumes from the
    latest checkpoint, as ``--resume auto`` does; every rank reads the same
    one, since rank 0 alone writes them. A relaunch after a failure that
    ``_mark_not_retried`` marked raises ``RelaunchRefused`` instead."""
    allowed = int(os.environ.get("TORCHELASTIC_MAX_RESTARTS", "0"))
    if allowed < cfg.max_retries:
        raise ValueError(
            f"autoResume under shards={cfg.shards} retries by relaunching "
            f"every rank: launch with python -m torch.distributed.run "
            f"--max-restarts {cfg.max_retries} --nproc-per-node "
            f"{cfg.shards} -m nbodyax_torch.cli ... (this launch allows "
            f"{allowed} restarts; maxRetries={cfg.max_retries})")
    restart = int(os.environ.get("TORCHELASTIC_RESTART_COUNT", "0"))
    mark = os.path.join(cfg.checkpoint_path, _NOT_RETRIED_MARK)
    if not restart:
        # a new launch: an earlier launch's mark no longer holds. Rank 0
        # clears it before it joins the group, so before any rank can fail
        if os.environ.get("RANK", "0") == "0" and os.path.exists(mark):
            os.remove(mark)
        return cfg
    if os.path.exists(mark):
        with open(mark) as f:
            raise RelaunchRefused(
                f"relaunch {restart} of {allowed} refused: the attempt "
                f"before it failed with {f.read().strip()}, which resuming "
                f"from a checkpoint cannot mend (as one card does not "
                f"retry it); fix the cause and launch again")
    ck = latest_checkpoint(cfg.checkpoint_path)
    if ck is None:
        return cfg
    if not quiet:
        print(f"Relaunch {restart} of {allowed}: resuming from {ck}")
    return dataclasses.replace(cfg, resume_from=ck)


def _mark_not_retried(cfg: SimConfig, e: BaseException) -> None:
    """Under torchrun's relaunch, tell the next attempt that this failure
    is one a checkpoint cannot mend: a mark beside the checkpoints (where
    every rank reads), written before the failing rank exits, so before
    torchrun starts the next attempt."""
    os.makedirs(cfg.checkpoint_path, exist_ok=True)
    mark = os.path.join(cfg.checkpoint_path, _NOT_RETRIED_MARK)
    tmp = f"{mark}.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{type(e).__name__}: {e}\n")
    os.replace(tmp, mark)


# ``RunResult.seconds``'s key for each span whose key is not its name
_SECONDS_KEY = {"window": "windows", "checkpoint": "checkpoints"}
_SECONDS_KEYS = ("run", "scene", "knobs", "runner", "windows", "capture",
                 "frames", "probe", "log", "checkpoints", "compaction",
                 "graph_free")
_COUNT_KEYS = ("windows", "one_step_windows", "replays", "captures",
               "graphs_freed", "probes", "adapts", "compactions",
               "checkpoints", "b1_cold_subtiles", "b1_subtiles",
               "annulus_launches")


def _run_simulation_once(cfg: SimConfig, dev: torch.device, *, quiet: bool,
                         state: Optional[SimState],
                         profile_dir: Optional[str], debug_nans: bool,
                         eager: bool, group=None) -> RunResult:
    """One attempt, in a ``run`` span of its own recorder, whose self
    seconds and counts become the result's ``seconds`` and ``counts``."""
    rec = Recorder()
    with rec.span("run"):
        res = _attempt(rec, cfg, dev, quiet=quiet, state=state,
                       profile_dir=profile_dir, debug_nans=debug_nans,
                       eager=eager, group=group)
    res.seconds = dict.fromkeys(_SECONDS_KEYS, 0.0)
    for name, s in rec.seconds.items():
        res.seconds[_SECONDS_KEY.get(name, name)] = s
    res.counts = dict.fromkeys(_COUNT_KEYS, 0)
    res.counts.update(rec.counts)
    res.windows = res.counts["windows"]
    return res


def _attempt(rec: Recorder, cfg: SimConfig, dev: torch.device, *,
             quiet: bool, state: Optional[SimState],
             profile_dir: Optional[str], debug_nans: bool, eager: bool,
             group=None) -> RunResult:
    t_start = time.perf_counter()
    # the bh knobs the user left auto, before any adoption or resolution:
    # compaction may re-pick these and only these
    auto_knobs = {"bh_levels": cfg.bh_levels == 0,
                  "bh_near": cfg.bh_near == "auto",
                  "bh_neighbor_k": cfg.bh_neighbor_k == 0,
                  "bh_comp_cap": cfg.bh_comp_cap == 0}
    if cfg.shards > 1 or group is not None:
        from nbodyax_torch.sharding import make_group, pad_to_shards
        group = group or make_group(cfg.shards, dev)
        dev = group.device
    reset_cold_counts(dev)
    annulus_before = annulus_cells.launches
    # rank 0 alone prints, logs, profiles and writes frames and checkpoints
    root = group is None or group.rank == 0
    quiet = quiet or not root
    with rec.span("scene"):
        if state is None:
            if cfg.resume_from:
                state = load_checkpoint(cfg.resume_from, device=dev)
                cfg = _adopt_ck_knobs(cfg, cfg.resume_from, quiet=quiet)
                if not quiet:
                    print(f"Resumed from {cfg.resume_from} at step "
                          f"{state.step}")
            else:
                state = init_scene(cfg, device=dev)
        else:
            state = make_state(*state[:4], step=int(state.step),
                               sim_time=float(state.sim_time), device=dev)
        if group is not None:
            # every rank holds the same whole state; the runner keeps its
            # rows
            state = pad_to_shards(state, group.size)
    with rec.span("knobs"):
        cfg = resolve_bh_config(cfg, state, quiet=quiet)
    bh = cfg.force_model == "bh"

    meter = StepMeter(state.capacity, dev)
    k_img = (cfg.save_image_every
             if cfg.save_images and cfg.save_image_every > 0 else 0)
    sched = _Schedule(cfg, k_img)
    writer = FrameWriter(cfg.image_path) if k_img and root else None
    logger = JsonlLogger(cfg.log_path if root else "", echo=not quiet)
    runner_class = _runner_class(dev, eager)

    def new_runner(c: SimConfig, s: SimState):
        """The runner of the step of ``c`` from the whole state ``s``."""
        with rec.span("runner"):
            if group is not None:
                if runner_class is _GraphWindows:
                    return _ShardedGraphWindows(build_step(c, dev, group), s,
                                                c, k_img, sched.stride,
                                                writer, group, rec)
                return _ShardedWindows(build_step(c, dev, group), s, c,
                                       k_img, group)
            if runner_class is _GraphWindows:
                return _GraphWindows(build_step(c, dev), s, c, k_img,
                                     sched.stride, writer, rec)
            return _EagerWindows(build_step(c, dev), s, c, k_img)

    def drop_runner(r) -> None:
        """Let a graph runner go: its graphs and their pools."""
        if isinstance(r, _GraphWindows):
            with rec.span("graph_free"):
                if writer is not None:
                    writer.drain()
                r.close()

    def adapt(c: SimConfig):
        """Step with the knobs a bh probe chose: a new step, and on a card
        a new runner, captured at its first window."""
        nonlocal runner
        rec.count("adapts")
        if isinstance(runner, _GraphWindows):
            old, runner = runner, new_runner(c, whole())
            drop_runner(old)
        else:
            with rec.span("runner"):
                runner.step = build_step(c, dev, group)
        return c

    def checkpoint(s: SimState):
        with rec.span("checkpoint"):
            rec.count("checkpoints")
            if root:
                save_checkpoint(cfg.checkpoint_path, s,
                                keep_last=cfg.checkpoint_keep,
                                milestone_every=cfg.checkpoint_milestone_every,
                                extra=_bh_ck_extra(cfg))

    def whole() -> SimState:
        """The whole state after the last window, on every rank."""
        return runner.state if group is None else runner.full

    runner = new_runner(cfg, state)
    # without bhAdapt the probe only reads bh_health and never drifts
    probe = _BhProbe(float((state.mass > 0).sum())) if bh else None
    pairs_key = "equivalent_pairs_per_sec" if bh else "pairs_per_sec"
    frames = 0
    capacities = []
    prev_sim_time, prev_log_iter = float(state.sim_time), state.step
    last_ck_step = state.step
    if cfg.checkpoint_every and cfg.auto_resume and not cfg.resume_from:
        # a fault before the first cadence checkpoint must be resumable too
        checkpoint(state)
    prof = None
    if profile_dir and root:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
        prof.start()
    # a fresh (or, after a compaction, rebuilt) bh step at scale takes a
    # short first window, so that the drift probe runs early
    bootstrap = bh and state.capacity >= BOOTSTRAP_MIN_CAPACITY
    try:
        iteration = state.step
        while iteration < cfg.total_iterations:
            k = sched.next_window(iteration)
            if bootstrap:
                k = min(k, BOOTSTRAP_WINDOW_STEPS)
                bootstrap = False
            if probe is not None and probe.drift_mode:
                k = min(k, SCALE_DRIFT_WINDOW_STEPS
                        if state.capacity >= BOOTSTRAP_MIN_CAPACITY
                        else DRIFT_WINDOW_STEPS)
            if k_img and iteration % k_img == 0 and k >= k_img:
                k -= k % k_img   # frame windows stay frame-aligned
            rec.count("windows")
            if k == 1:
                rec.count("one_step_windows")
            start = _copy_state(runner.state) if debug_nans else None
            with rec.span("window"):
                # the window's graph exists before its meter starts
                runner.prepare(k, k_img > 0)
                meter.start()
                vec, imgs = runner.advance(k, k_img > 0)
                win_wall = meter.stop(k)
                v = vec.cpu()
            state = whole()
            if debug_nans and _nan_fields(state, vec):
                _raise_first_nan(runner.step, start, k,
                                 None if group is None else runner.gather)
            if imgs:
                with rec.span("frames"):
                    for it, img, ready in imgs:
                        writer.submit(it, img, ready)
            frames += len(imgs)
            iteration += k
            alive_now = float(v[0])
            log_due = cfg.log_every and iteration % cfg.log_every == 0
            if probe is not None and (
                    log_due or (cfg.bh_adapt
                                and iteration < cfg.total_iterations
                                and (probe.drift_mode
                                     or probe.dropping(alive_now)))):
                # at each log point, and off the log cadence while the run
                # merges fast
                with rec.span("probe"):
                    rec.count("probes")
                    h, new_cfg = probe.probe(cfg, state, alive_now,
                                             iteration, quiet)
                if new_cfg is not cfg:
                    cfg = adapt(new_cfg)
            if log_due:
                with rec.span("log"):
                    scal = scalars_from_vec(v, cfg.dimensions)
                    if cfg.adaptive_dt:
                        # the mean dt since the last log line: sim_time
                        # telescopes the per-step dts the windows do not
                        # report
                        scal["dt_mean"] = (
                            (scal["sim_time"] - prev_sim_time)
                            / max(iteration - prev_log_iter, 1))
                    prev_sim_time, prev_log_iter = scal["sim_time"], iteration
                    if probe is not None:
                        scal["bh_overflow"] = int(h[0] + h[1])
                        scal["bh_giant_excess"] = int(h[6])
                    if (cfg.energy_every
                            and iteration % cfg.energy_every == 0 and root):
                        # O(N^2), as dear as a force pass: at its own
                        # cadence
                        pe = float(potential_energy(state, eps=cfg.softening))
                        scal["potential_energy"] = pe
                        scal["total_energy"] = pe + scal["kinetic_energy"]
                    logger.log(step=iteration, wall_ms=win_wall / k * 1e3,
                               steps_per_sec=meter.steps_per_sec,
                               force_model=cfg.force_model,
                               **{pairs_key: meter.pairs_per_sec}, **scal)
            ck_due = (cfg.checkpoint_every
                      and iteration % cfg.checkpoint_every == 0)
            if (cfg.checkpoint_every and not ck_due and probe is not None
                    and probe.drift_mode and iteration - last_ck_step
                    >= max(8, cfg.checkpoint_every // 4)):
                # while the run merges fast, checkpoint at a finer cadence
                ck_due = True
            if ck_due:
                checkpoint(state)
                last_ck_step = iteration
            compact_due = (cfg.compact_every
                           and iteration % cfg.compact_every == 0)
            if cfg.compact_every and not compact_due:
                # merger phase: compact as soon as it halves the capacity
                compact_due = shrink_due(alive_now, state.capacity)
            if not (compact_due and iteration < cfg.total_iterations):
                continue
            with rec.span("compaction"):
                rec.count("compactions")
                new_state = compact_state(state)
                if new_state.capacity == state.capacity:
                    continue
                if not quiet:
                    print(f"Compacted {state.capacity} -> "
                          f"{new_state.capacity} slots")
                capacities.append((iteration, new_state.capacity))
                if bh and any(auto_knobs.values()):
                    # re-pick the user-auto knobs for the compacted bodies
                    reset = {kk: ("auto" if kk == "bh_near" else 0)
                             for kk, on in auto_knobs.items() if on}
                    with rec.span("knobs"):
                        cfg = resolve_bh_config(
                            dataclasses.replace(cfg, **reset), new_state,
                            quiet=quiet)
                    probe.prev_overflow = probe.prev_dropped = 0.0
                if probe is not None:
                    probe.last_probe_alive = alive_now
                if group is not None:
                    new_state = pad_to_shards(new_state, group.size)
                drop_runner(runner)
                runner = new_runner(cfg, new_state)
                state = new_state
                meter.capacity = state.capacity
                bootstrap = bh and state.capacity >= BOOTSTRAP_MIN_CAPACITY
    except BaseException:
        # a failed run's graphs go at once: NCCL tears its communicator
        # down (``sharding.close_group``) only once every graph holding its
        # collectives is destroyed, and the traceback keeps this frame, so
        # the runner, alive
        if isinstance(runner, _GraphWindows):
            runner.close()
        raise
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        if writer is not None:
            with rec.span("frames"):
                writer.close()
        logger.close()

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cold, walked = cold_counts(dev)
    rec.count("b1_cold_subtiles", cold)
    rec.count("b1_subtiles", walked)
    rec.count("annulus_launches", annulus_cells.launches - annulus_before)
    if isinstance(runner, _GraphWindows):
        # the last runner's graphs go inside the run, not when the caller
        # lets the runner go (its pools stay cached for the next run)
        with rec.span("graph_free"):
            runner.free_graphs()
    wall = time.perf_counter() - t_start
    if not quiet:
        print(f"Time taken: {wall:.4f}")  # the reference's final line
    return RunResult(state=whole(), steps_per_sec=meter.steps_per_sec,
                     pairs_per_sec=meter.pairs_per_sec, wall_seconds=wall,
                     frames_written=frames, capacities=capacities,
                     shards=cfg.shards)
