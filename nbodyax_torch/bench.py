"""Headline benchmark of the port: pairwise interactions a second at
N = 1,048,576 on one card, collisions on.

    python -m nbodyax_torch.bench [--device cuda|cpu]

Counterpart of the repository's ``bench.py`` (BASELINE config 4): the
uniform scene (``parity=False``) in reference collision mode, timed over the
full step: the B1 pair pass, the collision commit, the boundary and the
integration. On a card the step runs through the driver's graph runner
(``driver._GraphWindows``) in one-step windows: one warm replay (it captures
the graph first), then ``REPS`` replays, each timed by the host clock and
fenced by ``torch.cuda.synchronize``. The value is n^2 over the median step
time. ``--device cpu`` runs N = 4,096 for 2 replays through the eager
runner, as ``bench.py`` does off the TPU. Prints one JSON line: the metric,
its value and unit, n, the replays, the median, min and max step ms, the
spread ((max - min) / median), each kernel's launches in the run (warm
replay included) and the device (on a card its name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` gives them).

There is no fallback size: a failure at 1M raises. ``bench.py``'s
``vs_baseline`` divides by a TPU v5e target, which is no target here.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

import torch

# the kernel wrappers' launch counts, in ``graphs._launch_counters`` order
KERNELS = ("pair_kernel", "pair_bwd_kernel", "near_kernel",
           "slot_pack_kernel", "slot_pack_moments_kernel", "annulus_kernel")
N_CARD, REPS_CARD = 1_048_576, 5
N_CPU, REPS_CPU = 4096, 2
METRIC = "pairwise_interactions_per_sec_per_chip_collisions_on_N{n}"


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu" off
    a card."""
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def launches_since(before: list) -> dict:
    """Each kernel's launches since ``graphs.read_counters()`` gave
    ``before`` (replays counted as the driver counts them; 0 on the CPU,
    where the wrappers run their plain versions)."""
    from nbodyax_torch.graphs import read_counters
    return {k: a - b for k, a, b in zip(KERNELS, read_counters(), before)}


def window_runner(step, state, cfg, window: int, group=None):
    """The driver's runner for windows of ``window`` steps, without frames:
    CUDA-graph replays on a card, the eager loop on the CPU. With a shard
    ``group``, ``step`` is the sharded step and ``state`` the whole (padded)
    state: the sharded graph runner on cards, the sharded eager one on the
    CPU."""
    from nbodyax_torch.driver import (_EagerWindows, _GraphWindows,
                                      _ShardedGraphWindows, _ShardedWindows)
    cuda = state.pos.device.type == "cuda"
    if group is not None:
        if cuda:
            return _ShardedGraphWindows(step, state, cfg, 0, window, None,
                                        group)
        return _ShardedWindows(step, state, cfg, 0, group)
    if cuda:
        return _GraphWindows(step, state, cfg, 0, window, None)
    return _EagerWindows(step, state, cfg, 0)


def time_windows(runner, window: int, count: int) -> list:
    """Host seconds a step of each of ``count`` windows of ``window``
    steps, each fenced by a device synchronize."""
    cuda = runner.state.pos.device.type == "cuda"
    out = []
    for _ in range(count):
        t0 = time.perf_counter()
        runner.advance(window, False)
        if cuda:
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / window)
    return out


def close_runner(runner) -> None:
    """Let a graph runner's graphs and pools go (the eager one holds none)."""
    if hasattr(runner, "close"):
        runner.close()


def capture_seconds(runner) -> float:
    """Seconds a graph runner has spent warming up and capturing its graphs
    (its recorder's ``capture`` spans); 0 for the eager runner."""
    rec = getattr(runner, "rec", None)
    return rec.seconds.get("capture", 0.0) if rec is not None else 0.0


def time_steps(step, state, cfg, *, steps: int, chunk: int, group=None):
    """``bench/suite.py``'s ``_time_steps`` on the driver's runner: one warm
    window of ``chunk`` steps (a graph's capture included), then windows of
    ``chunk`` until ``steps`` are done. Returns the final state (a copy; the
    whole state under a shard ``group``), the seconds a step of each timed
    window, and the graph capture seconds (0 on the CPU)."""
    from nbodyax_torch.driver import _copy_state
    runner = window_runner(step, state, cfg, chunk, group)
    try:
        time_windows(runner, chunk, 1)
        seconds = time_windows(runner, chunk, -(-steps // chunk))
        final = _copy_state(runner.state if group is None else runner.full)
        capture = capture_seconds(runner)
    finally:
        close_runner(runner)
    return final, seconds, capture


def run_logged(cfg, dev: torch.device, log_file: str):
    """``driver.run_simulation(cfg)`` on ``dev``, not quiet, its printed
    lines (bh knob choices and adapts, JSONL echoes, ``Time taken``)
    appended to ``log_file`` whether it ends or raises: (its result, those
    lines)."""
    from nbodyax_torch.driver import run_simulation
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = run_simulation(cfg, device=dev, quiet=False)
    finally:
        with open(log_file, "a") as f:
            f.write(buf.getvalue())
    return res, buf.getvalue().splitlines()


def bh_lines(lines: list) -> dict:
    """The driver's bh knob choices among its printed ``lines``: the
    ``bh adapt at step ...`` lines, and the knobs it resolved or adopted
    from a checkpoint."""
    return {"adapt_log": [l for l in lines if l.startswith("bh adapt")],
            "knobs_log": [l for l in lines if l.startswith(
                ("bh auto-selected", "bhNeighborK auto-selected",
                 "resumed bh knobs"))]}


def spread_keys(seconds: list) -> dict:
    """Median, min and max step ms of timed windows, and their spread."""
    med = statistics.median(seconds)
    return {"step_ms_median": med * 1e3, "step_ms_min": min(seconds) * 1e3,
            "step_ms_max": max(seconds) * 1e3,
            "spread": (max(seconds) - min(seconds)) / med}


def run(n: int, reps: int, dev: torch.device) -> dict:
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.driver import build_step
    from nbodyax_torch.graphs import read_counters
    from nbodyax_torch.scenes import init_scene

    cfg = SimConfig(particle_count=n, collision_mode="reference",
                    save_images=False)
    state = init_scene(cfg, device=dev, parity=False)
    before = read_counters()
    _, seconds, _ = time_steps(build_step(cfg, dev), state, cfg, steps=reps,
                               chunk=1)
    return {"metric": METRIC.format(n=n),
            "value": float(n) * n / statistics.median(seconds),
            "unit": "pairs/s", "n": n, "reps": reps,
            **spread_keys(seconds), "launches": launches_since(before),
            "device": device_line(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbodyax_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (N = 1,048,576) or cpu (N = 4,096)")
    args = ap.parse_args(argv)
    from nbodyax_torch.driver import resolve_device
    dev = resolve_device(args.device)
    n, reps = (N_CARD, REPS_CARD) if dev.type == "cuda" else (N_CPU,
                                                              REPS_CPU)
    print(json.dumps(run(n, reps, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
