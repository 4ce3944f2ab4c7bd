"""Throughput of each collision mode at N = 1,048,576 on one card.

    python -m nbodyax_torch.bench_modes [--n N] [--reps 3]
        [--modes reference,momentum,elastic[,none]] [--out F]
        [--device cuda|cpu]

Counterpart of ``bench/modes.py``: for each mode, ``SimConfig(
particle_count=n, collision_mode=mode, backend="auto")`` with softening
100 in elastic mode and 0 otherwise, on the uniform scene drawn with
``parity=False``, timed over the full step (B1 and the mode's collision
commit, the boundary and the integration) through the driver's one-step
graph windows (``bench.window_runner``): a warm window, which captures the
graph and replays it once, then ``--reps`` windows, each timed by the host
clock and fenced by ``torch.cuda.synchronize``. On the CPU the windows run
eagerly.

One JSON line a mode, with ``bench/modes.py``'s keys: ``steps_per_sec``
(the timed steps over their seconds), ``pairs_per_sec`` (n^2 a step) and
``compile_s``, the warm window's host seconds (the capture and its first
replay; there is no compile). Beside them: ``capture_s`` alone, the
median, min and max step ms with their spread, ``finite``, each kernel's
launches in the mode's run (warm window included) and the device (on a
card its name and power limit). A failing mode raises: no mode is skipped.

``bench/modes.py``'s ``target_1e11`` compares with a TPU target, which is
none here, and its ``--tiles`` sweep chooses Pallas block shapes; B1's
launch shape comes from ``physics.kernels.choose_splits``, so neither is
carried. ``--device cpu`` runs N = 1,024 for 2 replays.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from nbodyax_torch.bench import (capture_seconds, close_runner, device_line,
                                 launches_since, time_windows, window_runner)
from nbodyax_torch.bench_suite import _finite, _rates
from nbodyax_torch.graphs import read_counters

N_CARD, N_CPU = 1_048_576, 1024
MODES = ("reference", "momentum", "elastic", "none")


def run_mode(mode: str, n: int, reps: int, dev: torch.device) -> dict:
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.driver import build_step
    from nbodyax_torch.scenes import init_scene
    cfg = SimConfig(particle_count=n, collision_mode=mode, backend="auto",
                    softening=100.0 if mode == "elastic" else 0.0,
                    save_images=False)
    state = init_scene(cfg, device=dev, parity=False)
    before = read_counters()
    runner = window_runner(build_step(cfg, dev), state, cfg, 1)
    try:
        (warm,) = time_windows(runner, 1, 1)
        seconds = time_windows(runner, 1, reps)
        finite = _finite(runner.state)
        capture = capture_seconds(runner)
    finally:
        close_runner(runner)
    return {"mode": mode, "n": n, **_rates(n, seconds), "compile_s": warm,
            "capture_s": capture, "reps": reps, "finite": finite,
            "launches": launches_since(before), "device": device_line(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbodyax_torch.bench_modes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=0,
                    help=f"bodies (default {N_CARD:,} on a card, "
                         f"{N_CPU:,} on the CPU)")
    ap.add_argument("--reps", type=int, default=0,
                    help="timed windows (default 3 on a card, 2 on the CPU)")
    ap.add_argument("--modes", default="reference,momentum,elastic")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    bad = [m for m in modes if m not in MODES]
    if bad:
        ap.error(f"unknown modes {bad}; choose from {MODES}")
    from nbodyax_torch.driver import resolve_device
    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    results = []
    for mode in modes:
        r = run_mode(mode, args.n or (N_CARD if card else N_CPU),
                     args.reps or (3 if card else 2), dev)
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
