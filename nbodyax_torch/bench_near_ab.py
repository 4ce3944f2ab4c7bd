"""Interleaved A/B of the two bh near-field engines, ``bhNear=rows`` and
``bhNear=slots``, on one scene on one card.

    python -m nbodyax_torch.bench_near_ab [uniform|galaxy] [reps] [dim] [n]
        [--device cuda|cpu]

Counterpart of ``bench/near_ab.py`` (defaults: uniform, 3 reps, 2-D, N =
1,048,576): ``SimConfig(particle_count=n, collision_mode="reference",
force_model="bh", softening=100, scene=scene, dimensions=dim)``, the
scene drawn once with ``parity=False``, and for each engine the auto knobs
resolved against that state by ``driver.resolve_bh_config`` with
``bhNear`` pinned to it. Each engine's step runs through the driver's
one-step graph windows (``bench.window_runner``; a bh window of any size
replays the one-step graph on a card), each from its own copy of the
state: first a warm window a engine (its capture and first replay), then
``reps`` rounds of rows, slots, each window timed by the host clock and
fenced by ``torch.cuda.synchronize``, so the drift of the host's pace
falls on both. On the CPU the windows run eagerly.

Prints one JSON line: ``bench/near_ab.py``'s keys (``rows_step_s`` and
``slots_step_s``, here the medians), and for each engine the knobs it
got, its warm window's and its capture's seconds, the median, min and max
step ms with their spread, ``finite`` and each kernel's launches in its
windows (B3 and B5 launch under slots on a card, none under rows, whose
engine is plain torch); then the device (on a card its name and power
limit). ``--device cpu`` runs N = 4,096 for one round.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys

import torch

from nbodyax_torch.bench import (capture_seconds, close_runner, device_line,
                                 launches_since, spread_keys, time_windows,
                                 window_runner)
from nbodyax_torch.bench_suite import _finite, _knobs
from nbodyax_torch.graphs import read_counters

N_CARD, N_CPU = 1_048_576, 4096
ENGINES = ("rows", "slots")


def run(scene: str, reps: int, dim: int, n: int, dev: torch.device):
    """Returns (the record, each engine's final state by name)."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.driver import (_copy_state, build_step,
                                      resolve_bh_config)
    from nbodyax_torch.scenes import init_scene
    cfg0 = SimConfig(particle_count=n, collision_mode="reference",
                     force_model="bh", softening=100.0, scene=scene,
                     dimensions=dim, save_images=False)
    state = init_scene(cfg0, device=dev, parity=False)
    runners, per = {}, {}
    try:
        for near in ENGINES:
            cfg = resolve_bh_config(dataclasses.replace(cfg0, bh_near=near),
                                    state)
            before = read_counters()
            runners[near] = window_runner(build_step(cfg, dev), state, cfg,
                                          1)
            (warm,) = time_windows(runners[near], 1, 1)
            per[near] = {"knobs": _knobs(cfg), "warm_s": warm,
                         "capture_s": capture_seconds(runners[near]),
                         "seconds": [], "launches": launches_since(before)}
        for _ in range(reps):
            for near in ENGINES:
                before = read_counters()
                per[near]["seconds"] += time_windows(runners[near], 1, 1)
                for k, v in launches_since(before).items():
                    per[near]["launches"][k] += v
        finals = {near: _copy_state(r.state) for near, r in runners.items()}
    finally:
        for r in runners.values():
            close_runner(r)
    record = {"bench": "near_ab", "scene": scene, "reps": reps, "dim": dim,
              "n": n}
    for near in ENGINES:
        seconds = per[near].pop("seconds")
        record[f"{near}_step_s"] = statistics.median(seconds)
        per[near].update(spread_keys(seconds), finite=_finite(finals[near]))
    record.update(per, device=device_line(dev))
    return record, finals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbodyax_torch.bench_near_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="uniform",
                    choices=("uniform", "galaxy"))
    ap.add_argument("reps", nargs="?", type=int, default=0,
                    help="rounds (default 3 on a card, 1 on the CPU)")
    ap.add_argument("dim", nargs="?", type=int, default=2, choices=(2, 3))
    ap.add_argument("n", nargs="?", type=int, default=0,
                    help=f"bodies (default {N_CARD:,} on a card, "
                         f"{N_CPU:,} on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from nbodyax_torch.driver import resolve_device
    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    record, _ = run(args.scene, args.reps or (3 if card else 1), args.dim,
                    args.n or (N_CARD if card else N_CPU), dev)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
