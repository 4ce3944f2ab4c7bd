"""bhAdapt soak under a merging collapse, with its bounds, on one card.

    python -m nbodyax_torch.bench_soak_adapt [--n N] [--steps 300]
        [--log-every 20] [--dt 0.02] [--workdir DIR] [--device cuda|cpu]

Counterpart of ``bench/soak_adapt.py``: the galaxy scene at N =
1,048,576 under ``forceModel=bh`` with every bh knob auto and ``bhAdapt``
on, reference merging at dt 0.02 for 300 steps (collisions grow radii and
concentrate the core, the drift the driver's between-window self-tuning
exists to absorb), a JSONL line every 20 steps, a checkpoint every 100 and
autoResume with ``maxRetries`` 2, through ``driver.run_simulation`` (graph
windows on a card; every adapt captures a new runner). The adapts are
counted from the driver's ``bh adapt at step ...`` lines; the driver's
output goes to ``run.log`` in the work directory (a temporary one by
default), its JSONL to ``soak.jsonl`` there.

Prints one JSON line (``record``): ``bench/soak_adapt.py``'s keys, each
log point's ``bh_overflow``, the run's host seconds by part and its
counts (windows, probes, adapts, captures, ...), each kernel's launches
and the device (on a card its name and power limit); then
``check_bounds`` holds ``nbodyax``'s three bounds and raises on a broken
one: at least 2 adapts (the self-tuning engaged), fewer than 12
(each one costs a capture), and at least 3 trailing log points with
``bh_overflow`` 0 (once the collapse settles, the last adapt restores
exactness and holds it). ``--device cpu`` runs N = 4,096: the bounds are
set for the collapse of the card's size and may break there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from nbodyax_torch.bench import (bh_lines, device_line, launches_since,
                                 run_logged)
from nbodyax_torch.graphs import read_counters

N_CARD, N_CPU = 1_048_576, 4096
MIN_ADAPTS, MAX_ADAPTS, MIN_TRAILING_ZEROS = 2, 12, 3


def record(rows: list, adapts: list, **extra) -> dict:
    """``bench/soak_adapt.py``'s record of a run's JSONL ``rows`` and its
    ``bh adapt at step ...`` lines ``adapts``, with ``extra`` keys (n,
    steps, rates, walls)."""
    ov = [[r["step"], r["bh_overflow"]] for r in rows]
    tail_zeros = 0
    for _, o in reversed(ov):
        if o:
            break
        tail_zeros += 1
    return {**extra, "alive_final": rows[-1]["alive"] if rows else None,
            "adaptations": len(adapts), "adapt_log": adapts,
            "overflow_nonzero_steps": [s for s, o in ov if o > 0],
            "trailing_zero_checks": tail_zeros, "bh_overflow_by_log": ov}


def check_bounds(rec: dict) -> None:
    """Raise ``AssertionError`` where ``rec`` breaks one of
    ``bench/soak_adapt.py``'s bounds."""
    if rec["adaptations"] < MIN_ADAPTS:
        raise AssertionError("collapse never forced an adaptation: "
                             f"{rec['adapt_log']}")
    if rec["adaptations"] >= MAX_ADAPTS:
        raise AssertionError(f"unbounded recaptures: {rec['adapt_log']}")
    if rec["trailing_zero_checks"] < MIN_TRAILING_ZEROS:
        raise AssertionError("exactness not restored and held: "
                             f"{rec['bh_overflow_by_log']}")


def run(n: int, steps: int, log_every: int, dt: float, workdir: str,
        dev: torch.device) -> dict:
    from nbodyax_torch.config import SimConfig
    log_path, ck_path, run_log = (os.path.join(workdir, f) for f in
                                  ("soak.jsonl", "ck", "run.log"))
    # a run of its own: no earlier run's log lines, checkpoints or output
    shutil.rmtree(ck_path, ignore_errors=True)
    for f in (log_path, run_log):
        if os.path.exists(f):
            os.remove(f)
    cfg = SimConfig(
        particle_count=n, total_iterations=steps, scene="galaxy",
        force_model="bh", softening=100.0, timestep=dt,
        collision_mode="reference", log_every=log_every, save_images=False,
        checkpoint_every=log_every * 5, auto_resume=True, max_retries=2,
        checkpoint_path=ck_path, log_path=log_path).validate()
    before = read_counters()
    t0 = time.perf_counter()
    res, lines = run_logged(cfg, dev, run_log)
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        rows = [json.loads(l) for l in f]
    knobs = bh_lines(lines)
    return record(rows, knobs["adapt_log"], n=n, steps=steps,
                  steps_per_sec=res.steps_per_sec, wall_s=wall,
                  seconds=res.seconds, counts=res.counts,
                  capacities=res.capacities,
                  knobs_log=knobs["knobs_log"],
                  launches=launches_since(before), device=device_line(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbodyax_torch.bench_soak_adapt",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=0,
                    help=f"bodies (default {N_CARD:,} on a card, "
                         f"{N_CPU:,} on the CPU)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--dt", type=float, default=0.02,
                    help="0.02 drifts over hundreds of steps; 0.5 "
                         "collapses half the bodies inside 20")
    ap.add_argument("--workdir", default="",
                    help="checkpoints, JSONL and the driver's output "
                         "(default: a new temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from nbodyax_torch.driver import resolve_device
    dev = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="soak_adapt_")
    os.makedirs(workdir, exist_ok=True)
    rec = run(args.n or (N_CARD if dev.type == "cuda" else N_CPU),
              args.steps, args.log_every, args.dt, workdir, dev)
    print(json.dumps(rec), flush=True)
    check_bounds(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
