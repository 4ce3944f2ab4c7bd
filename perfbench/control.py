"""The check's readings outside a run: the control that must fail, and the
program's own readings over many seeds in one process.

The configurations state float32; the control is the reference computed in
bfloat16 (the reference module's ``control`` precision), from the cell's
own start state at its full size, held to the check's numbers and limits
exactly as the program's first step is. It must come out not correct: the
smallest reading it gives over three seeds or more is the upper reading
each limit stays under (``PERF.md``). The benchmark's own runs do not run
it.

With ``--program`` it reads instead the program's numbers at the cell's
check steps (or ``--steps``), as a run's check does but with the end state
from a job of its own rather than a window: the lower readings of many
seeds in one process. ``--drift-window N`` plants a fault first: bh drift
windows of ``N`` steps at scale (the program's ``SCALE_DRIFT_WINDOW_STEPS``
is 1), nbodyax_torch's fault F10.

    python3 -m perfbench.control --workload <cell> --seeds 1 2 3
    python3 -m perfbench.control --workload <cell> --seeds 1 2 3 --program
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import torch

from perfbench.check import compare, judge, points, sample_rows
from perfbench.scene import draw_scene
from perfbench.spec import load_cell, load_module

__all__ = ["control_numbers", "program_numbers"]


def control_numbers(cell, seed: int, device) -> dict:
    """The check's numbers of the control's first step from ``seed``'s
    start state."""
    s0 = tuple(torch.from_numpy(a).to(device)
               for a in draw_scene(seed, cell.params, cell.root))
    rows = sample_rows(seed, s0[2], s0[3], int(cell.check["sample"]),
                       int(cell.check.get("giants", 0)),
                       int(cell.params.get("shards", 1)), salt=1).to(device)
    step = load_module("reference", cell.reference, cell.root).step
    ref = step(*s0, rows, cell.params, precision="reference")
    ctrl = step(*s0, rows, cell.params, precision="control")
    whole = [t.clone() for t in s0]
    for w, c in zip(whole, ctrl):
        w[rows] = c
    field = max(float(cell.params["fieldWidth"]),
                float(cell.params["fieldHeight"]))
    return compare(s0, whole, ref, rows, field)


def program_numbers(cell, seed: int, device) -> dict:
    """The check's numbers of the program's steps that ``cell.check``
    lists, from ``seed``'s start state, on one process."""
    from nbodyax_torch.state import make_state
    from perfbench.worker import _Jobs, check_numbers
    run_dir = tempfile.mkdtemp(prefix="perfbench-program-",
                               dir=os.environ.get("TMPDIR"))
    try:
        jobs = _Jobs(cell, device, run_dir)
        s0 = make_state(*draw_scene(seed, cell.params, cell.root),
                        device=device)
        H = cell.horizon
        s_h = (tuple(t.clone() for t in jobs.run(H, "end", s0)[0].state[:4])
               if H - 1 in points(cell.check, H) else None)
        return check_numbers(cell, seed, jobs, s0, s_h, True, 1)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--steps", type=int, nargs="+",
                    help="with --program: the check steps to read")
    ap.add_argument("--drift-window", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if cell.chips > 1 and args.program:
        print("perfbench.control: --program reads one-card cells",
              file=sys.stderr)
        return 2
    if args.steps:
        cell = dataclasses.replace(cell, check=dict(cell.check,
                                                    steps=args.steps))
    if args.drift_window:
        import nbodyax_torch.driver as driver
        driver.SCALE_DRIFT_WINDOW_STEPS = args.drift_window
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        nums = (program_numbers if args.program else control_numbers)(
            cell, seed, dev)
        verdicts = judge(nums, {k: v for k, v in cell.check["limits"].items()
                                if k in nums})
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": args.program,
                          "drift_window": args.drift_window,
                          "steps": cell.check.get("steps"),
                          "numbers": nums,
                          "fails": sorted(k for k, (_, _, ok)
                                          in verdicts.items() if not ok)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
