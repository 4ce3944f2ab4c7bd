"""The 4M galaxy for 10,000 bh steps (BASELINE config 5's horizon) in
resumable stages, on one card.

    python -m nbodyax_torch.bench_soak10k --until K [--total 10000]
        [--n N] [--workdir DIR] [--out F] [--partial-ok] [--log-every 50]
        [--checkpoint-every 100] [--compact-every 100] [--device cuda|cpu]

Counterpart of ``bench/soak10k.py``: the galaxy scene at N = 4,194,304,
softening 100, reference merging, ``forceModel=bh`` with auto knobs.

- ``--until K`` runs from the work directory's latest checkpoint (or a
  fresh scene) to step K in one ``driver.run_simulation`` with autoResume
  and ``maxRetries`` 5 (a failure reloads the newest snapshot and goes on).
- Running the runner again with a larger ``--until`` is a real resume
  boundary: a new process, the state reloaded from disk, the graphs
  captured anew. The full run is ``--until 5000`` then ``--until 10000``.
- A checkpoint every 100 steps, the newest 3 kept beside every 2,000th
  (``checkpointKeep``, ``checkpointMilestoneEvery``); a JSONL line every 50
  steps (alive, mass, momentum, kinetic energy, sim time, the window's
  device ms a step, ``bh_overflow``) into one file across stages;
  compaction every 100 steps, and sooner whenever the live count halves the
  capacity.

Each stage appends its record (``stage_from``, ``stage_to``, ``wall_s``,
``steps_per_sec``, ``finite``, ``windows``, the conservation scalars, the
host seconds by part and counts, the capacities after each compaction,
the bh knobs the driver chose and each of its ``bh adapt`` lines, each
kernel's launches and the device: on a card its name and power limit) to
``stages.jsonl`` and prints it; the driver's printed lines go to
``run.log`` in the work directory. When the state reaches ``--total`` (or
with ``--partial-ok``) ``summarize`` turns the JSONL into one record with
``bench/soak10k.py``'s keys (its ``_summarize``: the last entry of each
step, since a retried attempt logs its steps again; the end-to-end wall
from the stage records when they cover the run, else the JSONL's device
estimate) plus ``bh_overflow`` at every log point and the total mass's
drift, from the first log point and from step 0's checkpoint (kept as a
milestone), printed and written to ``--out``. The census reads only log
points: merges dropped between them show in the mass. A non-finite state
or a stage that ends short raises.
``--device cpu`` runs N = 1,024.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from nbodyax_torch.bench import (bh_lines, device_line, launches_since,
                                 run_logged)
from nbodyax_torch.bench_suite import _finite
from nbodyax_torch.graphs import read_counters

N_CARD, N_CPU = 4_194_304, 1024


def config(n: int, until: int, workdir: str, *, log_every: int = 50,
           checkpoint_every: int = 100, compact_every: int = 100):
    """``bench/soak10k.py``'s config of a stage that ends at ``until``."""
    from nbodyax_torch.config import SimConfig
    return SimConfig(
        particle_count=n, scene="galaxy", softening=100.0,
        collision_mode="reference", force_model="bh",
        total_iterations=until, save_images=False, log_every=log_every,
        log_path=os.path.join(workdir, "soak.jsonl"),
        checkpoint_every=checkpoint_every,
        checkpoint_path=os.path.join(workdir, "cks"), checkpoint_keep=3,
        checkpoint_milestone_every=2000, compact_every=compact_every,
        auto_resume=True, max_retries=5)


def run_stage(n: int, until: int, workdir: str, dev: torch.device, **kw):
    """One stage to step ``until`` from the latest checkpoint; returns its
    record, or None when the checkpoint is there already."""
    import dataclasses

    from nbodyax_torch.io.checkpoint import latest_checkpoint
    from nbodyax_torch.metrics import conservation_scalars
    cfg = config(n, until, workdir, **kw)
    ck = latest_checkpoint(cfg.checkpoint_path)
    resumed_from = 0
    if ck is not None:
        cfg = dataclasses.replace(cfg, resume_from=ck)
        with np.load(ck) as z:
            resumed_from = int(z["step"])
        if resumed_from >= until:
            print(f"latest checkpoint already at step {resumed_from} >= "
                  f"--until {until}; nothing to run")
            return None
    before = read_counters()
    t0 = time.perf_counter()
    res, lines = run_logged(cfg, dev, os.path.join(workdir, "run.log"))
    end = int(res.state.step)
    stage = {"stage_from": resumed_from, "stage_to": end,
             "wall_s": time.perf_counter() - t0,
             "steps_per_sec": res.steps_per_sec, "finite": _finite(res.state),
             "windows": res.windows, **conservation_scalars(res.state),
             "seconds": res.seconds, "counts": res.counts,
             "capacities": res.capacities,
             **bh_lines(lines), "launches": launches_since(before),
             "device": device_line(dev)}
    with open(os.path.join(workdir, "stages.jsonl"), "a") as f:
        f.write(json.dumps(stage) + "\n")
    print(json.dumps(stage), flush=True)
    if not stage["finite"]:
        raise RuntimeError("the stage ended on a non-finite state")
    if end != until:
        raise RuntimeError(f"the stage ended at step {end}, not {until}")
    return stage


def summarize(rows: list, stages: list, *, n: int, horizon: int,
              log_every: int, checkpoints: list,
              mass_start: float | None = None) -> dict:
    """``bench/soak10k.py``'s ``_summarize`` record of the JSONL ``rows``
    and the ``stages`` records, with ``bh_overflow`` at every log point and
    the total mass's drift: from the first log point to the last
    (``total_mass_drift``, what ``bench/soak10k.py``'s keys give) and,
    given the starting state's ``mass_start``, from step 0
    (``total_mass_drift_from_start``). The census reads only log points;
    merges dropped between them show in the mass."""
    # a failed attempt that was resumed mid-stage logs its steps again:
    # keep the last entry of each step, the attempt that went on
    by_step = {r["step"]: r for r in rows}
    steps = sorted(by_step)
    rows = [by_step[s] for s in steps]
    overflow = [r.get("bh_overflow", 0) for r in rows]
    # persistent: two nonzero logs in a row (bhAdapt heals a single one)
    persistent = sum(1 for i in range(1, len(overflow))
                     if overflow[i] and overflow[i - 1])
    wall_jsonl = sum(r["wall_ms"] * log_every / 1000.0 for r in rows)
    covered = bool(stages and min(s["stage_from"] for s in stages) == 0
                   and max(s["stage_to"] for s in stages)
                   >= (steps[-1] if steps else 0))
    wall = sum(s["wall_s"] for s in stages) if covered else wall_jsonl
    last = steps[-1] if steps else 0
    return {
        "bench": "soak10k_config5", "n": n, "force_model": "bh",
        "scene": "galaxy", "steps_total": last,
        "partial": bool(steps and last < horizon), "horizon": horizon,
        "log_points": len(rows),
        "resume_boundaries": max(0, len(stages) - 1),
        "auto_resume_retries_visible": sum(
            1 for i in range(1, len(stages))
            if stages[i]["stage_from"] < stages[i - 1]["stage_to"]),
        "alive_first": rows[0]["alive"], "alive_last": rows[-1]["alive"],
        "alive_monotonic_nonincreasing": all(
            rows[i]["alive"] >= rows[i + 1]["alive"]
            for i in range(len(rows) - 1)),
        "total_mass_first": rows[0]["total_mass"],
        "total_mass_last": rows[-1]["total_mass"],
        "total_mass_start": mass_start,
        "total_mass_drift": rows[-1]["total_mass"] / rows[0]["total_mass"]
        - 1.0,
        "total_mass_drift_from_start": (
            None if mass_start is None
            else rows[-1]["total_mass"] / mass_start - 1.0),
        "kinetic_energy_last": rows[-1]["kinetic_energy"],
        "sim_time_last": rows[-1].get("sim_time", 0.0),
        "bh_overflow_nonzero_logs": sum(1 for o in overflow if o),
        "bh_overflow_persistent_pairs": persistent,
        "bh_overflow_max": max(overflow) if overflow else 0,
        "bh_overflow_last": overflow[-1] if overflow else 0,
        "bh_overflow_by_log": [[s, o] for s, o in zip(steps, overflow)],
        "finite_all_stages": all(s["finite"] for s in stages),
        "wall_s_total": wall, "wall_s_device_estimate": wall_jsonl,
        "steps_per_sec_mean": last / wall if wall else 0.0,
        "checkpoints_on_disk": checkpoints}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbodyax_torch.bench_soak10k",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=0,
                    help=f"bodies (default {N_CARD:,} on a card, "
                         f"{N_CPU:,} on the CPU)")
    ap.add_argument("--until", type=int, default=10_000,
                    help="run from the latest checkpoint to this step")
    ap.add_argument("--total", type=int, default=10_000,
                    help="the whole horizon: the summary is written when "
                         "the state reaches it")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "nbodyax_torch_soak10k"))
    ap.add_argument("--out", default="")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--compact-every", type=int, default=100)
    ap.add_argument("--partial-ok", action="store_true",
                    help="summarize before the whole horizon too")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from nbodyax_torch.driver import resolve_device
    from nbodyax_torch.io.checkpoint import latest_checkpoint, load_checkpoint
    from nbodyax_torch.metrics import conservation_scalars
    dev = resolve_device(args.device)
    n = args.n or (N_CARD if dev.type == "cuda" else N_CPU)
    os.makedirs(args.workdir, exist_ok=True)
    stage = run_stage(n, args.until, args.workdir, dev,
                      log_every=args.log_every,
                      checkpoint_every=args.checkpoint_every,
                      compact_every=args.compact_every)
    if stage is not None:
        end = stage["stage_to"]
    else:
        with np.load(latest_checkpoint(os.path.join(args.workdir,
                                                    "cks"))) as z:
            end = int(z["step"])
    if end >= args.total or args.partial_ok:
        with open(os.path.join(args.workdir, "soak.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(args.workdir, "stages.jsonl")) as f:
            stages = [json.loads(line) for line in f]
        cks = os.path.join(args.workdir, "cks")
        first = os.path.join(cks, "step_000000000.npz")   # a milestone
        mass_start = None
        if os.path.exists(first):
            mass_start = conservation_scalars(load_checkpoint(
                first, device="cpu"))["total_mass"]
        record = summarize(rows, stages, n=n, horizon=args.total,
                           log_every=args.log_every,
                           checkpoints=sorted(os.listdir(cks)),
                           mass_start=mass_start)
        print(json.dumps(record), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
