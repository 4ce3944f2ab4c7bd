"""The 4M galaxy across a resume boundary, on one card.

    python -m nbodyax_torch.bench_soak4m [--steps-a 12] [--steps-b 8]
        [--n N] [--force-model exact|bh] [--bh-levels 9] [--workdir DIR]
        [--out F] [--device cuda|cpu]

Counterpart of ``bench/soak4m.py``: the galaxy scene at N = 4,194,304,
softening 100, reference merging, exact all-pairs by default (B1 over all
4,194,304^2 pairs a step in one launch; ``--force-model bh`` runs the same
soak under bh at ``bhLevels`` 9), a checkpoint and a JSONL line every 4
steps. Phase A runs ``driver.run_simulation`` for ``--steps-a`` steps;
phase B is a new ``run_simulation`` in the same process that resumes from
the latest checkpoint (the crash-recovery path: the state reloaded from
disk, the graphs captured again) and runs to ``steps_a + steps_b``. The
latest checkpoint must be phase A's last step, or the boundary is not
where it is said to be and the run raises.

Prints one JSON line: ``bench/soak4m.py``'s keys (each phase's
conservation scalars and ``finite``, ``steps_total``,
``resume_boundary_at``, phase B's pairs/s and steps/s by the driver's
step meter, ``alive_monotonic_nonincreasing``, ``wall_s``), each phase's
host seconds by part, each kernel's launches and the device (on a card
its name and power limit). A non-finite state, a missing checkpoint or a
wrong step count raises. The work directory (checkpoints and JSONL) is
emptied first. ``--device cpu`` runs N = 1,024.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from nbodyax_torch.bench import device_line, launches_since
from nbodyax_torch.bench_suite import _finite
from nbodyax_torch.graphs import read_counters

N_CARD, N_CPU = 4_194_304, 1024


def config(n: int, total: int, workdir: str, *, force_model: str = "exact",
           bh_levels: int = 9, checkpoint_every: int = 4,
           log_every: int = 4):
    """``bench/soak4m.py``'s config of a phase that ends at ``total``."""
    from nbodyax_torch.config import SimConfig
    return SimConfig(
        particle_count=n, scene="galaxy", softening=100.0,
        collision_mode="reference", total_iterations=total,
        checkpoint_every=checkpoint_every, log_every=log_every,
        save_images=False, checkpoint_path=os.path.join(workdir, "cks"),
        force_model=force_model,
        bh_levels=bh_levels if force_model == "bh" else 0,
        log_path=os.path.join(workdir, "soak.jsonl"))


def scalars(state) -> dict:
    from nbodyax_torch.metrics import conservation_scalars
    return {**conservation_scalars(state), "finite": _finite(state)}


def run(n: int, steps_a: int, steps_b: int, workdir: str, dev: torch.device,
        **kw):
    """Returns (the record, phase B's final state). ``kw``: ``config``'s
    knobs."""
    from nbodyax_torch.driver import run_simulation
    from nbodyax_torch.io.checkpoint import latest_checkpoint
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    before = read_counters()
    t0 = time.perf_counter()
    res_a = run_simulation(config(n, steps_a, workdir, **kw), device=dev,
                           quiet=True)
    a = scalars(res_a.state)
    if not a["finite"]:
        raise RuntimeError(f"phase A ended on a non-finite state: {a}")
    ck = latest_checkpoint(os.path.join(workdir, "cks"))
    if ck is None:
        raise RuntimeError("phase A wrote no checkpoint")
    with np.load(ck) as z:
        at = int(z["step"])
    if at != steps_a:
        raise RuntimeError(f"phase A's last checkpoint is at step {at}, not "
                           f"at the boundary {steps_a}: make it a multiple "
                           f"of the checkpoint cadence")
    res_b = run_simulation(dataclasses.replace(
        config(n, steps_a + steps_b, workdir, **kw), resume_from=ck),
        device=dev, quiet=True)
    b = scalars(res_b.state)
    total = int(res_b.state.step)
    record = {
        "bench": "soak4m", "n": n,
        "force_model": kw.get("force_model", "exact"),
        "steps_total": total, "resume_boundary_at": at,
        "phase_a": a, "phase_b": b,
        "pairs_per_sec_phase_b": res_b.pairs_per_sec,
        "steps_per_sec_phase_b": res_b.steps_per_sec,
        "alive_monotonic_nonincreasing": b["alive"] <= a["alive"],
        "wall_s": time.perf_counter() - t0,
        "seconds_phase_a": res_a.seconds, "seconds_phase_b": res_b.seconds,
        "launches": launches_since(before), "device": device_line(dev)}
    if not b["finite"]:
        raise RuntimeError(f"phase B ended on a non-finite state: {record}")
    if total != steps_a + steps_b:
        raise RuntimeError(f"phase B ended at step {total}, not "
                           f"{steps_a + steps_b}")
    return record, res_b.state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbodyax_torch.bench_soak4m",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps-a", type=int, default=12)
    ap.add_argument("--steps-b", type=int, default=8)
    ap.add_argument("--n", type=int, default=0,
                    help=f"bodies (default {N_CARD:,} on a card, "
                         f"{N_CPU:,} on the CPU)")
    ap.add_argument("--force-model", default="exact",
                    choices=("exact", "bh"))
    ap.add_argument("--bh-levels", type=int, default=9)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "nbodyax_torch_soak4m"))
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from nbodyax_torch.driver import resolve_device
    dev = resolve_device(args.device)
    record, _ = run(args.n or (N_CARD if dev.type == "cuda" else N_CPU),
                    args.steps_a, args.steps_b, args.workdir, dev,
                    force_model=args.force_model, bh_levels=args.bh_levels)
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
