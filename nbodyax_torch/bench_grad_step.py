"""Gradient-step timing at the forward headline's scale: reverse mode
through a k-step rollout of the exact step on the pair kernels, N =
1,048,576 on one card.

    python -m nbodyax_torch.bench_grad_step [--n N] [--steps 4]
        [--mode reference|momentum|elastic] [--reps 3] [--out F]
        [--device cuda|cpu]

Counterpart of ``bench/grad_step.py``: ``SimConfig(particle_count=n,
collision_mode=mode, softening=100, save_images=False)``, the step of
``make_step`` over ``backends.build_accum_fn("auto", ...)``'s pair
accumulators (on a card B1 forward and B2, its analytic VJP, backward; on
the CPU their plain versions), and ``make_loss(step, steps, terminal)``
with each step checkpointed (the backward re-runs it) and ``terminal``
the mean squared distance to the origin of the alive bodies. The gradient
is taken with respect to ``pos`` alone, as ``nbodyax`` takes it, through
``autodiff.graphed_value_and_grad``: on a card its first call warms up
and captures forward, re-runs and backward into one CUDA graph, and
``--reps`` replays follow, each timed by the host clock and fenced by
``torch.cuda.synchronize``. The forward step is timed as
``nbodyax_torch.bench`` times it: one-step graph windows of the driver, a
warm one and then ``--reps``.

Prints one JSON line: ``bench/grad_step.py``'s keys (``forward_step_s``,
``grad_wall_s``, ``grad_step_s = grad_wall_s / steps``,
``grad_over_forward``, ``grad_abs_sum``; the times are medians), the
spread of each timing ((max - min) / median), the gradient graph's
capture seconds, the card's peak allocated memory over the gradient, each
kernel's launches in the run and in one gradient replay, and the device
(on a card its name and power limit). A zero or non-finite gradient
raises. ``--device cpu`` runs N = 1,024, 2 steps, 2 replays.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch

from nbodyax_torch.bench import (device_line, launches_since, spread_keys,
                                 time_steps)
from nbodyax_torch.graphs import read_counters

N_CARD, N_CPU = 1_048_576, 1024
MODES = ("reference", "momentum", "elastic")


def terminal(s) -> torch.Tensor:
    """The mean squared distance to the origin of the alive bodies:
    O(1)-conditioned, every position contributes."""
    w = (s.mass > 0).to(s.pos.dtype)
    return (w * (s.pos * s.pos).sum(-1)).sum() / w.sum()


def setup(n: int, steps: int, mode: str, dev: torch.device):
    """(config, starting state, step, loss) of ``bench/grad_step.py``."""
    from nbodyax_torch.autodiff import make_loss
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.scenes import init_scene
    cfg = SimConfig(particle_count=n, collision_mode=mode, softening=100.0,
                    save_images=False)
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn("auto", p, dev))
    return (cfg, init_scene(cfg, device=dev), step,
            make_loss(step, steps, terminal))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n: int, steps: int, mode: str, reps: int, dev: torch.device):
    """Returns (the record, the gradient with respect to ``pos``)."""
    from nbodyax_torch.autodiff import graphed_value_and_grad
    cfg, state, step, loss = setup(n, steps, mode, dev)
    before = read_counters()
    _, fwd, _ = time_steps(step, state, cfg, steps=reps, chunk=1)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with graphed_value_and_grad(loss, wrt=("pos",)) as vg:
        t0 = time.perf_counter()
        _, (g,) = vg(state)
        _sync(dev)
        first = time.perf_counter() - t0
        gsum = float(g.abs().sum())
        if not (math.isfinite(gsum) and gsum > 0):
            raise RuntimeError(f"zero or non-finite gradient: sum |g| = "
                               f"{gsum}")
        mid = read_counters()
        seconds = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _, (g,) = vg(state)
            _sync(dev)
            seconds.append(time.perf_counter() - t0)
        grad = g.detach().clone()
        capture = vg.capture_seconds
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    per_replay = {k: v / reps for k, v in launches_since(mid).items()}
    t_fwd, t_grad = statistics.median(fwd), statistics.median(seconds)
    record = {
        "bench": "grad_step", "n": n, "steps": steps, "mode": mode,
        "backend": "auto", "reps": reps,
        "forward_step_s": t_fwd,
        "forward_spread": spread_keys(fwd)["spread"],
        "grad_wall_s": t_grad, "grad_wall_s_min": min(seconds),
        "grad_wall_s_max": max(seconds),
        "grad_spread": spread_keys(seconds)["spread"],
        "grad_step_s": t_grad / steps,
        "grad_over_forward": t_grad / steps / t_fwd,
        "grad_abs_sum": gsum,
        "grad_first_call_s": first, "capture_s": capture,
        "peak_gib": peak, "launches": launches_since(before),
        "launches_a_replay": per_replay, "device": device_line(dev)}
    return record, grad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbodyax_torch.bench_grad_step",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=0,
                    help=f"bodies (default {N_CARD:,} on a card, "
                         f"{N_CPU:,} on the CPU)")
    ap.add_argument("--steps", type=int, default=0,
                    help="rollout steps (default 4 on a card, 2 on the CPU)")
    ap.add_argument("--mode", default="reference", choices=MODES)
    ap.add_argument("--reps", type=int, default=0,
                    help="timed replays (default 3 on a card, 2 on the CPU)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from nbodyax_torch.driver import resolve_device
    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    record, _ = run(args.n or (N_CARD if card else N_CPU),
                    args.steps or (4 if card else 2), args.mode,
                    args.reps or (3 if card else 2), dev)
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
