"""The comparison that decides ``correct``.

The program's answers are body states. The reference (``reference/``, the
module the configuration names) cannot follow a million bodies for a
whole job inside a run's time: it costs rows x N pairs a step. So it
follows the program one step at a time, from the program's own state,
at the steps the cell's ``check.steps`` lists (``points``): for each
``k`` there, the program's ``S_{k+1}`` against one reference step from
its ``S_k``, where ``S_k`` is the end of a job of ``k`` steps from the
same start (``S_0`` is the benchmark's own draw, and ``S_H`` the timed
window's last job's end). By default the first step (``k = 0``) and the
last (``k = H - 1``); a cell lists more where its job does something
else in between (drift-mode probes, compaction).

The rows are a seeded draw of live bodies, the same number from each
shard's slab (so every rank's rows and every hop of a ring are read),
plus the bodies of largest radius (the giants, which the bh path handles
in a pass of their own); every row where the cell has no more than the
sample's size. Each row is compared whole:

- ``collide``: the largest relative gap in mass or radius, 1 where one
  side has the body alive and the other dead: the pair pass's contact
  decisions and the merge commit;
- ``dv``: the largest gap in velocity over the largest velocity change
  the reference makes among the rows: gravity, walls and the kick;
- ``dx``: the largest gap in position over the field's half-width: the
  drift. One float32 ulp of a position is 6e-8 of it.

Each is the worst over the steps compared, and has a limit of its own in
the cell's file, set from the readings of sound runs and of the control
(``PERF.md``).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from perfbench.scene import rng
from perfbench.spec import ROOT, load_module

__all__ = ["points", "row_salt", "sample_rows", "compare", "check_step",
           "judge", "NUMBERS"]

NUMBERS = ("collide", "dv", "dx")


def points(check: dict, horizon: int) -> list:
    """The steps ``k`` whose step ``k -> k + 1`` is compared, in order."""
    steps = sorted({int(k) for k in check.get("steps", (0, horizon - 1))})
    if not steps or steps[0] < 0 or steps[-1] > horizon - 1:
        raise ValueError(f"check steps {steps} outside 0..{horizon - 1}")
    return steps


def row_salt(k: int, horizon: int) -> int:
    """The stream of step ``k``'s rows: the last step's 0, the first's 1,
    another ``k``'s ``k + 2``."""
    return 0 if k == horizon - 1 else 1 if k == 0 else k + 2


def sample_rows(seed: int, mass, radius, k: int, giants: int,
                shards: int = 1, salt: int = 0) -> torch.Tensor:
    """Row ids to compare (int64, sorted): ``k`` live rows drawn from
    ``seed``, ``k // shards`` from each shard's slab of the state padded to
    a multiple of ``shards``, plus the ``giants`` live rows of largest
    radius. All live rows when there are no more than ``k``."""
    m = mass.detach().cpu().numpy()
    live = np.flatnonzero(m > 0)
    if live.size <= k:
        return torch.from_numpy(live.astype(np.int64))
    g = rng(seed, 1 + salt)
    slab = -(-m.shape[0] // shards)
    picks = []
    for s in range(shards):
        pool = live[(live >= s * slab) & (live < (s + 1) * slab)]
        take = min(pool.size, k // shards)
        picks.append(g.choice(pool, size=take, replace=False))
    if giants:
        r = radius.detach().cpu().numpy()[live]
        picks.append(live[np.argsort(-r, kind="stable")[:giants]])
    return torch.from_numpy(np.unique(np.concatenate(picks)).astype(np.int64))


def compare(start, prog, ref, rows, field: float) -> dict:
    """The three numbers of rows ``rows`` of the program's next state
    ``prog`` (whole) against the reference's ``ref`` (the rows' own), from
    the step-start state ``start``, in a field of half-width ``field``.
    Each is a float, 0 at a perfect match; NaN anywhere reads as
    infinity."""
    p_pos, p_vel, p_m, p_r = (t[rows].double() for t in prog[:4])
    r_pos, r_vel, r_m, r_r = (t.double() for t in ref[:4])
    s_vel = start[1][rows].double()
    pa, ra = p_m > 0, r_m > 0
    both = pa & ra
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp_min(1e-30))
    col = torch.where(pa != ra, torch.ones_like(p_m), torch.zeros_like(p_m))
    col = torch.maximum(col, torch.where(
        both, torch.maximum(rel(p_m, r_m), rel(p_r, r_r)),
        torch.zeros_like(p_m)))

    def gap(p, r):
        if not bool(both.any()):
            return 0.0
        return float((p - r).abs().amax(1)[both].max())

    scale = (r_vel - s_vel).abs().amax(1)[both].max() if bool(both.any()) \
        else torch.ones(())
    out = {"collide": float(col.max()) if col.numel() else 0.0,
           "dv": gap(p_vel, r_vel) / max(float(scale), 1e-30),
           "dx": gap(p_pos, r_pos) / field}
    nan = any(bool(torch.isnan(t).any()) for t in (*prog[:4],))
    return {k: (math.inf if (nan or math.isnan(v)) else v)
            for k, v in out.items()}


def check_step(start, prog_next, seed: int, params: dict, check: dict,
               shards: int, salt: int, reference: str,
               root: Path = ROOT) -> dict:
    """The numbers of the step from ``start`` (a state's four tensors,
    whole) to the program's ``prog_next``, on rows drawn from ``seed``,
    against the reference module ``reference`` under ``root``."""
    start = _match_capacity(start, prog_next)
    rows = sample_rows(seed, start[2], start[3], int(check["sample"]),
                       int(check.get("giants", 0)), shards, salt)
    ref = load_module("reference", reference, root).step(*start[:4], rows,
                                                         params)
    field = max(float(params["fieldWidth"]), float(params["fieldHeight"]))
    return compare(start, prog_next, ref, rows.to(start[0].device), field)


def _match_capacity(start, nxt):
    """``start`` as the program holds it when ``nxt`` is smaller: the
    program compacts after a window (survivors in order, then empty
    slots), so its step-H rows are ``start``'s live rows in order."""
    n = nxt[0].shape[0]
    if start[0].shape[0] == n:
        return start
    keep = torch.nonzero(start[2] > 0).squeeze(1)[:n]

    def gather(x):
        out = x.new_zeros((n,) + tuple(x.shape[1:]))
        out[:keep.shape[0]] = x[keep]
        return out

    return tuple(gather(t) for t in start[:4])


def judge(numbers: dict, limits: dict) -> dict:
    """``{name: (value, limit, ok)}`` for every limit; a number without a
    limit is not compared."""
    return {k: (numbers.get(k, math.inf), lim,
                numbers.get(k, math.inf) <= lim)
            for k, lim in limits.items()}
