"""Checkpoint / resume.

Counterpart of ``nbodyax/io/checkpoint.py``, in the same file format, so a
snapshot written by either package loads in the other bit for bit: one
``np.savez`` a snapshot, ``{dir}/step_{step:09d}.npz``, holding format
version 1, pos, vel, mass, radius (f32), step (i32), sim_time (f32) and
any scalar metadata under ``meta_``-prefixed keys. A save writes
``.tmp.npz`` first and renames it into place, so a crash mid-write never
leaves a truncated snapshot under the final name.

Retention: after each save, ``save_checkpoint`` keeps the newest
``keep_last`` snapshots (0 = keep everything) plus every snapshot whose
step is a multiple of ``milestone_every`` (0 = no milestones). Pruning
only deletes files matching ``step_*.npz`` in the checkpoint directory.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from nbodyax_torch.state import SimState, make_state

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "prune_checkpoints", "load_checkpoint_extra"]

_FORMAT_VERSION = 1
_NAME_RE = re.compile(r"^step_(\d+)\.npz$")


def save_checkpoint(directory: str, state: SimState, *,
                    keep_last: int = 0, milestone_every: int = 0,
                    extra: Optional[dict] = None) -> str:
    """Write ``state`` (copied to the host) as the snapshot of its step;
    returns its path. ``extra``: scalar metadata saved under ``meta_``
    keys (the driver stores its resolved bh knobs there, so a resumed run
    steps with the knobs the interrupted one had)."""
    os.makedirs(directory, exist_ok=True)
    step = int(state.step)
    path = os.path.join(directory, f"step_{step:09d}.npz")
    tmp = path + ".tmp.npz"  # .npz suffix so np.savez doesn't append one
    meta = {f"meta_{k}": np.asarray(v) for k, v in (extra or {}).items()}
    np.savez(tmp,
             version=np.int32(_FORMAT_VERSION),
             pos=state.pos.cpu().numpy(),
             vel=state.vel.cpu().numpy(),
             mass=state.mass.cpu().numpy(),
             radius=state.radius.cpu().numpy(),
             step=np.int32(step),
             sim_time=np.float32(state.sim_time.cpu().numpy()),
             **meta)
    os.replace(tmp, path)
    if keep_last:
        prune_checkpoints(directory, keep_last=keep_last,
                          milestone_every=milestone_every)
    return path


def _snapshots(directory: str) -> list:
    """[(step, file name)] of the snapshots in ``directory``, by step."""
    if not os.path.isdir(directory):
        return []
    return sorted((int(m.group(1)), name) for name in os.listdir(directory)
                  if (m := _NAME_RE.match(name)))


def prune_checkpoints(directory: str, *, keep_last: int,
                      milestone_every: int = 0) -> list[str]:
    """Delete all but the newest ``keep_last`` snapshots (by step number);
    snapshots at ``milestone_every`` multiples are always kept. Returns
    the deleted paths."""
    if keep_last <= 0:
        return []
    deleted = []
    for step, name in _snapshots(directory)[:-keep_last]:
        if milestone_every and step % milestone_every == 0:
            continue
        p = os.path.join(directory, name)
        os.remove(p)
        deleted.append(p)
    return deleted


def load_checkpoint(path: str, *, device: torch.device | str) -> SimState:
    """The snapshot at ``path`` as a SimState on ``device`` (its step a
    host int). A snapshot without ``sim_time`` resumes at 0."""
    with np.load(path) as z:
        version = int(z["version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint {path} has newer format {version}")
        t = float(z["sim_time"]) if "sim_time" in z.files else 0.0
        return make_state(z["pos"], z["vel"], z["mass"], z["radius"],
                          step=int(z["step"]), sim_time=t, device=device)


def load_checkpoint_extra(path: str) -> dict:
    """The ``extra`` metadata a snapshot was saved with (un-prefixed keys,
    Python scalars); empty for snapshots without any."""
    with np.load(path) as z:
        return {k[len("meta_"):]: z[k].item() for k in z.files
                if k.startswith("meta_")}


def latest_checkpoint(directory: str) -> Optional[str]:
    """The path of the snapshot with the highest step, or None."""
    snaps = _snapshots(directory)
    return os.path.join(directory, snaps[-1][1]) if snaps else None
