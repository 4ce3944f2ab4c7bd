"""Post-processing utilities.

Counterpart of ``nbodyax/tools.py``:

``python -m nbodyax_torch.tools gif <frame_dir> [out.gif] [--fps 20]
[--scale 1]`` assembles the ``iteration_*.ppm`` frames of a run into an
animated GIF (needs pillow).

``python -m nbodyax_torch.tools dump <checkpoint> [--limit K]
[--alive-only]`` prints each body of a checkpoint (either package's) in
the reference's ``printData`` format.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

__all__ = ["read_pgm", "list_frames", "make_gif", "dump_checkpoint", "main"]

_FRAME_RE = re.compile(r"^iteration_(\d+)\.ppm$")


def read_pgm(path: str) -> np.ndarray:
    """Read a binary P5 file as the frame writer (and the reference) writes
    it: ``P5\\n<w> <h>\\n255\\n`` and the raster."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P5"):
        raise ValueError(f"{path}: not a binary PGM (P5) file")
    parts = data.split(b"\n", 3)
    w, h = (int(v) for v in parts[1].split())
    return np.frombuffer(parts[3][:w * h], np.uint8).reshape(h, w)


def list_frames(directory: str) -> list:
    """The frame files of ``directory``, by iteration."""
    frames = []
    for name in os.listdir(directory):
        m = _FRAME_RE.match(name)
        if m:
            frames.append((int(m.group(1)), os.path.join(directory, name)))
    return [p for _, p in sorted(frames)]


def make_gif(frame_dir: str, out: str = "", fps: float = 20.0,
             scale: int = 1) -> str:
    """Write the frames of ``frame_dir`` as an animated GIF (default
    ``frame_dir/animation.gif``), every ``scale``-th pixel; returns its
    path."""
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit("GIF assembly needs pillow") from e
    paths = list_frames(frame_dir)
    if not paths:
        raise SystemExit(f"no iteration_*.ppm frames in {frame_dir}")
    out = out or os.path.join(frame_dir, "animation.gif")
    images = [Image.fromarray(read_pgm(p)[::scale, ::scale], mode="L")
              for p in paths]
    images[0].save(out, save_all=True, append_images=images[1:],
                   duration=max(1, int(1000 / fps)), loop=0)
    return out


def dump_checkpoint(path: str, limit: int = 0, alive_only: bool = False,
                    out=None) -> int:
    """Print each body of the checkpoint at ``path`` (at most ``limit``,
    0 = all); returns the number printed."""
    from nbodyax_torch.io.checkpoint import load_checkpoint
    out = out or sys.stdout
    state = load_checkpoint(path, device="cpu")
    pos, vel = state.pos.numpy(), state.vel.numpy()
    mass, radius = state.mass.numpy(), state.radius.numpy()
    alive = mass > 0
    print(f"Checkpoint {path}: step {state.step}, "
          f"sim_time {float(state.sim_time):.6g}, "
          f"{int(alive.sum())} alive / {mass.shape[0]} slots", file=out)
    printed = 0
    for i in range(mass.shape[0]):
        if alive_only and not alive[i]:
            continue
        if limit and printed >= limit:
            print(f"... ({mass.shape[0] - i} more slots)", file=out)
            break
        coords = ", ".join(f"{c:.4f}" for c in pos[i])
        vels = ", ".join(f"{c:.4f}" for c in vel[i])
        print(f"Body #{i}{'' if alive[i] else ' (dead)'}", file=out)
        print(f"Position: ({coords})", file=out)
        print(f"Velocity: ({vels})", file=out)
        print(f"Mass: {mass[i]:.4f}", file=out)
        print(f"Radius: {radius[i]:.4f}", file=out)
        print("--------------", file=out)
        printed += 1
    return printed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nbodyax_torch.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gif", help="assemble frames into an animated GIF")
    g.add_argument("frame_dir")
    g.add_argument("out", nargs="?", default="")
    g.add_argument("--fps", type=float, default=20.0)
    g.add_argument("--scale", type=int, default=1,
                   help="downsample factor (2 = half resolution)")
    d = sub.add_parser("dump", help="print per-body state from a checkpoint "
                                    "(the reference's printData format)")
    d.add_argument("checkpoint")
    d.add_argument("--limit", type=int, default=0,
                   help="print at most K bodies (0 = all)")
    d.add_argument("--alive-only", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "gif":
        out = make_gif(args.frame_dir, args.out, args.fps, args.scale)
        print(f"wrote {out} ({len(list_frames(args.frame_dir))} frames)")
    else:
        dump_checkpoint(args.checkpoint, args.limit, args.alive_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
