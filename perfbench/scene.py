"""The benchmark's own draw of a cell's start state, in numpy, from the seed.

A scene is a file of its own, ``perfbench/scenes/<scene>.py``, named by the
cell's ``scene`` key, with ``draw(generator, n, params)`` returning
``(pos, vel, mass, radius)`` in the deployment's distributions. The draw
is not bit for bit the program's: every seed gives the same kind of work,
and the program's own fill stays out of the yardstick. Values are drawn in
float64 and rounded once to float32, the state's type.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from perfbench.spec import ROOT, load_module

__all__ = ["draw_scene", "rng"]


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``seed`` (any whole number, negative too) for one
    stream of draws: the scene is stream 0, the check's samples others."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) % (1 << 64), stream])))


def draw_scene(seed: int, params: dict, root: Path = ROOT):
    """``(pos f32[N, 2], vel f32[N, 2], mass f32[N], radius f32[N])`` of the
    cell's scene (``params``: the configuration's and the cell's
    ``nbodyConfig.txt`` keys) from ``seed``."""
    scene = str(params.get("scene", "uniform"))
    try:
        draw = load_module("scenes", scene, root).draw
    except FileNotFoundError as e:
        raise ValueError(f"no draw for scene {scene!r}") from e
    out = draw(rng(seed), int(params["particleCount"]), params)
    return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in out)
