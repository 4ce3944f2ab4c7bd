"""The ``galaxy`` scene (the port's ``galaxy_scene`` formulas): two 2-D
rotating disks on a collision course along x, each a heavy central body
plus orbiters on circular orbits."""

import math

import numpy as np

GRAV_CONSTANT = float(np.float32(6.67408e-11))


def draw(g: np.random.Generator, n: int, p: dict):
    if int(p.get("dimensions", 2)) != 2:
        raise ValueError("the galaxy draw is 2-D")
    if n < 4:
        raise ValueError("the galaxy scene needs at least 4 bodies")
    fw, fh = float(p["fieldWidth"]), float(p["fieldHeight"])
    lo_m, hi_m = float(p["minRandBodyMass"]), float(p["maxRandBodyMass"])
    lo_r, hi_r = float(p["minRadius"]), float(p["maxRadius"])
    sep = 0.5 * fw
    disk_r = 0.25 * min(fw, fh)
    approach_v = 0.25 * math.sqrt(GRAV_CONSTANT * hi_m / sep)
    # radii scaled so the bodies cover 1% of a disk's area
    mean_r2 = (lo_r ** 2 + lo_r * hi_r + hi_r ** 2) / 3.0
    packing = n * mean_r2 / disk_r ** 2
    r_scale = min(1.0, math.sqrt(0.01 / max(packing, 1e-30)))

    def disk(count, cx, drift):
        m = count - 1
        r = disk_r * np.sqrt(g.uniform(0.01, 1.0, m))
        th = g.uniform(0.0, 2 * math.pi, m)
        vc = np.sqrt(GRAV_CONSTANT * hi_m / r)
        pos = np.stack([cx + r * np.cos(th), r * np.sin(th)], -1)
        vel = np.stack([drift - vc * np.sin(th), vc * np.cos(th)], -1)
        mass = g.uniform(lo_m, 0.01 * hi_m, m)
        rad = g.uniform(lo_r * r_scale, hi_r * r_scale, m)
        return (np.concatenate([[[cx, 0.0]], pos]),
                np.concatenate([[[drift, 0.0]], vel]),
                np.concatenate([[hi_m], mass]), np.concatenate([[hi_r], rad]))

    a = disk(n // 2, -sep / 2, approach_v)
    b = disk(n - n // 2, sep / 2, -approach_v)
    return tuple(np.concatenate(x) for x in zip(a, b))
