"""The ``uniform3d`` scene (``nbodyax_torch.scenes``' uniform distribution in
3-D): positions uniform over [-fieldWidth, fieldWidth] x [-fieldHeight,
fieldHeight] x [-depth, depth], depth = ``fieldDepth`` or, where that is 0
or absent, ``fieldWidth`` (the program's z interval); bodies at rest, mass
and radius uniform over the configuration's ranges."""

import numpy as np


def draw(g: np.random.Generator, n: int, p: dict):
    if int(p.get("dimensions", 2)) != 3:
        raise ValueError("the uniform3d draw is 3-D")
    fw, fh = float(p["fieldWidth"]), float(p["fieldHeight"])
    fd = float(p.get("fieldDepth", 0)) or fw
    pos = np.stack([g.uniform(-fw, fw, n), g.uniform(-fh, fh, n),
                    g.uniform(-fd, fd, n)], -1)
    mass = g.uniform(float(p["minRandBodyMass"]), float(p["maxRandBodyMass"]),
                     n)
    radius = g.uniform(float(p["minRadius"]), float(p["maxRadius"]), n)
    return pos, np.zeros((n, 3)), mass, radius
