"""The ``uniform`` scene (``nbodyax_torch.scenes``' distribution): 2-D
positions uniform over [-fieldWidth, fieldWidth] x [-fieldHeight,
fieldHeight], bodies at rest, mass and radius uniform over the
configuration's ranges."""

import numpy as np


def draw(g: np.random.Generator, n: int, p: dict):
    if int(p.get("dimensions", 2)) != 2:
        raise ValueError("the uniform draw is 2-D")
    fw, fh = float(p["fieldWidth"]), float(p["fieldHeight"])
    pos = np.stack([g.uniform(-fw, fw, n), g.uniform(-fh, fh, n)], -1)
    mass = g.uniform(float(p["minRandBodyMass"]), float(p["maxRandBodyMass"]),
                     n)
    radius = g.uniform(float(p["minRadius"]), float(p["maxRadius"]), n)
    return pos, np.zeros((n, 2)), mass, radius
