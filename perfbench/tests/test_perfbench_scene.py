"""The benchmark's own draw of a start state."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.scene import draw_scene
from perfbench.spec import load_module

GRAV_CONSTANT = load_module("scenes", "galaxy").GRAV_CONSTANT

BASE = {"minRandBodyMass": 1e4, "maxRandBodyMass": 1e17, "minRadius": 50,
        "maxRadius": 200, "fieldWidth": 100000, "fieldHeight": 50000}


def test_uniform_shapes_and_ranges():
    pos, vel, mass, radius = draw_scene(
        7, dict(BASE, scene="uniform", particleCount=4096))
    assert pos.shape == vel.shape == (4096, 2) and mass.shape == (4096,)
    assert all(a.dtype == np.float32 for a in (pos, vel, mass, radius))
    assert np.abs(pos[:, 0]).max() <= 100000 and \
        np.abs(pos[:, 1]).max() <= 50000
    assert np.abs(pos[:, 0]).max() > 90000       # it spans the field
    assert (vel == 0).all()
    assert mass.min() >= 1e4 and mass.max() <= 1e17
    assert radius.min() >= 50 and radius.max() <= 200


def test_galaxy_shapes_centres_and_orbits():
    n = 2048
    pos, vel, mass, radius = draw_scene(
        9, dict(BASE, scene="galaxy", particleCount=n, fieldHeight=100000))
    assert pos.shape == (n, 2)
    for c, side in ((0, -1), (n // 2, 1)):       # the two central bodies
        assert mass[c] == np.float32(1e17) and radius[c] == 200
        assert pos[c, 0] == pytest.approx(side * 25000)
    light = np.ones(n, bool)
    light[[0, n // 2]] = False
    assert mass[light].max() <= 1e15 and radius[light].max() < 200
    # the orbiters of the first disk circle its centre at sqrt(G M / r)
    rel_p = pos[1:n // 2] - pos[0]
    rel_v = vel[1:n // 2] - vel[0]
    r = np.hypot(*rel_p.T)
    assert r.max() <= 25000 * 1.0001 and r.min() >= 2500 * 0.999
    speed = np.hypot(*rel_v.T)
    np.testing.assert_allclose(speed, np.sqrt(GRAV_CONSTANT * 1e17 / r),
                               rtol=1e-5)
    assert np.abs((rel_p * rel_v).sum(1) / (r * speed)).max() < 1e-4


@pytest.mark.parametrize("scene", ["uniform", "galaxy"])
def test_a_seed_gives_the_same_state_and_another_seed_another(scene):
    p = dict(BASE, scene=scene, particleCount=256)
    big = 2 ** 31 + 12345
    a, b, c = draw_scene(big, p), draw_scene(big, p), draw_scene(big + 1, p)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    draw_scene(-3, p)                              # any whole number


def test_unknown_scenes_and_3d_are_refused():
    with pytest.raises(ValueError):
        draw_scene(1, dict(BASE, scene="plummer", particleCount=8))
    with pytest.raises(ValueError):
        draw_scene(1, dict(BASE, scene="uniform", particleCount=8,
                           dimensions=3))
