"""nbodyax_torch's bh giant-collision pass against nbodyax on the CPU.

``giant_collision_accumulators`` is held to nbodyax's with its collision
decisions exact and its summed channels to float32 sum order, and the
port's clamp of the giant list to n (nbodyax fails for n < 8, ROADMAP C) is
held to nbodyax without the giant pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch.physics import bh_grid  # noqa: E402


def giant_state(n=2048, seed=4):
    """Small bodies plus a handful of giants whose radii reach well past
    the ring-1 window, two of them with equal radius (the tie order)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-5000, 5000, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = rng.uniform(1, 20, n).astype(np.float32)
    giants = rng.choice(n, 12, replace=False)
    radius[giants] = rng.uniform(900, 2500, 12).astype(np.float32)
    radius[giants[1]] = radius[giants[0]]
    mass[giants[:6]] = 1e6
    mass[giants[6]] = 0.0                      # a dead giant never counts
    return pos, vel, mass, radius


@pytest.mark.parametrize("n_giants", [1024, 8])
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_giant_collision_accumulators(mode, n_giants):
    """Collision decisions exact (died, parent, best mass), force 0, the
    summed channels within float32 sum order: gained mass and radius to
    rtol 1e-6 (measured 9.7e-8 on 4 of 2048 bodies: nbodyax sums over its
    1024-wide list of mostly masked giants, the port over the 11 real
    ones), elastic dv within 1e-6 of its largest value."""
    pos, vel, mass, radius = giant_state()
    je = jbh._extent(jnp.asarray(pos), jnp.asarray(mass) > 0)
    te = bh_grid._extent(torch.from_numpy(pos), torch.from_numpy(mass) > 0)
    kw = dict(levels=5, ring=1, growth_rate=0.1, mode=mode,
              n_giants=n_giants)
    want = jbh.giant_collision_accumulators(pos, vel, mass, radius, ext=je,
                                            **kw)
    got = tbh.giant_collision_accumulators(
        *map(torch.from_numpy, (pos, vel, mass, radius)), ext=te, **kw)
    assert not got.force.any()
    for name in ("died", "parent", "best_mass"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("gained_mass", "gained_radius"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    x = np.asarray(want.dv)
    assert np.abs(got.dv.numpy() - x).max() <= 1e-6 * max(np.abs(x).max(),
                                                          1e-30)
    if mode == "reference":
        assert np.asarray(want.died).any()      # the giants do eat


@pytest.mark.parametrize("n", [1, 5])
def test_fewer_than_eight_bodies(n):
    """nbodyax's giant list is max(8, min(bhGiants, n)) long, which fails
    for n < 8 (ROADMAP C); the port clamps it to n. Here every overlap is
    inside the window, so the giant pass (every body qualifies: radius 30
    against a 50-unit cell) adds nothing and the port's default
    (bhGiants = 1024) equals nbodyax at bhGiants = 0: force and gained
    radius within 2e-5 of their largest value, died, parent and gained mass
    exact."""
    pos = np.array([[0, 0], [3, 4], [-100, -100], [100, 100],
                    [-100, 100]], np.float32)[:n]
    vel = np.random.RandomState(n).uniform(-1, 1, (n, 2)).astype(np.float32)
    mass = np.array([5, 7, 1, 2, 3], np.float32)[:n]
    radius = np.full(n, 30.0, np.float32)
    kw = dict(eps=5.0, growth_rate=0.1, mode="reference", levels=2,
              neighbor_k=16, near="slots")
    want = jbh.bh_accumulators(pos, vel, mass, radius, n_giants=0, **kw)
    got = tbh.bh_accumulators(*map(torch.from_numpy, (pos, vel, mass,
                                                      radius)),
                              n_giants=1024, **kw)
    for name in ("force", "gained_radius"):
        x = np.asarray(getattr(want, name))
        err = np.abs(getattr(got, name).numpy() - x).max()
        assert err <= 2e-5 * max(np.abs(x).max(), 1e-30), name
    for name in ("died", "parent", "gained_mass"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
