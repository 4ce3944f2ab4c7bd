"""nbodyax_torch's scenes against nbodyax's, on the CPU, in 2-D and 3-D.

``three_body`` is a fixed fixture: bit for bit nbodyax's (tolerance:
none). ``galaxy``, ``plummer`` and ``uniform`` without parity are
nbodyax's own ``jax.random`` bodies: the port draws them from nbodyax's key
tree with jax.random's bits (``nbodyax_torch.prng``). Gates: the draws
themselves (masses, radii, uniform positions, the galaxy's z scatter)
bitwise; values through cos, sin, sqrt of a quotient or pow within 2e-7
of the largest |value| of their array; five steps from each package's own
scene within the golden gates (alive masks exact, mass to rtol 1e-6,
positions within 2e-4 of the field). The structure and statistics tests
stay: tests/test_scenes.py's bounds (the Plummer tail at 5a (1 + 1e-5),
speeds under v_esc (1 + 1e-5), the median radius within (1.0 a, 1.5 a),
the 3-D virial ratio within (0.75, 1.15)) and the disks' circular speeds
to rtol 1e-5 of sqrt(G M_c / r).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import scenes as jscenes  # noqa: E402
from nbodyax import state as jstate  # noqa: E402
from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax.physics.step import PhysicsParams as JaxParams  # noqa: E402
from nbodyax.physics.step import make_step as jax_make_step  # noqa: E402
from nbodyax_torch import scenes  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.state import from_numpy, to_numpy  # noqa: E402

G = scenes.G


def both(dim, **kw):
    """The port's and nbodyax's scene of one config, as numpy dicts."""
    kw = dict(kw, dimensions=dim)
    got = to_numpy(scenes.init_scene(SimConfig(**kw), device="cpu",
                                     parity=False))
    want = jstate.to_numpy(jscenes.init_scene(JaxConfig(**kw),
                                              parity=False))
    return got, want


@pytest.mark.parametrize("dim", [2, 3])
def test_three_body_bit_exact(dim):
    got, want = both(dim, scene="three_body")
    for k in ("pos", "vel", "mass", "radius"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.float32
    np.testing.assert_array_equal(got["pos"][:, :2],
                                  [[-500, 0], [500, 0], [-600, -150]])


@pytest.mark.parametrize("dim", [2, 3])
def test_uniform_without_parity(dim):
    """tests/test_scenes.py's bounds, the same ranges as nbodyax's draw,
    and the 3-D draw unchanged from ``uniform_scene``'s (parity is 2-D
    only)."""
    kw = dict(particle_count=4096, field_width=1000, field_height=1000)
    got, want = both(dim, **kw)
    cfg = SimConfig(dimensions=dim, **kw)
    for st in (got, want):
        assert (np.abs(st["pos"]) <= 1000).all()
        assert (st["mass"] >= cfg.min_body_mass).all()
        assert (st["radius"] >= cfg.min_radius).all()
        assert (st["vel"] == 0).all()
    # both fill the field: extremes within 1% of its edges
    np.testing.assert_allclose(np.abs(got["pos"]).max(0), 1000, rtol=1e-2)
    if dim == 2:
        parity = to_numpy(scenes.init_scene(SimConfig(**kw), device="cpu"))
        assert not np.array_equal(parity["pos"], got["pos"])
    a = scenes.uniform_scene(SimConfig(dimensions=dim, **kw), device="cpu",
                             parity=False)
    assert torch.equal(a.pos, torch.from_numpy(got["pos"]))


@pytest.mark.parametrize("dim", [2, 3])
def test_galaxy_structure(dim):
    n = 2048
    got, want = both(dim, particle_count=n, scene="galaxy")
    cfg = SimConfig(particle_count=n, scene="galaxy", dimensions=dim)
    for st in (got, want):
        pos, vel = st["pos"], st["vel"]
        mass = st["mass"].astype(np.float64)
        assert np.isfinite(pos).all() and np.isfinite(vel).all()
        assert (mass > 0).all()
        heavy = np.sort(mass)[::-1]
        assert heavy[1] > 10 * heavy[2]          # one central a disk
        n1 = n // 2
        assert vel[:n1, 0].mean() > 0 > vel[n1:, 0].mean()
        assert np.abs(vel[1:n1]).max() > 0
    # the same centres, drifts and central bodies as nbodyax's
    for i in (0, n // 2):
        for k in ("pos", "vel", "mass", "radius"):
            np.testing.assert_allclose(got[k][i], want[k][i], rtol=1e-6)
    fw = float(cfg.field_width)
    disk_r = 0.25 * min(fw, float(cfg.field_height))
    for lo, hi in ((1, n // 2), (n // 2 + 1, n)):
        c, drift = got["pos"][lo - 1], got["vel"][lo - 1]
        rel = got["pos"][lo:hi].astype(np.float64) - c
        r = np.hypot(rel[:, 0], rel[:, 1])
        assert (r >= 0.1 * disk_r * (1 - 1e-5)).all()
        assert (r <= disk_r * (1 + 1e-5)).all()
        v = got["vel"][lo:hi].astype(np.float64) - drift
        np.testing.assert_allclose(np.hypot(v[:, 0], v[:, 1]),
                                   np.sqrt(G * cfg.max_body_mass / r),
                                   rtol=1e-5)
        # tangential: v . r = 0
        assert np.abs((v[:, :2] * rel[:, :2]).sum(1)).max() < (
            1e-5 * np.hypot(v[:, 0], v[:, 1]) * r).max()
        if dim == 3:
            assert np.abs(rel[:, 2]).max() <= 0.02 * disk_r * (1 + 1e-5)
            assert (v[:, 2] == 0).all()
    for k in ("mass", "radius"):
        lo_g, hi_g = got[k].min(), got[k].max()
        lo_w, hi_w = want[k].min(), want[k].max()
        assert lo_g >= 0.99 * lo_w and hi_g <= hi_w * 1.01 + 1e-3


@pytest.mark.parametrize("dim", [2, 3])
def test_plummer_structure(dim):
    """Radial truncation, escape-speed bound, median radius, determinism:
    tests/test_scenes.py's bounds on both packages' draws."""
    n = 4096
    got, want = both(dim, particle_count=n, scene="plummer")
    cfg = SimConfig(particle_count=n, scene="plummer", dimensions=dim)
    a = cfg.field_width / 12.0
    m_total = n * 0.5 * (cfg.min_body_mass + cfg.max_body_mass)
    medians = []
    for st in (got, want):
        pos = st["pos"].astype(np.float64)
        vel = st["vel"].astype(np.float64)
        r = np.linalg.norm(pos, axis=1)
        assert r.max() <= 5.0 * a * (1 + 1e-5)
        assert np.abs(pos).max() < cfg.field_width
        vesc = np.sqrt(2 * G * m_total) * (r * r + a * a) ** -0.25
        assert (np.linalg.norm(vel, axis=1) <= vesc * (1 + 1e-5)).all()
        assert 1.0 * a < np.median(r) < 1.5 * a
        medians.append(np.median(r))
    np.testing.assert_allclose(medians[0], medians[1], rtol=0.05)
    again = scenes.plummer_scene(cfg, device="cpu")
    np.testing.assert_array_equal(again.pos.numpy(), got["pos"])


def test_plummer_near_virial_equilibrium_3d():
    """Aarseth's speeds: the 3-D sphere starts near 2T/|W| = 1."""
    cfg = SimConfig(particle_count=4096, scene="plummer", dimensions=3)
    st = to_numpy(scenes.plummer_scene(cfg, device="cpu"))
    pos = st["pos"].astype(np.float64)
    vel = st["vel"].astype(np.float64)
    mass = st["mass"].astype(np.float64)
    t_kin = 0.5 * (mass * (vel ** 2).sum(1)).sum()
    w = 0.0
    for s in range(0, len(mass), 512):      # pairs i < j, in row blocks
        d = np.linalg.norm(pos[s:s + 512, None] - pos[None], axis=-1)
        j = np.arange(len(mass))[None, :] > np.arange(s, s + len(d))[:, None]
        w -= G * (mass[s:s + 512, None] * mass[None] * np.where(
            j, 1.0 / np.where(j, d, 1.0), 0.0)).sum()
    assert 0.75 < 2 * t_kin / abs(w) < 1.15


@pytest.mark.parametrize("scene", ["galaxy", "plummer"])
@pytest.mark.parametrize("dim", [2, 3])
def test_large_scenes_stay_finite_in_f32(scene, dim):
    """Plummer's u^(-2/3) - 1 near u_max and galaxy's sqrt(G M_c / r) with
    M_c = 1e17 stay finite and inside the field at N = 65,536."""
    cfg = SimConfig(particle_count=65536, scene=scene, dimensions=dim)
    st = scenes.init_scene(cfg, device="cpu")
    for t in st[:4]:
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
    assert float(st.pos.abs().max()) < cfg.field_width
    assert bool((st.mass > 0).all()) and bool((st.radius > 0).all())


def test_interp_matches_jnp_interp():
    """The inverse-CDF lookup of Aarseth's speeds against ``jnp.interp``,
    which nbodyax uses, on the same f32 grid, bit for bit."""
    import jax.numpy as jnp
    qs = np.linspace(0.0, 1.0, 2049)
    pdf = qs ** 2 * (1.0 - qs ** 2) ** 3.5
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5)])
    cdf = (cdf / cdf[-1]).astype(np.float32)
    x = np.random.RandomState(0).uniform(0, 1, 10000).astype(np.float32)
    x[:4] = (0.0, 1.0, cdf[100], cdf[2047])     # ends, a grid point, flat
    got = scenes._interp(torch.from_numpy(x), torch.from_numpy(cdf),
                         torch.tensor(qs, dtype=torch.float32)).numpy()
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(cdf),
                                 jnp.asarray(qs, jnp.float32)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", ["three_body", "galaxy", "plummer",
                                   "uniform"])
@pytest.mark.parametrize("dim", [2, 3])
def test_scene_steps_match_nbodyax(scene, dim):
    """Five momentum-mode steps of nbodyax's scene, carried across, through
    the port's step and nbodyax's."""
    kw = dict(particle_count=256, scene=scene, dimensions=dim,
              softening=100.0, collision_mode="momentum")
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    j = jscenes.init_scene(jcfg, parity=False)
    t = from_numpy(jstate.to_numpy(j), "cpu")
    jstep = jax_make_step(JaxParams.from_config(jcfg))
    step = make_step(PhysicsParams.from_config(cfg))
    for _ in range(5):
        j, t = jstep(j), step(t)
    want, got = jstate.to_numpy(j), to_numpy(t)
    alive = want["mass"] > 0
    assert alive.any()
    np.testing.assert_array_equal(got["mass"] > 0, alive)
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-6)
    np.testing.assert_allclose(got["pos"][alive], want["pos"][alive],
                               rtol=0, atol=2e-4 * cfg.field_width)


def f32_bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("scene", ["galaxy", "plummer", "uniform"])
@pytest.mark.parametrize("dim", [2, 3])
def test_scene_is_nbodyax_own(scene, dim):
    """The port's scene is nbodyax's for the same config (uniform without
    parity): the draws bitwise, positions and velocities within 2e-7 of
    their largest |value|, and five momentum-mode steps from each
    package's own scene within the golden gates."""
    kw = dict(particle_count=4096, scene=scene, dimensions=dim,
              softening=100.0, collision_mode="momentum")
    jcfg, cfg = JaxConfig(**kw), SimConfig(**kw)
    j = jscenes.init_scene(jcfg, parity=False)
    t = scenes.init_scene(cfg, device="cpu", parity=False)
    got, want = to_numpy(t), jstate.to_numpy(j)
    for k in ("mass", "radius"):
        np.testing.assert_array_equal(f32_bits(got[k]), f32_bits(want[k]))
    if scene == "uniform":
        np.testing.assert_array_equal(f32_bits(got["pos"]),
                                      f32_bits(want["pos"]))
    if scene == "galaxy" and dim == 3:
        np.testing.assert_array_equal(f32_bits(got["pos"][:, 2]),
                                      f32_bits(want["pos"][:, 2]))
    for k in ("pos", "vel"):
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = np.abs(got[k].astype(np.float64) - want[k]).max() / scale
        assert err <= 2e-7, (k, err)

    jstep = jax_make_step(JaxParams.from_config(jcfg))
    step = make_step(PhysicsParams.from_config(cfg))
    for _ in range(5):
        j, t = jstep(j), step(t)
    want, got = jstate.to_numpy(j), to_numpy(t)
    alive = want["mass"] > 0
    assert alive.any()
    np.testing.assert_array_equal(got["mass"] > 0, alive)
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-6)
    np.testing.assert_allclose(got["pos"][alive], want["pos"][alive],
                               rtol=0, atol=2e-4 * cfg.field_width)


def test_powf_matches_jnp_power():
    """The Plummer scene's float32 powers, bit for bit ``jnp``'s on the
    CPU, over the radii's and speeds' ranges and beyond."""
    import jax.numpy as jnp
    rs = np.random.RandomState(3)
    x = np.concatenate([rs.uniform(1e-6, 1.0, 1 << 16),
                        10.0 ** rs.uniform(-30, 30, 1 << 16),
                        [1.0, 2.0, 0.5, 1e-6, 0.943]]).astype(np.float32)
    for y in (-2.0 / 3.0, -0.25):
        got = scenes._powf(torch.from_numpy(x), y).numpy()
        want = np.asarray(jnp.asarray(x) ** y)
        np.testing.assert_array_equal(f32_bits(got), f32_bits(want))
