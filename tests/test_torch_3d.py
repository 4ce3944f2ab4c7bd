"""nbodyax_torch in 3-D (``dimensions=3``, ``forceModel=exact``) against
nbodyax.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it (tests/test_3d.py,
tests/test_autodiff.py): its jnp oracle, and its Pallas kernels in
interpret mode. The port's kernel wrappers run their plain versions on
the CPU; the CUDA kernels' 3-D forms are held to those plain versions on
the card by tests/test_torch_kernels.py. Tolerances are tests/test_3d.py's
unless a test says otherwise.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import autodiff as jautodiff  # noqa: E402
from nbodyax import render as jrender  # noqa: E402
from nbodyax import state as jstate  # noqa: E402
from nbodyax.physics import kernels as jkernels  # noqa: E402
from nbodyax.physics import kernels_bwd as jkernels_bwd  # noqa: E402
from nbodyax.physics import pairwise as jpairwise  # noqa: E402
from nbodyax.physics import step as jstep  # noqa: E402
from nbodyax_torch import cli as tcli  # noqa: E402
from nbodyax_torch.autodiff import make_loss  # noqa: E402
from nbodyax_torch.backends import build_accum_fn  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.driver import run_simulation  # noqa: E402
from nbodyax_torch.metrics import conservation_vec, scalars_from_vec  # noqa
from nbodyax_torch.physics import kernels as tkernels  # noqa: E402
from nbodyax_torch.physics import kernels_bwd as tkernels_bwd  # noqa: E402
from nbodyax_torch.physics.pairwise import pair_accumulators  # noqa: E402
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.scenes import init_scene  # noqa: E402
from nbodyax_torch.state import SimState, from_numpy, make_state  # noqa
from nbodyax_torch.state import to_numpy  # noqa: E402

MODES = ["reference", "momentum", "elastic", "none"]
ENGINES = ["jnp", "auto"]
INTEGRATORS = ["euler", "leapfrog", "yoshida4"]
FORCE_GATE = 2e-6      # tests/test_3d.py:63, of the largest component
BWD_GATE = 3e-6        # tests/test_autodiff.py:201
ROLLOUT_GATE = 5e-6    # tests/test_autodiff.py:235


def random_state_3d(n, seed=0, field=1000.0):
    """tests/test_3d.py's random_state_3d: slot 7 dead, radii 5-60."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    if n > 10:
        mass[7] = 0.0
    radius = rng.uniform(5, 60, n).astype(np.float32)
    return pos, vel, mass, radius


def tensors(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# The forward kernel's plain version (B1 in 3-D)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["oracle", "kernel"])
def test_two_body_force_analytic(engine):
    """tests/test_3d.py:39-51 on both of the port's engines: the force
    along an off-plane separation is m_j d / |d|^3."""
    d = np.array([3.0, -4.0, 12.0], np.float32)           # |d| = 13
    pos = np.stack([np.zeros(3, np.float32), d])
    arrays = (pos, np.zeros((2, 3), np.float32),
              np.array([5.0, 80.0], np.float32),
              np.array([1.0, 1.0], np.float32))
    fn = (pair_accumulators if engine == "oracle"
          else tkernels.pair_accumulators_kernel)
    f = fn(*tensors(arrays), mode="none").force.numpy()
    np.testing.assert_allclose(f[0], 80.0 * d / 13.0 ** 3, rtol=1e-6)
    np.testing.assert_allclose(f[1], -5.0 * d / 13.0 ** 3, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def jax_forward(mode, eps):
    """nbodyax's Pallas kernel (interpret mode) and jnp oracle at N = 200,
    dense enough in 3-D that every mode's channels carry values."""
    arrays = random_state_3d(200, seed=17, field=300.0)
    kw = dict(mode=mode, eps=eps, growth_rate=0.1)
    pallas = jkernels.pallas_pair_accumulators(
        *arrays, tile_i=32, tile_j=128, interpret=True, **kw)
    oracle = jpairwise.pair_accumulators(*arrays, **kw)
    return arrays, pallas, oracle


def assert_accumulators_close(got, want, mode, dv_gate):
    assert rel(got.force, want.force) < FORCE_GATE
    if mode == "reference":
        np.testing.assert_allclose(got.gained_mass.numpy(),
                                   np.asarray(want.gained_mass), rtol=1e-6)
        np.testing.assert_allclose(got.gained_radius.numpy(),
                                   np.asarray(want.gained_radius), rtol=1e-6)
        np.testing.assert_array_equal(got.died.numpy(),
                                      np.asarray(want.died))
        assert got.died.any()
    if mode == "momentum":
        np.testing.assert_array_equal(got.parent.numpy(),
                                      np.asarray(want.parent))
        np.testing.assert_array_equal(got.best_mass.numpy(),
                                      np.asarray(want.best_mass))
        assert (got.best_mass > -np.inf).any()
    if mode == "elastic":
        assert rel(got.dv, want.dv) < dv_gate
        assert float(got.dv.abs().max()) > 0


@pytest.mark.parametrize("eps", [0.0, 25.0])
@pytest.mark.parametrize("mode", MODES)
def test_plain_forward_matches_pallas_interpret(mode, eps):
    """The port's plain B1 in 3-D against nbodyax's Pallas kernel at
    dim = 3 and against its jnp oracle. The elastic dv gate against the
    Pallas kernel is 1e-5, tests/test_kernels.py's: its reciprocal is the
    approximate one with one Newton step (nbodyax/physics/kernels.py:
    197-216), about 5e-6 off; against the oracle it is 2e-6."""
    arrays, pallas, oracle = jax_forward(mode, eps)
    got = tkernels.pair_accumulators_kernel(*tensors(arrays), mode=mode,
                                            eps=eps, growth_rate=0.1)
    assert got.force.shape == (200, 3) and got.dv.shape == (200, 3)
    assert_accumulators_close(got, pallas, mode, dv_gate=1e-5)
    assert_accumulators_close(got, oracle, mode, dv_gate=FORCE_GATE)


@pytest.mark.parametrize("mode", MODES)
def test_raw_layout_matches_pallas_interpret(mode):
    """The raw channels in 3-D sit where nbodyax's kernel puts them (force
    0-2, mode channels 3-5, best mass 6), at an i range against a j range
    with ids past 2^24; the momentum parent is exact."""
    arrays = random_state_3d(96, seed=3, field=200.0)
    jf = np.asarray(jkernels.body_features(*arrays))
    tf = tkernels.body_features(*tensors(arrays))
    np.testing.assert_array_equal(tf.numpy(), jf)
    base, (i0, i1), (j0, j1) = (1 << 25) + 5, (8, 72), (24, 96)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
    want, wpar = jkernels.tile_accumulators_raw(
        jf[i0:i1], jf[j0:j1].T, base + i0, base + j0, tile_i=8, tile_j=128,
        interpret=True, dim=3, **kw)
    got, gpar = tkernels.tile_accumulators_raw(
        tf[i0:i1], tf[j0:j1], base + i0, base + j0, dim=3, **kw)
    want = np.asarray(want)
    for c in range(8):
        if c == 6 or want[:, c].max() == want[:, c].min() == 0:
            np.testing.assert_array_equal(got[:, c].numpy(), want[:, c])
        else:
            assert rel(got[:, c], want[:, c]) < 1e-5, c
    if mode == "momentum":
        np.testing.assert_array_equal(gpar.numpy(), np.asarray(wpar)[:, 0])


def test_wrappers_reject_other_dimensions():
    feats = tkernels.body_features(*tensors(random_state_3d(12)))
    kw = dict(mode="reference", eps=0.0, growth_rate=0.1)
    for dim in (1, 4):
        with pytest.raises(ValueError, match="dimensions"):
            tkernels.tile_accumulators_raw(feats, feats, 0, 0, dim=dim, **kw)
        with pytest.raises(ValueError, match="dimensions"):
            tkernels_bwd.raw_backward(feats, feats, 0, 0, None,
                                      torch.zeros_like(feats), dim=dim, **kw)
    with pytest.raises(ValueError, match="dimensions"):
        z = torch.zeros((4, 4))
        tkernels.body_features(z, z, torch.ones(4), torch.ones(4))


# ---------------------------------------------------------------------------
# The backward kernel's plain version (B2 in 3-D)
# ---------------------------------------------------------------------------

VJP_CASES = [("none", 5.0), ("reference", 0.0), ("momentum", 0.0),
             ("elastic", 0.0), ("reference", 5.0), ("elastic", 5.0)]


def bwd_arrays(n=64, seed=7):
    """tests/test_torch_autodiff.py's backward inputs in 3-D."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5e12, 2e12, n).astype(np.float32)
    mass[[3, 30]] = 0.0
    radius = rng.uniform(10, 40, n).astype(np.float32)
    g_raw = rng.standard_normal((n, 8)).astype(np.float32)
    return (pos, vel, mass, radius), g_raw


@pytest.mark.parametrize("offsets", ["full", "offset"])
@pytest.mark.parametrize("mode,eps", VJP_CASES)
def test_plain_backward_matches_pallas_interpret(mode, eps, offsets):
    """raw_backward_reference at dim = 3 against nbodyax's backward Pallas
    kernel in interpret mode (dim = 3), with its best-mass route onto the
    3-D mass column 6; the offset case pairs i rows 8..40 with j rows
    24..56 at ids past 2^24."""
    arrays, g_raw = bwd_arrays()
    n = arrays[0].shape[0]
    jf = np.asarray(jkernels.body_features(*arrays))
    tf = torch.from_numpy(jf.copy())
    if offsets == "full":
        (i0, i1), (j0, j1), base = (0, n), (0, n), 0
    else:
        (i0, i1), (j0, j1), base = (8, 40), (24, 56), (1 << 25) + 5
    kw = dict(mode=mode, eps=eps, growth_rate=0.1)
    _, jpar = jkernels.tile_accumulators_raw(
        jf[i0:i1], jf[j0:j1].T, base + i0, base + j0, tile_i=8, tile_j=128,
        interpret=True, dim=3, **kw)
    want_i, want_jt = jkernels_bwd.raw_backward(
        jf[i0:i1], jf[j0:j1].T, base + i0, base + j0, jpar, g_raw[i0:i1],
        tile_i=8, tile_j=128, interpret=True, dim=3, **kw)
    _, tpar = tkernels.tile_accumulators_raw_reference(
        tf[i0:i1], tf[j0:j1], base + i0, base + j0, dim=3, **kw)
    got_i, got_j = tkernels_bwd.raw_backward(
        tf[i0:i1], tf[j0:j1], base + i0, base + j0, tpar,
        torch.from_numpy(g_raw[i0:i1].copy()), dim=3, **kw)
    assert rel(got_i.numpy(), want_i) < BWD_GATE
    assert rel(got_j.numpy(), np.asarray(want_jt).T) < BWD_GATE


def test_momentum_best_mass_routes_to_mass_column():
    """With only the best-mass cotangent (channel 6) set, the 3-D backward
    is that cotangent summed onto column 6 (the 3-D mass feature) of each
    parent, and nothing else; column 4 (the 2-D mass column, the 3-D vy)
    stays 0."""
    arrays, _ = bwd_arrays()
    feats = tkernels.body_features(*tensors(arrays))
    kw = dict(mode="momentum", eps=0.0, growth_rate=0.1, dim=3)
    raw, par = tkernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    has = raw[:, 6] > -3e38
    assert has.any()
    g = torch.zeros_like(feats)
    g[:, 6] = torch.arange(1, feats.shape[0] + 1, dtype=torch.float32)
    d_fi, d_fj = tkernels_bwd.raw_backward(feats, feats, 0, 0, par, g, **kw)
    want = torch.zeros(feats.shape[0])
    want.index_add_(0, par[has].long(), g[has, 6])
    assert not d_fi.any()
    torch.testing.assert_close(d_fj[:, 6], want, rtol=0, atol=0)
    assert not d_fj[:, [0, 1, 2, 3, 4, 5, 7]].any()


def _weights(n):
    k = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    return np.cos(k), np.sin(k)


def small_arrays_3d(seed=11, n=16, dead=(3, 7)):
    """tests/test_autodiff.py's small_state at dim = 3, overlapping."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5e12, 2e12, n).astype(np.float32)
    radius = rng.uniform(20, 60, n).astype(np.float32)
    mass[list(dead)] = 0.0
    return pos, vel, mass, radius


@pytest.mark.parametrize("mode,eps", VJP_CASES)
def test_accumulator_grads_match_jax_grad(mode, eps):
    """The port's autograd Function (plain B1 forward, plain B2 backward)
    in 3-D against jax.grad of nbodyax's jnp oracle and of its Pallas
    kernel (interpret mode), tests/test_autodiff.py:182-201's dim = 3
    cases and more: force, gained mass and radius, dv and best mass
    cotangents at once, two dead bodies."""
    arrays = small_arrays_3d()
    n = arrays[0].shape[0]
    cos_k, sin_k = _weights(n)
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    acc = tkernels.pair_accumulators_kernel(*xs, eps=eps, growth_rate=0.1,
                                            mode=mode)
    bm = acc.best_mass
    out = ((acc.force * torch.from_numpy(cos_k)).sum()
           + acc.gained_mass.sum() * 1e-12 + acc.gained_radius.sum()
           + (acc.dv * torch.from_numpy(sin_k)).sum()
           + 1e-12 * torch.where(torch.isfinite(bm), bm, 0.0).sum())
    got = [np.zeros_like(a) if g is None else g.numpy() for a, g in zip(
        arrays, torch.autograd.grad(out, xs, allow_unused=True))]

    def loss(fn, pos, vel, mass, radius):
        a = fn(pos, vel, mass, radius, eps=eps, growth_rate=0.1, mode=mode)
        b = a.best_mass
        return (jnp.sum(a.force * cos_k) + jnp.sum(a.gained_mass) * 1e-12
                + jnp.sum(a.gained_radius) + jnp.sum(a.dv * sin_k)
                + 1e-12 * jnp.sum(jnp.where(jnp.isfinite(b), b, 0.0)))

    pallas = functools.partial(jkernels.pallas_pair_accumulators,
                               interpret=True)
    for fn in (jpairwise.pair_accumulators, pallas):
        want = jax.grad(functools.partial(loss, fn), argnums=(0, 1, 2, 3))(
            *arrays)
        for name, g, w in zip(("pos", "vel", "mass", "radius"), got, want):
            assert np.all(np.isfinite(g)), (mode, name)
            assert np.all(g[[3, 7]] == 0.0), (mode, name)
            assert rel(g, w) < BWD_GATE, (mode, eps, name, rel(g, w))


# ---------------------------------------------------------------------------
# Steps: planar equivalence, walls, conservation, parity with nbodyax
# ---------------------------------------------------------------------------

def planar_arrays(n=96):
    """tests/test_3d.py:97-102's planar state."""
    rng = np.random.RandomState(5)
    pos2 = rng.uniform(-800, 800, (n, 2)).astype(np.float32)
    vel2 = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = rng.uniform(5, 50, n).astype(np.float32)
    return pos2, vel2, mass, radius


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("mode", MODES)
def test_planar_3d_run_matches_2d_exactly(mode, integrator, engine):
    """z = 0 everywhere: 5 steps of the port's 3-D step give the 2-D
    step's xy state bit for bit, and z stays 0 (every added z term is an
    exact 0.0)."""
    pos2, vel2, mass, radius = planar_arrays()
    z = np.zeros((pos2.shape[0], 1), np.float32)
    p = PhysicsParams(dt=0.2, field_width=1000, field_height=1000,
                      field_depth=1000, collision_mode=mode,
                      integrator=integrator)
    step = make_step(p, accum_fn=build_accum_fn(engine, p, "cpu"))
    s2 = make_state(pos2, vel2, mass, radius, device="cpu")
    s3 = make_state(np.concatenate([pos2, z], 1),
                    np.concatenate([vel2, z], 1), mass, radius, device="cpu")
    for _ in range(5):
        s2, s3 = step(s2), step(s3)
    assert torch.equal(s3.pos[:, :2], s2.pos)
    assert torch.equal(s3.vel[:, :2], s2.vel)
    assert torch.equal(s3.mass, s2.mass)
    assert torch.equal(s3.radius, s2.radius)
    assert not s3.pos[:, 2].any() and not s3.vel[:, 2].any()
    if mode != "none":
        assert int((s2.mass > 0).sum()) < pos2.shape[0] or mode == "elastic"


@pytest.mark.parametrize("boundary", ["reference", "clamp"])
def test_boundary_reflects_z(boundary):
    """A body heading out of the +z face reflects vz (tests/test_3d.py:
    121-134), in both wall modes, as nbodyax's step does."""
    arrays = (np.array([[0.0, 0.0, 990.0], [500.0, 0.0, 0.0]], np.float32),
              np.array([[0.0, 0.0, 100.0], [0.0, 0.0, 0.0]], np.float32),
              np.array([10.0, 10.0], np.float32),
              np.array([50.0, 1.0], np.float32))
    kw = dict(dt=0.2, field_width=1000, field_height=1000, field_depth=1000,
              collision_mode="none", boundary_mode=boundary)
    got = make_step(PhysicsParams(**kw))(make_state(*arrays, device="cpu"))
    want = jstep.make_step(jstep.PhysicsParams(**kw))(
        jstate.make_state(*arrays))
    assert float(got.vel[0, 2]) < 0
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=1e-6, atol=1e-6)
    if boundary == "clamp":
        assert float(got.pos[0, 2]) <= 1000.0 - 50.0


def test_field_depth_from_config():
    """fieldDepth sets the z interval; 0 falls back to fieldWidth
    (nbodyax/physics/step.py:83-84)."""
    assert PhysicsParams.from_config(
        SimConfig(dimensions=3, field_depth=50000)).field_depth == 50000.0
    p = PhysicsParams.from_config(SimConfig(dimensions=3, field_width=7000))
    assert p.field_depth == p.field_width == 7000.0


@pytest.mark.parametrize("engine", ENGINES)
def test_momentum_merge_conserves(engine):
    """tests/test_3d.py:137-152: momentum merges conserve mass and all
    three momentum components through a step with many overlaps."""
    pos, vel, mass, radius = random_state_3d(128, seed=31, field=200.0)
    mass[7] = 50.0
    st = make_state(pos, vel, mass, radius, device="cpu")
    p = PhysicsParams(dt=0.0, field_width=1e9, field_height=1e9,
                      field_depth=1e9, collision_mode="momentum",
                      boundary_mode="none")
    out = make_step(p, accum_fn=build_accum_fn(engine, p, "cpu"))(st)
    m0, m1 = mass, out.mass.numpy()
    assert (m1 > 0).sum() < 128
    np.testing.assert_allclose(m1.sum(), m0.sum(), rtol=1e-6)
    p0 = (m0[:, None] * vel).sum(0)
    p1 = (m1[:, None] * out.vel.numpy()).sum(0)
    np.testing.assert_allclose(p1, p0, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("engine", ENGINES)
def test_elastic_two_body_contact(engine):
    """tests/test_3d.py:155-173: a head-on 3-D contact conserves momentum
    and kinetic energy."""
    pos = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 12.0]], np.float32)
    d = pos[1] / 13.0
    vel = np.stack([5.0 * d, -2.0 * d]).astype(np.float32)
    mass = np.array([2.0, 6.0], np.float32)
    radius = np.array([7.0, 7.0], np.float32)
    p = PhysicsParams(dt=0.0, field_width=1e9, field_height=1e9,
                      field_depth=1e9, collision_mode="elastic",
                      boundary_mode="none")
    out = make_step(p, accum_fn=build_accum_fn(engine, p, "cpu"))(
        make_state(pos, vel, mass, radius, device="cpu"))
    v1 = out.vel.numpy()
    np.testing.assert_allclose((mass[:, None] * v1).sum(0),
                               (mass[:, None] * vel).sum(0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(0.5 * (mass * (v1 * v1).sum(1)).sum(),
                               0.5 * (mass * (vel * vel).sum(1)).sum(),
                               rtol=1e-5)
    assert not np.allclose(v1, vel)


FIELD = 400.0


def step_arrays(n=150, seed=4):
    """Dense 3-D overlaps, bodies against every wall, slot 7 dead."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-FIELD, FIELD, (n, 3)).astype(np.float32)
    vel = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    mass = rng.uniform(1e12, 1e14, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(10, 60, n).astype(np.float32)
    return pos, vel, mass, radius


STEP_CASES = ([(m, "euler") for m in MODES]
              + [("reference", "leapfrog"), ("momentum", "yoshida4")])


@functools.lru_cache(maxsize=None)
def jax_five_steps(mode, integrator):
    p = jstep.PhysicsParams(dt=0.1, field_width=FIELD, field_height=FIELD,
                            field_depth=FIELD, collision_mode=mode,
                            integrator=integrator)
    st = jstate.make_state(*step_arrays())
    step = jstep.make_step(p)
    for _ in range(5):
        st = step(st)
    return jstate.to_numpy(st)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode,integrator", STEP_CASES)
def test_five_steps_match_jax(mode, integrator, engine):
    """5 steps of the port's make_step against nbodyax's on one 3-D state
    (nbodyax's, carried across with from_numpy): alive masks exact, mass
    to rtol 1e-6, positions within 2e-4 of the field."""
    before = jstate.to_numpy(jstate.make_state(*step_arrays()))
    p = PhysicsParams(dt=0.1, field_width=FIELD, field_height=FIELD,
                      field_depth=FIELD, collision_mode=mode,
                      integrator=integrator)
    step = make_step(p, accum_fn=build_accum_fn(engine, p, "cpu"))
    st = from_numpy(before, "cpu")
    assert st.pos.shape == (150, 3)
    for _ in range(5):
        st = step(st)
    got, want = to_numpy(st), jax_five_steps(mode, integrator)
    np.testing.assert_array_equal(got["mass"] > 0, want["mass"] > 0)
    if mode in ("reference", "momentum"):
        assert (want["mass"] > 0).sum() < 149
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-6)
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0,
                               atol=2e-4 * FIELD)
    assert int(got["step"]) == 5 and got["sim_time"] == want["sim_time"]


# ---------------------------------------------------------------------------
# Rollout gradients
# ---------------------------------------------------------------------------

ROLLOUT_MODES = ["none", "reference", "elastic"]


def rollout_cfg(mode):
    return dict(particle_count=16, collision_mode=mode, softening=5.0,
                dimensions=3, field_width=10_000, field_height=10_000)


@functools.lru_cache(maxsize=None)
def jax_rollout_grads(mode):
    from nbodyax.config import SimConfig as JaxConfig
    p = jstep.PhysicsParams.from_config(JaxConfig(backend="jnp",
                                                  **rollout_cfg(mode)))
    step = jstep.make_step(p, accum_fn=functools.partial(
        jpairwise.pair_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode=mode))
    st = jstate.make_state(*small_arrays_3d(2, dead=()))
    loss = jautodiff.make_loss(step, 4,
                               lambda s: jnp.sum((s.pos / 100.0) ** 2) / 16)
    gs = jax.grad(lambda x, v, m: loss(st._replace(pos=x, vel=v, mass=m)),
                  argnums=(0, 1, 2))(st.pos, st.vel, st.mass)
    return tuple(np.asarray(g) for g in gs)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", ROLLOUT_MODES)
def test_rollout_grads_match_jax(mode, engine):
    """A 4-step 3-D euler rollout with collisions and walls: gradients with
    respect to the initial pos, vel and mass against jax.grad of
    nbodyax.autodiff on the oracle (tests/test_autodiff.py:235's gate)."""
    cfg = SimConfig(**rollout_cfg(mode))
    p = PhysicsParams.from_config(cfg)
    assert p.field_depth == 10_000
    step = make_step(p, accum_fn=build_accum_fn(engine, p, "cpu"))
    arrays = small_arrays_3d(2, dead=())
    pos, vel, mass = (torch.tensor(a, requires_grad=True)
                      for a in arrays[:3])
    st = SimState(pos, vel, mass, torch.tensor(arrays[3]), 0,
                  torch.zeros(()))
    loss = make_loss(step, 4, lambda s: ((s.pos / 100.0) ** 2).sum() / 16)
    got = torch.autograd.grad(loss(st), (pos, vel, mass))
    for leaf, g, w in zip(("pos", "vel", "mass"), got,
                          jax_rollout_grads(mode)):
        assert np.abs(w).max() > 0 and g.shape == w.shape
        assert rel(g.numpy(), w) < ROLLOUT_GATE, (mode, engine, leaf)


# ---------------------------------------------------------------------------
# Scene, metrics, driver and CLI
# ---------------------------------------------------------------------------

def test_uniform_scene_3d():
    """Shapes, ranges and determinism of the port's 3-D uniform scene (a
    torch.Generator draw, not nbodyax's jax.random bits)."""
    cfg = SimConfig(particle_count=4096, dimensions=3, field_width=1000,
                    field_height=600, field_depth=400, seed=9)
    st = init_scene(cfg, device="cpu")
    assert st.pos.shape == (4096, 3) and st.vel.shape == (4096, 3)
    assert st.pos.dtype == torch.float32 and not st.vel.any()
    ext = torch.tensor([1000.0, 600.0, 400.0])
    assert bool((st.pos.abs() <= ext).all())
    # each axis fills its interval
    assert bool((st.pos.amax(0) > 0.95 * ext).all())
    assert bool((st.pos.amin(0) < -0.95 * ext).all())
    assert float(st.mass.min()) >= 1e4 and float(st.mass.max()) <= 1e17
    assert float(st.radius.min()) >= 50 and float(st.radius.max()) <= 200
    again = init_scene(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(st[:4], again[:4]))
    other = init_scene(SimConfig(particle_count=4096, dimensions=3, seed=10),
                       device="cpu")
    assert not torch.equal(other.pos, st.pos)
    # fieldDepth 0 falls back to fieldWidth
    wide = init_scene(SimConfig(particle_count=4096, dimensions=3,
                                field_width=1000, field_height=10),
                      device="cpu")
    assert float(wide.pos[:, 2].abs().max()) > 900


def test_conservation_scalars_3d():
    """conservation_vec carries momentum z in 3-D, and scalars_from_vec
    reads sim_time from the end (nbodyax/metrics.py:42-55)."""
    arrays = random_state_3d(32, seed=2)
    st = make_state(*arrays, sim_time=0.6, device="cpu")
    v = conservation_vec(st)
    assert v.shape == (7,)
    got = scalars_from_vec(v, 3)
    m = np.where(arrays[2] > 0, arrays[2], 0)
    np.testing.assert_allclose(got["momentum_z"],
                               (m * arrays[1][:, 2]).sum(), rtol=1e-5)
    assert abs(got["sim_time"] - 0.6) < 1e-6 and got["alive"] == 31
    from nbodyax.metrics import conservation_scalars
    want = conservation_scalars(jstate.make_state(*arrays, sim_time=0.6))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    two = scalars_from_vec(conservation_vec(make_state(
        arrays[0][:, :2], arrays[1][:, :2], arrays[2], arrays[3],
        sim_time=0.6, device="cpu")), 2)
    assert "momentum_z" not in two and abs(two["sim_time"] - 0.6) < 1e-6


def test_run_simulation_3d_frames_and_log(tmp_path):
    """A 3-D run_simulation on the CPU: its frames are byte for byte
    nbodyax's render (the xy projection) of the same states, and every log
    line carries momentum_z."""
    cfg = SimConfig(particle_count=200, total_iterations=4, dimensions=3,
                    field_width=1500, field_height=1500, field_depth=800,
                    img_width=128, img_height=128, save_image_every=2,
                    image_path=str(tmp_path / "img"), log_every=2,
                    log_path=str(tmp_path / "log.jsonl"), seed=5)
    res = run_simulation(cfg, device="cpu", quiet=True)
    assert res.frames_written == 2 and res.state.pos.shape == (200, 3)
    logs = [json.loads(line) for line in
            open(cfg.log_path).read().splitlines()]
    assert [rec["step"] for rec in logs] == [2, 4]
    assert all("momentum_z" in rec for rec in logs)
    # the same states again, through the step the driver builds
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn(cfg.backend, p, "cpu"))
    st = init_scene(cfg, device="cpu")
    for it in range(4):
        st = step(st)
        if it % 2:
            continue
        js = jstate.make_state(*(x.numpy() for x in st[:4]))
        want = jrender.pgm_bytes(np.asarray(jrender.render_state(js, cfg)))
        got = (tmp_path / "img" / f"iteration_{it}.ppm").read_bytes()
        assert got == want, it
        assert (np.frombuffer(got[-128 * 128:], np.uint8) == 0).any()
    assert torch.equal(st.pos, res.state.pos)


CLI_CONFIG = """particleCount=128
totalIterations=20
save_Image_Every_Xth_Iteration=10
timestep=0.2f
minRandBodyMass=1e4f
maxRandBodyMass=1e17f
minRadius=50.f
maxRadius=200.f
imgWidth=128
imgHeight=128
fieldWidth=3000
fieldHeight=3000
"""


def test_cli_runs_3d(tmp_path, capsys):
    """python -m nbodyax_torch.cli --device cpu --set dimensions=3: P5
    frames of the xy projection and a log with momentum_z."""
    path = tmp_path / "nbodyConfig.txt"
    path.write_text(CLI_CONFIG)
    assert tcli.main(["--config", str(path), "--device", "cpu", "--set",
                      "dimensions=3", "--steps", "20", "--set",
                      f"imagePath={tmp_path / 'img'}"]) == 0
    out = capsys.readouterr().out
    assert "Time taken:" in out
    logs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    assert len(logs) == 2 and all("momentum_z" in rec for rec in logs)
    assert sorted(os.listdir(tmp_path / "img")) == ["iteration_0.ppm",
                                                    "iteration_10.ppm"]
    raw = (tmp_path / "img" / "iteration_10.ppm").read_bytes()
    assert raw.startswith(b"P5\n128 128\n255\n")


def test_bh_in_3d_raises_and_names_its_item():
    """3-D bh runs on a single device (tests/test_torch_bh_3d.py and
    test_torch_bh_3d_slice.py hold it to nbodyax): a direct 3-D call gives
    3-D accumulators, and the driver runs it. What is left, sharded 3-D bh,
    raises and names ROADMAP item A11."""
    from nbodyax_torch.physics.barneshut import bh_accumulators
    arrays = tensors(random_state_3d(256, seed=8))
    acc = bh_accumulators(*arrays, eps=10.0, mode="reference", levels=3,
                          neighbor_k=64)
    assert acc.force.shape == (256, 3) and bool(acc.force[:, 2].any())
    cfg = SimConfig(particle_count=64, total_iterations=1, dimensions=3,
                    force_model="bh", save_images=False)
    assert run_simulation(cfg, device="cpu",
                          quiet=True).state.pos.shape == (64, 3)
    cfg.shards = 2
    with pytest.raises(NotImplementedError, match="A11"):
        run_simulation(cfg, device="cpu", quiet=True)
