"""nbodyax_torch's adaptive dt against nbodyax's, on the CPU.

The single-device cases of tests/test_adaptive_dt.py, each run through both
packages on numpy-made states (``from_numpy`` carries nbodyax's state
across): sim_time telescopes the f32 dts, a pinned adaptive dt gives the
fixed-dt trajectory bit for bit, dt stays within its bounds under every
integrator, shrinks on a fast flyby, follows ``step_dt``'s criteria, and
stops a fast body tunnelling through its target; plus a 3-D case and a bh
case. The forces of the two packages differ in their last bits (two sum
orders), and each dt is a min over bodies of sqrt(r/|a|), so dts and
sim_time are held to rtol 1e-6 and states to tests/test_torch_step.py's
gates.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nbodyax import state as jstate  # noqa: E402
from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax.physics import step as jstep  # noqa: E402
from nbodyax_torch.backends import build_accum_fn  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch.physics import step as tstep  # noqa: E402
from nbodyax_torch.state import from_numpy, to_numpy  # noqa: E402


def flyby(n=64, v=400.0):
    """tests/test_adaptive_dt.py's scene: a fast light body heading at a
    heavy one among quiet background bodies."""
    rng = np.random.RandomState(3)
    pos = rng.uniform(-40000, 40000, (n, 2)).astype(np.float32)
    vel = np.zeros((n, 2), np.float32)
    mass = np.full(n, 1e4, np.float32)
    radius = np.full(n, 60.0, np.float32)
    pos[0], vel[0] = (-3000.0, 0.0), (v, 0.0)
    mass[0], radius[0] = 1e5, 50.0
    pos[1] = (0.0, 0.0)
    mass[1], radius[1] = 1e17, 200.0
    return pos, vel, mass, radius


def uniform(n=256, seed=5, dim=2, field=100000.0):
    """Default-scene-like bodies: masses 1e4-1e17, radii 50-200."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, dim)).astype(np.float32)
    vel = np.zeros((n, dim), np.float32)
    mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
    radius = rng.uniform(50, 200, n).astype(np.float32)
    return pos, vel, mass, radius


def both(arrays, **kw):
    """(nbodyax state, port state, nbodyax step, port step) for
    PhysicsParams(**kw); the port's step runs its default engine."""
    jp, tp = jstep.PhysicsParams(**kw), tstep.PhysicsParams(**kw)
    js = jstate.make_state(*arrays)
    ts = from_numpy(jstate.to_numpy(js), "cpu")
    return (js, ts, jstep.make_step(jp),
            tstep.make_step(tp, accum_fn=build_accum_fn("auto", tp, "cpu")))


def run(js, ts, jfn, tfn, steps):
    """Both packages' sim_time after each step."""
    jt, tt = [], []
    for _ in range(steps):
        js, ts = jfn(js), tfn(ts)
        jt.append(float(js.sim_time))
        tt.append(float(ts.sim_time))
    return js, ts, np.array(jt), np.array(tt)


def assert_states_close(js, ts, field):
    want, got = jstate.to_numpy(js), to_numpy(ts)
    np.testing.assert_array_equal(got["mass"] > 0, want["mass"] > 0)
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-6)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=0,
                               atol=1e-6 * max(np.abs(want["vel"]).max(), 1))
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0,
                               atol=1e-6 * field)


def test_fixed_dt_telescopes():
    """Adaptive dt off: sim_time is the f32 sum of the f32 dt, as nbodyax
    has it."""
    js, ts, jfn, tfn = both(uniform(), dt=0.2)
    js, ts, jt, tt = run(js, ts, jfn, tfn, 7)
    want = np.float32(0.0)
    for _ in range(7):
        want = np.float32(want + np.float32(0.2))
    assert ts.step == 7 and tt[-1] == float(want) == jt[-1]


def test_pinned_adaptive_matches_fixed_bitwise():
    """dtMin == dtMax == timestep: the adaptive step is the fixed step bit
    for bit (the clip pins dt; the tails are shared)."""
    for integrator in ("euler", "leapfrog", "yoshida4"):
        kw = dict(dt=0.2, integrator=integrator)
        _, a, _, fixed = both(uniform(), **kw)
        _, b, _, pinned = both(uniform(), adaptive_dt=True, dt_min=0.2,
                               dt_max=0.2, **kw)
        for _ in range(4):
            a, b = fixed(a), pinned(b)
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y), integrator
        assert torch.equal(a.sim_time, b.sim_time)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_adaptive_dt_within_bounds_and_telescopes(integrator):
    js, ts, jfn, tfn = both(flyby(), dt=0.2, adaptive_dt=True,
                            integrator=integrator)
    js, ts, jt, tt = run(js, ts, jfn, tfn, 10)
    dts = np.diff(np.concatenate([[0.0], tt]))
    lo, hi = 0.2 / 1024, 0.2
    assert np.all(dts >= lo * (1 - 1e-5)) and np.all(dts <= hi * (1 + 1e-5))
    assert dts.min() < hi          # the flyby drove dt below its ceiling
    np.testing.assert_allclose(tt, jt, rtol=1e-6)
    assert ts.step == 10
    assert_states_close(js, ts, 40000.0)


def test_adaptive_dt_shrinks_on_fast_encounter():
    """The fast flyby forces dt below half its ceiling, as nbodyax's does;
    a quiet pair stays at the ceiling."""
    js, ts, jfn, tfn = both(flyby(v=4000.0), dt=0.2, adaptive_dt=True)
    _, _, jt, tt = run(js, ts, jfn, tfn, 1)
    assert tt[0] < 0.2 * 0.5
    np.testing.assert_allclose(tt, jt, rtol=1e-6)
    quiet = (np.array([[-30000.0, 0], [30000.0, 0]], np.float32),
             np.zeros((2, 2), np.float32), np.full(2, 1e4, np.float32),
             np.full(2, 60.0, np.float32))
    js, ts, jfn, tfn = both(quiet, dt=0.2, adaptive_dt=True)
    _, _, jt, tt = run(js, ts, jfn, tfn, 1)
    assert tt[0] == jt[0] == pytest.approx(0.2)


@pytest.mark.parametrize("case", ["unit", "random", "all_dead"])
def test_step_dt_criteria_match_nbodyax(case):
    """``step_dt`` against nbodyax's on the same arrays: tests/
    test_adaptive_dt.py's unit pin (a dead body with a huge force left
    out), random bodies with explicit bounds, and an all-dead state
    (clips to dtMax)."""
    if case == "random":
        rng = np.random.RandomState(11)
        vel = rng.uniform(-50, 50, (300, 3)).astype(np.float32)
        mass = rng.uniform(0, 1e15, 300).astype(np.float32)
        mass[::7] = 0.0
        radius = rng.uniform(5, 80, 300).astype(np.float32)
        force = rng.normal(0, 1e9, (300, 3)).astype(np.float32)
        kw = dict(dt=0.5, adaptive_dt=True, dt_eta=0.3, dt_min=1e-3,
                  dt_max=0.4)
    else:
        vel = np.array([[3.0, 4.0], [1000.0, 0.0]], np.float32)
        mass = np.array([1.0, 0.0 if case == "unit" else 0.0], np.float32)
        if case == "all_dead":
            mass[0] = 0.0
        radius = np.array([2.0, 0.1], np.float32)
        force = np.array([[0.0, 0.0], [1e20, 0.0]], np.float32)
        kw = dict(dt=1.0, adaptive_dt=True, dt_eta=0.5, dt_min=1e-4,
                  dt_max=1.0)
    want = float(jstep.step_dt(*(jnp.asarray(x) for x in
                                 (vel, mass, radius, force)),
                               jstep.PhysicsParams(**kw)))
    got = tstep.step_dt(*(torch.from_numpy(x) for x in
                          (vel, mass, radius, force)),
                        tstep.PhysicsParams(**kw))
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    expect = {"unit": 0.2, "all_dead": 1.0}.get(case)
    if expect is not None:
        assert float(got) == pytest.approx(expect, rel=1e-6)
    assert tstep.step_dt(*(torch.from_numpy(x) for x in
                           (vel, mass, radius, force)),
                         tstep.PhysicsParams(dt=0.25)) == 0.25


def test_adaptive_prevents_tunneling_through_target():
    """A body that crosses its partner in one fixed step tunnels through
    it; under adaptive dt it merges, in the same step as nbodyax's."""
    scene = (np.array([[-3000.0, 0.0], [0.0, 0.0]], np.float32),
             np.array([[30000.0, 0.0], [0.0, 0.0]], np.float32),
             np.array([1e4, 1e17], np.float32),
             np.array([50.0, 200.0], np.float32))
    _, ts, _, fixed = both(scene, dt=0.2)
    for _ in range(40):
        ts = fixed(ts)
    assert int((ts.mass > 0).sum()) == 2          # tunnelled through
    js, ts, jfn, tfn = both(scene, dt=0.2, adaptive_dt=True)
    merged = {}
    for s in range(1, 401):
        js, ts = jfn(js), tfn(ts)
        for name, alive in (("jax", int(np.sum(np.asarray(js.mass) > 0))),
                            ("torch", int((ts.mass > 0).sum()))):
            if alive == 1:
                merged.setdefault(name, s)
        if len(merged) == 2:
            break
    assert merged.get("torch") is not None
    assert merged["torch"] == merged["jax"]


def test_adaptive_3d_matches_nbodyax():
    """Five adaptive leapfrog steps of a 3-D state (dense, a fast body)."""
    pos, vel, mass, radius = uniform(128, seed=9, dim=3, field=3000.0)
    vel[0] = (2000.0, -500.0, 300.0)
    kw = dict(dt=0.2, adaptive_dt=True, integrator="leapfrog",
              field_width=3000.0, field_height=3000.0, field_depth=3000.0,
              collision_mode="momentum")
    js, ts, jfn, tfn = both((pos, vel, mass, radius), **kw)
    js, ts, jt, tt = run(js, ts, jfn, tfn, 5)
    assert tt[-1] < 5 * 0.2
    np.testing.assert_allclose(tt, jt, rtol=1e-6)
    assert_states_close(js, ts, 3000.0)


def test_adaptive_bh_matches_nbodyax():
    """The bh step takes adaptive dt through the same make_step: three
    euler steps at N = 256 (levels 3, rows engine, plain near field)."""
    pos, vel, mass, radius = uniform(256, seed=13, field=20000.0)
    bh = dict(eps=20.0, growth_rate=0.1, mode="reference", levels=3, ring=1,
              neighbor_k=0, order=2, far="fmm", near="rows", n_giants=1024)
    kw = dict(dt=0.2, adaptive_dt=True, field_width=20000.0,
              field_height=20000.0, eps=20.0)
    jp, tp = jstep.PhysicsParams(**kw), tstep.PhysicsParams(**kw)
    jfn = jstep.make_step(jp, accum_fn=partial(jbh.bh_accumulators,
                                               near_pallas="off", **bh))
    tfn = tstep.make_step(tp, accum_fn=partial(tbh.bh_accumulators,
                                               near_kernel="off", **bh))
    js = jstate.make_state(pos, vel, mass, radius)
    ts = from_numpy(jstate.to_numpy(js), "cpu")
    js, ts, jt, tt = run(js, ts, jfn, tfn, 3)
    assert tt[-1] < 3 * 0.2
    np.testing.assert_allclose(tt, jt, rtol=2e-5)
    want = jstate.to_numpy(js)
    np.testing.assert_array_equal(ts.mass.numpy() > 0, want["mass"] > 0)
    np.testing.assert_allclose(ts.pos.numpy(), want["pos"], rtol=0,
                               atol=2e-5 * 20000.0)
