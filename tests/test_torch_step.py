"""nbodyax_torch step against nbodyax's, and the external goldens.

One step of the port, on the JAX package's state carried across with
``from_numpy``, against ``nbodyax.physics.step.make_step`` in every
collision and boundary mode, with the euler, leapfrog and yoshida4
integrators, and five adaptive-dt steps of each integrator; then the
C++-oracle trajectories (tests/golden/ref_*.npz) at tests/test_golden.py's
gates, through both of the port's CPU engines.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import state as jstate  # noqa: E402
from nbodyax.physics import step as jstep  # noqa: E402
from nbodyax_torch.backends import build_accum_fn  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics import step as tstep  # noqa: E402
from nbodyax_torch.scenes import init_scene  # noqa: E402
from nbodyax_torch.state import (alive_count, alive_mask,  # noqa: E402
                                 from_numpy, to_numpy)

HERE = os.path.dirname(os.path.abspath(__file__))
MODES = ["reference", "momentum", "elastic", "none"]
BOUNDARIES = ["reference", "clamp", "none"]


def random_arrays(n=150, seed=4, field=1000.0):
    """Dense overlaps, bodies against the walls, slot 7 dead."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 2)).astype(np.float32)
    vel = rng.uniform(-300, 300, (n, 2)).astype(np.float32)
    mass = rng.uniform(1e12, 1e14, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(5, 40, n).astype(np.float32)
    return pos, vel, mass, radius


def params(mode, boundary, restitution=1.0, wall_restitution=1.0,
           integrator="euler"):
    kw = dict(dt=0.1, field_width=1000.0, field_height=1000.0,
              growth_rate=0.1, collision_mode=mode, boundary_mode=boundary,
              restitution=restitution, wall_restitution=wall_restitution,
              integrator=integrator)
    return jstep.PhysicsParams(**kw), tstep.PhysicsParams(**kw)


@functools.lru_cache(maxsize=None)
def jax_step_result(mode, boundary, restitution, wall_restitution,
                    integrator="euler"):
    jp, _ = params(mode, boundary, restitution, wall_restitution, integrator)
    st = jstate.make_state(*random_arrays())
    return jstate.to_numpy(st), jstate.to_numpy(jstep.make_step(jp)(st))


CASES = ([(m, b, 1.0, 1.0) for m in MODES for b in BOUNDARIES]
         + [("elastic", "clamp", 0.5, 0.7)])


@pytest.mark.parametrize("engine", ["jnp", "auto"])
@pytest.mark.parametrize("mode,boundary,rest,wall_rest", CASES)
def test_step_matches_jax(mode, boundary, rest, wall_rest, engine):
    assert_step_matches_jax(mode, boundary, rest, wall_rest, "euler", engine)


@pytest.mark.parametrize("engine", ["jnp", "auto"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
def test_symplectic_step_matches_jax(integrator, mode, boundary, engine):
    """One leapfrog (two force passes) or yoshida4 (four) step."""
    assert_step_matches_jax(mode, boundary, 1.0, 1.0, integrator, engine)


def assert_step_matches_jax(mode, boundary, rest, wall_rest, integrator,
                            engine):
    before, want = jax_step_result(mode, boundary, rest, wall_rest,
                                   integrator)
    _, tp = params(mode, boundary, rest, wall_rest, integrator)
    state = from_numpy(before, "cpu")
    got = to_numpy(tstep.make_step(
        tp, accum_fn=build_accum_fn(engine, tp, "cpu"))(state))
    np.testing.assert_array_equal(got["mass"] > 0, want["mass"] > 0)
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-6)
    np.testing.assert_allclose(got["radius"], want["radius"], rtol=1e-6)
    vscale = np.abs(want["vel"]).max()
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=0,
                               atol=1e-6 * vscale)
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0,
                               atol=1e-6 * 1000.0)
    assert int(got["step"]) == int(want["step"]) == 1
    assert got["sim_time"] == want["sim_time"]
    assert got["pos"].dtype == np.float32


def test_state_round_trip():
    arrays = random_arrays(20)
    st = jstate.make_state(*arrays, step=5, sim_time=1.5)
    d = to_numpy(from_numpy(jstate.to_numpy(st), "cpu"))
    for k, v in jstate.to_numpy(st).items():
        np.testing.assert_array_equal(d[k], v)
        assert d[k].dtype == v.dtype
    st = from_numpy(jstate.to_numpy(st), "cpu")
    assert alive_count(st) == jstate.alive_count(jstate.make_state(*arrays))
    assert torch.equal(alive_mask(st), st.mass > 0)


@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4", "euler"])
def test_adaptive_step_matches_jax(integrator):
    """Five adaptive-dt steps of the port against nbodyax's on one
    numpy-made state, at the fixed-dt parity's gates."""
    kw = dict(dt=0.1, field_width=1000.0, field_height=1000.0,
              growth_rate=0.1, integrator=integrator, adaptive_dt=True)
    jp, tp = jstep.PhysicsParams(**kw), tstep.PhysicsParams(**kw)
    st = jstate.make_state(*random_arrays())
    state = from_numpy(jstate.to_numpy(st), "cpu")
    jfn = jstep.make_step(jp)
    tfn = tstep.make_step(tp, accum_fn=build_accum_fn("auto", tp, "cpu"))
    for _ in range(5):
        st, state = jfn(st), tfn(state)
    want, got = jstate.to_numpy(st), to_numpy(state)
    np.testing.assert_array_equal(got["mass"] > 0, want["mass"] > 0)
    np.testing.assert_allclose(got["mass"], want["mass"], rtol=1e-6)
    np.testing.assert_allclose(got["radius"], want["radius"], rtol=1e-6)
    np.testing.assert_allclose(got["vel"], want["vel"], rtol=0,
                               atol=1e-6 * np.abs(want["vel"]).max())
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0,
                               atol=1e-6 * 1000.0)
    assert int(got["step"]) == int(want["step"]) == 5
    # each dt is a min over bodies of sqrt(r/|a|): the forces' last bits
    # (two engines' sum orders) reach it, so sim_time gets mass's rtol
    np.testing.assert_allclose(got["sim_time"], want["sim_time"], rtol=1e-6)
    assert 0 < got["sim_time"] < 5 * 0.1     # dt shrank below the ceiling


@pytest.mark.parametrize("engine", ["jnp", "auto"])
@pytest.mark.parametrize("name,n,steps,field", [
    ("ref_n64_dense", 64, 20, 5000),
    ("ref_n64_sparse", 64, 100, 100000),
    ("ref_n1k", 1024, 200, 100000),
])
def test_matches_external_cpp_oracle(name, n, steps, field, engine):
    """tests/test_golden.py's gates: alive masks exact at every step, mass
    and radius to rtol 1e-6, live pos and vel within 2e-4 of the field."""
    with np.load(os.path.join(HERE, "golden", name + ".npz")) as z:
        gpos, gvel = z["pos"], z["vel"]
        gmass, gradius = z["mass"], z["radius"]
    cfg = SimConfig(particle_count=n, field_width=field, field_height=field,
                    timestep=0.2, seed=1024)
    state = init_scene(cfg, device="cpu")
    p = tstep.PhysicsParams.from_config(cfg)
    step = tstep.make_step(p, accum_fn=build_accum_fn(engine, p, "cpu"))
    for s in range(1, steps + 1):
        state = step(state)
        mass = state.mass.numpy()
        np.testing.assert_array_equal(mass > 0, gmass[s] > 0,
                                      err_msg=f"alive mask at step {s}")
        np.testing.assert_allclose(mass, gmass[s], rtol=1e-6,
                                   err_msg=f"mass at step {s}")
        np.testing.assert_allclose(state.radius.numpy(), gradius[s],
                                   rtol=1e-6, err_msg=f"radius at step {s}")
        alive2 = (mass > 0)[:, None]
        for got, want, what in ((state.pos, gpos[s], "pos"),
                                (state.vel, gvel[s], "vel")):
            np.testing.assert_allclose(
                np.where(alive2, got.numpy(), 0), np.where(alive2, want, 0),
                atol=2e-4 * field, rtol=0, err_msg=f"{what} at step {s}")
