"""Differentiable rollouts of nbodyax_torch against nbodyax's.

The port's reverse mode (``nbodyax_torch.autodiff`` over both of its
all-pairs engines, and the analytic backward pass of the pair kernel,
``physics/kernels_bwd.py``) is held to ``jax.grad`` of the JAX package on
the same numpy-made inputs: the plain backward against the Pallas backward
kernel in interpret mode, the accumulator gradients against ``jax.grad`` of
the Pallas kernel and of the JAX oracle, and whole rollouts against
``nbodyax.autodiff``. Then the JAX suite's own properties
(tests/test_autodiff.py) are asserted again on the port. Everything here
runs on the CPU, where the kernel wrappers run their plain versions; the
CUDA kernels are tested on the card by tests/test_torch_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import autodiff as jautodiff  # noqa: E402
from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax.physics import kernels as jkernels  # noqa: E402
from nbodyax.physics import kernels_bwd as jkernels_bwd  # noqa: E402
from nbodyax.physics import pairwise as jpairwise  # noqa: E402
from nbodyax.physics import step as jstep  # noqa: E402
from nbodyax.state import make_state as jax_make_state  # noqa: E402
from nbodyax_torch.autodiff import make_loss, rollout  # noqa: E402
from nbodyax_torch.backends import build_accum_fn  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics import kernels as tkernels  # noqa: E402
from nbodyax_torch.physics import kernels_bwd as tkernels_bwd  # noqa: E402
from nbodyax_torch.physics.pairwise import pair_accumulators  # noqa: E402
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.state import SimState, make_state  # noqa: E402

N = 16
SCALE = 100.0
MODES = ["reference", "momentum", "elastic", "none"]
# tests/test_autodiff.py:182-184's 2-D cases, plus softened reference and
# elastic
VJP_CASES = [("none", 5.0), ("reference", 0.0), ("momentum", 0.0),
             ("elastic", 0.0), ("reference", 5.0), ("elastic", 5.0)]
GATE = 3e-6            # tests/test_autodiff.py:201
ROLLOUT_GATE = 5e-6    # tests/test_autodiff.py:235


def small_arrays(seed=0, overlapping=False, dead=()):
    """tests/test_autodiff.py's small_state as numpy arrays."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-SCALE, SCALE, (N, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    mass = rng.uniform(0.5e12, 2e12, N).astype(np.float32)
    radius = (rng.uniform(20, 60, N) if overlapping
              else rng.uniform(0.5, 2.0, N)).astype(np.float32)
    mass[list(dead)] = 0.0
    return pos, vel, mass, radius


def _state(arrays, **replace):
    """A CPU SimState of ``arrays`` with some fields replaced by tensors
    that require grad."""
    return make_state(*arrays, device="cpu")._replace(**replace)


def small_step(mode="none", integrator="euler", engine="jnp"):
    cfg = SimConfig(particle_count=N, collision_mode=mode, softening=5.0,
                    integrator=integrator, field_width=10_000,
                    field_height=10_000)
    p = PhysicsParams.from_config(cfg)
    return make_step(p, accum_fn=build_accum_fn(engine, p, "cpu"))


def target_loss(state):
    return ((state.pos / SCALE) ** 2).sum() / N


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# The analytic backward pass and the accumulator gradients
# ---------------------------------------------------------------------------

def _weights():
    k = np.arange(2 * N, dtype=np.float32).reshape(N, 2)
    return np.cos(k), np.sin(k)


def torch_accum_grads(fn, arrays, mode, eps):
    """tests/test_autodiff.py::_accum_grads for a port engine: gradients of
    a channel-weighted scalar of the accumulators with respect to pos, vel,
    mass and radius (force, gained mass and radius, dv and best mass
    cotangents at once)."""
    cos_k, sin_k = (torch.from_numpy(w) for w in _weights())
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    acc = fn(*xs, eps=eps, growth_rate=0.1, mode=mode)
    out = (acc.force * cos_k).sum()
    out = out + acc.gained_mass.sum() * 1e-12
    out = out + acc.gained_radius.sum()
    out = out + (acc.dv * sin_k).sum()
    bm = acc.best_mass
    out = out + 1e-12 * torch.where(torch.isfinite(bm), bm, 0.0).sum()
    gs = torch.autograd.grad(out, xs, allow_unused=True)
    return [np.zeros_like(a) if g is None else g.numpy()
            for a, g in zip(arrays, gs)]


def jax_accum_grads(fn, arrays, mode, eps):
    cos_k, sin_k = _weights()

    def loss(pos, vel, mass, radius):
        acc = fn(pos, vel, mass, radius, eps=eps, growth_rate=0.1, mode=mode)
        out = jnp.sum(acc.force * cos_k)
        out = out + jnp.sum(acc.gained_mass) * 1e-12
        out = out + jnp.sum(acc.gained_radius)
        out = out + jnp.sum(acc.dv * sin_k)
        bm = acc.best_mass
        return out + 1e-12 * jnp.sum(jnp.where(jnp.isfinite(bm), bm, 0.0))

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2, 3))(*arrays)]


@pytest.mark.parametrize("eps", [0.0, 5.0])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_path_grads_finite_and_dead_bodies_zero(mode, eps):
    """Regression: autograd through the plain forward gave non-finite
    position and mass gradients at eps = 0 (rsqrt of the self pairs) and a
    non-zero mass gradient to a dead body at eps = 5 (its zero value still
    has a derivative in m_j). The analytic backward gates every pair as the
    oracle does."""
    arrays = small_arrays(11, overlapping=True, dead=(3,))
    got = torch_accum_grads(tkernels.pair_accumulators_kernel, arrays, mode,
                            eps)
    want = torch_accum_grads(pair_accumulators, arrays, mode, eps)
    for name, g, w in zip(("pos", "vel", "mass", "radius"), got, want):
        assert np.all(np.isfinite(g)), (mode, eps, name)
        assert np.all(g[3] == 0.0), (mode, eps, name, g[3])
        assert np.all(np.isfinite(w)) and np.all(w[3] == 0.0)


@pytest.mark.parametrize("offsets", ["full", "offset"])
@pytest.mark.parametrize("mode,eps", VJP_CASES)
def test_plain_backward_matches_pallas_interpret(mode, eps, offsets):
    """raw_backward_reference against nbodyax's backward Pallas kernel in
    interpret mode, on the same features and a numpy-made cotangent; the
    offset case pairs i rows 8..40 with j rows 24..56 at ids past 2^24."""
    n = 64
    rng = np.random.RandomState(7)
    pos = rng.uniform(-SCALE, SCALE, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5e12, 2e12, n).astype(np.float32)
    mass[[3, 30]] = 0.0
    radius = rng.uniform(10, 40, n).astype(np.float32)
    g_raw = rng.standard_normal((n, 8)).astype(np.float32)
    jf = np.asarray(jkernels.body_features(pos, vel, mass, radius))
    tf = torch.from_numpy(jf.copy())
    if offsets == "full":
        (i0, i1), (j0, j1), base = (0, n), (0, n), 0
    else:
        (i0, i1), (j0, j1), base = (8, 40), (24, 56), (1 << 25) + 5
    kw = dict(mode=mode, eps=eps, growth_rate=0.1)
    _, jpar = jkernels.tile_accumulators_raw(
        jf[i0:i1], jf[j0:j1].T, base + i0, base + j0, tile_i=8, tile_j=128,
        interpret=True, **kw)
    want_i, want_jt = jkernels_bwd.raw_backward(
        jf[i0:i1], jf[j0:j1].T, base + i0, base + j0, jpar, g_raw[i0:i1],
        tile_i=8, tile_j=128, interpret=True, dim=2, **kw)
    _, tpar = tkernels.tile_accumulators_raw_reference(
        tf[i0:i1], tf[j0:j1], base + i0, base + j0, **kw)
    if mode == "momentum":
        np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar)[:, 0])
    got_i, got_j = tkernels_bwd.raw_backward(
        tf[i0:i1], tf[j0:j1], base + i0, base + j0, tpar,
        torch.from_numpy(g_raw[i0:i1].copy()), **kw)
    assert rel_err(got_i.numpy(), want_i) < GATE
    assert rel_err(got_j.numpy(), np.asarray(want_jt).T) < GATE


@pytest.mark.parametrize("mode,eps", VJP_CASES)
def test_accumulator_grads_match_jax(mode, eps):
    """The port through its autograd Function against jax.grad of the
    Pallas kernel (interpret mode) and of the JAX oracle, with two dead
    bodies and overlapping radii so every channel carries a gradient."""
    arrays = small_arrays(11, overlapping=True, dead=(3, 7))
    got = torch_accum_grads(tkernels.pair_accumulators_kernel, arrays, mode,
                            eps)
    pallas = functools.partial(jkernels.pallas_pair_accumulators,
                               interpret=True)
    for fn in (pallas, jpairwise.pair_accumulators):
        want = jax_accum_grads(fn, arrays, mode, eps)
        for name, g, w in zip(("pos", "vel", "mass", "radius"), got, want):
            assert np.all(np.isfinite(g)), (mode, name)
            assert rel_err(g, w) < GATE, (mode, eps, name, rel_err(g, w))


def test_backward_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    arrays = small_arrays(2, overlapping=True, dead=(5,))
    feats = tkernels.body_features(*(torch.from_numpy(a) for a in arrays))
    g = torch.from_numpy(
        np.random.RandomState(0).standard_normal((N, 8)).astype(np.float32))
    kw = dict(mode="elastic", eps=0.0, growth_rate=0.1)
    before = tkernels_bwd.raw_backward.launches
    a = tkernels_bwd.raw_backward(feats, feats, 0, 0, None, g, **kw)
    b = tkernels_bwd.raw_backward_reference(feats, feats, 0, 0, None, g,
                                            **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tkernels_bwd.raw_backward.launches == before
    chunked = tkernels_bwd.raw_backward_reference(feats, feats, 0, 0, None,
                                                  g, chunk=5, **kw)
    for x, y in zip(a, chunked):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6 * float(
            x.abs().max()))
    with pytest.raises(ValueError):
        tkernels_bwd.raw_backward(feats, feats, 0, 0, None, g[:, :6], **kw)


# ---------------------------------------------------------------------------
# Rollouts against nbodyax.autodiff
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_rollout_grads(mode, integrator):
    cfg = JaxConfig(particle_count=N, collision_mode=mode, backend="jnp",
                    softening=5.0, integrator=integrator,
                    field_width=10_000, field_height=10_000)
    p = jstep.PhysicsParams.from_config(cfg)
    step = jstep.make_step(p, accum_fn=functools.partial(
        jpairwise.pair_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode=mode))
    pos, vel, mass, radius = small_arrays(2, overlapping=True)
    state = jax_make_state(pos, vel, mass, radius)
    loss = jautodiff.make_loss(
        step, 4, lambda s: jnp.sum((s.pos / SCALE) ** 2) / N)
    gs = jax.grad(lambda x, v, m: loss(state._replace(pos=x, vel=v, mass=m)),
                  argnums=(0, 1, 2))(state.pos, state.vel, state.mass)
    return tuple(np.asarray(g) for g in gs)


@pytest.mark.parametrize("engine", ["jnp", "auto"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("mode", MODES)
def test_rollout_grads_match_jax(mode, integrator, engine):
    """4 steps with collisions, boundary and integrator: gradients with
    respect to the initial pos, vel and mass against nbodyax.autodiff."""
    arrays = small_arrays(2, overlapping=True)
    got = port_rollout_grads(arrays, mode, integrator, engine)
    for leaf, g, w in zip(("pos", "vel", "mass"), got,
                          jax_rollout_grads(mode, integrator)):
        assert np.abs(w).max() > 0, (mode, leaf, "zero gradient")
        err = rel_err(g, w)
        if mode == "momentum" and leaf == "mass":
            # The merged centre of mass X = sum m_k x_k / M has the mass
            # derivative (x_k - X) / M, a cancellation: on this scene the
            # float32 mass gradient of either package carries ~1e-5 of
            # rounding noise (nbodyax's is 1.3e-5 from a float64 run, the
            # port's 6.2e-6). Hold the port to being no noisier than
            # nbodyax against the port's own float64 run, and to 2e-5 of
            # nbodyax.
            exact = port_rollout_grads(arrays, mode, integrator, "jnp",
                                       torch.float64)[2]
            assert rel_err(g, exact) <= rel_err(w, exact), (integrator,
                                                            engine)
            assert err < 2e-5, (integrator, engine, err)
        else:
            assert err < ROLLOUT_GATE, (mode, integrator, engine, leaf, err)


def port_rollout_grads(arrays, mode, integrator, engine,
                       dtype=torch.float32):
    """Gradients of a 4-step rollout's target_loss with respect to the
    initial pos, vel and mass (float64 runs the jnp engine's same code in
    double precision)."""
    pos, vel, mass = (torch.tensor(a, dtype=dtype, requires_grad=True)
                      for a in arrays[:3])
    state = SimState(pos, vel, mass, torch.tensor(arrays[3], dtype=dtype), 0,
                     torch.zeros((), dtype=dtype))
    loss = make_loss(small_step(mode, integrator, engine), 4, target_loss)
    return [g.double().numpy()
            for g in torch.autograd.grad(loss(state), (pos, vel, mass))]


# ---------------------------------------------------------------------------
# tests/test_autodiff.py's properties, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["jnp", "auto"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_grad_matches_central_fd(integrator, engine):
    arrays = small_arrays(1)
    step = small_step("none", integrator, engine)
    loss = make_loss(step, 5, target_loss)
    pos = torch.tensor(arrays[0], requires_grad=True)
    (g,) = torch.autograd.grad(loss(_state(arrays, pos=pos)), pos)
    assert torch.isfinite(g).all()
    # central differences on the 3 largest-gradient coordinates
    idx = np.argsort(np.abs(g.numpy()).ravel())[-3:]
    eps = 0.05
    with torch.no_grad():
        for flat in idx:
            i, d = divmod(int(flat), 2)
            pp, pm = arrays[0].copy(), arrays[0].copy()
            pp[i, d] += eps
            pm[i, d] -= eps
            fd = (float(loss(_state(arrays, pos=torch.from_numpy(pp))))
                  - float(loss(_state(arrays, pos=torch.from_numpy(pm))))
                  ) / (2 * eps)
            ad = float(g[i, d])
            assert abs(ad - fd) <= 0.08 * max(abs(ad), abs(fd)), \
                (integrator, engine, i, d, ad, fd)


@pytest.mark.parametrize("engine", ["jnp", "auto"])
def test_remat_matches_full_residuals(engine):
    arrays = small_arrays(3, overlapping=True)
    step = small_step("reference", engine=engine)
    grads = []
    for remat in (True, False):
        pos = torch.tensor(arrays[0], requires_grad=True)
        final, _ = rollout(step, _state(arrays, pos=pos), 4, remat=remat)
        grads.append(torch.autograd.grad(target_loss(final), pos)[0])
    # the checkpoint re-runs the identical ops
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-9)


def test_trajectory_loss_and_shapes():
    arrays = small_arrays(4)
    step = small_step("none", engine="auto")
    final, traj = rollout(step, _state(arrays), 6, save_positions=True)
    assert traj.shape == (6, N, 2)
    assert torch.equal(traj[-1], final.pos)
    assert final.step == 6
    vel = torch.tensor(arrays[1], requires_grad=True)
    _, traj = rollout(step, _state(arrays, vel=vel), 6, save_positions=True)
    (g,) = torch.autograd.grad(((traj / SCALE) ** 2).mean(), vel)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


@pytest.mark.parametrize("engine", ["jnp", "auto"])
def test_elastic_grad_finite_with_dead_bodies(engine):
    arrays = small_arrays(4, overlapping=True, dead=(0, 5))
    loss = make_loss(small_step("elastic", engine=engine), 3, target_loss)
    pos = torch.tensor(arrays[0], requires_grad=True)
    mass = torch.tensor(arrays[2], requires_grad=True)
    g, gm = torch.autograd.grad(loss(_state(arrays, pos=pos, mass=mass)),
                                (pos, mass))
    assert torch.isfinite(g).all() and torch.isfinite(gm).all()


@pytest.mark.parametrize("engine", ["jnp", "auto"])
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_grad_finite_through_collision_modes(mode, engine):
    arrays = small_arrays(2, overlapping=True)
    loss = make_loss(small_step(mode, engine=engine), 4, target_loss)
    pos = torch.tensor(arrays[0], requires_grad=True)
    vel = torch.tensor(arrays[1], requires_grad=True)
    val = loss(_state(arrays, pos=pos, vel=vel))
    g, gv = torch.autograd.grad(val, (pos, vel))
    assert torch.isfinite(val)
    assert torch.isfinite(g).all() and torch.isfinite(gv).all()
    assert float(g.abs().max()) > 0


def shooting_history(step, arrays, steps=5, iters=8, lr=2e3):
    """Steer body 0 onto a target by descending the gradient of the miss
    with respect to its initial velocity (tests/test_autodiff.py:280-303).
    Returns the loss before each update and after the last."""
    target = torch.tensor([80.0, -40.0])
    base = _state(arrays)

    def value_and_grad(v0):
        v0 = v0.detach().requires_grad_(True)
        vel = torch.cat([v0[None], base.vel[1:]])
        final, _ = rollout(step, base._replace(vel=vel), steps)
        val = (((final.pos[0] - target) / SCALE) ** 2).sum()
        return float(val.detach()), torch.autograd.grad(val, v0)[0]

    v0 = base.vel[0].clone()
    prev, g = value_and_grad(v0)
    history = [prev]
    for _ in range(iters):
        # curvature ~ (steps*dt/SCALE)^2 = 1e-4, so lr up to ~1e4 is stable
        v0 = v0 - lr * g
        val, g = value_and_grad(v0)
        history.append(val)
    return history


@pytest.mark.parametrize("engine", ["jnp", "auto"])
def test_shooting_descends(engine):
    history = shooting_history(small_step("none", engine=engine),
                               small_arrays(5))
    assert history[-1] < 0.01 * history[0], history
