"""Gradients through the sharded exact step (``nbodyax_torch.sharding``)
against nbodyax's sharded gradients and the port's single-device ones, on
the CPU.

The port's ranks are gloo processes (one spawn for each group size, each
rank on one thread, never importing JAX). Each rank differentiates its
share of ``target_loss`` (a sum over bodies, so the shares add up to the
whole loss) through ``make_loss`` over ``make_sharded_step``; the backward
passes of the collectives carry every other rank's share to its leaves,
so each rank ends with its rows of the gradient of the whole loss.
nbodyax's side is ``jax.grad`` through ``nbodyax.sharding.ring``'s step
(``backend="jnp"``) over four of the eight fake CPU devices of
``tests/conftest.py``. The gate is tests/test_autodiff.py:155's: 1e-5 of
the largest |grad|, for the gradients with respect to pos, vel and mass.

- F6, the fault this file was written for: two ranks, modes none,
  reference and momentum, one and three euler steps, B1 and B2 (their
  plain versions here). Before the collectives had backward passes the
  remote tiles' gradients never went home (off by 6.4e-3 and 2.0e-2 of
  the largest) and momentum mode's forward raised under grad mode.
- Four ranks: reference, momentum (merges whose winners sit in other
  ranks' rows) and elastic mode; euler over 3 steps, leapfrog over 2 and
  yoshida4 over 1; both engines (B1 and the torch oracle); remat on and
  off; a capacity that 4 does not divide.
- Momentum mode's mass gradient where float32 cannot hold it (merges of
  bodies that barely overlap, see ``random_arrays``): in float64 through
  the torch oracle's ring, against the single-device oracle in float64.
- Adaptive dt under shards raises ``NotImplementedError`` in both
  packages (nbodyax: ``lax.pmin`` has no differentiation rule).
- The best-mass cotangent of a momentum tie whose equal-mass candidates
  lie in two other ranks' tiles goes whole to the lower id, as in one pass
  over all bodies.
- With grad mode on, the sharded forward is bitwise the forward-only one;
  reduce_scatter_sum and all_gather are each other's transposes; a
  gradient request through the bh step, sharded or not, raises (F7).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax.physics.step import PhysicsParams as JaxParams  # noqa: E402
from nbodyax.sharding.mesh import make_mesh  # noqa: E402
from nbodyax.sharding.mesh import pad_to_shards as jax_pad  # noqa: E402
from nbodyax.sharding.mesh import shard_state as jax_shard  # noqa: E402
from nbodyax.sharding.ring import make_sharded_step as jax_sharded  # noqa
from nbodyax.state import make_state as jax_make_state  # noqa: E402
from nbodyax_torch.autodiff import make_loss  # noqa: E402
from nbodyax_torch.backends import build_accum_fn  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics.kernels import pair_accumulators_kernel  # noqa
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = 4
SCALE = 100.0
GATE = 1e-5            # tests/test_autodiff.py:155
LEAVES = ("pos", "vel", "mass")
# tests/test_autodiff.py's settings: softening 5 and a 1e4 field
BASE = dict(softening=5.0, field_width=10_000, field_height=10_000)

# (name, collision mode, integrator, steps, backend, remat, bodies)
CASES = [
    ("euler-reference-auto", "reference", "euler", 3, "auto", True, 64),
    ("euler-momentum-auto", "momentum", "euler", 3, "auto", True, 64),
    ("euler-elastic-jnp", "elastic", "euler", 3, "jnp", False, 64),
    ("leapfrog-reference-jnp", "reference", "leapfrog", 2, "jnp", True, 64),
    ("leapfrog-momentum-auto", "momentum", "leapfrog", 2, "auto", False,
     64),
    ("leapfrog-elastic-auto", "elastic", "leapfrog", 2, "auto", True, 64),
    ("yoshida4-reference-auto", "reference", "yoshida4", 1, "auto", False,
     64),
    ("yoshida4-momentum-jnp", "momentum", "yoshida4", 1, "jnp", True, 64),
    ("yoshida4-elastic-auto", "elastic", "yoshida4", 1, "auto", True, 64),
    ("euler-momentum-padded-62", "momentum", "euler", 3, "auto", True, 62),
]
# the F6 probe: two ranks, B1 and B2, one and three euler steps
F6_CASES = [(f"f6-{mode}-{steps}", mode, "euler", steps, "auto", True, 64)
            for mode in ("none", "reference", "momentum") for steps in (1, 3)]
ADAPTIVE = ("adaptive-dt", "reference", "euler", 2, "auto", True, 64)
# in float64 on the "sparse" bodies (the oracle: B1 and B2 are float32)
F64 = ("f64-euler-momentum-sparse", "momentum", "euler", 3, "jnp", True, 64)

CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, size, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=size)
from nbodyax_torch.autodiff import make_loss
from nbodyax_torch.config import SimConfig
from nbodyax_torch.physics.kernels import body_features, decode_raw
from nbodyax_torch.physics.step import PhysicsParams
from nbodyax_torch.sharding import (make_group, make_sharded_bh_step,
                                    make_sharded_step, pad_to_shards,
                                    ring_accumulators, shard_state)
from nbodyax_torch.sharding.ring import make_local_accum_fn
from nbodyax_torch.state import make_state
g = make_group(size, "cpu")
spec = json.load(open(work + "/spec.json"))
inp = np.load(work + "/in.npz")
out = {}


def arrays(n):
    return [inp[k + str(n)] for k in ("pos", "vel", "mass", "radius")]


def state_of(name, n):
    if not name.startswith("f64"):
        return make_state(*arrays(n), device="cpu")
    st = make_state(*arrays("sparse"), device="cpu")
    return st._replace(**{k: getattr(st, k).double() for k in
                          ("pos", "vel", "mass", "radius", "sim_time")})


def config(mode, integ, backend, adaptive=False):
    return SimConfig(shards=size, collision_mode=mode, integrator=integ,
                     backend=backend, adaptive_dt=adaptive, **spec["base"])


for name, mode, integ, steps, backend, remat, n in spec["cases"]:
    cfg = config(mode, integ, backend, name == "adaptive-dt")
    step = make_sharded_step(cfg, PhysicsParams.from_config(cfg), g)
    st = shard_state(pad_to_shards(state_of(name, n), size), g)
    leaves = [t.detach().clone().requires_grad_(True) for t in st[:3]]
    # this rank's share of target_loss
    loss = make_loss(step, steps,
                     lambda s: ((s.pos / spec["scale"]) ** 2).sum() / n,
                     remat=remat)
    try:
        grads = torch.autograd.grad(loss(st._replace(
            pos=leaves[0], vel=leaves[1], mass=leaves[2])), leaves)
    except Exception as e:       # recorded for the test to read
        out[name + "/error"] = np.asarray(f"{type(e).__name__}: {e}")
        continue
    for k, t in zip(("pos", "vel", "mass"), grads):
        out[f"{name}/{k}"] = g.all_gather(t).numpy()

if spec["extras"]:
    # grad mode on leaves the forward bitwise as it was
    cfg = config("momentum", "leapfrog", "auto")
    step = make_sharded_step(cfg, PhysicsParams.from_config(cfg), g)
    st = shard_state(make_state(*arrays(64), device="cpu"), g)
    plain = step(st)
    tracked = step(st._replace(pos=st.pos.clone().requires_grad_(True)))
    out["forward/bitwise"] = np.asarray(all(
        torch.equal(a, b.detach()) for a, b in zip(plain[:4], tracked[:4]))
        and tracked.pos.requires_grad)
    # the tie: best-mass and force cotangents through the ring's fold
    p = PhysicsParams.from_config(config("momentum", "euler", "auto"))
    st = shard_state(make_state(*arrays("tie"), device="cpu"), g)
    pos = st.pos.clone().requires_grad_(True)
    mass = st.mass.clone().requires_grad_(True)
    acc = ring_accumulators(pos, st.vel, mass, st.radius, group=g,
                            accum_fn=make_local_accum_fn("auto", p),
                            need_vel=False)
    w = torch.from_numpy(inp["w_tie"])[g.rank * pos.shape[0]:][
        :pos.shape[0]]
    bm = torch.where(torch.isfinite(acc.best_mass), acc.best_mass,
                     torch.zeros_like(acc.best_mass))
    val = (acc.force * w).sum() * 1e-9 + bm.sum()
    for k, t in zip(("pos", "mass"), torch.autograd.grad(val, (pos, mass))):
        out[f"tie/{k}"] = g.all_gather(t).numpy()
    out["tie/parent"] = g.all_gather(acc.parent).numpy()
    # the transposes: reduce_scatter_sum's backward gathers, all_gather's
    # reduce-scatters
    x = torch.ones((3 * size, 2), requires_grad=True)
    y = g.reduce_scatter_sum(x)
    out["rs/grad"] = torch.autograd.grad((y * (rank + 1.0)).sum(), x)[0].numpy()
    x = torch.ones((3, 2), requires_grad=True)
    y = g.all_gather(x)
    w = torch.arange(3 * size, dtype=torch.float32)[:, None] * (rank + 1.0)
    out["ag/grad"] = g.all_gather(
        torch.autograd.grad((y * w).sum(), x)[0]).numpy()
    # the sharded bh step is forward-only
    cfg = SimConfig(shards=size, force_model="bh", bh_levels=2, bh_near="rows",
                    bh_neighbor_k=16, bh_pallas="off", **spec["base"])
    step = make_sharded_bh_step(cfg, PhysicsParams.from_config(cfg), g)
    st = shard_state(make_state(*arrays(64), device="cpu"), g)
    try:
        step(st._replace(pos=st.pos.clone().requires_grad_(True)))
        out["bh/error"] = np.asarray("no error")
    except NotImplementedError as e:
        out["bh/error"] = np.asarray(f"NotImplementedError: {e}")
if rank == 0:
    np.savez(work + "/out.npz", **out)
dist.destroy_process_group()
"""


def spawn(work, size, timeout=240):
    """Run CHILD as ``size`` gloo ranks (a FileStore in ``work``); any
    rank failing fails the test."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(size),
         str(work / "store"), str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(size)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


def random_arrays(n, seed, radii=(20.0, 60.0)):
    """tests/test_autodiff.py's ``small_state(overlapping=True)`` bodies,
    64 of them: most overlap and merge in the first step, slot 5 dead.

    Merges of bodies that barely overlap (radii of 2 to 8 here) put the
    momentum-mode mass gradient at the edge of float32: the centre of
    mass's quotient ``sum(m p) / sum(m)`` differentiates into two terms
    that cancel to about 1% of themselves, so one rounding step of those
    terms is 2e-5 to 5e-5 of the largest mass gradient. That much
    separates nbodyax's single-device and sharded gradients, and the
    port's two single-device engines, as well as the port's sharded
    gradient, so it says nothing of the ring; these dense merges keep the
    rounding near 1e-7 and leave the gate something to find."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-SCALE, SCALE, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5e12, 2e12, n).astype(np.float32)
    radius = rng.uniform(*radii, n).astype(np.float32)
    mass[5] = 0.0
    return pos, vel, mass, radius


def tie_arrays(n=64):
    """Body 0 (rank 0's rows) overlapped by two bodies of equal mass in
    ranks 1 and 2's rows (ids 20 and 40), both heavier; everything else
    far apart."""
    pos, vel, mass, radius = random_arrays(n, seed=7)
    pos *= 100.0
    pos[[0, 20, 40]] = [[0.0, 0.0], [3.0, 0.0], [0.0, 3.0]]
    mass[[20, 40]] = 4e12
    mass[0] = 1e12
    radius[[0, 20, 40]] = 5.0
    return pos, vel, mass, radius


def case_inputs():
    arrays = {}
    for n in (62, 64):
        for k, a in zip(("pos", "vel", "mass", "radius"),
                        random_arrays(n, seed=n)):
            arrays[k + str(n)] = a
    for k, a in zip(("pos", "vel", "mass", "radius"), tie_arrays()):
        arrays[k + "tie"] = a
    for k, a in zip(("pos", "vel", "mass", "radius"),
                    random_arrays(64, seed=64, radii=(2.0, 8.0))):
        arrays[k + "sparse"] = a
    arrays["w_tie"] = np.random.RandomState(3).standard_normal(
        (64, 2)).astype(np.float32)
    return arrays


def run_port(work, size, cases, extras):
    arrays = case_inputs()
    np.savez(work / "in.npz", **arrays)
    (work / "spec.json").write_text(json.dumps(
        {"cases": cases, "extras": extras, "scale": SCALE, "base": BASE}))
    spawn(work, size)
    return dict(np.load(work / "out.npz")), arrays


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's four-rank gradients for every case, from one spawn."""
    return run_port(tmp_path_factory.mktemp("grad4"), SHARDS,
                    CASES + [ADAPTIVE, F64], True)


@pytest.fixture(scope="module")
def port_f6(tmp_path_factory):
    """The port's two-rank gradients of the F6 probe, from one spawn."""
    return run_port(tmp_path_factory.mktemp("grad2"), 2, F6_CASES, False)


def target_loss(pos, n):
    return ((pos / SCALE) ** 2).sum() / n


def single_grads(arrays, case):
    """The port's single-device gradients of the case, with respect to
    pos, vel and mass (the padding's rows are zero); an "f64" case in
    float64 on the "sparse" bodies."""
    name, mode, integ, steps, backend, remat, n = case
    cfg = SimConfig(particle_count=n, collision_mode=mode, integrator=integ,
                    **BASE)
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn(backend, p, "cpu"))
    key = "sparse" if name.startswith("f64") else str(n)
    st = make_state(*(arrays[k + key]
                      for k in ("pos", "vel", "mass", "radius")),
                    device="cpu")
    if name.startswith("f64"):
        st = st._replace(**{k: getattr(st, k).double() for k in
                            ("pos", "vel", "mass", "radius", "sim_time")})
    leaves = [t.clone().requires_grad_(True) for t in st[:3]]
    loss = make_loss(step, steps, lambda s: target_loss(s.pos, n),
                     remat=remat)
    grads = torch.autograd.grad(loss(st._replace(
        pos=leaves[0], vel=leaves[1], mass=leaves[2])), leaves)
    return {k: g.numpy() for k, g in zip(LEAVES, grads)}


_JAX_GRADS = {}


def nbodyax_grads(arrays, case):
    """``jax.grad`` through nbodyax's sharded ring step (the jnp engine)
    over four devices, with respect to pos, vel and mass."""
    name, mode, integ, steps, _, _, n = case
    if name in _JAX_GRADS:
        return _JAX_GRADS[name]
    cfg = JaxConfig(particle_count=n, collision_mode=mode, integrator=integ,
                    backend="jnp", shards=SHARDS, **BASE)
    mesh = make_mesh(SHARDS)
    step = jax_sharded(cfg, JaxParams.from_config(cfg), mesh=mesh)
    st = jax_shard(jax_pad(jax_make_state(*(
        arrays[k + str(n)] for k in ("pos", "vel", "mass", "radius"))),
        SHARDS), mesh)

    def loss(pos, vel, mass):
        s = st._replace(pos=pos, vel=vel, mass=mass)
        for _ in range(steps):
            s = step(s)
        return jnp.sum((s.pos / SCALE) ** 2) / n

    grads = jax.grad(loss, argnums=(0, 1, 2))(st.pos, st.vel, st.mass)
    _JAX_GRADS[name] = {k: np.asarray(g) for k, g in zip(LEAVES, grads)}
    return _JAX_GRADS[name]


def got(out, name, leaf):
    err = out.get(name + "/error")
    assert err is None, str(err)
    return out[f"{name}/{leaf}"]


def assert_close(a, want, label):
    """Within GATE of the largest |grad| of ``want``, which is nonzero."""
    assert a.shape == want.shape, (label, a.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0 and np.all(np.isfinite(a)), (label, "zero or nan")
    err = float(np.abs(a - want).max()) / scale
    assert err < GATE, (label, err)


@pytest.mark.parametrize("case", F6_CASES, ids=[c[0] for c in F6_CASES])
def test_f6_sharded_gradient_equals_single_device(port_f6, case):
    out, arrays = port_f6
    want = single_grads(arrays, case)
    for leaf in LEAVES:
        assert_close(got(out, case[0], leaf), want[leaf], (case[0], leaf))


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_gradient_matches_single_device(port, case, leaf):
    out, arrays = port
    n = case[-1]
    g = got(out, case[0], leaf)
    assert np.all(g[n:] == 0)       # the padding's rows carry nothing
    assert_close(g[:n], single_grads(arrays, case)[leaf], (case[0], leaf))


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_gradient_matches_nbodyax(port, case, leaf):
    out, arrays = port
    assert_close(got(out, case[0], leaf), nbodyax_grads(arrays, case)[leaf],
                 (case[0], leaf))


@pytest.mark.parametrize("leaf", LEAVES)
def test_float64_sharded_gradient_where_float32_cannot_hold(port, leaf):
    """Merges of bodies that barely overlap: float32 rounding alone puts
    the momentum-mode mass gradient 2e-5 to 5e-5 of its largest apart
    between any two engines (``random_arrays``), so the ring is held to
    the gate in float64, through the torch oracle's ring on four ranks."""
    out, arrays = port
    g = got(out, F64[0], leaf)
    assert g.dtype == np.float64
    assert_close(g, single_grads(arrays, F64)[leaf], (F64[0], leaf))


def test_momentum_merges_cross_ranks(port):
    """The momentum cases merge bodies whose winners sit in another rank's
    rows, so the merge's gradient crosses ranks."""
    _, arrays = port
    st = make_state(*(arrays[k + "64"]
                      for k in ("pos", "vel", "mass", "radius")),
                    device="cpu")
    acc = pair_accumulators_kernel(*st[:4], eps=5.0, mode="momentum")
    ids = torch.arange(64)
    won = acc.parent != ids
    assert int((won & (acc.parent // 16 != ids // 16)).sum()) >= 2


def test_adaptive_dt_under_shards_raises_in_both(port):
    out, arrays = port
    assert "NotImplementedError" in str(out["adaptive-dt/error"])
    assert "pmin" in str(out["adaptive-dt/error"])
    cfg = JaxConfig(particle_count=64, backend="jnp", shards=SHARDS,
                    adaptive_dt=True, **BASE)
    mesh = make_mesh(SHARDS)
    step = jax_sharded(cfg, JaxParams.from_config(cfg), mesh=mesh)
    st = jax_shard(jax_make_state(*(arrays[k + "64"] for k in
                                    ("pos", "vel", "mass", "radius"))), mesh)
    with pytest.raises(NotImplementedError, match="pmin"):
        jax.grad(lambda pos: jnp.sum(step(st._replace(pos=pos)).pos))(
            st.pos)


def test_tie_best_mass_cotangent_goes_to_the_lower_id(port):
    """Body 0's two equal-mass candidates lie in ranks 1 and 2's tiles: the
    lower id wins the merge, and the best-mass cotangent goes whole to its
    mass, as in one pass over all bodies (the plain B1 and B2 here)."""
    out, arrays = port
    st = make_state(*(arrays[k + "tie"]
                      for k in ("pos", "vel", "mass", "radius")),
                    device="cpu")
    pos = st.pos.clone().requires_grad_(True)
    mass = st.mass.clone().requires_grad_(True)
    acc = pair_accumulators_kernel(pos, st.vel, mass, st.radius, eps=5.0,
                                   mode="momentum")
    bm = torch.where(torch.isfinite(acc.best_mass), acc.best_mass,
                     torch.zeros_like(acc.best_mass))
    val = ((acc.force * torch.from_numpy(arrays["w_tie"])).sum() * 1e-9
           + bm.sum())
    want = torch.autograd.grad(val, (pos, mass))
    assert int(acc.parent[0]) == 20 and int(out["tie/parent"][0]) == 20
    for k, w in zip(("pos", "mass"), want):
        assert_close(out[f"tie/{k}"], w.numpy(), ("tie", k))


def test_grad_mode_leaves_the_sharded_forward_bitwise(port):
    out, _ = port
    assert bool(out["forward/bitwise"])


def test_sharded_bh_gradient_raises(port):
    out, _ = port
    assert str(out["bh/error"]).startswith("NotImplementedError")
    assert "forward-only" in str(out["bh/error"])


def test_collectives_are_each_others_transposes(port):
    """d/dx of sum_r w_r . reduce_scatter_sum(x)_r is all_gather(w): rank
    r's block of every rank's x gets w_r = r + 1. d/dx_r of sum_s w_s .
    all_gather(x) is the sum over ranks s of w_s's rows of block r."""
    out, _ = port
    want = np.repeat(np.arange(1.0, SHARDS + 1), 3)[:, None] * np.ones(2)
    assert np.array_equal(out["rs/grad"], want)
    rows = np.arange(3 * SHARDS, dtype=np.float32)[:, None] * np.ones(2)
    assert np.array_equal(out["ag/grad"],
                          rows * sum(range(1, SHARDS + 1)))


def test_single_device_bh_gradient_raises():
    """F7: the single-device bh step is forward-only too. Its near-field
    kernels run through ctypes, which autograd does not see, so on a card
    a gradient would lack the near field's part; it raises instead of
    returning one (on the CPU as on the card)."""
    cfg = SimConfig(particle_count=64, force_model="bh", bh_levels=2,
                    bh_near="rows", bh_neighbor_k=16, **BASE)
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn("auto", p, "cpu", cfg))
    st = make_state(*random_arrays(64, seed=64), device="cpu")
    with pytest.raises(NotImplementedError, match="forward-only"):
        step(st._replace(pos=st.pos.clone().requires_grad_(True)))
    with torch.no_grad():       # the forward itself runs as before
        assert torch.isfinite(step(st).pos).all()
