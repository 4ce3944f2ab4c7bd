"""The exact step across shards (``nbodyax_torch.sharding.ring``) against
nbodyax's ppermute ring, on the CPU.

The port's ranks are four gloo processes (one spawn for the module, each
rank on one thread, never importing JAX); nbodyax runs its ring over four
of the eight fake CPU devices of ``tests/conftest.py``. The same seeded
bodies go through both:

- ``ring_accumulators`` in reference, momentum and elastic mode, through
  B1's wrapper (its plain version here) and the torch oracle, at
  ``tests/test_ring.py``'s gates: force within 2e-6 of the largest
  |force|, merge decisions exact, gained mass to rtol 1e-6, dv to rtol
  1e-5;
- ``make_sharded_step``: euler in every mode, leapfrog over three steps,
  yoshida4, elastic restitution 0.5, adaptive dt (the lockstep minimum
  over ranks) and five euler steps, at test_ring.py's step gates, with
  the alive mask exact and the simulated time equal;
- a capacity the shard count does not divide (102 bodies, padded to 104):
  the padding stays dead.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from nbodyax.config import SimConfig as JaxConfig
from nbodyax.physics.step import PhysicsParams as JaxParams
from nbodyax.sharding.mesh import AXIS, make_mesh, pad_to_shards, shard_state
from nbodyax.sharding.ring import (make_local_accum_fn, make_sharded_step,
                                   ring_accumulators)
from nbodyax.state import make_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = 4
MODES = ("reference", "momentum", "elastic")

# (name, collision mode, integrator, steps, restitution, adaptive dt, n)
STEPS = ([(f"euler-{m}", m, "euler", 1, 1.0, False, 256) for m in MODES]
         + [(f"leapfrog-{m}", m, "leapfrog", 3, 1.0, False, 256)
            for m in MODES]
         + [("yoshida4-none", "none", "yoshida4", 1, 1.0, False, 256),
            ("elastic-e0.5", "elastic", "euler", 1, 0.5, False, 256),
            ("adaptive-dt", "reference", "euler", 3, 1.0, True, 256),
            ("euler-5-steps", "reference", "euler", 5, 1.0, False, 128),
            ("padded-102", "reference", "euler", 1, 1.0, False, 102)])

CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, size, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=size)
from nbodyax_torch.config import SimConfig
from nbodyax_torch.physics.step import PhysicsParams
from nbodyax_torch.sharding import (make_group, make_sharded_step,
                                    pad_to_shards, ring_accumulators,
                                    shard_state)
from nbodyax_torch.sharding.ring import make_local_accum_fn
from nbodyax_torch.state import make_state
g = make_group(size, "cpu")
spec = json.load(open(work + "/spec.json"))
inp = np.load(work + "/in.npz")
out = {}
for mode in spec["modes"]:
    st = shard_state(make_state(*(inp[k + "256"] for k in ("pos", "vel", "mass", "radius")),
                                device="cpu"), g)
    p = PhysicsParams(collision_mode=mode)
    for backend in ("jnp", "auto"):
        acc = ring_accumulators(*st[:4], group=g,
                                accum_fn=make_local_accum_fn(backend, p),
                                need_vel=mode == "elastic")
        for f in ("force", "gained_mass", "died", "parent", "dv"):
            t = getattr(acc, f)
            out[f"acc/{mode}/{backend}/{f}"] = g.all_gather(
                t.to(torch.int32) if t.dtype == torch.bool else t).numpy()
for name, mode, integ, steps, rest, adaptive, n in spec["steps"]:
    p = PhysicsParams(dt=0.1, field_width=1000.0, field_height=1000.0,
                      collision_mode=mode, integrator=integ, restitution=rest,
                      adaptive_dt=adaptive, dt_eta=0.02)
    step = make_sharded_step(SimConfig(shards=size), p, g)
    st = make_state(*(inp[k + str(n)] for k in ("pos", "vel", "mass", "radius")),
                    device="cpu")
    s = shard_state(pad_to_shards(st, size), g)
    for _ in range(steps):
        s = step(s)
    for k, t in zip(("pos", "vel", "mass", "radius"), s[:4]):
        out[f"step/{name}/{k}"] = g.all_gather(t).numpy()
    out[f"step/{name}/sim_time"] = s.sim_time.numpy()
    out[f"step/{name}/step"] = np.asarray(s.step)
if rank == 0:
    np.savez(work + "/out.npz", **out)
dist.destroy_process_group()
"""


def spawn(work, size, code, timeout=60):
    """Run ``code`` as ``size`` gloo ranks (a FileStore in ``work``) and
    wait for all of them; any rank failing fails the test."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(size),
         str(work / "store"), str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(size)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


def random_arrays(n, seed):
    """test_ring.py's bodies, with masses heavy enough that gravity moves
    them within a step (slot 3 dead)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1e11, 1e13, n).astype(np.float32)
    mass[3] = 0.0
    radius = rng.uniform(5, 40, n).astype(np.float32)
    return pos, vel, mass, radius


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's results for every case, from one four-rank spawn."""
    work = tmp_path_factory.mktemp("ring")
    arrays = {}
    for n in sorted({c[-1] for c in STEPS}):
        for k, a in zip(("pos", "vel", "mass", "radius"),
                        random_arrays(n, seed=n)):
            arrays[k + str(n)] = a
    np.savez(work / "in.npz", **arrays)
    (work / "spec.json").write_text(json.dumps(
        {"modes": MODES, "steps": STEPS}))
    spawn(work, SHARDS, CHILD)
    return dict(np.load(work / "out.npz")), arrays


def jax_state(arrays, n):
    return make_state(*(arrays[k + str(n)]
                        for k in ("pos", "vel", "mass", "radius")))


@pytest.mark.parametrize("backend", ["jnp", "auto"])
@pytest.mark.parametrize("mode", MODES)
def test_ring_accumulators_match_nbodyax(port, mode, backend):
    out, arrays = port
    st = jax_state(arrays, 256)
    p = JaxParams(collision_mode=mode)
    mesh = make_mesh(SHARDS)
    accum_fn = make_local_accum_fn("jnp", p)
    want = jax.jit(jax.shard_map(
        lambda pos, vel, m, r: ring_accumulators(
            pos, vel, m, r, n_shards=SHARDS, accum_fn=accum_fn,
            need_vel=mode == "elastic"),
        mesh=mesh, in_specs=(P(AXIS),) * 4, out_specs=P(AXIS),
        check_vma=False))(st.pos, st.vel, st.mass, st.radius)

    def got(f):
        return out[f"acc/{mode}/{backend}/{f}"]
    fd = np.asarray(want.force)
    assert np.abs(got("force") - fd).max() <= 2e-6 * np.abs(fd).max()
    if mode == "reference":
        np.testing.assert_allclose(got("gained_mass"),
                                   np.asarray(want.gained_mass), rtol=1e-6)
        np.testing.assert_array_equal(got("died") > 0, np.asarray(want.died))
        assert np.asarray(want.died).any()
    if mode == "momentum":
        np.testing.assert_array_equal(got("parent"), np.asarray(want.parent))
        assert (np.asarray(want.parent) != np.arange(256)).any()
    if mode == "elastic":
        np.testing.assert_allclose(got("dv"), np.asarray(want.dv),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", STEPS, ids=[c[0] for c in STEPS])
def test_sharded_step_matches_nbodyax(port, case):
    out, arrays = port
    name, mode, integ, steps, rest, adaptive, n = case
    p = JaxParams(dt=0.1, field_width=1000, field_height=1000,
                  collision_mode=mode, integrator=integ, restitution=rest,
                  adaptive_dt=adaptive, dt_eta=0.02)
    mesh = make_mesh(SHARDS)
    step = make_sharded_step(JaxConfig(shards=SHARDS, backend="jnp"), p,
                             mesh=mesh)
    s = shard_state(pad_to_shards(jax_state(arrays, n), SHARDS), mesh)
    for _ in range(steps):
        s = step(s)

    def got(k):
        return out[f"step/{name}/{k}"]
    cap = -(-n // SHARDS) * SHARDS
    assert got("pos").shape[0] == cap and int(got("step")) == steps
    tol = (dict(rtol=1e-5, atol=1e-3) if integ == "leapfrog" or steps > 3
           else dict(rtol=1e-5, atol=1e-4))
    np.testing.assert_allclose(got("pos"), np.asarray(s.pos), **tol)
    np.testing.assert_allclose(got("vel"), np.asarray(s.vel), **tol)
    np.testing.assert_allclose(got("mass"), np.asarray(s.mass), rtol=1e-6)
    np.testing.assert_allclose(got("radius"), np.asarray(s.radius),
                               rtol=1e-6)
    np.testing.assert_array_equal(got("mass") > 0, np.asarray(s.mass) > 0)
    assert float(got("sim_time")) == float(np.asarray(s.sim_time))
    if adaptive:            # the bound bit: dt fell below the configured 0.1
        assert float(got("sim_time")) < 0.1 * steps * 0.999
    if n % SHARDS:
        assert np.all(got("mass")[n:] == 0)      # the padding stays dead
