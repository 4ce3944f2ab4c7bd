"""The cell-range bh step (``nbodyax_torch.sharding.bh``) against
nbodyax's, on the CPU.

- ``bh_cellrange_accumulators`` of one shard (of four) against nbodyax's
  with the same shard index, on a state with a 200-body crowded cell (past
  the slot budget, so the sliced completion list runs), dead bodies and a
  giant: every collision mode with the rows and the slots engine and the
  FMM far field, and ``bhFar=direct``; the gates of
  ``tests/test_torch_bh_slice.py`` (force within 2e-5 of the largest
  |force|, died and parent exact, gained mass to rtol 1e-5, dv within
  2e-5 of the largest); and the slots engine in 3-D (levels 3). The shard
  is the case's index mod 4, so every index is held to nbodyax in some
  case.
- Disjoint and complete: over the four shards each body is touched by at
  most one, and the shards' identity-rebased sum equals the port's
  single-device ``bh_accumulators`` bit for bit, in every case.
- ``make_sharded_bh_step`` over two gloo ranks (one spawn, never
  importing JAX) against nbodyax's ``make_sharded_bh_step`` on two fake
  devices at ``tests/test_sharded_bh.py``'s gates (pos and vel rtol 1e-5
  atol 1e-3, mass rtol 1e-6, alive mask exact), and bit for bit against
  the port's single-device bh step.
- A shard count that does not divide the finest grid's cells is a
  ``ValueError`` in both packages.
"""

import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax.physics.step import PhysicsParams as JaxParams  # noqa: E402
from nbodyax.sharding.bh import make_sharded_bh_step  # noqa: E402
from nbodyax.sharding.mesh import (make_mesh, pad_to_shards,  # noqa: E402
                                   shard_state)
from nbodyax.state import make_state  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = 4
STEP_RANKS = 2      # the step's spawn: two processes keep it short

# (mode, near, far, order, dim)
CASES = [(m, near, "fmm", 2, 2) for m in ("reference", "momentum", "elastic")
         for near in ("rows", "slots")] + [
    ("reference", "slots", "direct", 1, 2), ("momentum", "slots", "fmm", 2, 3)]
# (name, mode, near, integrator, steps)
STEPS = [("reference-slots-euler", "reference", "slots", "euler", 2),
         ("momentum-rows-leapfrog", "momentum", "rows", "leapfrog", 2),
         ("elastic-slots-euler", "elastic", "slots", "euler", 1)]


@pytest.fixture
def one_thread():
    """A CPU bh pass is thousands of small ops: on one thread each, so the
    suite's other workers do not contend with their pools."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def crowded_arrays(n=1024, seed=7, dim=2):
    """tests/test_sharded_bh.py's state: 200 bodies in one finest cell, a
    dead body, and one giant whose radius outruns the ring."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-2000, 2000, (n, dim)).astype(np.float32)
    pos[:200] = rng.uniform(-40, 40, (200, dim))
    vel = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[3] = 0.0
    radius = rng.uniform(1, 15, n).astype(np.float32)
    radius[250], mass[250] = 600.0, 1e4
    return pos, vel, mass, radius


def knobs(mode, near, far, order, dim=2):
    return dict(eps=10.0, growth_rate=0.1, mode=mode, levels=6 - dim, ring=1,
                neighbor_k=64, order=order, far=far, near=near,
                n_giants=1024)


def touched(acc, n):
    idx = torch.arange(n, dtype=torch.int32)
    return ((acc.parent != idx) | acc.died | (acc.force.abs().sum(1) > 0)
            | (acc.gained_mass > 0) | (acc.gained_radius > 0)
            | (acc.dv.abs().sum(1) > 0))


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_cellrange_matches_nbodyax_and_partitions(case, one_thread):
    arrays = crowded_arrays(dim=case[-1])
    n = arrays[0].shape[0]
    kw = knobs(*case)
    t = [torch.from_numpy(x) for x in arrays]
    parts = [tbh.bh_cellrange_accumulators(*t, s, SHARDS, near_kernel="off",
                                           **kw) for s in range(SHARDS)]
    shard = CASES.index(case) % SHARDS
    want = jbh.bh_cellrange_accumulators(*arrays, shard, SHARDS,
                                         near_pallas="off", **kw)
    got = parts[shard]
    f = np.asarray(want.force)
    assert np.abs(got.force.numpy() - f).max() <= 2e-5 * np.abs(f).max()
    np.testing.assert_array_equal(got.died.numpy(), np.asarray(want.died))
    np.testing.assert_array_equal(got.parent.numpy(), np.asarray(want.parent))
    np.testing.assert_allclose(got.gained_mass.numpy(),
                               np.asarray(want.gained_mass), rtol=1e-5)
    dv = np.asarray(want.dv)
    assert np.abs(got.dv.numpy() - dv).max() <= 2e-5 * max(np.abs(dv).max(),
                                                           1e-30)
    assert touched(got, n).any()

    # disjoint and complete: the rebased sum is the single evaluation
    own = sum(touched(p, n).to(torch.int64) for p in parts)
    assert int(own.max()) == 1
    full = tbh.bh_accumulators(*t, near_kernel="off", **kw)
    idx = torch.arange(n, dtype=torch.int32)
    assert torch.equal(sum(p.force for p in parts), full.force)
    assert torch.equal(sum(p.gained_mass for p in parts), full.gained_mass)
    assert torch.equal(sum(p.gained_radius for p in parts),
                       full.gained_radius)
    assert torch.equal(sum(p.died.to(torch.int32) for p in parts) > 0,
                       full.died)
    assert torch.equal(sum(p.parent - idx for p in parts) + idx, full.parent)
    assert torch.equal(sum(p.dv for p in parts), full.dv)


def test_shards_must_divide_the_cells():
    arrays = crowded_arrays(n=256)
    kw = knobs("reference", "slots", "fmm", 2)
    kw["levels"] = 2                       # 16 cells: 3 shards do not divide
    with pytest.raises(ValueError, match="must divide"):
        tbh.bh_cellrange_accumulators(
            *(torch.from_numpy(x) for x in arrays), 0, 3, **kw)
    with pytest.raises(ValueError, match="must divide"):
        jbh.bh_cellrange_accumulators(*arrays, 0, 3, **kw)


CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, size, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=size)
from nbodyax_torch.backends import build_accum_fn
from nbodyax_torch.config import SimConfig
from nbodyax_torch.physics.step import PhysicsParams, make_step
from nbodyax_torch.sharding import (make_group, make_sharded_bh_step,
                                    pad_to_shards, shard_state)
from nbodyax_torch.state import make_state
g = make_group(size, "cpu")
inp = np.load(work + "/in.npz")
out = {}
for name, mode, near, integ, steps in json.load(open(work + "/spec.json")):
    cfg = SimConfig(shards=size, force_model="bh", collision_mode=mode,
                    integrator=integ, timestep=0.1, field_width=2000.0,
                    field_height=2000.0, softening=10.0, bh_levels=3,
                    bh_neighbor_k=128, bh_near=near)
    p = PhysicsParams.from_config(cfg)
    st = make_state(*(inp[k] for k in ("pos", "vel", "mass", "radius")),
                    device="cpu")
    step = make_sharded_bh_step(cfg, p, g)
    s = shard_state(pad_to_shards(st, size), g)
    for _ in range(steps):
        s = step(s)
    whole = [g.all_gather(t) for t in s[:4]]
    if rank == 0:     # the single-device step, on one rank only
        single = make_step(p, accum_fn=build_accum_fn("auto", p, "cpu", cfg))
        b = st
        for _ in range(steps):
            b = single(b)
        for k, t, u in zip(("pos", "vel", "mass", "radius"), whole, b[:4]):
            out[f"{name}/{k}"] = t.numpy()
            out[f"{name}/{k}/bitwise"] = np.asarray(torch.equal(t, u))
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


def step_arrays(n=256, seed=1):
    """tests/test_sharded_bh.py's random_state."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-2000, 2000, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[3] = 0.0
    radius = rng.uniform(1, 15, n).astype(np.float32)
    return pos, vel, mass, radius


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    work = tmp_path_factory.mktemp("bh")
    np.savez(work / "in.npz", **dict(zip(("pos", "vel", "mass", "radius"),
                                         step_arrays())))
    (work / "spec.json").write_text(json.dumps(STEPS))
    spawn(work, STEP_RANKS, CHILD)
    return dict(np.load(work / "out.npz"))


@pytest.mark.parametrize("case", STEPS, ids=[c[0] for c in STEPS])
def test_sharded_bh_step_matches_nbodyax(port_steps, case):
    name, mode, near, integ, steps = case
    p = JaxParams(dt=0.1, field_width=2000, field_height=2000, eps=10.0,
                  collision_mode=mode, integrator=integ)
    cfg = JaxConfig(shards=STEP_RANKS, force_model="bh", collision_mode=mode,
                    integrator=integ, bh_levels=3, bh_neighbor_k=128,
                    softening=10.0, bh_near=near, bh_pallas="off")
    mesh = make_mesh(STEP_RANKS)
    step = make_sharded_bh_step(cfg, p, mesh=mesh)
    s = shard_state(pad_to_shards(make_state(*step_arrays()), STEP_RANKS),
                    mesh)
    for _ in range(steps):
        s = step(s)
    for k in ("pos", "vel", "mass", "radius"):
        assert bool(port_steps[f"{name}/{k}/bitwise"]), k
    tol = dict(rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(port_steps[f"{name}/pos"], np.asarray(s.pos),
                               **tol)
    np.testing.assert_allclose(port_steps[f"{name}/vel"], np.asarray(s.vel),
                               **tol)
    np.testing.assert_allclose(port_steps[f"{name}/mass"],
                               np.asarray(s.mass), rtol=1e-6)
    np.testing.assert_array_equal(port_steps[f"{name}/mass"] > 0,
                                  np.asarray(s.mass) > 0)
