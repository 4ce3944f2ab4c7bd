"""nbodyax_torch's forceModel=bh in 3-D as a whole, against nbodyax on the
CPU.

- ``bh_accumulators`` at ``dim = 3`` (FMM far field and ``bhFar=direct``,
  both near engines, reference / momentum / elastic, ring 1 and 2, order 1
  and 2) on a state with a crowded cell, dead bodies and giants: force
  within 2e-5 of the largest |force|, ``died`` and ``parent`` exact, gained
  mass to rtol 1e-5, elastic dv within 2e-5 of its largest value;
- the giant pass on tests/test_giants.py:101's 3-D scene: the port's
  ``giant_collision_accumulators`` against nbodyax's, decisions exact, and
  bh with giants against the exact all-pairs oracle as that test holds it;
- a 10-step 3-D bh CLI run (N = 512) whose merges (alive mask exact) equal
  nbodyax's driver started from the same state; the port's 3-D uniform
  scene is its own draw, so nbodyax takes it over through ``make_state``;
- what still raises: ``shards > 1`` (ROADMAP A11) with 3-D bh.

nbodyax runs with ``bhPallas=off``: its own tests hold its Pallas kernels
to that engine. Its results are computed once per module.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import state as jstate  # noqa: E402
from nbodyax.config import SimConfig as JaxSimConfig  # noqa: E402
from nbodyax.config import parse_config_file as jax_parse  # noqa: E402
from nbodyax.driver import resolve_bh_config as jax_resolve  # noqa: E402
from nbodyax.driver import run_simulation as jax_run  # noqa: E402
from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch import cli as tcli  # noqa: E402
from nbodyax_torch.config import SimConfig, parse_config_file  # noqa: E402
from nbodyax_torch.driver import (resolve_bh_config,  # noqa: E402
                                  run_simulation)
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch.physics import bh_grid  # noqa: E402
from nbodyax_torch.physics.pairwise import pair_accumulators  # noqa: E402
from nbodyax_torch.scenes import init_scene  # noqa: E402
from test_giants import giant_scene  # noqa: E402

FIELD = 20000.0


def slice_state_3d(n=2048, seed=31):
    """Heavy bodies over a cube, a crowded cell past the slot budget, a few
    dead bodies and three giants whose radii outrun the window (the cell of
    the 8 x 8 x 8 grid is 5,000 wide)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-FIELD, FIELD, (n, 3)).astype(np.float32)
    pos[:150] = rng.uniform(-400, 400, (150, 3)).astype(np.float32)
    vel = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    mass = rng.uniform(1e10, 1e14, n).astype(np.float32)
    radius = rng.uniform(50, 400, n).astype(np.float32)
    mass[rng.rand(n) < 0.05] = 0.0
    radius[[300, 301, 302]] = [6000.0, 5000.0, 5000.0]
    mass[[300, 301]] = 1e16
    return pos, vel, mass, radius


# (mode, near, far, order, ring)
CASES = [("reference", "slots", "fmm", 2, 1),
         ("elastic", "slots", "fmm", 2, 1),
         ("reference", "slots", "direct", 1, 1),
         ("momentum", "rows", "direct", 2, 2)]


def bh_kwargs(case):
    mode, near, far, order, ring = case
    return dict(eps=20.0, growth_rate=0.1, mode=mode, levels=3, ring=ring,
                neighbor_k=0, order=order, far=far, near=near,
                n_giants=1024)


@pytest.fixture(scope="module")
def slice_results():
    """nbodyax's accumulators for every case, computed once."""
    arrays = slice_state_3d()
    return arrays, {case: jbh.bh_accumulators(*arrays, near_pallas="off",
                                              **bh_kwargs(case))
                    for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_bh_accumulators_3d_match_nbodyax(slice_results, case):
    arrays, results = slice_results
    want = results[case]
    mode = case[0]
    t = [torch.from_numpy(x) for x in arrays]
    got = tbh.bh_accumulators(*t, near_kernel="off", **bh_kwargs(case))
    f = np.asarray(want.force)
    assert f.shape == (2048, 3) and np.abs(f[:, 2]).max() > 0
    assert np.abs(got.force.numpy() - f).max() <= 2e-5 * np.abs(f).max()
    np.testing.assert_array_equal(got.died.numpy(), np.asarray(want.died))
    np.testing.assert_array_equal(got.parent.numpy(),
                                  np.asarray(want.parent))
    np.testing.assert_allclose(got.gained_mass.numpy(),
                               np.asarray(want.gained_mass), rtol=1e-5)
    if mode == "reference":
        assert np.asarray(want.died).any()     # merges happen in this state
    if mode == "momentum":
        assert (np.asarray(want.parent) != np.arange(2048)).any()
    if mode == "elastic":
        dv = np.asarray(want.dv)
        assert np.abs(dv[:, 2]).max() > 0
        assert np.abs(got.dv.numpy() - dv).max() <= 2e-5 * np.abs(dv).max()


def test_bh_accumulators_3d_wrappers_equal_plain_engine_on_cpu():
    """``near_kernel="auto"`` on a CPU state is the plain engine (the
    wrappers run their plain versions there), bit for bit, and
    ``"on"`` is an error without a card."""
    t = [torch.from_numpy(x) for x in slice_state_3d(1024, 3)]
    kw = dict(eps=20.0, mode="reference", levels=2, near="slots")
    a = tbh.bh_accumulators(*t, near_kernel="auto", **kw)
    b = tbh.bh_accumulators(*t, near_kernel="off", **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="bhPallas=on"):
        tbh.bh_accumulators(*t, near_kernel="on", **kw)


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_giant_collision_accumulators_3d(mode):
    """The giant pass on tests/test_giants.py:101's 3-D scene against
    nbodyax's: force 0, died / parent / best mass exact, gained mass and
    radius to rtol 1e-6 and dv within 1e-6 of its largest value (float32
    sum order: nbodyax sums over its padded giant list)."""
    pos, vel, mass, radius = giant_scene(dim=3, seed=5)
    je = jbh._extent(jnp.asarray(pos), jnp.asarray(mass) > 0)
    te = bh_grid._extent(torch.from_numpy(pos), torch.from_numpy(mass) > 0)
    kw = dict(levels=3, ring=1, growth_rate=0.1, mode=mode, n_giants=64)
    want = jbh.giant_collision_accumulators(pos, vel, mass, radius, ext=je,
                                            **kw)
    got = tbh.giant_collision_accumulators(
        *map(torch.from_numpy, (pos, vel, mass, radius)), ext=te, **kw)
    assert not got.force.any() and got.force.shape == (256, 3)
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
        assert bool(np.asarray(want.died)[3])    # the giant eats the victim


def test_bh_with_giants_3d_matches_the_exact_oracle():
    """tests/test_giants.py:101 on the port: 3-D bh with the giant pass
    takes the all-pairs oracle's deaths exactly and its gained mass to
    rtol 1e-6; without the pass the distant victim survives."""
    t = [torch.from_numpy(x) for x in giant_scene(dim=3, seed=5)]
    kw = dict(growth_rate=0.1, mode="reference")
    oracle = pair_accumulators(*t, **kw)
    bkw = dict(levels=3, ring=1, neighbor_k=256, **kw)
    bh = tbh.bh_accumulators(*t, n_giants=64, **bkw)
    assert torch.equal(bh.died, oracle.died) and bool(bh.died[3])
    np.testing.assert_allclose(bh.gained_mass.numpy(),
                               oracle.gained_mass.numpy(), rtol=1e-6)
    assert not bool(tbh.bh_accumulators(*t, n_giants=0, **bkw).died[3])


CLI_CONFIG = """particleCount=512
totalIterations=10
timestep=0.2f
radiusGrowthRate=0.1f
minRandBodyMass=1e4f
maxRandBodyMass=1e17f
minRadius=50.f
maxRadius=200.f
fieldWidth=3000
fieldHeight=3000
saveImages=false
forceModel=bh
dimensions=3
logEvery=5
"""


def test_bh_3d_cli_run_matches_nbodyax_driver(tmp_path, capsys):
    """``python -m nbodyax_torch.cli --device cpu --set forceModel=bh --set
    dimensions=3`` on a small scene: it prints the knobs it picked and logs
    bh_overflow 0 and momentum_z; its final state has the merges of
    nbodyax's driver started from the same state (alive mask exact, mass
    rtol 1e-6) and positions within 2e-4 of the field, the gate of
    test_torch_bh_slice.py's 2-D run."""
    path = tmp_path / "nbodyConfig.txt"
    path.write_text(CLI_CONFIG.replace("forceModel=bh\ndimensions=3\n", ""))
    log = tmp_path / "log.jsonl"
    assert tcli.main(["--config", str(path), "--device", "cpu",
                      "--set", "forceModel=bh", "--set", "dimensions=3",
                      "--set", f"logPath={log}"]) == 0
    out = capsys.readouterr().out
    assert "bh auto-selected: bhLevels=2 bhNear=rows bhNeighborK=" in out
    logs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in logs] == [5, 10]
    assert all(x["bh_overflow"] == 0 and "equivalent_pairs_per_sec" in x
               and "momentum_z" in x for x in logs)
    path.write_text(CLI_CONFIG)
    tcfg = parse_config_file(str(path))
    tcfg.log_path = str(tmp_path / "unused.jsonl")
    start = init_scene(tcfg, device="cpu")
    got = run_simulation(tcfg, device="cpu", quiet=True).state
    jcfg = jax_parse(str(path))
    jcfg.log_path = str(tmp_path / "jax.jsonl")
    want = jax_run(jcfg, quiet=True, state=jstate.make_state(
        *(x.numpy() for x in start[:4]))).state
    alive = np.asarray(want.mass) > 0
    assert alive.sum() < 512                    # merges happened
    assert got.pos.shape == (512, 3)
    np.testing.assert_array_equal(got.mass.numpy() > 0, alive)
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    d = np.abs(got.pos.numpy()[alive] - np.asarray(want.pos)[alive]).max()
    assert d <= 2e-4 * 3000, d
    assert logs[-1]["alive"] == int(alive.sum())


def test_resolve_bh_config_3d_matches_nbodyax():
    """The driver's knob resolution on a 3-D state: nbodyax's levels,
    engine, K and completion cap (the octree's occupancy target of 32)."""
    cfg = SimConfig(particle_count=2048, dimensions=3, force_model="bh",
                    field_width=3000, field_height=3000, save_images=False)
    st = init_scene(cfg, device="cpu")
    got = resolve_bh_config(cfg, st)
    jcfg = JaxSimConfig(
        particle_count=2048, dimensions=3, force_model="bh",
        field_width=3000, field_height=3000, save_images=False)
    want = jax_resolve(jcfg, state=jstate.make_state(
        *(x.numpy() for x in st[:4])))
    for key in ("bh_levels", "bh_near", "bh_neighbor_k", "bh_comp_cap"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.bh_levels == 2 and resolve_bh_config(got, st) == got


def test_sharded_3d_bh_raises_and_names_its_item():
    """The cell-slice shard hooks of the 3-D near kernel and of the bh
    structure are ROADMAP item A11: ``shards > 1`` raises and says so."""
    cfg = SimConfig(particle_count=64, total_iterations=1, dimensions=3,
                    force_model="bh", shards=2, save_images=False)
    with pytest.raises(NotImplementedError, match="A11"):
        run_simulation(cfg, device="cpu", quiet=True)
