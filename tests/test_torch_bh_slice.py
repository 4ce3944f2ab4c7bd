"""nbodyax_torch's forceModel=bh as a whole, against nbodyax on the CPU.

- ``bh_accumulators`` (FMM far field, both near engines, reference /
  momentum / elastic, and ``bhFar=direct``) on a state with crowded cells,
  dead bodies and giants: force within 2e-5 of the largest |force|,
  ``died`` and ``parent`` exact, gained mass to rtol 1e-5;
- ``pick_levels``, ``overflow_count`` and ``bh_health`` equal to nbodyax's
  on a uniform and a clustered state, ``prefer_slots`` given explicitly;
- a 10-step bh CLI run (N = 1,024) whose merges (alive mask exact) equal
  nbodyax's driver.

nbodyax runs with ``bhPallas=off``: its own tests hold its Pallas kernels
to that engine. Its results are computed once per module.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.config import parse_config_file as jax_parse  # noqa: E402
from nbodyax.driver import run_simulation as jax_run  # noqa: E402
from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch import cli as tcli  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402

FIELD = 20000.0


def slice_state(n=2048, seed=31):
    """Heavy bodies over the field, a crowded cell past the slot budget, a
    few dead bodies and three giants whose radii outrun the window."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-FIELD, FIELD, (n, 2)).astype(np.float32)
    pos[:120] = rng.uniform(-300, 300, (120, 2)).astype(np.float32)
    vel = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    mass = rng.uniform(1e10, 1e14, n).astype(np.float32)
    radius = rng.uniform(5, 60, n).astype(np.float32)
    mass[rng.rand(n) < 0.05] = 0.0
    radius[[300, 301, 302]] = [4000.0, 3500.0, 3500.0]
    mass[[300, 301]] = 1e16
    return pos, vel, mass, radius


CASES = [("reference", "slots", "fmm", 2), ("momentum", "slots", "fmm", 2),
         ("elastic", "slots", "fmm", 2), ("reference", "rows", "fmm", 2),
         ("momentum", "rows", "direct", 2), ("reference", "slots", "direct",
                                             1)]


@pytest.fixture(scope="module")
def slice_results():
    """nbodyax's accumulators for every case, computed once."""
    arrays = slice_state()
    out = {}
    for mode, near, far, order in CASES:
        out[mode, near, far, order] = jbh.bh_accumulators(
            *arrays, eps=20.0, growth_rate=0.1, mode=mode, levels=4, ring=1,
            neighbor_k=0, order=order, far=far, near=near,
            near_pallas="off", n_giants=1024)
    return arrays, out


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_bh_accumulators_match_nbodyax(slice_results, case):
    arrays, results = slice_results
    want = results[case]
    mode, near, far, order = case
    t = [torch.from_numpy(x) for x in arrays]
    got = tbh.bh_accumulators(*t, eps=20.0, growth_rate=0.1, mode=mode,
                              levels=4, ring=1, neighbor_k=0, order=order,
                              far=far, near=near, near_kernel="off",
                              n_giants=1024)
    f = np.asarray(want.force)
    assert np.abs(got.force.numpy() - f).max() <= 2e-5 * np.abs(f).max()
    np.testing.assert_array_equal(got.died.numpy(), np.asarray(want.died))
    np.testing.assert_array_equal(got.parent.numpy(),
                                  np.asarray(want.parent))
    np.testing.assert_allclose(got.gained_mass.numpy(),
                               np.asarray(want.gained_mass), rtol=1e-5)
    if mode == "reference":
        assert np.asarray(want.died).any()     # merges happen in this state
    if mode == "elastic":
        dv = np.asarray(want.dv)
        assert np.abs(got.dv.numpy() - dv).max() <= 2e-5 * np.abs(dv).max()


def test_bh_pallas_on_needs_a_card():
    """bhPallas=on asks for the CUDA kernels: on a CPU state it is an
    error, never a quiet switch to their plain versions."""
    t = [torch.from_numpy(x) for x in slice_state()]
    with pytest.raises(ValueError, match="bhPallas=on"):
        tbh.bh_accumulators(*t, levels=4, near="slots", near_kernel="on")


def probe_states():
    rng = np.random.RandomState(11)
    n = 8192
    uni = rng.uniform(-2000, 2000, (n, 2)).astype(np.float32)
    clu = uni.copy()
    clu[: n // 4] = rng.normal(0.0, 3.0, (n // 4, 2)).astype(np.float32)
    mass = rng.uniform(1, 10, n).astype(np.float32)
    mass[::97] = 0.0
    radius = rng.uniform(0.5, 40, n).astype(np.float32)
    return {"uniform": uni, "clustered": clu}, mass, radius


@pytest.mark.parametrize("scene", ["uniform", "clustered"])
def test_pick_levels_and_health_match_nbodyax(scene):
    states, mass, radius = probe_states()
    pos = states[scene]
    tp, tm, tr = map(torch.from_numpy, (pos, mass, radius))
    for prefer in (False, True):
        want = jbh.pick_levels(jnp.asarray(pos), jnp.asarray(mass),
                               prefer_slots=prefer)
        got = tbh.pick_levels(tp, tm, prefer_slots=prefer)
        assert got == tuple(int(x) if not isinstance(x, str) else x
                            for x in want)
    lv, near, k, comp = got
    for lv_, near_, k_ in ((lv, near, k), (lv, "rows", 32), (3, "slots", 8)):
        kw = dict(levels=lv_, neighbor_k=k_, near=near_)
        assert int(tbh.overflow_count(tp, tm, **kw)) == int(
            jbh.overflow_count(jnp.asarray(pos), jnp.asarray(mass), **kw))
        h_j = np.asarray(jbh.bh_health(jnp.asarray(pos), jnp.asarray(mass),
                                       jnp.asarray(radius), n_giants=16,
                                       comp_cap=comp, **kw))
        h_t = tbh.bh_health(tp, tm, tr, n_giants=16, comp_cap=comp,
                            **kw).numpy()
        np.testing.assert_array_equal(h_t, h_j)


CLI_CONFIG = """particleCount=1024
totalIterations=10
timestep=0.2f
radiusGrowthRate=0.1f
minRandBodyMass=1e4f
maxRandBodyMass=1e17f
minRadius=50.f
maxRadius=200.f
fieldWidth=20000
fieldHeight=20000
saveImages=false
forceModel=bh
logEvery=5
"""


def test_bh_cli_run_matches_nbodyax_driver(tmp_path, capsys):
    """The port's CLI on a 10-step bh config prints the knobs it picked and
    logs bh_overflow 0; its final state has nbodyax's merges (alive mask
    exact, mass rtol 1e-6) and positions within 2e-4 of the field."""
    path = tmp_path / "nbodyConfig.txt"
    path.write_text(CLI_CONFIG)
    log = tmp_path / "log.jsonl"
    assert tcli.main(["--config", str(path), "--device", "cpu",
                      "--set", f"logPath={log}"]) == 0
    out = capsys.readouterr().out
    assert "bh auto-selected: bhLevels=3 bhNear=rows bhNeighborK=" in out
    logs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in logs] == [5, 10]
    assert all(x["bh_overflow"] == 0 and "equivalent_pairs_per_sec" in x
               for x in logs)
    jcfg = jax_parse(str(path))
    jcfg.log_path = str(tmp_path / "jax.jsonl")
    want = jax_run(jcfg, quiet=True).state
    from nbodyax_torch.config import parse_config_file
    from nbodyax_torch.driver import run_simulation
    tcfg = parse_config_file(str(path))
    tcfg.log_path = str(tmp_path / "unused.jsonl")
    got = run_simulation(tcfg, device="cpu", quiet=True).state
    alive = np.asarray(want.mass) > 0
    assert alive.sum() < 1024                   # merges happened
    np.testing.assert_array_equal(got.mass.numpy() > 0, alive)
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    d = np.abs(got.pos.numpy()[alive] - np.asarray(want.pos)[alive]).max()
    assert d <= 2e-4 * 20000, d
    assert logs[-1]["alive"] == int(alive.sum())
