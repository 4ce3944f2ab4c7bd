"""nbodyax_torch's compaction against nbodyax's, on the CPU.

``compact_state`` picks nbodyax's bucket and keeps the same survivors in
the same order, bit for bit (tolerance: none). The port's driver with
``compactEvery`` against nbodyax's on a merging 512-body run (and a 3-D
run from nbodyax's state carried across): the same capacities at the same
steps and equal alive masks; mass to rtol 1e-6 and positions within
tests/test_compaction.py:41-58's gates (rtol 1e-6, atol 1e-3). With
``forceModel=bh`` a shrink re-resolves the knobs the user left auto, to
the knobs nbodyax's ``resolve_bh_config`` picks on the same state.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import driver as jdriver  # noqa: E402
from nbodyax import state as jstate  # noqa: E402
from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax_torch import driver  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.state import (MIN_CAPACITY, compact_state,  # noqa: E402
                                 from_numpy, make_state, shrink_due,
                                 to_numpy)

MERGING = dict(particle_count=512, total_iterations=30, field_width=2000,
               field_height=2000, save_images=False, log_every=5,
               compact_every=10)


@pytest.fixture
def one_thread():
    """Run torch on one thread: the bh step is thousands of small ops, and
    where the suite's workers share the cores each op's thread pool
    contends with theirs (tens of times slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sparse(capacity=1024, alive=100, seed=0, dim=2):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1000, 1000, (capacity, dim)).astype(np.float32)
    vel = rng.uniform(-1, 1, (capacity, dim)).astype(np.float32)
    mass = np.zeros(capacity, np.float32)
    live = rng.choice(capacity, alive, replace=False)
    mass[live] = rng.uniform(1, 10, alive).astype(np.float32)
    radius = rng.uniform(1, 3, capacity).astype(np.float32)
    return pos, vel, mass, radius


@pytest.mark.parametrize("capacity,alive,dim", [
    (1024, 100, 2), (1024, 100, 3), (4096, 1500, 2), (2048, 0, 2),
    (256, 250, 2), (1024, 800, 3)])
def test_compact_state_matches_nbodyax(capacity, alive, dim):
    a = sparse(capacity, alive, seed=capacity + alive, dim=dim)
    want = jstate.compact_state(jstate.make_state(*a, step=9,
                                                  sim_time=1.5))
    st = make_state(*a, step=9, sim_time=1.5, device="cpu")
    got = compact_state(st)
    assert got.capacity == want.capacity
    if want.capacity == capacity:
        assert got is st        # no smaller bucket: the input itself
    for x, y in zip(to_numpy(got).values(), jstate.to_numpy(want).values()):
        np.testing.assert_array_equal(x, y)
    assert isinstance(got.step, int) and got.step == 9


@pytest.mark.parametrize("capacity", [256, 512, 1024, 16384, 1 << 20])
def test_shrink_due_means_compaction_halves(capacity):
    """The driver's merger trigger (nbodyax's ``alive * 2.5 <= capacity >
    256``) fires exactly when ``compact_state`` would at least halve a
    power-of-2 capacity, for every live count."""
    for alive in sorted({0, 1, *range(capacity // 4 - 3, capacity // 4 + 4),
                         capacity // 2, capacity}):
        alive = min(alive, capacity)
        assert shrink_due(alive, capacity) == (
            alive * 2.5 <= capacity and capacity > 256)
        mass = np.zeros(capacity, np.float32)
        mass[:alive] = 1.0
        st = make_state(np.zeros((capacity, 2)), np.zeros((capacity, 2)),
                        mass, np.ones(capacity), device="cpu")
        new = compact_state(st).capacity
        assert shrink_due(alive, capacity) == (new <= capacity // 2)
        assert new >= MIN_CAPACITY


def test_compacted_trajectory_matches():
    """Dead slots add exact zeros: a compacted state steps like the full
    one (tests/test_compaction.py's gates)."""
    st = make_state(*sparse(512, 64, seed=3), device="cpu")
    step = make_step(PhysicsParams(dt=0.1, field_width=1000,
                                   field_height=1000))
    a, b = compact_state(st), st
    for _ in range(5):
        a, b = step(a), step(b)
    live_a, live_b = a.mass > 0, b.mass > 0
    np.testing.assert_allclose(a.pos[live_a], b.pos[live_b], rtol=1e-6,
                               atol=1e-3)
    np.testing.assert_allclose(a.mass[live_a], b.mass[live_b], rtol=1e-6)


def compactions(out):
    """The compactions a run printed, each with the step of the last log
    line before it: [(step, old capacity, new capacity)]."""
    events, step = [], 0
    for line in out.splitlines():
        if line.startswith("{"):
            step = json.loads(line)["step"]
        elif m := re.match(r"Compacted (\d+) -> (\d+) slots", line):
            events.append((step, int(m.group(1)), int(m.group(2))))
    return events


def assert_matches_nbodyax(got, want):
    """Alive masks equal, mass and positions within the gates."""
    g, w = to_numpy(got), jstate.to_numpy(want)
    assert g["pos"].shape == w["pos"].shape
    np.testing.assert_array_equal(g["mass"] > 0, w["mass"] > 0)
    live = w["mass"] > 0
    np.testing.assert_allclose(g["mass"][live], w["mass"][live], rtol=1e-6)
    np.testing.assert_allclose(g["pos"][live], w["pos"][live], rtol=1e-6,
                               atol=1e-3)


def test_driver_compaction_matches_nbodyax(tmp_path, capsys, one_thread):
    """A dense 512-body scene merges fast: both drivers shrink to the same
    buckets at the same steps (the early trigger included) and end on the
    same bodies."""
    got = driver.run_simulation(SimConfig(
        log_path=str(tmp_path / "t.jsonl"), **MERGING), device="cpu")
    t_out = capsys.readouterr().out
    want = jdriver.run_simulation(JaxConfig(
        backend="jnp", log_path=str(tmp_path / "j.jsonl"), **MERGING))
    j_out = capsys.readouterr().out
    assert compactions(t_out) == compactions(j_out)
    assert got.capacities and got.state.capacity < 512
    assert [c for _, c in got.capacities] == [
        new for _, _, new in compactions(j_out)]
    assert got.state.step == 30
    assert_matches_nbodyax(got.state, want.state)


def test_driver_compaction_3d_from_nbodyax_state(tmp_path, capsys,
                                                one_thread):
    """3-D: nbodyax's (jax.random) scene carried across; the same buckets,
    alive masks and gates."""
    kw = dict(MERGING, dimensions=3, field_width=1950, field_height=1950)
    j0 = jdriver.init_scene(JaxConfig(**kw))
    got = driver.run_simulation(SimConfig(
        log_path=str(tmp_path / "t.jsonl"), **kw), device="cpu",
        state=from_numpy(jstate.to_numpy(j0), "cpu"))
    t_out = capsys.readouterr().out
    want = jdriver.run_simulation(JaxConfig(
        backend="jnp", log_path=str(tmp_path / "j.jsonl"), **kw), state=j0)
    j_out = capsys.readouterr().out
    assert compactions(t_out) == compactions(j_out) and compactions(t_out)
    assert_matches_nbodyax(got.state, want.state)


def test_bh_shrink_re_resolves_auto_knobs_as_nbodyax(tmp_path, monkeypatch,
                                                     one_thread):
    """forceModel=bh with every knob auto: after a shrink the driver resets
    the auto knobs and re-resolves them on the compacted state, and the
    knobs it picks are nbodyax's ``resolve_bh_config``'s on that state;
    a pinned knob stays pinned."""
    seen = []
    real = driver.resolve_bh_config

    def spy(cfg, state, quiet=True):
        out = real(cfg, state, quiet=quiet)
        seen.append((cfg, to_numpy(state), out))
        return out

    monkeypatch.setattr(driver, "resolve_bh_config", spy)
    kw = dict(MERGING, force_model="bh", total_iterations=10,
              log_path=str(tmp_path / "b.jsonl"))
    res = driver.run_simulation(SimConfig(**kw), device="cpu", quiet=True)
    assert res.capacities and len(seen) == 1 + len(res.capacities)
    knobs = ("bh_levels", "bh_near", "bh_neighbor_k", "bh_comp_cap")
    for cfg, arrays, out in seen[1:]:
        # the re-resolve starts from the user's auto values
        assert [getattr(cfg, k) for k in knobs] == [0, "auto", 0, 0]
        jcfg = jdriver.resolve_bh_config(
            JaxConfig(**dataclasses.asdict(cfg)),
            capacity=arrays["mass"].shape[0],
            state=jstate.make_state(arrays["pos"], arrays["vel"],
                                    arrays["mass"], arrays["radius"]))
        assert ([getattr(out, k) for k in knobs]
                == [getattr(jcfg, k) for k in knobs])
    seen.clear()
    res = driver.run_simulation(SimConfig(**dict(kw, bh_levels=3)),
                                device="cpu", quiet=True)
    assert res.capacities
    assert all(out.bh_levels == 3 for _, _, out in seen)
    assert all(cfg.bh_levels == 3 for cfg, _, _ in seen)
