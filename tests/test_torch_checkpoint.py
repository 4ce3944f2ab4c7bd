"""nbodyax_torch's checkpoints against nbodyax's, on the CPU.

The cases of tests/test_checkpoint.py on the port's
``nbodyax_torch.io.checkpoint`` and driver, plus the two packages reading
each other's files: the same npz format, so a snapshot written by either
loads in the other bit for bit (tolerance: none). A resume continues bit
for bit, through ``load_checkpoint`` and through the driver; retention and
milestones prune as nbodyax's do; ``meta_`` extras round-trip; and
``_adopt_ck_knobs`` adopts the same knobs as nbodyax's from the same file.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax.driver import _adopt_ck_knobs as jax_adopt  # noqa: E402
from nbodyax.io import checkpoint as jck  # noqa: E402
from nbodyax.state import make_state as jax_make_state  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.driver import _adopt_ck_knobs, run_simulation  # noqa: E402
from nbodyax_torch.io.checkpoint import (latest_checkpoint,  # noqa: E402
                                         load_checkpoint,
                                         load_checkpoint_extra,
                                         save_checkpoint)
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402

TIMINGS = ("wall_ms", "steps_per_sec", "pairs_per_sec")
KNOBS = {"bh_levels": 9, "bh_neighbor_k": 264, "bh_comp_cap": 683008,
         "bh_near_slots": 1}


@pytest.fixture
def one_thread():
    """Run torch on one thread: the bh step is thousands of small ops, and
    where the suite's workers share the cores each op's thread pool
    contends with theirs (tens of times slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arrays(n=16, seed=0, dim=2):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-100, 100, (n, dim)).astype(np.float32),
            rng.uniform(-1, 1, (n, dim)).astype(np.float32),
            rng.uniform(1, 10, n).astype(np.float32),
            rng.uniform(1, 3, n).astype(np.float32))


def small_state(n=16, seed=0, step=0, dim=2):
    return make_state(*arrays(n, seed, dim), step=step, sim_time=0.5 * step,
                      device="cpu")


def names(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".npz"))


def assert_states_equal(a, b):
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert a.step == b.step and torch.equal(a.sim_time, b.sim_time)


@pytest.mark.parametrize("dim", [2, 3])
def test_roundtrip_bit_exact(tmp_path, dim):
    st = small_state(step=7, dim=dim)
    path = save_checkpoint(str(tmp_path), st)
    assert os.path.basename(path) == "step_000000007.npz"
    back = load_checkpoint(path, device="cpu")
    assert_states_equal(st, back)
    assert isinstance(back.step, int)
    assert not any(p.endswith(".tmp.npz") for p in os.listdir(tmp_path))


@pytest.mark.parametrize("dim", [2, 3])
def test_nbodyax_reads_the_ports_files(tmp_path, dim):
    st = small_state(step=12, dim=dim)
    path = save_checkpoint(str(tmp_path), st, extra=KNOBS)
    back = jck.load_checkpoint(path)
    for x, y in zip(st[:4], back[:4]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(np.asarray(back.step)) == 12
    assert np.asarray(back.sim_time) == st.sim_time.numpy()
    assert jck.load_checkpoint_extra(path) == KNOBS
    assert jck.latest_checkpoint(str(tmp_path)) == path


@pytest.mark.parametrize("dim", [2, 3])
def test_the_port_reads_nbodyax_files(tmp_path, dim):
    a = arrays(seed=3, dim=dim)
    jst = jax_make_state(*a, step=40, sim_time=7.25)
    path = jck.save_checkpoint(str(tmp_path), jst, extra=KNOBS)
    back = load_checkpoint(path, device="cpu")
    for x, y in zip(a, back[:4]):
        np.testing.assert_array_equal(x, y.numpy())
    assert back.step == 40 and float(back.sim_time) == 7.25
    assert load_checkpoint_extra(path) == KNOBS
    assert latest_checkpoint(str(tmp_path)) == path


def test_resume_continues_identically(tmp_path):
    step = make_step(PhysicsParams(dt=0.1, field_width=1000,
                                   field_height=1000))
    st = small_state()
    for _ in range(5):
        st = step(st)
    path = save_checkpoint(str(tmp_path), st)
    direct = step(step(st))
    resumed = step(step(load_checkpoint(path, device="cpu")))
    assert_states_equal(direct, resumed)


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path)) is None
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    save_checkpoint(str(tmp_path), small_state())
    p5 = save_checkpoint(str(tmp_path), small_state(step=5))
    assert latest_checkpoint(str(tmp_path)) == p5


@pytest.mark.parametrize("keep,every,count,stride,want", [
    (3, 0, 7, 10, (40, 50, 60)),         # the newest three
    (2, 40, 9, 10, (0, 40, 70, 80)),     # milestones survive the prune
    (0, 0, 5, 1, (0, 1, 2, 3, 4)),       # keep_last 0 keeps everything
])
def test_retention_matches_nbodyax(tmp_path, keep, every, count, stride,
                                   want):
    """The port's and nbodyax's retention keep the same snapshots."""
    for k in range(count):
        save_checkpoint(str(tmp_path / "t"), small_state(step=stride * k),
                        keep_last=keep, milestone_every=every)
        jck.save_checkpoint(str(tmp_path / "j"), jax_make_state(
            *arrays(), step=stride * k), keep_last=keep,
            milestone_every=every)
    assert names(tmp_path / "t") == [f"step_{s:09d}.npz" for s in want]
    assert names(tmp_path / "t") == names(tmp_path / "j")


def test_driver_prunes_checkpoints(tmp_path):
    """checkpointKeep rides the driver: cadence 2 over 10 steps writes 5
    snapshots and keeps the newest 2, as nbodyax's driver does."""
    kw = dict(particle_count=16, total_iterations=10, save_images=False,
              log_every=0, checkpoint_every=2, checkpoint_keep=2)
    run_simulation(SimConfig(checkpoint_path=str(tmp_path / "ck"), **kw),
                   device="cpu", quiet=True)
    assert names(tmp_path / "ck") == [f"step_{s:09d}.npz" for s in (8, 10)]


def test_checkpoint_extra_roundtrip(tmp_path):
    p = save_checkpoint(str(tmp_path), small_state(step=7), extra=KNOBS)
    assert load_checkpoint_extra(p) == KNOBS
    np.testing.assert_array_equal(load_checkpoint(p, device="cpu").mass,
                                  small_state().mass)
    p2 = save_checkpoint(str(tmp_path), small_state(step=8))
    assert load_checkpoint_extra(p2) == {}


def test_adopt_ck_knobs_matches_nbodyax(tmp_path):
    """From the same file, the port adopts the knobs nbodyax adopts: every
    user-auto knob, no pinned one; exact configs pass through."""
    p = save_checkpoint(str(tmp_path), small_state(step=5), extra=KNOBS)
    fields = ("bh_levels", "bh_neighbor_k", "bh_comp_cap", "bh_near")
    for pins in ({}, dict(bh_levels=6, bh_neighbor_k=32, bh_near="rows")):
        kw = dict(particle_count=64, force_model="bh", save_images=False,
                  **pins)
        got = _adopt_ck_knobs(SimConfig(**kw), p)
        want = jax_adopt(JaxConfig(**kw), p)
        assert ([getattr(got, f) for f in fields]
                == [getattr(want, f) for f in fields])
    assert (got.bh_levels, got.bh_neighbor_k, got.bh_comp_cap,
            got.bh_near) == (6, 32, 683008, "rows")
    exact = SimConfig(particle_count=64, save_images=False)
    assert _adopt_ck_knobs(exact, p) is exact


def test_driver_resume_equals_straight_run(tmp_path):
    """A run to step 20 equals a run to 10 resumed from its checkpoint to
    20, bit for bit, and its log lines after step 10 agree."""
    kw = dict(particle_count=64, total_iterations=20, field_width=5000,
              field_height=5000, save_images=False, log_every=5,
              checkpoint_every=10)
    straight = run_simulation(SimConfig(
        checkpoint_path=str(tmp_path / "a"),
        log_path=str(tmp_path / "a.jsonl"), **kw), device="cpu", quiet=True)
    first = SimConfig(checkpoint_path=str(tmp_path / "b"),
                      log_path=str(tmp_path / "b.jsonl"), **kw)
    first.total_iterations = 10
    run_simulation(first, device="cpu", quiet=True)
    resumed = run_simulation(dataclasses.replace(
        first, total_iterations=20,
        resume_from=str(tmp_path / "b" / "step_000000010.npz"),
        log_path=str(tmp_path / "c.jsonl")), device="cpu", quiet=True)
    assert_states_equal(straight.state, resumed.state)
    assert names(tmp_path / "b") == [f"step_{s:09d}.npz" for s in (10, 20)]

    def values(name):
        with open(tmp_path / name) as f:
            recs = [json.loads(line) for line in f]
        return [{k: v for k, v in r.items() if k not in TIMINGS}
                for r in recs if r["step"] > 10]
    assert values("a.jsonl") == values("c.jsonl") and values("c.jsonl")


def test_cli_resume_auto_and_nbodyax_resumes_the_ports_run(tmp_path,
                                                           capsys):
    """``--resume auto`` continues from the newest snapshot to the straight
    run's state bit for bit; nbodyax's CLI resumed from the port's
    snapshot ends on the same bodies (alive masks exact, mass to rtol
    1e-6, positions within 2e-4 of the field); no snapshot is an error."""
    from nbodyax import cli as jcli
    from nbodyax_torch import cli as tcli
    cfg = tmp_path / "c.txt"
    cfg.write_text("particleCount=64\nfieldWidth=5000\nfieldHeight=5000\n"
                   "saveImages=false\ncheckpointEvery=10\nlogEvery=10\n")

    def argv(ck, steps, *extra):
        return ["--config", str(cfg), "--steps", str(steps), "--quiet",
                "--set", f"checkpointPath={tmp_path / ck}",
                "--set", f"logPath={tmp_path / (ck + '.jsonl')}", *extra]

    assert tcli.main(argv("none", 20, "--device", "cpu",
                          "--resume", "auto")) == 1
    assert "No checkpoint found" in capsys.readouterr().err
    assert tcli.main(argv("a", 20, "--device", "cpu")) == 0
    assert tcli.main(argv("b", 10, "--device", "cpu")) == 0
    jax_ck = tmp_path / "j"
    os.makedirs(jax_ck)
    os.link(tmp_path / "b" / "step_000000010.npz",
            jax_ck / "step_000000010.npz")
    assert tcli.main(argv("b", 20, "--device", "cpu", "--resume",
                          "auto")) == 0
    straight = load_checkpoint(str(tmp_path / "a" / "step_000000020.npz"),
                               device="cpu")
    resumed = load_checkpoint(str(tmp_path / "b" / "step_000000020.npz"),
                              device="cpu")
    assert_states_equal(straight, resumed)
    assert jcli.main(argv("j", 20, "--resume", "auto",
                          "--set", "backend=jnp")) == 0
    want = jck.load_checkpoint(str(jax_ck / "step_000000020.npz"))
    alive = np.asarray(want.mass) > 0
    np.testing.assert_array_equal(resumed.mass.numpy() > 0, alive)
    np.testing.assert_allclose(resumed.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    np.testing.assert_allclose(resumed.pos.numpy()[alive],
                               np.asarray(want.pos)[alive], rtol=0,
                               atol=2e-4 * 5000)


def test_drift_mode_checkpoints_and_their_resume(tmp_path, one_thread):
    """forceModel=bh while the run merges fast (the probe's drift mode):
    checkpoints come every max(8, checkpointEvery // 4) steps between the
    cadence ones, and a resume from such an off-cadence snapshot re-aligns
    and ends on the straight run's state bit for bit."""
    kw = dict(particle_count=512, total_iterations=32, field_width=4000,
              field_height=4000, save_images=False, log_every=8,
              force_model="bh", checkpoint_every=32, checkpoint_keep=0)
    straight = run_simulation(SimConfig(
        checkpoint_path=str(tmp_path / "a"),
        log_path=str(tmp_path / "a.jsonl"), **kw), device="cpu", quiet=True)
    steps = [int(n[5:14]) for n in names(tmp_path / "a")]
    off = [s for s in steps if s % 32]
    assert len(off) >= 2 and steps[-1] == 32
    assert all(b - a >= max(8, 32 // 4)
               for a, b in zip([0] + steps, steps) if b in off)
    resumed = run_simulation(SimConfig(
        checkpoint_path=str(tmp_path / "b"),
        log_path=str(tmp_path / "b.jsonl"),
        resume_from=str(tmp_path / "a" / f"step_{off[-1]:09d}.npz"), **kw),
        device="cpu", quiet=True)
    assert_states_equal(straight.state, resumed.state)
