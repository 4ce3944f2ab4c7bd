"""Compaction, checkpoints, resume and autoResume through the exact path's
CUDA graphs, on a card.

Each compaction replaces the graph runner: the frame writer is drained,
the old graphs and buffers are dropped and new graphs are captured at the
new capacity. Graph windows across compactions must equal the eager
runner bit for bit (state, logs, frames, capacities), with one kernel
launch a step counted by replays, and each old runner's graphs must be
destroyed at its close and their memory handed back to the card. A run
resumed from a checkpoint, and an autoResume run whose fault strikes
between two replays, must end on the straight run's state bit for bit; so
must a resumed ``forceModel=bh`` run, through graph windows as well. A failed
capture is not retried.

These tests need a CUDA card and skip without one. The file imports
neither JAX nor nbodyax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graphs_resume.py
"""

import dataclasses
import json
import os
import weakref

import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch import driver  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics.kernels import tile_accumulators_raw  # noqa: E402

pytestmark = pytest.mark.cuda
TIMINGS = ("wall_ms", "steps_per_sec", "pairs_per_sec",
           "equivalent_pairs_per_sec")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def config(tmp_path, name, **kw):
    """1,024 bodies that merge fast enough to shrink to 512 and 256 slots
    within 40 steps."""
    d = dict(particle_count=1024, total_iterations=40, field_width=8000,
             field_height=8000, log_every=5, compact_every=10,
             save_image_every=2, img_width=64, img_height=64,
             image_path=str(tmp_path / name / "frames"),
             log_path=str(tmp_path / name / "log.jsonl"),
             checkpoint_path=str(tmp_path / name / "ck"))
    d.update(kw)
    return SimConfig(**d)


def run(cfg, eager=False, **kw):
    tile_accumulators_raw.launches = 0
    res = driver.run_simulation(cfg, device="cuda", quiet=True,
                                _eager=eager, **kw)
    with open(cfg.log_path) as f:
        logs = [{k: v for k, v in json.loads(line).items()
                 if k not in TIMINGS} for line in f]
    frames = {}
    if cfg.save_images:
        for nm in os.listdir(cfg.image_path):
            with open(os.path.join(cfg.image_path, nm), "rb") as f:
                frames[nm] = f.read()
    return res, logs, frames, tile_accumulators_raw.launches


def assert_same_state(a, b):
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert torch.equal(a.sim_time, b.sim_time) and a.step == b.step


def test_graph_windows_across_compactions_equal_eager(cuda, tmp_path,
                                                      monkeypatch):
    """Each old runner's close destroys its graphs and hands their private
    memory pools back to the card: no segment of those pools is left."""
    closed = []
    real_close = driver._GraphWindows.close

    def close(self):
        graphs = [g[0] for g in self.graphs.values()]
        pools = {tuple(g.pool()) for g in graphs}
        refs = [weakref.ref(g) for g in graphs]
        del graphs
        real_close(self)
        kept = {tuple(seg["segment_pool_id"])
                for seg in torch.cuda.memory_snapshot()} & pools
        closed.append((len(refs), [r() for r in refs], kept))

    monkeypatch.setattr(driver._GraphWindows, "close", close)
    g, g_logs, g_frames, g_n = run(config(tmp_path, "g"))
    e, e_logs, e_frames, e_n = run(config(tmp_path, "e"), eager=True)
    assert [c for _, c in g.capacities] == [512, 256]
    assert g.capacities == e.capacities
    assert_same_state(g.state, e.state)
    assert g_logs == e_logs and g_frames == e_frames and len(g_frames) == 20
    assert g_n == e_n == 40            # one B1 launch a step, by replays
    assert len(closed) == 2
    for n_graphs, alive, kept in closed:
        assert n_graphs and alive == [None] * n_graphs and not kept


@pytest.mark.parametrize("dims", [2, 3])
def test_resume_on_the_graph_path_equals_straight_run(cuda, tmp_path, dims):
    """40 steps straight against 20 steps and a resume to 40 from the
    step-20 checkpoint, across a compaction: state, frames and the log
    lines after step 20 bitwise."""
    # a 3-D scene of the same N merges as fast in a field half as wide
    kw = dict(dimensions=dims, checkpoint_every=20,
              field_width=8000 // (dims - 1), field_height=8000 // (dims - 1))
    straight, s_logs, s_frames, _ = run(config(tmp_path, "s", **kw))
    first = config(tmp_path, "r", total_iterations=20, **kw)
    run(first)
    ck = os.path.join(first.checkpoint_path, "step_000000020.npz")
    res, logs, frames, _ = run(dataclasses.replace(
        first, total_iterations=40, resume_from=ck,
        log_path=str(tmp_path / "r2.jsonl")))
    assert straight.capacities and res.capacities
    assert_same_state(straight.state, res.state)
    assert logs == [r for r in s_logs if r["step"] > 20]
    assert frames == s_frames          # the same iteration numbers


def test_off_cadence_resume_realigns(cuda, tmp_path):
    """A checkpoint at step 23 (off every cadence, as a drift-mode save
    can be): the resumed run's first windows replay the one-step graph up
    to the next boundary, its frames keep their iteration numbers, and it
    ends on the straight run's state."""
    kw = dict(compact_every=0, checkpoint_every=10)
    straight, s_logs, s_frames, _ = run(config(tmp_path, "s", **kw))
    first = config(tmp_path, "o", total_iterations=23, **kw)
    mid, _, _, _ = run(first)
    ck = driver.save_checkpoint(str(tmp_path / "odd"), mid.state)
    res, logs, frames, _ = run(dataclasses.replace(
        first, total_iterations=40, resume_from=ck,
        log_path=str(tmp_path / "o2.jsonl")))
    assert_same_state(straight.state, res.state)
    assert logs == [r for r in s_logs if r["step"] > 23]
    assert frames == s_frames


def test_auto_resume_from_a_fault_between_replays(cuda, tmp_path,
                                                  monkeypatch):
    """A fault raised between two replays, past the first checkpoint: the
    retry rebuilds every graph from the reloaded state and ends on the
    unfaulted run's state, bit for bit."""
    ref, ref_logs, _, _ = run(config(tmp_path, "u", checkpoint_every=10))
    real = driver._GraphWindows._replay
    raised = []

    def flaky(self, k, frames):
        if self.buf.step == 25 and not raised:
            raised.append(self.buf.step)
            raise RuntimeError("injected fault between replays")
        return real(self, k, frames)

    monkeypatch.setattr(driver._GraphWindows, "_replay", flaky)
    res, logs, _, _ = run(config(tmp_path, "a", checkpoint_every=10,
                                 auto_resume=True))
    assert raised == [25]
    assert_same_state(ref.state, res.state)
    assert logs[-1] == ref_logs[-1]


def test_a_failed_capture_is_not_retried(cuda, tmp_path, monkeypatch):
    real = driver.make_step
    attempts = []

    def reading_step(p, accum_fn=None):
        inner = real(p, accum_fn=accum_fn)
        attempts.append(1)

        def step(s):
            float(s.mass.sum())
            return inner(s)
        return step

    monkeypatch.setattr(driver, "make_step", reading_step)
    with pytest.raises(driver.GraphCaptureError):
        driver.run_simulation(config(tmp_path, "x", save_images=False,
                                     checkpoint_every=10, auto_resume=True),
                              device="cuda", quiet=True)
    assert len(attempts) == 1


def test_bh_resume_equals_straight_run(cuda, tmp_path):
    """forceModel=bh with every knob auto (graph windows on the card):
    the resumed run adopts the checkpoint's knobs and ends on the straight
    run's state bit for bit, across a compaction."""
    kw = dict(force_model="bh", save_images=False, checkpoint_every=20)
    straight, s_logs, _, _ = run(config(tmp_path, "bs", **kw))
    first = config(tmp_path, "br", total_iterations=20, **kw)
    run(first)
    res, logs, _, _ = run(dataclasses.replace(
        first, total_iterations=40, log_path=str(tmp_path / "br2.jsonl"),
        resume_from=os.path.join(first.checkpoint_path,
                                 "step_000000020.npz")))
    assert straight.capacities
    assert_same_state(straight.state, res.state)
    assert logs == [r for r in s_logs if r["step"] > 20]
