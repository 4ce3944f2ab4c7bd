"""The exact path's CUDA-graph windows against the eager runner, on a card.

On a CUDA device ``run_simulation`` runs each window of the exact path as a
replay of a captured CUDA graph; ``_eager=True`` runs the same windows
step by step. The kernels combine in a fixed order and use no atomics, so
the two must agree bit for bit: final state, every log value but the
timings, and every frame, in every collision mode, integrator and
dimension, with adaptive dt on and off, through the stride's graph (frames
rendered inside it) and the one-step graph (other window sizes). The
launch counts count replays. A momentum commit repeats bit for bit. A
step that reads the card from the host cannot be captured, and the run
raises.

These tests need a CUDA card and skip without one. The file imports
neither JAX nor nbodyax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graphs.py
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch import driver  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics.kernels import tile_accumulators_raw  # noqa: E402

pytestmark = pytest.mark.cuda
TIMINGS = ("wall_ms", "steps_per_sec", "pairs_per_sec")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def config(tmp_path, name, **kw):
    d = dict(particle_count=1024, total_iterations=12, field_width=12000,
             field_height=12000, log_every=4, save_image_every=2,
             img_width=128, img_height=128,
             image_path=str(tmp_path / name / "frames"),
             log_path=str(tmp_path / name / "log.jsonl"))
    d.update(kw)
    return SimConfig(**d)


def run(tmp_path, name, eager, **kw):
    cfg = config(tmp_path, name, **kw)
    tile_accumulators_raw.launches = 0
    res = driver.run_simulation(cfg, device="cuda", quiet=True,
                                _eager=eager)
    launches = tile_accumulators_raw.launches
    with open(cfg.log_path) as f:
        logs = [{k: v for k, v in json.loads(line).items()
                 if k not in TIMINGS} for line in f]
    frames = {}
    if cfg.save_images:
        for nm in os.listdir(cfg.image_path):
            with open(os.path.join(cfg.image_path, nm), "rb") as f:
                frames[nm] = f.read()
    return res, logs, frames, launches


def assert_graph_equals_eager(tmp_path, passes=1, **kw):
    g, g_logs, g_frames, g_n = run(tmp_path, "graph", False, **kw)
    e, e_logs, e_frames, e_n = run(tmp_path, "eager", True, **kw)
    for a, b in zip(g.state[:4], e.state[:4]):
        assert torch.equal(a, b)
    assert torch.equal(g.state.sim_time, e.state.sim_time)
    assert g.state.step == e.state.step
    assert g_logs == e_logs and g_logs
    assert g_frames == e_frames
    assert g.windows == e.windows and g.frames_written == e.frames_written
    steps = kw.get("total_iterations", 12)
    assert g_n == e_n == passes * steps
    return g, g_logs


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("integrator,passes", [("euler", 1), ("leapfrog", 2),
                                               ("yoshida4", 4)])
@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic",
                                  "none"])
@pytest.mark.parametrize("dims", [2, 3])
def test_graph_windows_equal_eager(cuda, tmp_path, dims, mode, integrator,
                                   passes, adaptive):
    _, logs = assert_graph_equals_eager(
        tmp_path, passes, dimensions=dims, collision_mode=mode,
        integrator=integrator, adaptive_dt=adaptive)
    assert ("dt_mean" in logs[-1]) == adaptive


def test_other_window_sizes_replay_the_one_step_graph(cuda, tmp_path):
    """logEvery 5 with frames every 2: the stride is 1, so the 1-step
    windows replay the stride's graph (with a frame, or without one from
    an odd step) and the 4-step windows the one-step graph four times,
    rendering between replays; a 23-step run at logEvery 10 ends on a
    3-step window."""
    g, _ = assert_graph_equals_eager(tmp_path, log_every=5,
                                     total_iterations=15)
    assert g.windows == 6
    g, _ = assert_graph_equals_eager(tmp_path, log_every=10,
                                     save_images=False, total_iterations=23)
    assert g.windows == 3


def test_energy_and_misaligned_start(cuda, tmp_path):
    """energyEvery on the graph path, and a start at step 3 by state=."""
    assert_graph_equals_eager(tmp_path, energy_every=8, log_every=4,
                              total_iterations=16, softening=20.0)
    from nbodyax_torch.scenes import init_scene
    cfg = config(tmp_path, "s")
    s0 = init_scene(cfg, device="cuda")._replace(step=3)
    a = driver.run_simulation(cfg, device="cuda", quiet=True, state=s0)
    b = driver.run_simulation(config(tmp_path, "t"), device="cuda",
                              quiet=True, state=s0, _eager=True)
    assert a.state.step == b.state.step == 12
    for x, y in zip(a.state[:4], b.state[:4]):
        assert torch.equal(x, y)


def test_momentum_commit_repeats_bitwise(cuda):
    """Merge trees of up to hundreds of bodies: the momentum commit sums
    each tree in a fixed order, so repeated calls agree bit for bit."""
    from nbodyax_torch.physics.collisions import resolve_collisions
    from nbodyax_torch.physics.kernels import pair_accumulators_kernel
    rng = np.random.RandomState(8)
    n = 16384
    pos = rng.uniform(-3000, 3000, (n, 2)).astype(np.float32)
    pos[: n // 2] = rng.normal(0, 300, (n // 2, 2)).astype(np.float32)
    t = [torch.from_numpy(x).to(cuda) for x in (
        pos, rng.uniform(-5, 5, (n, 2)).astype(np.float32),
        rng.uniform(1, 100, n).astype(np.float32),
        rng.uniform(5, 40, n).astype(np.float32))]
    acc = pair_accumulators_kernel(*t, mode="momentum")
    outs = [resolve_collisions(*t, acc, mode="momentum") for _ in range(5)]
    merged = int((outs[0][2] > 0).sum())
    assert merged < n // 2
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)


def test_a_capture_that_fails_raises(cuda, tmp_path, monkeypatch):
    """No fallback: a step that reads the card from the host cannot be
    captured, and the run raises instead of looping eagerly."""
    real = driver.make_step

    def reading_step(p, accum_fn=None):
        inner = real(p, accum_fn=accum_fn)

        def step(s):
            float(s.mass.sum())
            return inner(s)
        return step

    monkeypatch.setattr(driver, "make_step", reading_step)
    with pytest.raises(RuntimeError):
        driver.run_simulation(config(tmp_path, "x", save_images=False),
                              device="cuda", quiet=True)
