"""The 3-D bh cell ``bh3d-million``: its scene draw, its configuration
merged into the cell, the M2L reader, a run of the cell at a tiny size on
the CPU that its 3-D reference judges, and the program's handling of the
cell's scene name."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from perfbench.scene import draw_scene
from perfbench.spec import config_text, load_cell, load_metric

BASE = {"minRandBodyMass": 1e4, "maxRandBodyMass": 1e17, "minRadius": 50,
        "maxRadius": 200, "fieldWidth": 100000, "fieldHeight": 50000,
        "dimensions": 3, "scene": "uniform3d", "particleCount": 4096}
MS = 1_000_000  # ns


@pytest.fixture
def one_thread():
    """Torch on one thread: a CPU bh step is thousands of small ops, whose
    thread pools contend with other processes' on a shared host."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("depth", [0, 20000])
def test_uniform3d_is_a_box_of_bodies_at_rest(depth):
    pos, vel, mass, radius = draw_scene(11, dict(BASE, fieldDepth=depth))
    assert pos.shape == vel.shape == (4096, 3) and mass.shape == (4096,)
    assert all(a.dtype == np.float32 for a in (pos, vel, mass, radius))
    half = np.abs(pos).max(0)
    z = depth or 100000                  # fieldDepth 0: z over fieldWidth
    assert (half <= [100000, 50000, z]).all()
    assert (half > 0.95 * np.array([100000, 50000, z])).all()
    assert (vel == 0).all()
    assert mass.min() >= 1e4 and mass.max() <= 1e17
    assert radius.min() >= 50 and radius.max() <= 200


def test_uniform3d_is_the_seeds_and_refuses_2d():
    big = 2 ** 31 + 4321
    p = dict(BASE, particleCount=256)
    a, b, c = draw_scene(big, p), draw_scene(big, p), draw_scene(big + 1, p)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    with pytest.raises(ValueError, match="3-D"):
        draw_scene(1, dict(p, dimensions=2))


def test_the_cell_merges_its_3d_configuration():
    c = load_cell("bh3d-million")
    assert c.chips == 1 and c.horizon == 200 and c.trace_steps == 50
    assert c.reference == "reference_euler_3d"
    assert c.params["dimensions"] == 3 and c.params["forceModel"] == "bh"
    assert c.params["scene"] == "uniform3d"
    assert c.params["particleCount"] == 1 << 20
    assert c.check["steps"] == [0, 50, 100, 199]
    from nbodyax_torch.config import parse_config_text
    cfg = parse_config_text(config_text(c.params))
    assert cfg.dimensions == 3 and cfg.field_depth == 0
    assert cfg.bh_levels == 0 and cfg.bh_adapt           # knobs auto
    assert (cfg.compact_every, cfg.checkpoint_every, cfg.log_every) == (
        50, 100, 10)
    names = {m["name"] for m in c.per_layer}
    assert {"b3_ms_per_step.3d", "m2l_ms_per_step"} <= names
    assert {m["name"] for m in c.end_to_end} == {
        "steps_per_s.host_heavy", "setup_s", "peak_device_gib"}


def _record(device, steps=2):
    return {"shards": 1, "params": {"dimensions": 3},
            "trace": {"steps": steps, "device": device}}


def test_m2l_reader_sums_cudnn_convolutions_a_step():
    read = load_metric("m2l_ms_per_step").read
    # the kernel an H100 ran (the trace's short name, cut at 120
    # characters) and a layout transform cuDNN may put around one
    conv = [("sm80_xmma_fprop_implicit_gemm_indexed_f32f32_f32f32_f32_nchwkcr"
             "s_nchw_tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_align", 0,
             2 * MS),
            ("nchwToNhwcKernel", 3 * MS, 4 * MS)]
    other = [("near_kernel", 5 * MS, 6 * MS), ("near_kernel", 7 * MS, 8 * MS),
             ("vectorized_elementwise_kernel", 9 * MS, 19 * MS),
             ("reduce_kernel", 20 * MS, 21 * MS),
             ("CatArrayBatchedCopy_alignedK_contig", 22 * MS, 23 * MS),
             ("DeviceRadixSortOnesweepKernel", 24 * MS, 25 * MS),
             ("index_elementwise_kernel", 26 * MS, 27 * MS)]
    # two steps (two B3 launches), 3 ms of convolution
    assert read(_record(conv + other)) == pytest.approx(1.5)
    assert read(_record(other)) is None
    assert read({"trace": None}) is None


def test_b3_3d_is_read_by_the_b3_reader():
    read = load_metric("b3_ms_per_step.3d").read
    dev = [("near_kernel", 0, 2 * MS), ("near_kernel", 3 * MS, 5 * MS),
           ("vectorized_elementwise_kernel", 6 * MS, 9 * MS)]
    assert read(_record(dev)) == pytest.approx(2.0)
    assert read(_record(dev[2:])) is None


def test_the_cell_runs_tiny_on_the_cpu_and_its_reference_judges(one_thread):
    """The cell at 512 bodies in a 2e4 cube, 6-step jobs, checked at every
    step it lists (cut to the horizon): correct, every number inside its
    limit; the same run with the 2-D reference in its place refuses."""
    c = load_cell("bh3d-million")
    p = dict(c.params, particleCount=512, fieldWidth=20000,
             fieldHeight=20000)
    c = dataclasses.replace(c, params=p, horizon=6, warm_steps=1,
                            trace_steps=2,
                            check=dict(c.check, steps=[0, 2, 5]))
    from perfbench.worker import run_cell
    out = run_cell(c, 2 ** 31 + 9, 0.05, False, t_start=time.time(),
                   device="cpu")["result"]
    assert out["correct"] is True, out["compared"]
    assert out["metrics"]["steps_per_s.host_heavy"]["value"] > 0
    with pytest.raises(ValueError, match="dimensions"):
        run_cell(dataclasses.replace(c, reference="reference_euler_2d"),
                 2 ** 31 + 9, 0.05, False, t_start=time.time(), device="cpu")


def test_the_program_ignores_the_scene_name_on_every_path(tmp_path,
                                                         monkeypatch,
                                                         one_thread):
    """The cell's ``scene`` key reaches the program as ``scene=uniform3d``,
    a scene it does not have (``init_scene`` refuses it). Given a state it
    never draws one: not at the start, not when autoResume reloads a
    checkpoint after a fault, not after a compaction. A 3-D bh job of the
    cell's settings from a state with dead slots compacts at its first
    cadence, fails once after it, resumes, and ends bit for bit where the
    straight job ends."""
    import torch

    from nbodyax_torch import driver
    from nbodyax_torch.config import parse_config_text
    from nbodyax_torch.scenes import init_scene
    from nbodyax_torch.state import make_state
    c = load_cell("bh3d-million")
    p = dict(c.params, particleCount=1024, fieldWidth=5000,
             fieldHeight=5000, totalIterations=12, compactEvery=4,
             checkpointEvery=4, logEvery=4)
    pos, vel, mass, radius = draw_scene(2 ** 31 + 5, p)
    mass[300:] = 0                        # a compaction halves it at 4
    s0 = make_state(pos, vel, mass, radius, device="cpu")

    def job(tag):
        cfg = parse_config_text(config_text(dict(
            p, logPath=str(tmp_path / f"{tag}.jsonl"),
            checkpointPath=str(tmp_path / f"ck-{tag}"))))
        assert cfg.scene == "uniform3d"
        return cfg
    with pytest.raises(ValueError, match="unknown scene"):
        init_scene(job("x"), device="cpu")
    monkeypatch.setattr(driver, "init_scene", None)   # never called
    straight = driver.run_simulation(job("a"), device="cpu", quiet=True,
                                     state=s0)
    advance, failed = driver._EagerWindows.advance, []

    def flaky(self, k, frames):
        if self.state.step >= 6 and not failed:
            failed.append(self.state.step)
            raise RuntimeError("injected fault")
        return advance(self, k, frames)
    monkeypatch.setattr(driver._EagerWindows, "advance", flaky)
    resumed = driver.run_simulation(job("b"), device="cpu", quiet=True,
                                    state=s0)
    assert failed and straight.capacities == [(4, 512)]
    assert resumed.state.step == straight.state.step == 12
    for a, b in zip(resumed.state[:4], straight.state[:4]):
        assert torch.equal(a, b)
