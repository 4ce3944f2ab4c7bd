"""``shards > 1`` through the port's CLI under ``torch.distributed.run``
(gloo ranks on the CPU), against nbodyax's CLI at the same shard count on
the fake CPU devices of ``tests/conftest.py``.

- The exact ring at P = 2 and 4 (64 bodies, 20 steps, a frame and a
  checkpoint every 10): frames byte for byte equal to nbodyax's, the same
  log lines (alive exact, the totals within f32 rounding, as
  ``assert_logs_match`` says), a final checkpoint that
  nbodyax's ``load_checkpoint`` reads and whose state matches nbodyax's at
  ``tests/test_ring.py``'s step gates, ``Time taken`` printed once and
  files written by rank 0 only.
- Compaction at P = 3, where neither capacity is a multiple of the shard
  count (512 pads to 513, the 256 bucket to 258): the same "Compacted"
  line and log lines as nbodyax's.
- bh under bhAdapt with checkpoints (the galaxy example cut to 1,024
  bodies and the rows engine, as ``test_torch_driver.py``'s probe test):
  four ranks take the same probes, adapts and checkpoints as one process
  and log the same lines, so every rank took the same collectives in the
  same order; the sharded bh step is bit for bit the single-device one.
- ``--resume`` from the P = 2 run's step-10 checkpoint in a new launch ends
  on the straight run's step-20 checkpoint, bit for bit.
- A shard count other than the world size is a ``ValueError``, in one
  process and under torchrun; so is autoResume under shards outside a
  launch that allows maxRetries restarts (the relaunch itself:
  ``tests/test_torch_sharding_resume.py``).

Each launch has a timeout of its own.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import cli as jcli  # noqa: E402
from nbodyax.io.checkpoint import load_checkpoint as jax_load  # noqa: E402
from nbodyax_torch.config import SimConfig, parse_config_file  # noqa: E402
from nbodyax_torch.driver import run_simulation  # noqa: E402
from nbodyax_torch.scenes import init_scene  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = """particleCount=64
totalIterations=20
save_Image_Every_Xth_Iteration=10
timestep=0.2f
radiusGrowthRate=0.1f
minRandBodyMass=1e4f
maxRandBodyMass=1e17f
minRadius=50.f
maxRadius=200.f
imgWidth=128
imgHeight=128
fieldWidth=5000
fieldHeight=5000
checkpointEvery=10
"""
TIMING = ("wall_ms", "steps_per_sec", "pairs_per_sec",
          "equivalent_pairs_per_sec")


def torchrun(work, nproc, args, timeout=60):
    """The port's CLI as ``nproc`` gloo ranks in ``work``; returns
    (exit code, output)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "nbodyax_torch.cli",
         "--device", "cpu", *args], cwd=work, env=env, capture_output=True,
        text=True, timeout=timeout)
    return r.returncode, r.stdout + r.stderr


def log_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def assert_logs_match(got, want, exact=False):
    """The same log steps and live counts; the other values equal
    (``exact``) or within f32 rounding of a differently ordered sum: mass
    and time to rtol 1e-6, kinetic energy to rtol 1e-5, momentum within
    1e-5 of sqrt(2 M KE), the bound of sum m |v|."""
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for a, b in zip(got, want):
        assert a["alive"] == b["alive"]
        p_scale = np.sqrt(2.0 * b["total_mass"] * b["kinetic_energy"])
        for k in b:
            if k in TIMING or k in ("step", "alive"):
                continue
            if exact:
                assert a[k] == b[k], k
            elif k.startswith("momentum"):
                assert abs(a[k] - b[k]) <= 1e-5 * p_scale, k
            elif isinstance(b[k], float):
                np.testing.assert_allclose(
                    a[k], b[k], rtol=1e-5 if k == "kinetic_energy" else 1e-6,
                    err_msg=k)


def paths(d):
    return ["--set", f"imagePath={d / 'img'}", "--set",
            f"logPath={d / 'm.jsonl'}", "--set",
            f"checkpointPath={d / 'ck'}"]


@pytest.fixture(scope="module")
def exact_runs(tmp_path_factory):
    """The port's and nbodyax's CLI at P = 2 and 4, one launch each."""
    work = tmp_path_factory.mktemp("exact")
    (work / "cfg.txt").write_text(CONFIG)
    out = {}
    for nproc in (2, 4):
        t, j = work / f"t{nproc}", work / f"j{nproc}"
        rc, text = torchrun(work, nproc, ["--config", "cfg.txt", "--set",
                                          f"shards={nproc}", *paths(t)])
        assert rc == 0, text[-3000:]
        assert jcli.main(["--config", str(work / "cfg.txt"), "--quiet",
                          "--set", f"shards={nproc}", *paths(j)]) == 0
        out[nproc] = (t, j, text)
    return work, out


@pytest.mark.parametrize("nproc", [2, 4])
def test_exact_ring_cli_matches_nbodyax(exact_runs, nproc):
    _, runs = exact_runs
    t, j, text = runs[nproc]
    assert text.count("Time taken:") == 1
    names = sorted(os.listdir(j / "img"))
    assert names == sorted(os.listdir(t / "img")) and len(names) == 2
    for name in names:
        assert (t / "img" / name).read_bytes() == (j / "img" / name
                                                   ).read_bytes(), name
    assert_logs_match(log_lines(t / "m.jsonl"), log_lines(j / "m.jsonl"))
    assert sorted(os.listdir(t / "ck")) == sorted(os.listdir(j / "ck"))
    got = jax_load(str(t / "ck" / "step_000000020.npz"))
    want = jax_load(str(j / "ck" / "step_000000020.npz"))
    assert int(got.step) == 20 and got.pos.shape[0] == 64
    for k in ("pos", "vel"):
        np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.mass), np.asarray(want.mass),
                               rtol=1e-6)
    # one rank wrote: no file beside rank 0's
    assert sorted(os.listdir(t)) == ["ck", "img", "m.jsonl"]


def test_resume_continues_the_straight_run(exact_runs):
    work, runs = exact_runs
    t = runs[2][0]
    r = work / "resumed"
    rc, text = torchrun(work, 2, [
        "--config", "cfg.txt", "--set", "shards=2", *paths(r),
        "--resume", str(t / "ck" / "step_000000010.npz")])
    assert rc == 0, text[-3000:]
    assert "Resumed from" in text
    a = np.load(t / "ck" / "step_000000020.npz")
    b = np.load(r / "ck" / "step_000000020.npz")
    for k in ("pos", "vel", "mass", "radius", "sim_time"):
        assert np.array_equal(a[k], b[k]), k


def test_compaction_repads_to_the_shard_count(tmp_path):
    args = ["--set", "particleCount=512", "--set", "fieldWidth=2000",
            "--set", "fieldHeight=2000", "--set", "compactEvery=10",
            "--steps", "30", "--no-images", "--set", "shards=3"]
    rc, text = torchrun(tmp_path, 3, args + [
        "--set", f"logPath={tmp_path / 't.jsonl'}"])
    assert rc == 0, text[-3000:]
    assert jcli.main(args + ["--quiet", "--set",
                             f"logPath={tmp_path / 'j.jsonl'}"]) == 0
    assert "Compacted 513 -> 256 slots" in text
    assert_logs_match(log_lines(tmp_path / "t.jsonl"),
                      log_lines(tmp_path / "j.jsonl"))


def test_bh_adapt_and_checkpoints_match_one_process(tmp_path):
    """Four ranks decide every probe, adapt, checkpoint and window as one
    process does: the logs and checkpoints are the same, bit for bit."""
    cfg_path = os.path.join(ROOT, "examples", "galaxy_momentum.txt")
    sets = dict(particleCount=1024, logEvery=25, checkpointEvery=16,
                checkpointKeep=0, autoResume=0, forceModel="bh",
                bhNear="rows", bhLevels=3, bhNeighborK=40, bhAdapt=1)
    args = ["--config", cfg_path, "--steps", "80", "--no-images"]
    for k, v in sets.items():
        args += ["--set", f"{k}={v}"]
    rc, text = torchrun(tmp_path, 4, args + [
        "--set", "shards=4", "--set", f"logPath={tmp_path / 't.jsonl'}",
        "--set", f"checkpointPath={tmp_path / 'tck'}"])
    assert rc == 0, text[-3000:]
    from nbodyax_torch.config import apply_overrides
    cfg = apply_overrides(parse_config_file(cfg_path),
                          [f"{k}={v}" for k, v in sets.items()])
    cfg = dataclasses.replace(cfg, total_iterations=80, save_images=False,
                              log_path=str(tmp_path / "o.jsonl"),
                              checkpoint_path=str(tmp_path / "ock"))
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = run_simulation(cfg, device="cpu", quiet=True,
                             state=init_scene(cfg, device="cpu"))
    finally:
        torch.set_num_threads(old)
    adapts = re.findall(r"bh adapt at step (\d+)", text)
    assert adapts, text[-2000:]
    assert_logs_match(log_lines(tmp_path / "t.jsonl"),
                      log_lines(tmp_path / "o.jsonl"), exact=True)
    names = sorted(os.listdir(tmp_path / "tck"))
    assert names == sorted(os.listdir(tmp_path / "ock")) and names
    for name in names:
        a = np.load(tmp_path / "tck" / name)
        b = np.load(tmp_path / "ock" / name)
        for k in ("pos", "vel", "mass", "radius"):
            assert np.array_equal(a[k], b[k]), (name, k)
    assert one.shards == 1


def test_shards_other_than_the_world_size_raise(tmp_path):
    cfg = SimConfig(particle_count=64, total_iterations=1, shards=2,
                    save_images=False)
    with pytest.raises(ValueError, match="2 processes"):
        run_simulation(cfg, device="cpu", quiet=True)
    rc, text = torchrun(tmp_path, 2, ["--set", "shards=4", "--steps", "1",
                                      "--no-images"])
    assert rc != 0 and "ValueError: shards=4 needs 4 processes" in text


def test_auto_resume_under_shards_raises(tmp_path, monkeypatch):
    """Outside a torchrun launch that allows maxRetries restarts, a sharded
    autoResume run is a ``ValueError`` naming the launch line, raised
    before any checkpoint is written."""
    monkeypatch.delenv("TORCHELASTIC_MAX_RESTARTS", raising=False)
    cfg = SimConfig(particle_count=64, total_iterations=1, shards=2,
                    save_images=False, auto_resume=True, checkpoint_every=1,
                    checkpoint_path=str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="--max-restarts 3 --nproc-per-node 2"):
        run_simulation(cfg, device="cpu", quiet=True)
    assert not os.path.exists(tmp_path / "ck")
