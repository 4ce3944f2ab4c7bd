"""``--debug-nans`` on nbodyax_torch, on the CPU, against nbodyax's flag.

A 16-body state whose body 0 moves at 1e38 along x with open boundaries:
its position overflows f32 to inf, and the next step's pair sums turn NaN
(0 * inf). Both CLIs resume from the same checkpoint of that state with
``--debug-nans``: both raise ``FloatingPointError``, both write the same
log lines before the raise, and the port's message names the step.
nbodyax's CLI runs in a process of its own: ``jax_debug_nans`` is
process-global, and once other JAX work has run in a process (the JAX
shooting example, for one) its check has been seen to miss the NaN. A clean
run is the same with and without the flag, and autoResume does not retry
the raise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch import cli as tcli  # noqa: E402
from nbodyax_torch import driver  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.io.checkpoint import save_checkpoint  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAN_STEP = 19   # the first state that holds a NaN: after step 19
N = 16


def overflow_state():
    rng = np.random.RandomState(3)
    pos = rng.uniform(-2000, 2000, (N, 2)).astype(np.float32)
    vel = np.zeros((N, 2), np.float32)
    vel[0, 0] = 1e38
    mass = rng.uniform(1e4, 1e15, N).astype(np.float32)
    radius = rng.uniform(5, 20, N).astype(np.float32)
    return make_state(pos, vel, mass, radius, device="cpu")


def cli_args(tmp_path, log_every, name):
    save_checkpoint(str(tmp_path / "ck"), overflow_state(), keep_last=0)
    ck = os.path.join(tmp_path, "ck", sorted(os.listdir(tmp_path / "ck"))[0])
    return ["--config", str(tmp_path / "nbodyConfig.txt"), "--steps", "40",
            "--no-images", "--quiet", "--debug-nans", "--resume", ck,
            "--set", f"logEvery={log_every}", "--set", f"particleCount={N}",
            "--set", "boundaryMode=none",
            "--set", f"logPath={tmp_path / name}.jsonl"]


def logged(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("log_every", [1, 5])
def test_debug_nans_raises_at_nbodyax_step(tmp_path, log_every):
    (tmp_path / "nbodyConfig.txt").write_text(f"particleCount={N}\n")
    with pytest.raises(FloatingPointError) as got:
        tcli.main(cli_args(tmp_path, log_every, "port")
                  + ["--device", "cpu"])
    ref = subprocess.run(
        [sys.executable, "-m", "nbodyax.cli",
         *cli_args(tmp_path, log_every, "jax")], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert ref.returncode != 0 and "FloatingPointError" in ref.stderr, (
        ref.returncode, ref.stderr[-2000:])
    assert f"after step {NAN_STEP} " in str(got.value)
    assert "pos" in str(got.value) and "vel" in str(got.value)
    port, ref = logged(tmp_path / "port.jsonl"), logged(tmp_path / "jax.jsonl")
    # the window holding step 19 logs nothing in either package
    last = (NAN_STEP - 1) // log_every * log_every
    assert [r["step"] for r in port] == [r["step"] for r in ref] == list(
        range(log_every, last + 1, log_every))
    for p, r in zip(port, ref):
        assert p["alive"] == r["alive"]
        np.testing.assert_allclose(p["total_mass"], r["total_mass"],
                                   rtol=1e-6)


def test_clean_run_is_unchanged_by_the_flag(tmp_path):
    """The flag reads each window's state and changes nothing in it."""
    kw = dict(particle_count=96, total_iterations=12, log_every=4,
              field_width=5000, field_height=5000, save_images=False)
    runs = [driver.run_simulation(SimConfig(
        log_path=str(tmp_path / f"{flag}.jsonl"), **kw), device="cpu",
        quiet=True, debug_nans=flag) for flag in (False, True)]
    for a, b in zip(runs[0].state[:4], runs[1].state[:4]):
        assert torch.equal(a, b)
    assert runs[0].windows == runs[1].windows
    strip = [{k: v for k, v in r.items() if k not in (
        "wall_ms", "steps_per_sec", "pairs_per_sec")}
        for f in ("False", "True") for r in logged(tmp_path / f"{f}.jsonl")]
    assert strip[:3] == strip[3:]


def test_debug_nans_is_not_retried(tmp_path, monkeypatch):
    """autoResume reloads a checkpoint after a RuntimeError, never after a
    ``debug_nans`` raise: one attempt, one raise."""
    attempts = []
    real = driver._run_simulation_once

    def once(*a, **k):
        attempts.append(1)
        return real(*a, **k)

    monkeypatch.setattr(driver, "_run_simulation_once", once)
    cfg = SimConfig(particle_count=N, total_iterations=40, log_every=10,
                    boundary_mode="none", save_images=False,
                    checkpoint_every=10, auto_resume=True, max_retries=3,
                    checkpoint_path=str(tmp_path / "ck"),
                    log_path=str(tmp_path / "m.jsonl"))
    with pytest.raises(FloatingPointError, match=f"after step {NAN_STEP} "):
        driver.run_simulation(cfg, device="cpu", quiet=True,
                              state=overflow_state(), debug_nans=True)
    assert attempts == [1]
