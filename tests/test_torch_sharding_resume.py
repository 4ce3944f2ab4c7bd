"""autoResume under ``shards > 1``: torchrun's relaunch, on the CPU.

Two gloo ranks run the port's CLI under ``python -m
torch.distributed.run --max-restarts 1``. The fault is the test's own:
its child script makes rank 1 raise at the start of the window after step
``FAULT_AT`` on the first attempt (``TORCHELASTIC_RESTART_COUNT`` 0) and
then runs the CLI. torchrun ends both ranks and starts them again, and the
relaunched ranks resume from the latest checkpoint, so the run ends on the
straight run's final state, bit for bit (nbodyax's in-process retry under
shards has the same outcome: ``nbodyax/driver.py:230-262``). Without
``--max-restarts`` the launch fails with the ``ValueError`` that names it.
A fault that one card does not retry (a ``FloatingPointError``, as
``--debug-nans`` raises) is not relaunched either: the relaunched ranks
stop at once, and a new launch into the same checkpoints runs again.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT_AT = 20
CHILD = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
from nbodyax_torch import cli, driver
FAULTS = dict(runtime=RuntimeError, fpe=FloatingPointError)
fault = [a for a in sys.argv[1:] if a.startswith("--fault=")]
if (os.environ["TORCHELASTIC_RESTART_COUNT"] == "0"
        and os.environ["RANK"] == "1" and fault):
    advance = driver._ShardedWindows.advance
    error = FAULTS[fault[0].split("=")[1]]

    def failing(self, k, frames):
        if self.state.step >= {FAULT_AT}:
            raise error("injected fault at step %d" % self.state.step)
        return advance(self, k, frames)

    driver._ShardedWindows.advance = failing
sys.exit(cli.main([a for a in sys.argv[1:] if a not in fault]))
"""
ARGS = ["--device", "cpu", "--no-images", "--steps", "40",
        "--set", "particleCount=64", "--set", "fieldWidth=5000",
        "--set", "fieldHeight=5000", "--set", "shards=2",
        "--set", "autoResume=1", "--set", "maxRetries=1",
        "--set", "checkpointEvery=10", "--set", "checkpointKeep=0"]


def launch(work, tag, restarts, fault=None, timeout=120):
    """The CLI through the child script as two gloo ranks; returns (exit
    code, output, checkpoint directory)."""
    (work / "child.py").write_text(CHILD)
    ck = work / tag
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2"]
    if restarts is not None:
        cmd += ["--max-restarts", str(restarts)]
    cmd += [str(work / "child.py"), *ARGS, "--set", f"checkpointPath={ck}"]
    cmd += [f"--fault={fault}"] if fault else []
    r = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                       text=True, timeout=timeout)
    return r.returncode, r.stdout + r.stderr, ck


def test_relaunch_ends_bitwise_on_the_straight_run(tmp_path):
    rc, text, straight = launch(tmp_path, "straight", 1)
    assert rc == 0, text[-3000:]
    assert "injected fault" not in text and "Relaunch" not in text
    rc, text, faulted = launch(tmp_path, "faulted", 1, fault="runtime")
    assert rc == 0, text[-3000:]
    assert f"injected fault at step {FAULT_AT}" in text
    assert "Relaunch 1 of 1: resuming from" in text
    names = sorted(os.listdir(straight))
    assert names[-1] == "step_000000040.npz"
    a = np.load(straight / names[-1])
    b = np.load(faulted / names[-1])
    for k in ("pos", "vel", "mass", "radius", "sim_time", "step"):
        assert np.array_equal(a[k], b[k]), k


def test_without_max_restarts_the_launch_fails(tmp_path):
    rc, text, ck = launch(tmp_path, "none", None)
    assert rc != 0
    assert "ValueError: autoResume under shards=2" in text
    assert "--max-restarts 1 --nproc-per-node 2" in text
    assert not os.path.exists(ck)


def test_a_failure_one_card_does_not_retry_is_not_relaunched(tmp_path):
    rc, text, ck = launch(tmp_path, "fpe", 1, fault="fpe")
    assert rc != 0
    assert f"FloatingPointError: injected fault at step {FAULT_AT}" in text
    assert "RelaunchRefused: relaunch 1 of 1 refused" in text
    assert "Relaunch 1 of 1: resuming" not in text
    names = sorted(os.listdir(ck))
    assert "not_retried.txt" in names
    assert names[-1] == f"step_{FAULT_AT:09d}.npz"    # no run after it
    rc, text, ck = launch(tmp_path, "fpe", 1)         # a new launch runs
    assert rc == 0, text[-3000:]
    assert "not_retried.txt" not in os.listdir(ck)
    assert "step_000000040.npz" in os.listdir(ck)
