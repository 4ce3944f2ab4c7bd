"""nbodyax_torch's failure recovery, on the CPU.

tests/test_recovery.py's three cases on the port's module-level
``driver.build_step``: with ``autoResume`` a fault reloads the latest
checkpoint and the run ends on the unfaulted run's state, bit for bit
(nbodyax's test allows rtol 1e-6; the port's CPU steps repeat exactly),
and on nbodyax's faulted run's bodies (alive masks exact, mass to rtol
1e-6, positions within 2e-4 of the field, the golden gates); a
frame-write failure is not retried; without ``autoResume`` the fault
raises. Plus the failures reloading a checkpoint cannot mend, which are
raised at once: ``NotImplementedError``, a kernel build and a graph
capture that fail.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nbodyax.driver as jdriver  # noqa: E402
from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax_torch import driver  # noqa: E402
from nbodyax_torch import render  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics._build import KernelCompileError  # noqa: E402
from nbodyax_torch.render import FrameWriteError  # noqa: E402


def make_cfg(tmp_path, cls=SimConfig, **kw):
    d = dict(particle_count=64, total_iterations=20, field_width=5000,
             field_height=5000, save_images=False, log_every=0,
             checkpoint_every=5, checkpoint_path=str(tmp_path / "ckpt"),
             auto_resume=True, max_retries=2)
    d.update(kw)
    return cls(**d)


def faulty_build(monkeypatch, error, once=True):
    """Make every built step raise ``error`` when it reaches step 12 (once,
    or every time); returns the list of steps that raised."""
    real_build = driver.build_step
    raised = []

    def build(cfg_, device):
        real_step = real_build(cfg_, device)

        def step(state):
            if state.step == 12 and not (once and raised):
                raised.append(state.step)
                raise error
            return real_step(state)
        return step

    monkeypatch.setattr(driver, "build_step", build)
    return raised


def count_attempts(monkeypatch):
    calls = {"n": 0}
    real_once = driver._run_simulation_once

    def counting_once(*a, **kw):
        calls["n"] += 1
        return real_once(*a, **kw)

    monkeypatch.setattr(driver, "_run_simulation_once", counting_once)
    return calls


def test_auto_resume_after_injected_fault(tmp_path, monkeypatch):
    raised = faulty_build(monkeypatch,
                          RuntimeError("injected device failure"))
    calls = count_attempts(monkeypatch)
    res = driver.run_simulation(make_cfg(tmp_path), device="cpu",
                                quiet=True)
    # completed despite the fault, resumed from the step-10 checkpoint
    assert res.state.step == 20 and raised == [12] and calls["n"] == 2
    monkeypatch.undo()
    ref = driver.run_simulation(make_cfg(
        tmp_path, checkpoint_path=str(tmp_path / "ckpt2"),
        auto_resume=False), device="cpu", quiet=True)
    for a, b in zip(res.state[:4], ref.state[:4]):
        assert torch.equal(a, b)
    assert torch.equal(res.state.sim_time, ref.state.sim_time)

    # nbodyax's driver through the same fault (its test's injection)
    real_build = jdriver.build_step
    armed = [True]

    def jax_build(cfg_, capacity=0):
        real_step = real_build(cfg_, capacity)

        def step(state):
            if armed[0] and int(np.asarray(state.step)) == 12:
                armed[0] = False
                raise RuntimeError("injected device failure")
            return real_step(state)
        step._host_loop = True
        return step

    monkeypatch.setattr(jdriver, "build_step", jax_build)
    monkeypatch.setattr(jdriver.time, "sleep", lambda s: None)
    want = jdriver.run_simulation(make_cfg(
        tmp_path, JaxConfig, backend="jnp",
        checkpoint_path=str(tmp_path / "jck")), quiet=True).state
    assert not armed[0]
    alive = np.asarray(want.mass) > 0
    np.testing.assert_array_equal(res.state.mass.numpy() > 0, alive)
    np.testing.assert_allclose(res.state.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    np.testing.assert_allclose(res.state.pos.numpy()[alive],
                               np.asarray(want.pos)[alive], rtol=0,
                               atol=2e-4 * 5000)


def test_retries_are_bounded_by_max_retries(tmp_path, monkeypatch):
    """A fault that repeats surfaces after 1 + maxRetries attempts."""
    raised = faulty_build(monkeypatch, RuntimeError("injected"), once=False)
    calls = count_attempts(monkeypatch)
    with pytest.raises(RuntimeError, match="injected"):
        driver.run_simulation(make_cfg(tmp_path), device="cpu", quiet=True)
    assert calls["n"] == 3 and len(raised) == 3


def test_frame_write_failure_is_not_retried(tmp_path, monkeypatch):
    """Host IO failures (a full disk) must not use up autoResume's
    retries: reloading a checkpoint cannot fix a full disk."""
    def broken_write(path, img):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(render, "write_pgm", broken_write)
    calls = count_attempts(monkeypatch)
    cfg = make_cfg(tmp_path, save_images=True, save_image_every=2,
                   img_width=32, img_height=32,
                   image_path=str(tmp_path / "frames"))
    with pytest.raises(FrameWriteError):
        driver.run_simulation(cfg, device="cpu", quiet=True)
    assert calls["n"] == 1


def test_fault_without_auto_resume_raises(tmp_path, monkeypatch):
    faulty_build(monkeypatch, RuntimeError("injected device failure"))
    calls = count_attempts(monkeypatch)
    with pytest.raises(RuntimeError, match="injected"):
        driver.run_simulation(make_cfg(tmp_path, auto_resume=False),
                              device="cpu", quiet=True)
    assert calls["n"] == 1


@pytest.mark.parametrize("error", [
    NotImplementedError("not ported"),
    KernelCompileError("nvcc failed"),
    driver.GraphCaptureError("capture failed")])
def test_unmendable_failures_are_not_retried(tmp_path, monkeypatch, error):
    """NotImplementedError is a RuntimeError in Python, and so are a kernel
    build's and a capture's failures: each is raised on the first attempt,
    though a checkpoint to resume from exists."""
    faulty_build(monkeypatch, error)
    calls = count_attempts(monkeypatch)
    with pytest.raises(type(error)):
        driver.run_simulation(make_cfg(tmp_path), device="cpu", quiet=True)
    assert calls["n"] == 1
    assert driver.latest_checkpoint(str(tmp_path / "ckpt")) is not None


def test_unported_config_raises_before_any_attempt(tmp_path, monkeypatch):
    """autoResume under shards outside a torchrun launch that allows its
    retries (the last config that once raised as unported) fails before
    any attempt runs."""
    calls = count_attempts(monkeypatch)
    monkeypatch.delenv("TORCHELASTIC_MAX_RESTARTS", raising=False)
    with pytest.raises(ValueError, match="--max-restarts 2"):
        driver.run_simulation(make_cfg(tmp_path, shards=2), device="cpu",
                              quiet=True)
    assert calls["n"] == 0
