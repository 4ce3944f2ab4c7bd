"""nbodyax_torch command line, end to end on the CPU.

The port's CLI (``--device cpu``) writes the same frames, byte for byte,
as ``nbodyax.cli`` on the same config, runs leapfrog and yoshida4 to
nbodyax's final state, logs ``adaptiveDt``'s ``dt_mean`` and
``energyEvery``'s energies as nbodyax does, and ends the galaxy and
Plummer scenes on nbodyax's alive count; the port imports no JAX; and
the config values it does not run yet (autoResume under shards) are
refused.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import cli as jcli  # noqa: E402
from nbodyax.config import parse_config_file as jax_parse  # noqa: E402
from nbodyax.driver import run_simulation as jax_run  # noqa: E402
from nbodyax_torch import cli as tcli  # noqa: E402
from nbodyax_torch.config import SimConfig, parse_config_file  # noqa: E402
from nbodyax_torch.driver import run_simulation  # noqa: E402

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
"""


@pytest.fixture
def config(tmp_path):
    path = tmp_path / "nbodyConfig.txt"
    path.write_text(CONFIG)
    return path


def test_frames_byte_equal_to_jax_cli(config, tmp_path, capsys):
    jdir, tdir = tmp_path / "jax_frames", tmp_path / "torch_frames"
    assert jcli.main(["--config", str(config), "--quiet",
                      "--set", f"imagePath={jdir}"]) == 0
    assert tcli.main(["--config", str(config), "--device", "cpu",
                      "--set", f"imagePath={tdir}",
                      "--set", f"logPath={tmp_path / 'log.jsonl'}"]) == 0
    out = capsys.readouterr().out
    assert "Time taken:" in out
    names = sorted(os.listdir(jdir))
    assert names == ["iteration_0.ppm", "iteration_10.ppm"]
    assert sorted(os.listdir(tdir)) == names
    for name in names:
        raw = (tdir / name).read_bytes()
        assert raw.startswith(b"P5\n128 128\n255\n")
        assert raw == (jdir / name).read_bytes(), name
    body = np.frombuffer(raw.split(b"255\n", 1)[1], np.uint8)
    assert (body == 0).any() and (body == 254).any()
    logs = [json.loads(l) for l in
            (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [l["step"] for l in logs] == [10, 20]
    assert 0 < logs[-1]["alive"] <= 64 and logs[-1]["pairs_per_sec"] > 0


@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
def test_symplectic_integrators_run_end_to_end(config, tmp_path, capsys,
                                               integrator):
    """``--set integrator=...`` runs through the CLI, and the driver's
    final state matches nbodyax's run of the same config (alive masks
    exact; mass to rtol 1e-6; pos and vel within 2e-4 of the field, the
    golden gates)."""
    tdir = tmp_path / "frames"
    assert tcli.main(["--config", str(config), "--device", "cpu",
                      "--set", f"imagePath={tdir}",
                      "--set", f"integrator={integrator}",
                      "--set", f"logPath={tmp_path / 'log.jsonl'}"]) == 0
    assert "Time taken:" in capsys.readouterr().out
    assert sorted(os.listdir(tdir)) == ["iteration_0.ppm",
                                        "iteration_10.ppm"]
    jcfg, tcfg = jax_parse(str(config)), parse_config_file(str(config))
    for cfg in (jcfg, tcfg):
        cfg.integrator, cfg.save_images = integrator, False
        cfg.log_path = str(tmp_path / "unused.jsonl")
    want = jax_run(jcfg, quiet=True).state
    got = run_simulation(tcfg, device="cpu", quiet=True).state
    alive = np.asarray(want.mass) > 0
    np.testing.assert_array_equal(got.mass.numpy() > 0, alive)
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(want.mass),
                               rtol=1e-6)
    for name in ("pos", "vel"):
        np.testing.assert_allclose(
            getattr(got, name).numpy()[alive],
            np.asarray(getattr(want, name))[alive], rtol=0, atol=2e-4 * 5000)


@pytest.mark.parametrize("key,value,fields", [
    ("adaptiveDt", "1", ("dt_mean",)),
    ("energyEvery", "10", ("potential_energy", "total_energy")),
])
def test_adaptive_dt_and_energy_run_end_to_end(config, tmp_path, capsys,
                                               key, value, fields):
    """``--set adaptiveDt=1`` and ``--set energyEvery=10`` run through the
    CLI at N = 64 and log their fields at every log line (adaptive dt) or
    at the energy cadence, equal to nbodyax's run of the same config to
    rtol 1e-5."""
    log = tmp_path / "log.jsonl"
    assert tcli.main(["--config", str(config), "--device", "cpu",
                      "--no-images", "--set", f"{key}={value}",
                      "--set", f"logPath={log}"]) == 0
    assert "Time taken:" in capsys.readouterr().out
    got = [json.loads(l) for l in log.read_text().splitlines()]
    jcfg = jax_parse(str(config))
    jcfg.save_images, jcfg.log_path = False, str(tmp_path / "jax.jsonl")
    setattr(jcfg, {"adaptiveDt": "adaptive_dt",
                   "energyEvery": "energy_every"}[key], int(value))
    jax_run(jcfg, quiet=True)
    want = [json.loads(l) for l in
            (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert [l["step"] for l in got] == [l["step"] for l in want] == [10, 20]
    for g, w in zip(got, want):
        assert [f for f in fields if f in g] == [f for f in fields if f in w]
        assert all(f in g for f in fields)
        for f in fields + ("sim_time", "kinetic_energy"):
            np.testing.assert_allclose(g[f], w[f], rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("scene", ["galaxy", "plummer"])
def test_drawn_scenes_end_on_nbodyax_cli(config, tmp_path, capsys, scene,
                                         dims):
    """``--set scene=galaxy|plummer`` at 256 bodies for 20 steps, in 2-D
    and 3-D, through nbodyax.cli and the port's CLI on one config: both
    start from nbodyax's bodies, so the last log line's alive count is
    equal and its mass within rtol 1e-6."""
    lines = {}
    for name, main, extra in (("jax", jcli.main, ["--quiet"]),
                              ("torch", tcli.main, ["--device", "cpu"])):
        log = tmp_path / f"{name}.jsonl"
        assert main(["--config", str(config), "--no-images", *extra,
                     "--set", f"scene={scene}", "--set", f"dimensions={dims}",
                     "--set", "particleCount=256", "--set", "softening=100",
                     "--set", f"logPath={log}"]) == 0
        lines[name] = [json.loads(l) for l in log.read_text().splitlines()]
    capsys.readouterr()
    got, want = lines["torch"][-1], lines["jax"][-1]
    assert got["step"] == want["step"] == 20
    assert got["alive"] == want["alive"]
    np.testing.assert_allclose(got["total_mass"], want["total_mass"],
                               rtol=1e-6)


def test_port_imports_no_jax():
    code = ("import sys, nbodyax_torch, nbodyax_torch.cli, "
            "nbodyax_torch.prng, nbodyax_torch.scenes, "
            "nbodyax_torch.physics.kernels, nbodyax_torch.driver, "
            "nbodyax_torch.physics.kernels_bwd, nbodyax_torch.autodiff, "
            "nbodyax_torch.physics.barneshut; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'nbodyax.')) or m == 'nbodyax']; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_without_a_card_is_an_error(config, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert tcli.main(["--config", str(config)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="cuda"):
        run_simulation(SimConfig(particle_count=8), device="cuda")


def test_missing_config_errors(tmp_path, capsys):
    assert tcli.main(["--config", str(tmp_path / "nope.txt"),
                      "--device", "cpu"]) == 1
    assert "Error opening config file!" in capsys.readouterr().err


@pytest.mark.parametrize("override,item", [
    (dict(force_model="bh", dimensions=3, shards=2, auto_resume=True),
     "max-restarts"),
    (dict(shards=2, auto_resume=True), "max-restarts"),
])
def test_unported_config_values_raise(override, item, tmp_path,
                                      monkeypatch):
    """No config value is unported any more; the last one, autoResume
    under shards, needs a torchrun launch that allows its retries and,
    outside one, raises before it runs, naming the launch line."""
    monkeypatch.delenv("TORCHELASTIC_MAX_RESTARTS", raising=False)
    cfg = SimConfig(particle_count=8, total_iterations=1, save_images=False,
                    checkpoint_every=1, checkpoint_path=str(tmp_path / "ck"),
                    **override)
    with pytest.raises(ValueError, match=item):
        run_simulation(cfg, device="cpu", quiet=True)
    assert not (tmp_path / "ck").exists()
