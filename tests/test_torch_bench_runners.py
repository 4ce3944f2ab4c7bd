"""The port's counterparts of the ``bench/`` runners, on the CPU at small
sizes, and ``metrics.conservation_scalars``.

``bench_grad_step``'s gradient is held to ``jax.grad`` of ``nbodyax``'s
``make_loss`` over its jnp step from the same state, and the port's
``conservation_scalars`` to ``nbodyax``'s on the same numpy-made states.
The other runners are held to the port's own plain runs: each near engine
of ``bench_near_ab`` to its eager bh step, ``bench_soak4m``'s resumed phase
to an uninterrupted run, ``bench_soak10k``'s two stages to its summary's
counts; ``bench_soak_adapt``'s bounds are exercised on synthetic logs.
Here the windows run eagerly and the kernel wrappers their plain versions;
the card runs every runner at its full size (``chip_smoke.py`` runs three
at small sizes).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import state as jstate  # noqa: E402
from nbodyax.autodiff import make_loss as jax_make_loss  # noqa: E402
from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax.metrics import conservation_scalars as jax_scalars  # noqa: E402
from nbodyax.physics.step import PhysicsParams as JaxParams  # noqa: E402
from nbodyax.physics.step import make_step as jax_make_step  # noqa: E402
from nbodyax_torch import (bench, bench_grad_step, bench_modes,  # noqa: E402
                           bench_near_ab, bench_soak4m, bench_soak10k,
                           bench_soak_adapt)
from nbodyax_torch.driver import build_step, run_simulation  # noqa: E402
from nbodyax_torch.metrics import conservation_scalars  # noqa: E402
from nbodyax_torch.scenes import init_scene  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402

CPU = torch.device("cpu")
RUNNERS = ("bench_grad_step", "bench_modes", "bench_near_ab",
           "bench_soak_adapt", "bench_soak4m", "bench_soak10k")
FIELDS = ("pos", "vel", "mass", "radius")


@pytest.fixture
def one_thread():
    """Run torch on one thread: a CPU bh step is thousands of small ops,
    and beside the suite's other workers each op's thread pool contends
    with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(s):
    return jstate.make_state(*(t.detach().numpy() for t in s[:4]),
                             step=int(s.step), sim_time=float(s.sim_time))


def same_state(a, b) -> bool:
    return (all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)
            and a.step == b.step and torch.equal(a.sim_time, b.sim_time))


@pytest.mark.parametrize("dim", [2, 3])
def test_conservation_scalars_match_nbodyax(dim):
    rng = np.random.RandomState(7 + dim)
    n = 300
    pos = rng.uniform(-1e4, 1e4, (n, dim)).astype(np.float32)
    vel = rng.uniform(-50, 50, (n, dim)).astype(np.float32)
    mass = rng.uniform(1e10, 1e14, n).astype(np.float32)
    mass[rng.choice(n, 40, replace=False)] = 0.0
    radius = rng.uniform(1, 10, n).astype(np.float32)
    got = conservation_scalars(make_state(pos, vel, mass, radius, step=3,
                                          sim_time=0.6, device=CPU))
    want = jax_scalars(jstate.make_state(pos, vel, mass, radius, step=3,
                                         sim_time=0.6))
    assert sorted(got) == sorted(want)
    assert got["alive"] == want["alive"] == n - 40
    # a momentum sums terms of both signs, which cancel: its rtol is taken
    # of the sum of its terms' magnitudes, each package summing in its own
    # order
    terms = np.abs(mass[:, None].astype(np.float64) * vel).sum(0)
    for k in want:
        axis = "xyz".find(k[-1]) if k.startswith("momentum_") else -1
        np.testing.assert_allclose(
            got[k], want[k], rtol=1e-6 if axis < 0 else 0,
            atol=0 if axis < 0 else 1e-6 * terms[axis], err_msg=k)


@pytest.mark.parametrize("mode", bench_grad_step.MODES)
def test_grad_step_gradient_matches_jax(mode):
    """``bench/grad_step.py``'s gradient (2 steps, N = 256): the port's,
    through the runner, against ``jax.grad`` of ``nbodyax``'s loss over its
    jnp step, within 1e-5 of the largest |grad|
    (tests/test_autodiff.py:155)."""
    record, got = bench_grad_step.run(256, 2, mode, 1, CPU)
    _, state, _, _ = bench_grad_step.setup(256, 2, mode, CPU)
    cfg = JaxConfig(particle_count=256, collision_mode=mode, softening=100.0,
                    save_images=False)
    js = to_jax(state)

    def terminal(s):
        w = (s.mass > 0).astype(np.float32)
        return (w * (s.pos * s.pos).sum(-1)).sum() / w.sum()

    loss = jax_make_loss(jax_make_step(JaxParams.from_config(cfg)), 2,
                         terminal)
    want = np.asarray(jax.jit(jax.grad(
        lambda pos: loss(js._replace(pos=pos))))(js.pos))
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got.numpy() - want).max() / scale < 1e-5
    assert record["grad_abs_sum"] == pytest.approx(float(np.abs(want).sum()),
                                                   rel=1e-4)
    assert {"forward_step_s", "grad_wall_s", "grad_step_s",
            "grad_over_forward", "grad_abs_sum"} <= set(record)


def test_modes_prints_a_line_a_mode(capsys):
    argv = ["--device", "cpu", "--n", "512", "--reps", "1", "--modes",
            ",".join(bench_modes.MODES)]
    assert bench_modes.main(argv) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["mode"] for l in lines] == list(bench_modes.MODES)
    for line in lines:
        # bench/modes.py's keys less target_1e11 and tiles
        assert {"mode", "n", "steps_per_sec", "pairs_per_sec",
                "compile_s"} <= set(line)
        assert not {"target_1e11", "tiles"} & set(line)
        assert line["n"] == 512 and line["finite"] is True
        assert line["pairs_per_sec"] == pytest.approx(
            512 ** 2 * line["steps_per_sec"])


def test_modes_refuses_an_unknown_mode():
    with pytest.raises(SystemExit):
        bench_modes.main(["--device", "cpu", "--modes", "reference,bogus"])


def test_near_ab_engines_end_on_their_eager_steps(one_thread):
    record, finals = bench_near_ab.run("uniform", 1, 2, 4096, CPU)
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.driver import resolve_bh_config
    cfg0 = SimConfig(particle_count=4096, collision_mode="reference",
                     force_model="bh", softening=100.0, save_images=False)
    start = init_scene(cfg0, device=CPU, parity=False)
    for near in bench_near_ab.ENGINES:
        assert record[near]["knobs"]["bh_near"] == near
        cfg = resolve_bh_config(dataclasses.replace(cfg0, bh_near=near),
                                start)
        step = build_step(cfg, CPU)
        s = start
        for _ in range(2):      # the warm window and one round
            s = step(s)
        assert same_state(finals[near], s), near
        assert record[f"{near}_step_s"] > 0 and record[near]["finite"]


def soak_rows(overflows, every=20):
    return [{"step": every * (i + 1), "alive": 1000 - i, "bh_overflow": o}
            for i, o in enumerate(overflows)]


ADAPT = "bh adapt at step {}: {{'bh_neighbor_k': 48}}"


@pytest.mark.parametrize("adapts, overflows, broken", [
    (2, [5, 0, 0, 0], None),
    (11, [0, 3, 0, 0, 0], None),
    (1, [5, 0, 0, 0], "never forced"),
    (12, [5, 0, 0, 0], "unbounded"),
    (3, [0, 0, 0, 4, 0, 0], "not restored"),
])
def test_soak_adapt_bounds(adapts, overflows, broken):
    lines = (["bh auto-selected: bhLevels=8 bhNear=slots bhNeighborK=40"]
             + [ADAPT.format(20 * i) for i in range(adapts)])
    rec = bench_soak_adapt.record(soak_rows(overflows),
                                  bench.bh_lines(lines)["adapt_log"])
    assert rec["adaptations"] == adapts
    assert rec["overflow_nonzero_steps"] == [
        20 * (i + 1) for i, o in enumerate(overflows) if o]
    if broken is None:
        bench_soak_adapt.check_bounds(rec)
    else:
        with pytest.raises(AssertionError, match=broken):
            bench_soak_adapt.check_bounds(rec)


def test_soak4m_resumed_phase_ends_on_the_uninterrupted_run(tmp_path):
    kw = dict(checkpoint_every=1, log_every=1)
    record, resumed = bench_soak4m.run(1024, 3, 2, str(tmp_path / "ab"), CPU,
                                       **kw)
    assert record["steps_total"] == 5 and record["resume_boundary_at"] == 3
    assert record["phase_b"]["finite"] and record["phase_a"]["finite"]
    straight = run_simulation(bench_soak4m.config(
        1024, 5, str(tmp_path / "straight"), **kw), device=CPU,
        quiet=True).state
    assert same_state(resumed, straight)
    assert record["phase_b"] == {**conservation_scalars(straight),
                                 "finite": True}


def test_soak4m_refuses_a_boundary_off_the_checkpoints(tmp_path):
    with pytest.raises(RuntimeError, match="not at the boundary"):
        bench_soak4m.run(256, 3, 1, str(tmp_path), CPU, checkpoint_every=2)


def test_soak10k_stages_and_summary(tmp_path, capsys, one_thread):
    argv = ["--device", "cpu", "--n", "1024", "--total", "40",
            "--log-every", "5", "--checkpoint-every", "10",
            "--compact-every", "10", "--workdir", str(tmp_path)]
    assert bench_soak10k.main(argv + ["--until", "20"]) == 0
    first = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["stage_to"] for l in first] == [20]       # no summary yet
    assert bench_soak10k.main(argv + ["--until", "40"]) == 0
    stage, summary = [json.loads(l)
                      for l in capsys.readouterr().out.splitlines()]
    assert (stage["stage_from"], stage["stage_to"]) == (20, 40)
    assert summary["steps_total"] == 40 and summary["resume_boundaries"] == 1
    assert summary["log_points"] == 8 and summary["partial"] is False
    assert summary["finite_all_stages"] is True
    assert [s for s, _ in summary["bh_overflow_by_log"]] == list(
        range(5, 45, 5))
    rows = [json.loads(l) for l in open(tmp_path / "soak.jsonl")]
    # the mass's drift from step 0, read back from its checkpoint
    scene = init_scene(bench_soak10k.config(1024, 40, str(tmp_path)),
                       device="cpu")
    start = conservation_scalars(scene)["total_mass"]
    assert summary["total_mass_start"] == pytest.approx(start, rel=1e-6)
    assert summary["total_mass_drift_from_start"] == pytest.approx(
        rows[-1]["total_mass"] / start - 1.0, rel=1e-6, abs=1e-9)
    assert summary["total_mass_drift"] == pytest.approx(
        rows[-1]["total_mass"] / rows[0]["total_mass"] - 1.0)
    stages = [json.loads(l) for l in open(tmp_path / "stages.jsonl")]
    # an attempt resumed mid-stage logs a step again: the last entry counts
    again = {**rows[-1], "alive": rows[-1]["alive"] - 7}
    resummed = bench_soak10k.summarize(
        rows[:-1] + [rows[-1], again], stages, n=1024, horizon=40,
        log_every=5, checkpoints=[])
    assert resummed["log_points"] == 8
    assert resummed["alive_last"] == rows[-1]["alive"] - 7


def test_runners_load_neither_jax_nor_nbodyax():
    code = ("import sys\n"
            + "".join(f"import nbodyax_torch.{m}\n" for m in RUNNERS)
            + "print([m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'nbodyax', 'bench')])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
