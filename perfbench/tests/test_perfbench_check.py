"""The comparison that decides ``correct``: the reference against the
program's plain path, the control that must fail, and runs driven on the
CPU with the timed path broken underneath, which must come out not
correct."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.control import control_numbers
from perfbench.scene import draw_scene
from perfbench.spec import ROOT, load_cell, load_module
from perfbench.worker import run_cell

SEEDS = (3, 2 ** 31 + 99)


def tiny(name, n=384, field=6000, horizon=6, steps=None, **params):
    """Cell ``name`` at a size a CPU test holds: dense enough to merge,
    checked at ``steps`` (by default the first, the middle and the last)."""
    c = load_cell(name)
    p = {k: v for k, v in c.params.items() if k != "shards"}
    p.update(particleCount=n, fieldWidth=field, fieldHeight=field, **params)
    steps = [0, horizon // 2, horizon - 1] if steps is None else steps
    return dataclasses.replace(c, params=p, horizon=horizon, warm_steps=1,
                               trace_steps=2,
                               check=dict(c.check, steps=steps))


def run(cell, seed=SEEDS[0]):
    return run_cell(cell, seed, 0.01, False, t_start=time.time(),
                    device="cpu")["result"]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_matches_the_programs_plain_step(seed):
    from nbodyax_torch.config import parse_config_text
    from nbodyax_torch.physics.pairwise import pair_accumulators
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.state import make_state
    from perfbench.spec import config_text
    cell = tiny("exact-million", n=512, field=5000)
    cfg = parse_config_text(config_text(cell.params))
    s0 = make_state(*draw_scene(seed, cell.params), device="cpu")
    p = PhysicsParams.from_config(cfg)
    s1 = make_step(p)(s0)
    assert int((s1.mass > 0).sum()) < 512          # bodies merged
    rows = torch.arange(512)
    ref = load_module("reference", cell.reference).step(*s0[:4], rows,
                                                       cell.params)
    nums = check.compare(s0[:4], s1[:4], ref, rows, 5000.0)
    assert nums["collide"] < 1e-6 and nums["dv"] < 1e-5
    assert nums["dx"] <= 2 * 2.0 ** -24
    acc = pair_accumulators(*s0[:4], eps=0.0, growth_rate=p.growth_rate)
    gained = ref[2] > s0.mass
    assert (gained == (acc.gained_mass > 0) & ~acc.died).all()


@pytest.mark.parametrize("name", ["exact-million", "bh-million",
                                  "exact-default", "ring4-galaxy4m"])
def test_the_bfloat16_control_fails_every_cell(name):
    cell = tiny(name, n=2048, field=int(load_cell(name).params["fieldWidth"]))
    for seed in SEEDS:
        nums = control_numbers(cell, seed, torch.device("cpu"))
        verdicts = check.judge(nums, {k: v for k, v in
                                      cell.check["limits"].items()
                                      if k in nums})
        assert not all(ok for _, _, ok in verdicts.values()), nums


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["exact-million", "exact-default",
                                  "bh-million"])
def test_a_sound_run_is_correct(name, seed):
    res = run(tiny(name), seed)
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "compared"


def _broken(kind):
    """A ``driver.build_step`` whose step is broken in one way."""
    import nbodyax_torch.driver as drv
    real = drv.build_step

    def build(cfg, device, group=None):
        step = real(cfg, device, group)

        def broken(state):
            out = step(state)
            if kind == "unchanged":                # returns its input
                return out._replace(pos=state.pos, vel=state.vel,
                                    mass=state.mass, radius=state.radius)
            if kind == "half":                     # half the bodies left out
                h = state.pos.shape[0] // 2
                cat = lambda a, b: torch.cat([a[:h], b[h:]])
                return out._replace(pos=cat(out.pos, state.pos),
                                    vel=cat(out.vel, state.vel),
                                    mass=cat(out.mass, state.mass),
                                    radius=cat(out.radius, state.radius))
            if kind == "altered":                  # an answer altered
                mass = out.mass.clone()
                mass[::97] *= 1.01
                return out._replace(mass=mass)
            raise ValueError(kind)
        return broken
    return build


@pytest.mark.parametrize("name", ["exact-million", "bh-million"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(monkeypatch, name, kind):
    import nbodyax_torch.driver as drv
    monkeypatch.setattr(drv, "build_step", _broken(kind))
    res = run(tiny(name))
    assert res["correct"] is False, (kind, res["compared"])


def _drops_merges_between(first, last):
    """A ``driver.build_step`` whose steps from step ``first`` up to step
    ``last`` drop every contact: the merge commit left out, as a near
    field that loses its partners between probes would."""
    import nbodyax_torch.driver as drv
    real = drv.build_step

    def build(cfg, device, group=None):
        step = real(cfg, device, group)

        def dropping(state):
            out = step(state)
            if first <= state.step < last:
                return out._replace(mass=state.mass, radius=state.radius)
            return out
        return dropping
    return build


@pytest.mark.parametrize("steps,correct", [([0, 11], True),
                                           ([0, 4, 11], False)])
def test_a_fault_inside_the_job_needs_a_step_inside_it(monkeypatch, steps,
                                                       correct):
    """Steps 4 to 10 of a 12-step bh job drop their contacts and the last
    step is sound again: a check of the first and last steps alone reads
    the run correct, one that also compares step 4 does not."""
    import nbodyax_torch.driver as drv
    monkeypatch.setattr(drv, "build_step", _drops_merges_between(4, 11))
    res = run(tiny("bh-million", n=2048, field=10000, horizon=12,
                   steps=steps, logEvery=4, compactEvery=0,
                   checkpointEvery=0))
    assert res["correct"] is correct, res["compared"]


def test_a_state_that_leaks_from_job_to_job_is_not_correct(monkeypatch):
    """The window's jobs all start from S0: a program that kept something
    from the last job gives another answer, and the jobs disagree."""
    import nbodyax_torch.driver as drv
    real, calls = drv.run_simulation, []

    def leaky(cfg, **kw):
        calls.append(1)
        res = real(cfg, **kw)
        if len(calls) == 3:                      # the window's second job
            res.state.vel.mul_(1.0001)
        return res
    monkeypatch.setattr(drv, "run_simulation", leaky)
    cell = tiny("exact-default", horizon=4)
    res = run_cell(cell, 11, 0.3, False, t_start=time.time(),
                   device="cpu")["result"]
    assert res["attempted"] >= 3
    assert res["compared"]["jobs_differing"]["value"] >= 1
    assert res["correct"] is False


RING_FAULT = textwrap.dedent("""
    import sys
    import nbodyax_torch.sharding.ring as ring
    real = ring.ring_accumulators

    def local_only(pos, vel, mass, radius, *, group, accum_fn,
                   need_vel=True):
        # the exchange between ranks left out: this rank's own tile alone
        class One:
            rank, size, device = group.rank, 1, group.device
        acc = real(pos, vel, mass, radius, group=One(), accum_fn=accum_fn,
                   need_vel=need_vel)
        return acc

    if sys.argv[1] == "broken":
        ring.ring_accumulators = local_only
    from perfbench.worker import main
    sys.exit(main(sys.argv[2:]))
""")


@pytest.mark.parametrize("kind", ["sound", "broken"])
def test_the_ring_without_its_exchange_is_not_correct(tmp_path, kind):
    """Two gloo ranks on the CPU run the ring cell at a small size; with the
    ring's exchange taken out underneath, the run is not correct."""
    script = tmp_path / "rank.py"
    script.write_text(RING_FAULT)
    out = tmp_path / "result.json"
    cell = tiny("ring4-galaxy4m", n=1024, field=100000, horizon=3,
                shards=2)
    fields = {"params": cell.params, "horizon": 3, "warm_steps": 1,
              "trace_steps": 2}
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), kind, "--device", "cpu",
         "--workload", "ring4-galaxy4m", "--seed", "77", "--seconds",
         "0.01", "--trace", "0", "--t-start", repr(time.time()), "--out",
         str(out), "--cell", json.dumps(fields)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(out.read_text())["result"]
    assert res["device"]["count"] == 2
    assert res["correct"] is (kind == "sound"), res["compared"]


def test_rows_are_drawn_from_every_shard_with_the_giants():
    n = 4000
    mass = torch.ones(n)
    mass[::3] = 0
    radius = torch.arange(n, dtype=torch.float32)
    rows = check.sample_rows(5, mass, radius, k=400, giants=10, shards=4)
    assert (mass[rows] > 0).all()
    slab = rows // 1000
    assert [int((slab == s).sum()) >= 100 for s in range(4)] == [True] * 4
    assert set(range(3989, 4000)) - {3990, 3993, 3996, 3999} <= set(
        rows.tolist())
    again = check.sample_rows(5, mass, radius, k=400, giants=10, shards=4)
    assert torch.equal(rows, again)
    every = check.sample_rows(5, mass[:300], radius[:300], k=400, giants=0)
    assert every.tolist() == np.flatnonzero(mass[:300].numpy()).tolist()


def test_a_compacted_state_is_compared_row_for_row():
    start = tuple(torch.arange(8, dtype=torch.float32).reshape(8, 1)
                  .repeat(1, k) for k in (2, 2))
    mass = torch.tensor([1.0, 0, 2, 0, 3, 0, 0, 4])
    nxt = (torch.zeros(4, 2), torch.zeros(4, 2), torch.zeros(4),
           torch.zeros(4))
    out = check._match_capacity((*start, mass, mass), nxt)
    assert out[2].tolist() == [1.0, 2, 3, 4]
    assert out[0][:, 0].tolist() == [0.0, 2, 4, 7]


def test_the_measurement_path_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "exact-default",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "exact-default",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_the_control_fails_at_full_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    cell = load_cell("exact-million")
    nums = control_numbers(cell, 11, torch.device("cuda", 0))
    assert all(nums[k] > cell.check["limits"][k] for k in nums)
