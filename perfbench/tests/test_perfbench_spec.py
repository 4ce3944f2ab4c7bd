"""The benchmark's files: every cell, configuration and metric that
``BENCHMARK.json`` names loads, the file keeps to its contract, and a new
cell, configuration and metric are picked up from files alone."""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import time

import pytest

from perfbench.spec import ROOT, config_text, load_benchmark, load_cell, \
    load_metric

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_and_its_config_load(cell):
    c = load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    with open(ROOT / "perfbench" / "cells" / f"{cell}.json") as f:
        raw = json.load(f)
    assert raw["why"] == entry["why"]
    assert c.chips == entry["chips"] == raw["chips"]
    assert c.horizon >= 2 and c.warm_steps >= 1 and c.trace_steps >= 1
    assert set(c.check["limits"]) >= {"collide", "dv", "dx"}
    # every key is one the program's parser knows, in its own spelling
    from nbodyax_torch.config import parse_config_text
    cfg = parse_config_text(config_text(c.params))
    assert cfg.particle_count == c.params["particleCount"]
    assert cfg.save_images is False


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(load_metric(metric).read)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert all("/" not in w or w.startswith("perfbench/")
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        c = load_cell(cell)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer


def test_every_layer_is_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """Added as files and entries only, a configuration, a cell and a
    per-layer metric run through the harness without an edit to any file
    that was there."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "perfbench/configs/reference-exact.json")
                      .read_text())
    conf.update(name="reference-soft", softening=50)
    (tmp_path / "perfbench/configs/reference-soft.json").write_text(
        json.dumps(conf))
    cell = json.loads((ROOT / "perfbench/cells/exact-default.json")
                      .read_text())
    cell.update(config="reference-soft", horizon=6, warm_steps=1,
                trace_steps=4)
    cell["scene"]["particleCount"] = 128
    (tmp_path / "perfbench/cells/soft-tiny.json").write_text(
        json.dumps(cell))
    (tmp_path / "perfbench/metrics/job_count.py").write_text(
        "def read(record):\n    return float(len(record['jobs']))\n")
    bench["configs"].append({"name": "reference-soft", "source": "test",
                             "file": "perfbench/configs/reference-soft.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "soft-tiny",
                               "config": "reference-soft",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "exact-default" in m["workloads"]:
            m["workloads"].append("soft-tiny")
    bench["per_layer"].append({"name": "job_count", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "device",
                               "moves": "steps_per_s.host_heavy",
                               "workloads": ["soft-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = load_cell("soft-tiny", root=tmp_path)
    assert c.params["softening"] == 50 and c.params["particleCount"] == 128
    assert [m["name"] for m in c.per_layer] == ["job_count"]
    from perfbench.worker import run_cell
    out = run_cell(c, 5, 0.05, True, t_start=time.time(), device="cpu")
    assert out["result"]["metrics"]["job_count"]["value"] >= 1
    out = run_cell(dataclasses.replace(c), 5, 0.05, False,
                   t_start=time.time(), device="cpu")
    assert set(out["result"]["metrics"]) == {
        "steps_per_s.host_heavy", "peak_device_gib", "setup_s"}
    assert out["result"]["correct"] is True


NONE_REFERENCE = """
import numpy as np
import torch

G = float(np.float32(6.67408e-11))


def step(pos, vel, mass, radius, rows, params, *, precision="reference"):
    # collisionMode=none: gravity from every live partner that does not
    # overlap, no merges; reflective walls; euler; float64 sums
    assert params["collisionMode"] == "none" and precision == "reference"
    dt = float(np.float32(params["timestep"]))
    n = pos.shape[0]
    alive = mass > 0
    pi, vi, ri = pos[rows], vel[rows], radius[rows]
    d = pos[None] - pi[:, None]
    d2 = (d * d).sum(-1)
    rs = ri[:, None] + radius[None]
    valid = alive[rows][:, None] & alive[None] & (
        rows[:, None] != torch.arange(n)[None])
    far = valid & ~(d2 <= rs * rs)
    dd = pos.double()[None] - pos.double()[rows][:, None]
    inv = torch.where(far, (dd * dd).sum(-1), torch.ones(())).rsqrt()
    w = torch.where(far, mass.double()[None] * inv ** 3, torch.zeros(()))
    accel = (w[..., None] * dd).sum(1).float() * G
    lim = torch.stack([params["fieldWidth"] - ri,
                       params["fieldHeight"] - ri], -1)
    pred = pi + accel * dt
    v = torch.where((pred > lim) | (pred < -lim), -vi, vi) + accel * dt
    live = alive[rows][:, None]
    return (torch.where(live, pi + v * dt, pi),
            torch.where(live, v, torch.zeros_like(v)), mass[rows],
            radius[rows])
"""

LATTICE_SCENE = """
import numpy as np


def draw(g, n, p):
    # a square lattice over the field, jittered, bodies at rest
    side = int(np.ceil(np.sqrt(n)))
    i = np.arange(n)
    cell = 2 * float(p["fieldWidth"]) / side
    pos = np.stack([(i % side + 0.5) * cell, (i // side + 0.5) * cell], -1)
    pos = pos - float(p["fieldWidth"]) + g.uniform(-0.1, 0.1, (n, 2)) * cell
    mass = g.uniform(float(p["minRandBodyMass"]),
                     float(p["maxRandBodyMass"]), n)
    return pos, np.zeros((n, 2)), mass, np.full(n, float(p["minRadius"]))
"""


def test_a_new_physics_scene_and_rate_are_found_by_name(tmp_path):
    """A configuration with a physics of its own (collisionMode=none and
    its reference module), a cell with a scene of its own and an
    end-to-end metric with a reader of its own, each added as new files
    and entries, run through the harness without an edit to any file
    that was there; the new reference decides ``correct``."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp_path / "perfbench"
    (pb / "reference/none_euler_2d.py").write_text(NONE_REFERENCE)
    (pb / "scenes/lattice.py").write_text(LATTICE_SCENE)
    (pb / "end_to_end/jobs_per_s.py").write_text(
        "def read(window):\n"
        "    return len(window['jobs']) / window['seconds']\n")
    conf = json.loads((pb / "configs/reference-exact.json").read_text())
    conf.update(name="gravity-only", collisionMode="none",
                reference="none_euler_2d")
    (pb / "configs/gravity-only.json").write_text(json.dumps(conf))
    cell = json.loads((pb / "cells/exact-default.json").read_text())
    cell.update(config="gravity-only", horizon=4, warm_steps=1,
                trace_steps=2)
    cell["scene"] = {"scene": "lattice", "particleCount": 256,
                     "fieldWidth": 20000, "fieldHeight": 20000}
    (pb / "cells/lattice-none.json").write_text(json.dumps(cell))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "gravity-only", "source": "test",
                             "file": "perfbench/configs/gravity-only.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "lattice-none",
                               "config": "gravity-only",
                               "traffic": "lattice", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "jobs_per_s", "unit": "jobs/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["lattice-none"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = load_cell("lattice-none", root=tmp_path)
    assert c.reference == "none_euler_2d"
    from perfbench.scene import draw_scene
    pos = draw_scene(3, c.params, tmp_path)[0]
    assert pos.shape == (256, 2) and abs(pos).max() < 20000
    from perfbench.worker import run_cell
    res = run_cell(c, 8, 0.05, False, t_start=time.time(),
                   device="cpu")["result"]
    assert res["correct"] is True, res["compared"]
    assert res["metrics"]["jobs_per_s"]["value"] > 0
    assert {"setup_s", "peak_device_gib"} <= set(res["metrics"])
    # the reference the configuration names is the one that judges: the
    # merging physics' reference refuses a run without merges
    with pytest.raises(ValueError, match="collisionMode"):
        run_cell(dataclasses.replace(c, reference="reference_euler_2d"),
                 8, 0.05, False, t_start=time.time(), device="cpu")
