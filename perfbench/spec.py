"""What a run measures, found by name from ``BENCHMARK.json``.

- a cell: ``perfbench/cells/<workload>.json`` (its scene, horizon, warm-up,
  traced steps and the limits of its check);
- its configuration: the ``file`` that ``BENCHMARK.json`` names for it
  (the physics under their ``nbodyConfig.txt`` names, with its source);
- a per-layer metric: ``perfbench/metrics/<metric>.py``, a reader with
  ``read(record) -> float | None``;
- an end-to-end metric: ``perfbench/end_to_end/<metric>.py``, a reader
  with ``read(window) -> float``;
- a scene: ``perfbench/scenes/<scene>.py``, a draw with
  ``draw(generator, n, params)``;
- a reference: ``perfbench/reference/<reference>.py``, the plain step that
  the configuration's ``reference`` key names, with ``step_rows``.

A metric named ``<base>.<variant>`` (one quantity split by the rate its
cells report) is read by ``<base>.py`` unless it has a file of its own.
A later change adds a cell, a configuration, a scene, a physics or a
metric by adding files and entries; nothing here names one.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["ROOT", "Cell", "load_benchmark", "load_cell", "load_module",
           "load_metric", "config_text"]

ROOT = Path(__file__).resolve().parent.parent

# keys of a configuration file that are about it, not physics
_CONFIG_META = ("name", "source", "reduced", "assumed", "precision",
                "deployment", "reference")


@dataclass
class Cell:
    name: str
    chips: int
    params: dict           # every nbodyConfig.txt key the run sets
    horizon: int           # steps a job runs
    warm_steps: int
    trace_steps: int
    check: dict            # sample sizes, steps compared and limits
    reference: str = "reference_euler_2d"   # module in reference/
    end_to_end: list = field(default_factory=list)    # metric entries
    per_layer: list = field(default_factory=list)     # metric entries
    root: Path = ROOT      # the checkout it was found in


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration's
    physics merged under its own scene and cadence keys."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(work)})")
    entry = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[entry["config"]]
    with open(root / conf_entry["file"]) as f:
        conf = json.load(f)
    with open(root / "perfbench" / "cells" / f"{name}.json") as f:
        cell = json.load(f)
    if cell.get("config", entry["config"]) != entry["config"]:
        raise ValueError(f"cell {name}: its file names configuration "
                         f"{cell['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    params = {k: v for k, v in conf.items() if k not in _CONFIG_META}
    params.update(cell["scene"])
    params.update(cell.get("settings", {}))
    return Cell(name=name, chips=int(entry["chips"]), params=params,
                horizon=int(cell["horizon"]),
                warm_steps=int(cell["warm_steps"]),
                trace_steps=int(cell["trace_steps"]),
                check=cell["check"], reference=conf["reference"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                root=root)


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module ``perfbench/<kind>/<name>.py``; for a dotted ``name``
    with no file of its own, that of its base (``a.b`` -> ``a.py``)."""
    base = name
    while not (root / "perfbench" / kind / f"{base}.py").exists():
        if "." not in base:
            raise FileNotFoundError(f"no {kind} module for {name!r} under "
                                    f"{root / 'perfbench' / kind}")
        base = base.rsplit(".", 1)[0]
    return _exec(str(root / "perfbench" / kind / f"{base}.py"))


@functools.lru_cache(maxsize=None)
def _exec(path: str):
    tag = "".join(c if c.isalnum() else "_" for c in path)
    spec = importlib.util.spec_from_file_location(f"perfbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod       # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``."""
    return load_module("metrics", name, root)


def _value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def config_text(params: dict) -> str:
    """``params`` as ``nbodyConfig.txt`` lines."""
    return "".join(f"{k}={_value(v)}\n" for k, v in params.items())
