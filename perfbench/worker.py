"""One run of one cell on one rank: set-up, the measured window, the traced
job and the check.

A **job** is one call of ``nbodyax_torch.driver.run_simulation`` from the
cell's start state ``S0`` (the benchmark's own draw from the seed) to the
cell's horizon, with the cell's cadences: what ``python -m
nbodyax_torch.cli`` runs. Each job captures its own CUDA graphs, as every
user run does, so capture stays inside the window.

- **Set-up** (``setup_s``): process start, imports, the draw of ``S0``, and
  one warm job of ``warm_steps``, which builds or loads the kernels.
- **Window**: jobs back to back from ``S0`` until ``seconds`` have passed;
  the last one completes. Each ends in a device synchronize and writes
  into a directory of its own, which is removed once the window has
  closed. The end-to-end readers (``end_to_end/<metric>.py``) take their
  numbers from the window's record: ``steps_per_s`` is every step of the
  window's jobs over its wall seconds, ``peak_device_gib`` the
  allocator's peak over the window (the fullest card's).
- **Traced job** (``trace``): one job of ``trace_steps`` under
  ``torch.profiler``; the per-layer readers take their numbers from it and
  from the window's jobs.
- **Check** (``check.py``), once the window has closed: at each step the
  cell lists, the program's next state against one reference step from
  its state (jobs of ``k`` and ``k + 1`` steps; the last step's next
  state is the timed job's end).

Across cards every rank runs this in step (``torch.distributed.run``);
rank 0 decides when the window closes, checks, and writes the result.
The program's names used: ``config.parse_config_text``,
``state.make_state``, ``driver.run_simulation``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

import torch

from perfbench import check as check_mod
from perfbench import trace as trace_mod
from perfbench.guard import forbidden_loaded
from perfbench.peaks import card_line
from perfbench.scene import draw_scene
from perfbench.spec import Cell, config_text, load_cell, load_module

__all__ = ["run_cell", "check_numbers", "main"]


class _Ranks:
    """The harness's own collectives (none on one process)."""

    def __init__(self, dev: torch.device):
        import torch.distributed as dist
        self.dist = dist if dist.is_initialized() else None
        self.rank = self.dist.get_rank() if self.dist else 0
        self.size = self.dist.get_world_size() if self.dist else 1
        self.dev = dev

    def barrier(self):
        if self.dist:
            self.all(0.0, "max")

    def all(self, x: float, op: str) -> float:
        """``x`` reduced over the ranks (``sum`` or ``max``)."""
        if not self.dist:
            return x
        t = torch.tensor([x], dtype=torch.float64, device=self.dev)
        self.dist.all_reduce(t, op=getattr(self.dist.ReduceOp, op.upper()))
        return float(t.item())

    def from_root(self, flag: bool) -> bool:
        if not self.dist:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=self.dev)
        self.dist.broadcast(t, 0)
        return bool(t.item() > 0)


def _fingerprint(state) -> tuple:
    """The exact bits of a state's four fields, folded to integers."""
    return tuple(int(t.contiguous().view(torch.int32).sum(dtype=torch.int64))
                 for t in state[:4])


def _finite(state) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in state[:4])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _read_log(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class _Jobs:
    """Runs jobs of the cell's configuration with the program's entry."""

    def __init__(self, cell: Cell, dev: torch.device, run_dir: str):
        from nbodyax_torch.config import parse_config_text
        from nbodyax_torch.driver import run_simulation
        self.parse, self.run_simulation = parse_config_text, run_simulation
        self.cell, self.dev, self.dir = cell, dev, run_dir

    def config(self, steps: int, tag: str):
        p = dict(self.cell.params)
        p.update(totalIterations=steps,
                 logPath=os.path.join(self.dir, f"{tag}.jsonl"),
                 checkpointPath=os.path.join(self.dir, f"ck-{tag}"),
                 imagePath=os.path.join(self.dir, f"img-{tag}"))
        return self.parse(config_text(p))

    def run(self, steps: int, tag: str, state):
        """One job of ``steps`` from ``state``; its log, checkpoints and
        frames start empty and stay until ``remove(tag)`` or the next job
        of ``tag``."""
        self.remove(tag)
        cfg = self.config(steps, tag)
        res = self.run_simulation(cfg, device=self.dev, quiet=True,
                                  state=state)
        _sync(self.dev)
        return res, cfg.log_path

    def remove(self, tag: str) -> None:
        """What the job of ``tag`` wrote."""
        cfg = self.config(1, tag)
        if os.path.exists(cfg.log_path):
            os.remove(cfg.log_path)
        for d in (cfg.checkpoint_path, cfg.image_path):
            shutil.rmtree(d, ignore_errors=True)


def _job_record(res, steps: int) -> dict:
    return {"steps": steps, "steps_per_sec": float(res.steps_per_sec),
            "seconds": {k: float(v) for k, v in res.seconds.items()}}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda") -> dict:
    """Run the cell; on rank 0 returns ``{"result": the result line's
    object, "compared": [lines]}``, on other ranks ``{}``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ranks = _Ranks(dev)
    root = ranks.rank == 0
    run_dir = tempfile.mkdtemp(prefix=f"perfbench-{cell.name}-",
                               dir=os.environ.get("TMPDIR"))
    try:
        return _run(cell, seed, seconds, trace, t_start, dev, ranks, root,
                    run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _run(cell, seed, seconds, trace, t_start, dev, ranks, root, run_dir):
    from nbodyax_torch.state import make_state
    jobs = _Jobs(cell, dev, run_dir)
    H = cell.horizon
    pos, vel, mass, radius = draw_scene(seed, cell.params, cell.root)
    s0 = make_state(pos, vel, mass, radius, device=dev)
    del pos, vel, mass, radius
    jobs.run(cell.warm_steps, "warm", s0)

    # the window
    ranks.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_window = time.time()
    t0 = time.perf_counter()
    records, finals = [], []
    while True:
        # each job its own directory: nothing is removed inside the window
        last, _ = jobs.run(H, f"window-{len(records)}", s0)
        records.append(_job_record(last, H))
        finals.append((_fingerprint(last.state), _finite(last.state)))
        if not ranks.from_root(time.perf_counter() - t0 < seconds):
            break
        last = None   # no job's state outlives it into the next one's peak
    window_s = time.perf_counter() - t0
    peak_bytes = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    peak_bytes = int(ranks.all(float(peak_bytes), "max"))
    for i in range(len(records)):
        jobs.remove(f"window-{i}")
    window = {"jobs": records, "horizon": H, "steps": len(records) * H,
              "seconds": window_s, "peak_bytes": peak_bytes,
              "setup_s": t_window - t_start}

    traced = _traced_job(cell, jobs, s0, dev, ranks) if trace else None

    s_h = tuple(t.clone() for t in last.state[:4])
    last = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check_numbers(cell, seed, jobs, s0, s_h, root, ranks.size)
    ranks.barrier()
    if not root:
        return {}
    numbers["jobs_differing"] = float(
        sum(p != finals[-1][0] for p, _ in finals))

    failed = sum(not ok for _, ok in finals)
    verdicts = check_mod.judge(numbers, cell.check["limits"])
    correct = failed == 0 and all(ok for _, _, ok in verdicts.values())
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    result = {
        "correct": bool(correct), "attempted": len(records),
        "failed": int(failed), "metrics": {},
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": ranks.size,
                   "memory_peak_bytes": peak_bytes}}
    if trace:
        record = {"cell": cell.name, "params": cell.params,
                  "shards": ranks.size, "horizon": H, "jobs": records,
                  "trace": traced, "kind": kind}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"], cell.root).read(record)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v),
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = traced["busy_s_mean"]
        result["device"]["window_s"] = traced["window_s_mean"]
        result["breakdown"] = traced["breakdown"]
    else:
        for m in cell.end_to_end:
            v = load_module("end_to_end", m["name"], cell.root).read(window)
            result["metrics"][m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
    card = dev.type == "cuda"
    result["card"] = card_line(dev.index or 0) if card else ""
    # the card as the window ended, and what the run wrote: diagnostics
    parts = {}
    for j in records:
        for k, v in j["seconds"].items():
            parts[k] = parts.get(k, 0.0) + v
    result["window"] = {
        "jobs": len(records), "steps": window["steps"], "seconds": window_s,
        "setup_s": window["setup_s"], "parts_s": parts, "wchar": _written(),
        "card_now": card_line(dev.index or 0, "clocks.sm,power.draw,"
                              "temperature.gpu") if card else ""}
    result["compared"] = {k: {"value": _num(v), "limit": lim}
                          for k, (v, lim, _) in verdicts.items()}
    lines = [f"jobs: {len(records)} attempted, {failed} non-finite"] + [
        f"compared {k}: {_num(v):.6g} limit {lim:g} {'ok' if ok else 'FAILED'}"
        for k, (v, lim, ok) in verdicts.items()]
    return {"result": result, "compared": lines}


def check_numbers(cell, seed, jobs, s0, s_h, root: bool, shards: int) -> dict:
    """The check's numbers (``check.NUMBERS``), each the worst over the
    cell's steps: for each ``k`` of ``check.points``, the program's state
    after ``k + 1`` steps against one reference step from its state after
    ``k``, each the end of a job of that many steps from ``s0`` (``s_h``:
    the end of the window's last job, of ``horizon`` steps). Every rank
    runs the jobs; rank 0 compares, the others return ``{}``."""
    H = cell.horizon
    steps = check_mod.points(cell.check, H)
    states = {0: tuple(s0[:4]), H: s_h}
    for n in sorted({m for k in steps for m in (k, k + 1)} - set(states)):
        states[n] = tuple(t.clone() for t in
                          jobs.run(n, f"check-{n}", s0)[0].state[:4])
        jobs.remove(f"check-{n}")
    if not root:
        return {}
    worst = dict.fromkeys(check_mod.NUMBERS, 0.0)
    for k in steps:
        got = check_mod.check_step(states[k], states[k + 1], seed,
                                   cell.params, cell.check, shards,
                                   check_mod.row_salt(k, H), cell.reference,
                                   cell.root)
        worst = {x: max(worst[x], got[x]) for x in worst}
    return worst


def _written() -> int:
    """Bytes this process has passed to write() so far (Linux)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def _num(v: float) -> float:
    """A JSON number for ``v`` (an infinite reading prints as 1e308)."""
    return 1e308 if math.isinf(v) or math.isnan(v) else float(v)


def _traced_job(cell, jobs, s0, dev, ranks) -> dict:
    """One job of ``trace_steps`` under ``torch.profiler`` on every rank:
    the device's busy seconds (averaged over the ranks) and rank 0's
    events, log and final state's live counts for the readers."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    ranks.barrier()
    prof = profile(activities=acts)
    prof.start()
    try:
        with record_function("perfbench.job"):
            res, log_path = jobs.run(cell.trace_steps, "trace", s0)
    finally:
        prof.stop()
    device, host = trace_mod.events(prof)
    del prof
    spans = [(s, e) for name, s, e in host if name == "perfbench.job"]
    t0, t1 = spans[0] if spans else (min(s for _, s, _ in host),
                                      max(e for _, _, e in host))
    busy = trace_mod.busy_seconds(device, t0, t1)
    window_s = (t1 - t0) / 1e9
    mass = res.state.mass
    slab = -(-mass.shape[0] // ranks.size)
    return {"steps": cell.trace_steps, "window_s": window_s,
            "busy_s": busy, "busy_s_mean": ranks.all(busy, "sum") / ranks.size,
            "window_s_mean": ranks.all(window_s, "sum") / ranks.size,
            "device": [(n, s, e) for n, s, e in device if s < t1 and e > t0],
            "log": _read_log(log_path),
            "final_alive": int((mass > 0).sum()),
            "rows_alive": int((mass[:slab] > 0).sum()),
            "breakdown": {
                "device_ops": trace_mod.top_device_ops(device),
                "idle_gaps": trace_mod.idle_by_host(device, host, t0, t1)}}


def main(argv=None) -> int:
    """Entry of each rank under ``torch.distributed.run``: joins the group
    (NCCL on the cards; gloo with ``--device cpu``, which the tests use
    with ``--cell`` overrides at small sizes), runs the cell, and on rank 0
    writes the result to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cell", default="{}",
                    help="JSON of Cell fields to replace (tests)")
    args = ap.parse_args(argv)
    import dataclasses

    import torch.distributed as dist
    if args.device == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    else:
        dev = torch.device("cpu")
        dist.init_process_group("gloo")
    cell = dataclasses.replace(load_cell(args.workload),
                               **json.loads(args.cell))
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       t_start=args.t_start, device=dev)
        found = forbidden_loaded()
        others = torch.tensor([float(len(found))], device=dev)
        dist.all_reduce(others)
        if dist.get_rank() == 0:
            out["forbidden"] = found + (
                ["(a module on another rank)"]
                if others.item() > len(found) else [])
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                json.dump(out, f)
            os.replace(tmp, args.out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
