"""The program's own spans in a ``torch.profiler`` trace, and the program
span each device event was launched under.

The port marks its driver's parts with host-only profiler ranges named
``nbodyax.<span>`` (``nbodyax_torch/tracing.py``: ``run``, ``scene``,
``knobs``, ``runner``, ``window``, ``capture``, ``frames``, ``probe``,
``graph_free``, ``log``, ``checkpoint``, ``compaction``). ``attribute(prof)``
reduces a stopped profiler to two lists for a traced job's record:

- ``spans``: the ``nbodyax.*`` host events inside the harness's
  ``perfbench.job`` span, as ``[name, start_ns, end_ns]`` without the
  prefix;
- ``launched``: every device event inside the job, as ``trace.events``
  lists it, as ``[name, start_ns, end_ns, span]``: ``span`` is the
  innermost program span that its launching runtime call ran in, matched by
  the profiler's correlation id (a kernel of a graph replay carries the
  ``cudaGraphLaunch``'s), or None. Each device event has one span or none,
  so the parts add up to the job's device time.

The readers ``metrics/driver_wait_ms_per_step.py`` and
``metrics/driver_device_ms_per_step.py`` read these lists; without them
they read nothing. The harness's traced job does not yet make them
(``worker._traced_job`` would call ``attribute(prof)`` beside
``trace.events(prof)``). Until it does,

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``perfbench.run --trace 1`` does, with the traced job's
record given both lists: its result line reads the two metrics, and its
``breakdown`` adds the device's idle time and device time by program span
(``idle_by_span``, ``device_by_span``) and the ``nbodyax.*`` events found
on the card's timeline (``spans_on_device``, which should be none).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

from perfbench import trace as trace_mod

__all__ = ["PREFIX", "HOST_WORK", "attribute", "innermost", "span_at",
           "idle_by_span", "device_by_span", "main"]

PREFIX = "nbodyax."
JOB_SPAN = "perfbench.job"
# the driver's host work between windows: every span but the run itself
# and the window's own launch and fetch
HOST_WORK = frozenset(("capture", "probe", "runner", "graph_free", "knobs",
                       "log", "checkpoint", "compaction", "frames", "scene"))
# the CUDA runtime's and driver's calls, by name (torch 2.11's events have
# no activity type)
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")
# the metrics this module's records add to a cell's (name, unit)
METRICS = (("driver_wait_ms_per_step", "ms"),
           ("driver_device_ms_per_step", "ms"))


def _is_device(e) -> bool:
    return str(e.device_type()).upper().endswith("CUDA")


def attribute(prof) -> dict:
    """``{"spans": ..., "launched": ...}`` of the profiler ``prof`` after it
    stopped (see the module's docstring)."""
    evs = list(prof.profiler.kineto_results.events())
    host = [e for e in evs if not _is_device(e)]
    jobs = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in host
            if e.name() == JOB_SPAN]
    t0, t1 = jobs[0] if jobs else (min(e.start_ns() for e in evs),
                                   max(e.start_ns() + e.duration_ns()
                                       for e in evs))
    spans, tid = [], None
    for e in host:
        s, n = e.start_ns(), e.name()
        if n.startswith(PREFIX) and t0 <= s < t1:
            spans.append([n[len(PREFIX):], s, s + e.duration_ns()])
            tid = e.start_thread_id()
    spans.sort(key=lambda t: t[1])
    calls = {e.correlation_id(): e.start_ns() for e in host
             if _RUNTIME.match(e.name())
             and (tid is None or e.start_thread_id() == tid)}
    segs = innermost(spans)
    starts = [s for s, _, _ in segs]
    launched = []
    for e in evs:
        if not _is_device(e) or e.name().startswith(trace_mod.SPAN_PREFIX):
            continue   # (as trace.events: the harness's span copies)
        s = e.start_ns()
        end = s + e.duration_ns()
        if not (s < t1 and end > t0):
            continue
        at = calls.get(e.correlation_id())
        launched.append([trace_mod.short_name(e.name()), s, end,
                         None if at is None else span_at(segs, starts, at)])
    launched.sort(key=lambda t: t[1])
    return {"spans": spans, "launched": launched}


def innermost(spans) -> list:
    """The host timeline cut where the innermost open span changes:
    ``[(start_ns, end_ns, name)]``, sorted and disjoint, of properly nested
    ``(name, start_ns, end_ns)`` spans of one thread."""
    out, stack, cur = [], [], None
    for name, s, e in sorted(spans, key=lambda t: (t[1], -t[2])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if end > cur:
                out.append((cur, end, top))
            cur = max(cur, end)
        if stack:
            e = min(e, stack[-1][0])
            if s > cur:
                out.append((cur, s, stack[-1][1]))
        stack.append((e, name))
        cur = s
    while stack:
        end, top = stack.pop()
        if end > cur:
            out.append((cur, end, top))
        cur = max(cur, end)
    return out


def span_at(segs, starts, t: int):
    """The innermost span open at ``t`` (``segs`` from ``innermost``,
    ``starts`` their starts), or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < segs[i][1]:
        return segs[i][2]
    return None


def idle_by_span(launched, spans) -> dict:
    """Seconds in which no device event ran, by the innermost program span
    open on the host then (``None``: none open), over the spans' extent."""
    if not spans:
        return {}
    t0 = min(s for _, s, _ in spans)
    t1 = max(e for _, _, e in spans)
    device = [(n, s, e) for n, s, e, _ in launched]
    segs = innermost(spans)
    starts = [s for s, _, _ in segs]
    out = defaultdict(float)
    for gs, ge in trace_mod._gaps(device, t0, t1):
        i = max(bisect.bisect_right(starts, gs) - 1, 0)
        t = gs
        while t < ge:
            seg = segs[i] if i < len(segs) else None
            if seg is None or seg[0] >= ge:
                out[None] += (ge - t) / 1e9
                break
            if seg[1] <= t:
                i += 1
                continue
            if seg[0] > t:
                out[None] += (seg[0] - t) / 1e9
                t = seg[0]
            cut = min(seg[1], ge)
            out[seg[2]] += (cut - t) / 1e9
            t = cut
            i += 1
    return dict(out)


def device_by_span(launched) -> dict:
    """Device seconds by the program span each event was launched under."""
    out = defaultdict(float)
    for _, s, e, span in launched:
        out[span] += (e - s) / 1e9
    return dict(out)


def _with_spans(real):
    """``worker._traced_job`` as ``real`` does it, its record given
    ``spans`` and ``launched`` and its breakdown the parts by span."""
    def traced_job(cell, jobs, s0, dev, ranks):
        found = {}
        events = trace_mod.events

        def events_and_spans(prof):
            found.update(attribute(prof))
            return events(prof)
        trace_mod.events = events_and_spans
        try:
            out = real(cell, jobs, s0, dev, ranks)
        finally:
            trace_mod.events = events
        out.update(found)
        bd = out["breakdown"]
        bd["idle_by_span"] = _named(idle_by_span(found["launched"],
                                                 found["spans"]))
        bd["device_by_span"] = _named(device_by_span(found["launched"]))
        bd["spans_on_device"] = sorted({n for n, _, _ in out["device"]
                                        if n.startswith(PREFIX)})
        bd["program_spans"] = len(found["spans"])
        bd["device_ops_in_no_span"] = trace_mod.top_device_ops(
            [(n, s, e) for n, s, e, span in found["launched"]
             if span is None])
        return out
    return traced_job


def _named(parts: dict) -> list:
    return [[k if k is not None else "(no program span)", v]
            for k, v in sorted(parts.items(), key=lambda kv: -kv[1])]


def _cell_fields(cell) -> dict:
    """The cell's per-layer entries with this module's metrics added."""
    have = {m["name"] for m in cell.per_layer}
    rate = next((m["moves"] for m in cell.per_layer), "steps_per_s")
    suffix = rate[len("steps_per_s"):]
    extra = [{"name": n + suffix, "unit": u} for n, u in METRICS
             if n + suffix not in have]
    return {"per_layer": cell.per_layer + extra}


def main(argv=None) -> int:
    t_start = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rank-out", default="",
                    help="(one rank of a cell on several cards)")
    args = ap.parse_args(argv)
    from perfbench import run as run_mod
    from perfbench import worker
    run_mod.cache_env()
    worker._traced_job = _with_spans(worker._traced_job)
    from perfbench.spec import load_cell
    cell = load_cell(args.workload)
    fields = _cell_fields(cell)
    if args.rank_out:
        return worker.main(["--workload", args.workload, "--seed",
                            str(args.seed), "--seconds", str(args.seconds),
                            "--trace", "1", "--t-start", repr(t_start),
                            "--out", args.rank_out,
                            "--cell", json.dumps(fields)])
    import dataclasses

    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"perfbench.spans: {args.workload} needs {cell.chips} "
              "CUDA cards", file=sys.stderr)
        return 2
    if cell.chips == 1:
        out = worker.run_cell(dataclasses.replace(cell, **fields), args.seed,
                              args.seconds, True, t_start=t_start,
                              device=torch.device("cuda", 0))
    else:
        tmp = tempfile.mkdtemp(prefix="perfbench-spans-",
                               dir=os.environ.get("TMPDIR"))
        try:
            path = os.path.join(tmp, "result.json")
            subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(cell.chips), "-m",
                 "perfbench.spans", "--workload", args.workload, "--seed",
                 str(args.seed), "--seconds", str(args.seconds),
                 "--rank-out", path], cwd=run_mod.ROOT, stdout=sys.stderr,
                check=True, timeout=run_mod.RUN_TIMEOUT_S)
            with open(path) as f:
                out = json.load(f)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    for line in out["compared"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
