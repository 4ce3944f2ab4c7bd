"""``perfbench/spans.py`` and the readers of the program's spans, on
hand-made profiler events and records."""

from __future__ import annotations

import copy

import pytest

from perfbench import spans, trace
from perfbench.spec import load_benchmark, load_cell, load_metric

MS = 1_000_000  # ns
NEW = ("driver_wait_ms_per_step", "driver_device_ms_per_step",
       "probe_ms_per_step")


class Event:
    """A stand-in for the profiler's ``_KinetoEvent``."""

    def __init__(self, name, start, end, device="CPU", corr=0, thread=1):
        self._n, self._s, self._d = name, start, end - start
        self._dev, self._corr, self._tid = device, corr, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


class Prof:
    def __init__(self, events):
        class Results:
            def events(_):
                return events

        class Profiler:
            kineto_results = Results()
        self.profiler = Profiler()


def kernel(name, start, end, corr):
    return Event(name, start, end, device="CUDA", corr=corr)


def launch(start, corr, name="cudaLaunchKernel", thread=1):
    return Event(name, start, start + 10_000, corr=corr, thread=thread)


def job():
    """A 10-ms job: run 1-9 ms holds window 1-3 (a graph launch, two
    kernels), probe 4-6 (a kernel launched at 4.5) and a launch at 7 in run
    alone; the harness launches one kernel before the run; a cpu_op shares
    the probe kernel's correlation id; a copy of an NCCL range and a
    harness span sit on the card's timeline; the frame writer's thread
    launches a copy inside the probe's time."""
    host = [Event("perfbench.job", 0, 10 * MS),
            Event("nbodyax.run", 1 * MS, 9 * MS),
            Event("nbodyax.window", 1 * MS, 3 * MS),
            Event("nbodyax.probe", 4 * MS, 6 * MS),
            launch(500_000, 1), launch(1 * MS + 100, 2, "cudaGraphLaunch"),
            launch(4 * MS + 500_000, 3), launch(7 * MS, 4),
            launch(5 * MS, 5, "cudaMemcpyAsync", thread=2),
            Event("aten::add", 4 * MS, 4 * MS + 1, corr=3),
            Event("perfbench.unrelated", 20 * MS, 21 * MS)]
    device = [kernel("void k0<1>(int)", 600_000, 800_000, 1),
              kernel("void graph_a(float)", 1 * MS + 200_000, 2 * MS, 2),
              kernel("void graph_b(float)", 2 * MS, 3 * MS, 2),
              kernel("bh_health_kernel", 5 * MS, 5 * MS + 500_000, 3),
              kernel("Memcpy DtoH", 5 * MS + 500_000, 5 * MS + 600_000, 5),
              kernel("late", 7 * MS + 100_000, 7 * MS + 200_000, 4),
              Event("nccl:coalesced", 2 * MS, 2 * MS + 10, device="CUDA"),
              Event("perfbench.job", 0, 10 * MS, device="CUDA")]
    return host + device


def test_innermost_cuts_the_timeline_where_the_innermost_span_changes():
    segs = spans.innermost([["run", 0, 100], ["window", 10, 20],
                            ["capture", 12, 15], ["probe", 30, 40]])
    assert segs == [(0, 10, "run"), (10, 12, "window"), (12, 15, "capture"),
                    (15, 20, "window"), (20, 30, "run"), (30, 40, "probe"),
                    (40, 100, "run")]
    starts = [s for s, _, _ in segs]
    assert spans.span_at(segs, starts, 13) == "capture"
    assert spans.span_at(segs, starts, 100) is None
    assert spans.span_at(segs, starts, -1) is None


def test_each_device_event_takes_its_launch_s_innermost_span():
    got = spans.attribute(Prof(job()))
    assert got["spans"] == [["run", 1 * MS, 9 * MS],
                            ["window", 1 * MS, 3 * MS],
                            ["probe", 4 * MS, 6 * MS]]
    assert [(n, s) for n, _, _, s in got["launched"]] == [
        ("k0", None), ("graph_a", "window"), ("graph_b", "window"),
        ("nccl:coalesced", None), ("bh_health_kernel", "probe"),
        ("Memcpy DtoH", None), ("late", "run")]
    # the same device events as trace.events, so the parts add up
    device, _ = trace.events(Prof(job()))
    assert [tuple(x[:3]) for x in got["launched"]] == device
    total = sum(e - s for _, s, e in device) / 1e9
    assert sum(spans.device_by_span(got["launched"]).values()) == \
        pytest.approx(total)


def test_idle_time_goes_to_the_innermost_span_open_on_the_host():
    got = spans.attribute(Prof(job()))
    idle = spans.idle_by_span(got["launched"], got["spans"])
    # 1-9 ms, busy 1.2-3 (graph), 5-5.6, 7.1-7.2
    assert idle["window"] == pytest.approx(0.2e-3)
    assert idle["run"] == pytest.approx(1e-3 + 1.1e-3 + 1.8e-3)
    assert idle["probe"] == pytest.approx(1e-3 + 0.4e-3)
    assert set(idle) == {"window", "run", "probe"}
    assert sum(idle.values()) == pytest.approx(8e-3 - 1.8e-3 - 0.6e-3
                                               - 0.1e-3)


def record(trace_part=None, jobs=()):
    device = [("pair_kernel", 0, 1 * MS), ("elementwise_kernel", 1 * MS,
                                            3 * MS),
              ("near_kernel", 4 * MS, 5 * MS),
              ("ncclDevKernel_SendRecv", 6 * MS, 7 * MS)]
    tr = {"steps": 2, "window_s": 0.01,
          "busy_s": trace.busy_seconds(device, 0, 10 * MS), "device": device,
          "log": [{"step": 2, "alive": 90}], "final_alive": 90,
          "rows_alive": 90}
    tr.update(trace_part or {})
    return {"cell": "c", "params": {"dimensions": 2}, "shards": 1,
            "horizon": 2, "kind": "NVIDIA H100 80GB HBM3",
            "jobs": list(jobs) or [
                {"steps": 2, "steps_per_sec": 100.0,
                 "seconds": {"capture": 0.5, "windows": 0.02}}],
            "trace": tr}


def test_the_driver_readers_read_the_spans_and_the_launches():
    got = spans.attribute(Prof(job()))
    rec = record({**got, "steps": 4})
    # idle under host work: the probe's 1.4 ms, over 4 steps
    assert load_metric("driver_wait_ms_per_step").read(rec) == \
        pytest.approx(1.4 / 4)
    assert load_metric("driver_wait_ms_per_step.host_heavy").read(rec) == \
        pytest.approx(1.4 / 4)
    # device time under host work: bh_health's 0.5 ms
    assert load_metric("driver_device_ms_per_step").read(rec) == \
        pytest.approx(0.5 / 4)


def test_the_probe_reader_takes_the_probe_span_a_step_of_the_window():
    jobs = [{"steps": 10, "steps_per_sec": 50.0,
             "seconds": {"capture": 0.1, "probe": 0.02}},
            {"steps": 30, "steps_per_sec": 50.0,
             "seconds": {"capture": 0.1, "probe": 0.06}}]
    assert load_metric("probe_ms_per_step.host_heavy").read(
        record(jobs=jobs)) == pytest.approx(1e3 * 0.08 / 40)


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_gives_nothing_without_the_program_s_spans(name):
    assert load_metric(name).read(record()) is None
    assert load_metric(name).read({**record(), "trace": None}) is None


EXISTING = [m["name"] for m in load_benchmark()["per_layer"]
            if not m["name"].startswith(NEW)]


@pytest.mark.parametrize("name", EXISTING)
def test_an_existing_reader_reads_alike_with_the_new_keys(name):
    plain = record()
    rich = copy.deepcopy(plain)
    rich["trace"].update(spans.attribute(Prof(job())))
    for j in rich["jobs"]:
        j["seconds"].update(run=0.1, knobs=0.2, runner=0.3, probe=0.4,
                            log=0.5, graph_free=0.6)
        j["counts"] = {"windows": 3, "captures": 1}
    assert load_metric(name).read(rich) == load_metric(name).read(plain)


def test_the_tool_adds_its_metrics_under_the_cell_s_rate():
    bh = spans._cell_fields(load_cell("bh-million"))["per_layer"]
    assert {"driver_wait_ms_per_step.host_heavy",
            "driver_device_ms_per_step.host_heavy"} <= {m["name"] for m in bh}
    ring = spans._cell_fields(load_cell("ring4-galaxy4m"))["per_layer"]
    assert {"driver_wait_ms_per_step", "driver_device_ms_per_step"} <= {
        m["name"] for m in ring}
