"""``nbodyax_torch.tracing`` and the driver's spans and counters, on the
CPU. Graph windows run with stand-in graphs whose replay runs the window's
body eagerly (``stand_in_graphs``), so capture, replay and the release of
graphs take their spans and counts here too; what a real capture does is
tested on the card (tests/test_torch_graphs.py)."""

import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from nbodyax_torch import driver, tracing  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.driver import run_simulation  # noqa: E402

# the span each span may open inside (None: the top)
PARENTS = {"run": {None}, "scene": {"run"}, "knobs": {"run", "compaction"},
           "runner": {"run", "compaction"}, "window": {"run"},
           "capture": {"window"}, "frames": {"run"}, "probe": {"run"},
           "log": {"run"}, "checkpoint": {"run"}, "compaction": {"run"},
           "graph_free": {"run", "compaction"}}
SECONDS_KEY = {"window": "windows", "checkpoint": "checkpoints"}
SCENE = dict(particle_count=512, total_iterations=24, field_width=2000,
             field_height=2000, save_images=False, log_every=4,
             compact_every=8, checkpoint_every=8)


@pytest.fixture
def one_thread():
    """Run torch on one thread: the bh step is thousands of small ops, and
    where the suite's workers share the cores each op's thread pool
    contends with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Graph windows on the CPU: a 'capture' makes a graph whose replay
    runs the window's body, after ``delay`` seconds of capture time."""
    delay = {"s": 0.0}

    def capture(self, k, frames):
        time.sleep(delay["s"])
        vec = torch.empty(4 + self.buf.pos.shape[1])

        class Graph:
            def replay(_):
                self.body(k, frames, vec, None)

        class Bodies:
            def release(_):
                pass
        return Graph(), vec, None, [0] * 5, Bodies()
    monkeypatch.setattr(driver, "_runner_class", lambda dev, eager: (
        driver._EagerWindows if eager else driver._GraphWindows))
    monkeypatch.setattr(driver._GraphWindows, "_capture", capture)
    return delay


@pytest.fixture
def recorders(monkeypatch):
    """Every ``Recorder`` the driver makes, in order."""
    made = []

    class Kept(tracing.Recorder):
        def __init__(self):
            super().__init__()
            made.append(self)
    monkeypatch.setattr(driver, "Recorder", Kept)
    return made


def config(tmp_path, **kw):
    return SimConfig(log_path=str(tmp_path / "log.jsonl"),
                     checkpoint_path=str(tmp_path / "ck"),
                     **{**SCENE, **kw})


def program_events(prof):
    """The profiler's ``nbodyax.*`` events as (name, start, end, is user
    annotation), by start."""
    out = [(e.name()[len(tracing.PREFIX):], e.start_ns(),
            e.start_ns() + e.duration_ns(), e.is_user_annotation())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(tracing.PREFIX)]
    return sorted(out, key=lambda t: (t[1], -t[2]))


def parents(events):
    """Each event's innermost enclosing event's name (None: none)."""
    out, stack = [], []
    for name, s, e, _ in events:
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, e))
    return out


def test_self_time_is_the_span_less_its_children(monkeypatch):
    ticks = iter([0.0, 1.0, 3.0, 4.0, 4.5, 10.0])
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: next(ticks))
    rec = tracing.Recorder()
    with rec.span("run"):            # 0 .. 10
        with rec.span("window"):     # 1 .. 3
            pass
        with rec.span("window"):     # 4 .. 4.5
            rec.count("windows")
            rec.count("replays", 3)
    assert rec.seconds == {"window": 2.5, "run": 7.5}
    assert rec.counts == {"windows": 1, "replays": 3}
    assert rec._open == []


def test_a_span_closes_when_its_body_raises():
    rec = tracing.Recorder()
    with pytest.raises(ValueError):
        with rec.span("run"):
            with rec.span("probe"):
                raise ValueError("x")
    assert set(rec.seconds) == {"run", "probe"} and rec._open == []


@pytest.mark.parametrize("case", ["exact", "bh", "eager-frames"])
def test_every_span_is_a_host_event_nested_as_the_driver_opens_them(
        tmp_path, one_thread, stand_in_graphs, recorders, case):
    graphs = case != "eager-frames"
    cfg = config(tmp_path, force_model="bh" if case == "bh" else "exact")
    if not graphs:
        cfg = dataclasses.replace(cfg, save_images=True, save_image_every=4,
                                  image_path=str(tmp_path / "img"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run_simulation(cfg, device="cpu", quiet=True,
                             _eager=not graphs)
    events = program_events(prof)
    assert not any(user for *_, user in events)
    seen = parents(events)
    assert all(parent in PARENTS[name] for name, parent in seen), seen
    names = {name for name, _ in seen}
    want = set(PARENTS) - ({"capture", "graph_free"} if not graphs
                           else {"frames"}) - (
        set() if case == "bh" else {"probe"})
    assert names == want
    # the result's seconds are the recorder's self-time sums
    (rec,) = recorders
    assert res.seconds == {SECONDS_KEY.get(n, n): rec.seconds.get(n, 0.0)
                           for n in PARENTS}
    # and its counts are the spans'
    n = {name: sum(1 for x, _ in seen if x == name) for name in PARENTS}
    c = res.counts
    assert c["windows"] == n["window"] == res.windows
    assert c["captures"] == n["capture"] and (c["captures"] > 0) == graphs
    assert c["probes"] == n["probe"] and (c["probes"] > 0) == (case == "bh")
    assert c["checkpoints"] == n["checkpoint"] == 3
    assert c["compactions"] == n["compaction"] >= 2
    assert (c["replays"] >= c["windows"]) == graphs
    # every graph goes, the last runner's inside the run
    assert c["graphs_freed"] == c["captures"]
    if graphs:
        assert n["graph_free"] == 1 + len(res.capacities) + c["adapts"]
    else:
        assert res.frames_written == 6 and n["frames"] == 7


def test_stand_in_graphs_end_where_the_eager_windows_do(
        tmp_path, monkeypatch, stand_in_graphs):
    cfg = config(tmp_path, total_iterations=12)
    eager = run_simulation(dataclasses.replace(
        cfg, checkpoint_path=str(tmp_path / "e")), device="cpu", quiet=True,
        _eager=True)
    calls = []
    real = driver._GraphWindows.advance

    def advance(self, k, frames):
        # the window's graph was made before its meter started
        calls.append(self._key(k, frames) in self.graphs)
        return real(self, k, frames)
    monkeypatch.setattr(driver._GraphWindows, "advance", advance)
    graph = run_simulation(cfg, device="cpu", quiet=True)
    assert calls and all(calls)
    for a, b in zip(eager.state[:4], graph.state[:4]):
        assert torch.equal(a, b)
    assert eager.windows == graph.windows
    assert eager.counts["replays"] == 0 < graph.counts["replays"]


def test_the_window_meter_leaves_captures_out(tmp_path, monkeypatch,
                                              stand_in_graphs):
    stand_in_graphs["s"] = 0.05
    order = []
    start, capture = driver.StepMeter.start, driver._GraphWindows._capture

    def meter_start(self):
        order.append("meter")
        start(self)

    def noted_capture(self, k, frames):
        order.append("capture")
        return capture(self, k, frames)
    monkeypatch.setattr(driver.StepMeter, "start", meter_start)
    monkeypatch.setattr(driver._GraphWindows, "_capture", noted_capture)
    res = run_simulation(config(tmp_path, total_iterations=2,
                                compact_every=0, checkpoint_every=0),
                         device="cpu", quiet=True)
    assert order == ["capture", "meter"] and res.windows == 1
    assert res.seconds["capture"] >= 0.05
    assert 2 / res.steps_per_sec <= res.seconds["windows"]


def test_no_profiler_range_opens_without_a_profiler(tmp_path, monkeypatch,
                                                    stand_in_graphs):
    opened = []
    real = tracing._profiler_range

    def counting(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(tracing, "_profiler_range", counting)
    cfg = config(tmp_path, total_iterations=16)
    run_simulation(cfg, device="cpu", quiet=True)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        run_simulation(dataclasses.replace(
            cfg, checkpoint_path=str(tmp_path / "ck2")), device="cpu",
            quiet=True)
    assert "run" in opened and "window" in opened and "capture" in opened


def test_a_graph_runner_outside_a_run_keeps_its_own_capture_seconds(
        stand_in_graphs):
    from nbodyax_torch.bench import capture_seconds, window_runner
    from nbodyax_torch.driver import build_step
    from nbodyax_torch.scenes import init_scene
    stand_in_graphs["s"] = 0.05
    cfg = SimConfig(particle_count=64, save_images=False)
    state = init_scene(cfg, device="cpu")
    r = driver._GraphWindows(build_step(cfg, "cpu"), state, cfg, 0, 1, None)
    r.advance(1, False)
    r.advance(1, False)
    assert capture_seconds(r) >= 0.05
    assert r.rec.counts == {"captures": 1, "replays": 2}
    assert capture_seconds(window_runner(build_step(cfg, "cpu"), state, cfg,
                                         1)) == 0.0   # eager on the CPU
