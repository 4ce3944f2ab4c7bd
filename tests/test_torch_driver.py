"""nbodyax_torch's window scheduler and driver loop, on the CPU.

The window cases of tests/test_driver.py that need no checkpoint, run
through the port's ``run_simulation`` (N <= 96): the log cadence, a
misaligned start given by ``state=``, the ``windows`` count against
``nbodyax.driver.run_simulation``'s on the same config, frames that hold
the post-step state, multi-frame windows byte-equal to a stride-1 run, a
run with no cadence, and the energy cadence; plus ``potential_energy``
against nbodyax's in 2-D and 3-D and ``dt_mean`` against nbodyax's logged
value; and, for a merging ``forceModel=bh`` run under ``bhAdapt``, the
steps of every ``bh_health`` probe, knob adapt and checkpoint against
nbodyax's driver (fault F5). On the CPU every window runs the step
eagerly; the card's graph
windows are held to this eager runner in tests/test_torch_graphs.py and,
for ``forceModel=bh``, tests/test_torch_graphs_bh.py. The runner choice:
graph windows on a card for both force models, the eager loop on the CPU
and under ``_eager``.
"""

import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import metrics as jmetrics  # noqa: E402
from nbodyax import state as jstate  # noqa: E402
from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax.driver import run_simulation as jax_run  # noqa: E402
from nbodyax_torch import metrics as tmetrics  # noqa: E402
from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch.config import SimConfig, parse_config_file  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch import driver  # noqa: E402
from nbodyax_torch.driver import _Schedule, run_simulation  # noqa: E402
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.render import render_state  # noqa: E402
from nbodyax_torch.scenes import init_scene  # noqa: E402
from nbodyax_torch.state import from_numpy, make_state  # noqa: E402


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def one_thread():
    """Run torch on one thread: a CPU bh step is thousands of small ops,
    and beside the suite's other workers each op's thread pool contends
    with theirs (tens of times slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def base(tmp_path, cls=SimConfig, **kw):
    d = dict(particle_count=96, total_iterations=20, field_width=5000,
             field_height=5000, save_images=False,
             log_path=str(tmp_path / "m.jsonl"))
    d.update(kw)
    return cls(**d)


def logs(cfg):
    with open(cfg.log_path) as f:
        return [json.loads(line) for line in f]


def read_pgm(path):
    raw = open(path, "rb").read()
    head, body = raw.split(b"255\n", 1)
    w, h = map(int, head.split()[1:3])
    return np.frombuffer(body, np.uint8).reshape(h, w)


def test_log_cadence_respected(tmp_path):
    cfg = base(tmp_path, log_every=5)
    res = run_simulation(cfg, device="cpu", quiet=True)
    assert [l["step"] for l in logs(cfg)] == [5, 10, 15, 20]
    assert res.state.step == 20 and res.windows == 4


def test_misaligned_start_keeps_cadence(tmp_path):
    """A run started at step 3 (``state=``) re-aligns on its first window:
    the absolute log cadence still fires, and the run stops at the
    configured total."""
    cfg = base(tmp_path, log_every=5)
    s0 = init_scene(cfg, device="cpu")
    st = make_state(*s0[:4], step=3, device="cpu")
    res = run_simulation(cfg, device="cpu", quiet=True, state=st)
    assert [l["step"] for l in logs(cfg)] == [5, 10, 15, 20]
    assert res.state.step == 20 and res.windows == 4


@pytest.mark.parametrize("log_every,k_img,total,energy", [
    (3, 2, 12, 0), (5, 2, 10, 0), (10, 4, 30, 20), (0, 3, 100, 0),
    (0, 0, 100, 0), (12, 2, 12, 0)])
def test_windows_equal_nbodyax(tmp_path, log_every, k_img, total, energy):
    """The same config gives the same window count as nbodyax's driver,
    frames and energy cadence included."""
    kw = dict(log_every=log_every, total_iterations=total,
              energy_every=energy, save_images=bool(k_img),
              save_image_every=k_img or 10, img_width=32, img_height=32,
              particle_count=16)
    got = run_simulation(base(tmp_path / "t", image_path=str(
        tmp_path / "t" / "f"), **kw), device="cpu", quiet=True)
    want = jax_run(base(tmp_path / "j", JaxConfig, backend="jnp",
                        image_path=str(tmp_path / "j" / "f"), **kw),
                   quiet=True)
    assert got.windows == want.windows
    assert got.frames_written == want.frames_written


def test_schedule_stride_and_windows():
    """The stride is the gcd of the cadences, cut to the frame cadence when
    it does not divide it; 16 frame cadences or 64 steps without one."""
    cases = [(dict(log_every=10), 10, 10), (dict(log_every=12), 4, 12),
             (dict(log_every=10), 4, 2), (dict(log_every=3), 2, 1),
             (dict(log_every=0), 3, 48), (dict(log_every=0), 0, 64),
             (dict(log_every=5, energy_every=15), 0, 5)]
    for kw, k_img, stride in cases:
        sched = _Schedule(SimConfig(total_iterations=100, **kw), k_img)
        assert sched.stride == stride, (kw, k_img)
    sched = _Schedule(SimConfig(total_iterations=20, log_every=5), 2)
    # from a frame-misaligned start the window ends at the frame boundary
    assert [sched.next_window(i) for i in (0, 3, 4, 5, 19)] == [5, 1, 1, 1,
                                                                 1]


def test_frame_content_is_post_step_state(tmp_path):
    """Frame iteration_j holds the state after step j, not before it."""
    cfg = base(tmp_path, save_images=True, save_image_every=2,
               total_iterations=4, log_every=2, img_width=64, img_height=64,
               image_path=str(tmp_path / "frames"))
    run_simulation(cfg, device="cpu", quiet=True)
    assert sorted(os.listdir(tmp_path / "frames")) == ["iteration_0.ppm",
                                                       "iteration_2.ppm"]
    state = init_scene(cfg, device="cpu")
    step = make_step(PhysicsParams.from_config(cfg))
    state = step(state)
    np.testing.assert_array_equal(
        read_pgm(tmp_path / "frames" / "iteration_0.ppm"),
        render_state(state, cfg).numpy())
    state = step(step(state))
    np.testing.assert_array_equal(
        read_pgm(tmp_path / "frames" / "iteration_2.ppm"),
        render_state(state, cfg).numpy())


def test_multi_frame_windows_equal_stride_one(tmp_path):
    """Six frames inside one 12-step window equal a run with a window a
    step, byte for byte, and so do the final states."""
    common = dict(save_images=True, save_image_every=2, total_iterations=12,
                  particle_count=64, img_width=64, img_height=64)
    cf = base(tmp_path / "f", log_every=12,
              image_path=str(tmp_path / "f" / "frames"), **common)
    c1 = base(tmp_path / "o", log_every=1,
              image_path=str(tmp_path / "o" / "frames"), **common)
    rf = run_simulation(cf, device="cpu", quiet=True)
    r1 = run_simulation(c1, device="cpu", quiet=True)
    assert (rf.windows, r1.windows) == (1, 12)
    names = sorted(os.listdir(tmp_path / "f" / "frames"))
    assert names == sorted(os.listdir(tmp_path / "o" / "frames"))
    assert names == sorted(f"iteration_{j}.ppm" for j in range(0, 12, 2))
    assert rf.frames_written == r1.frames_written == 6
    for nm in names:
        assert ((tmp_path / "f" / "frames" / nm).read_bytes()
                == (tmp_path / "o" / "frames" / nm).read_bytes()), nm
    for a, b in zip(rf.state[:4], r1.state[:4]):
        assert torch.equal(a, b)


def test_no_cadence_runs_to_completion(tmp_path):
    cfg = base(tmp_path, log_every=0, total_iterations=100)
    res = run_simulation(cfg, device="cpu", quiet=True)
    assert res.state.step == 100 and res.windows == 2    # 64 + 36
    assert not os.path.exists(cfg.log_path) or not logs(cfg)


def test_energy_logging_cadence(tmp_path):
    """energyEvery adds potential and total energy at its own cadence, the
    potential equal to nbodyax's driver's to rtol 1e-5."""
    kw = dict(log_every=5, energy_every=10, softening=50.0)
    cfg = base(tmp_path / "t", **kw)
    run_simulation(cfg, device="cpu", quiet=True)
    jcfg = base(tmp_path / "j", JaxConfig, backend="jnp", **kw)
    os.makedirs(tmp_path / "j", exist_ok=True)
    jax_run(jcfg, quiet=True)
    got = {r["step"]: r for r in logs(cfg)}
    want = {r["step"]: r for r in logs(jcfg)}
    assert sorted(got) == sorted(want) == [5, 10, 15, 20]
    for s in (5, 15):
        assert "potential_energy" not in got[s]
    for s in (10, 20):
        r = got[s]
        assert set(r) == set(want[s])
        np.testing.assert_allclose(r["potential_energy"],
                                   want[s]["potential_energy"], rtol=1e-5)
        assert abs(r["total_energy"] - (r["potential_energy"]
                                        + r["kinetic_energy"])) <= \
            1e-6 * max(abs(r["total_energy"]), 1.0)


@pytest.mark.parametrize("dim", [2, 3])
def test_potential_energy_matches_nbodyax(dim):
    """Dead bodies, a coincident pair (d = 0 is left out) and eps 0 or 30,
    over more rows than one chunk at N = 2,100."""
    rng = np.random.RandomState(7 + dim)
    for n in (60, 2100):
        pos = rng.uniform(-5000, 5000, (n, dim)).astype(np.float32)
        vel = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
        mass = rng.uniform(1e10, 1e17, n).astype(np.float32)
        mass[[3, 11]] = 0.0
        radius = rng.uniform(50, 200, n).astype(np.float32)
        pos[5] = pos[6]
        js = jstate.make_state(pos, vel, mass, radius)
        ts = from_numpy(jstate.to_numpy(js), "cpu")
        for eps in (0.0, 30.0):
            want = float(jmetrics.potential_energy(js, eps=eps))
            got = tmetrics.potential_energy(ts, eps=eps)
            assert got.dim() == 0 and got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_dt_mean_matches_nbodyax(tmp_path):
    """Under adaptiveDt every log line carries dt_mean, the mean dt since
    the last line, equal to nbodyax's to rtol 1e-5."""
    kw = dict(adaptive_dt=True, log_every=5, total_iterations=10,
              particle_count=64)
    cfg = base(tmp_path / "t", **kw)
    run_simulation(cfg, device="cpu", quiet=True)
    jcfg = base(tmp_path / "j", JaxConfig, backend="jnp", **kw)
    os.makedirs(tmp_path / "j", exist_ok=True)
    jax_run(jcfg, quiet=True)
    got, want = logs(cfg), logs(jcfg)
    assert [l["step"] for l in got] == [l["step"] for l in want] == [5, 10]
    t = 0.0
    for g, w in zip(got, want):
        assert g["sim_time"] > t
        assert 0.2 / 1024 * 0.99 <= g["dt_mean"] <= 0.2 * 1.01
        np.testing.assert_allclose(g["dt_mean"], w["dt_mean"], rtol=1e-5)
        np.testing.assert_allclose(g["sim_time"], w["sim_time"], rtol=1e-5)
        t = g["sim_time"]


def test_profile_writes_a_trace(tmp_path):
    cfg = base(tmp_path, total_iterations=4, particle_count=16)
    run_simulation(cfg, device="cpu", quiet=True,
                   profile_dir=str(tmp_path / "prof"))
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


@pytest.mark.parametrize("device,eager,graphs", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False),
    ("cpu", True, False)])
def test_runner_choice(device, eager, graphs):
    """Graph windows on a card, whatever the force model; the eager loop
    on the CPU and under the private ``_eager`` switch."""
    want = driver._GraphWindows if graphs else driver._EagerWindows
    assert driver._runner_class(torch.device(device), eager) is want


def test_bh_on_the_cpu_runs_eager_windows(tmp_path, monkeypatch):
    """A bh run on the CPU builds the eager runner, and only it."""
    built = []

    def refuse(*a, **k):
        raise AssertionError("a graph runner on the CPU")

    real = driver._EagerWindows.__init__

    def record(self, *a, **k):
        built.append(1)
        real(self, *a, **k)

    monkeypatch.setattr(driver._GraphWindows, "__init__", refuse)
    monkeypatch.setattr(driver._EagerWindows, "__init__", record)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = base(tmp_path, particle_count=64, total_iterations=4,
                   log_every=2, force_model="bh")
        res = run_simulation(cfg, device="cpu", quiet=True)
    finally:
        torch.set_num_threads(old)
    assert res.state.step == 4 and built == [1]
    assert [l["bh_overflow"] for l in logs(cfg)] == [0, 0]


def test_bh_probes_adapts_and_checkpoints_at_nbodyax_steps(
        tmp_path, capsys, monkeypatch, one_thread):
    """Fault F5: under bhAdapt a merging bh run probes ``bh_health`` after
    every window that ends off the log cadence while it drifts or once its
    live count fell by more than 0.5%, and drift mode clips windows to 16
    steps, as nbodyax's driver does. examples/galaxy_momentum.txt cut to
    2,048 bodies and 80 steps, with the rows engine at a K that the merger
    outgrows: both drivers run the same windows, probe, adapt and save
    checkpoints at the same steps, and the port's probes include one off
    the log cadence from a drop in the live count alone (it adapts there)
    and one from drift mode alone."""
    cfg = dataclasses.replace(
        parse_config_file(os.path.join(ROOT, "examples",
                                       "galaxy_momentum.txt")),
        particle_count=2048, total_iterations=80, log_every=25,
        checkpoint_every=16, checkpoint_keep=0, auto_resume=False,
        save_images=False, force_model="bh", bh_near="rows", bh_levels=3,
        bh_neighbor_k=40)
    probes = {"port": [], "nbodyax": []}

    def spy(mod, key):
        real = mod.bh_health

        def health(*a, **k):
            # the driver's iteration: its probe's ``at_step`` argument
            probes[key].append(sys._getframe(1).f_locals["at_step"])
            return real(*a, **k)
        monkeypatch.setattr(mod, "bh_health", health)

    spy(tbh, "port")
    spy(jbh, "nbodyax")
    causes = []
    real_probe = driver._BhProbe.probe

    def probe(self, c, s, alive_now, at_step, quiet):
        if at_step % c.log_every:
            causes.append((at_step, self.drift_mode,
                           self.dropping(alive_now)))
        return real_probe(self, c, s, alive_now, at_step, quiet)
    monkeypatch.setattr(driver._BhProbe, "probe", probe)

    def paths(d):
        return dict(checkpoint_path=str(tmp_path / d / "ck"),
                    log_path=str(tmp_path / d / "m.jsonl"))

    def saved(d):
        return sorted(int(f[5:14]) for f in os.listdir(tmp_path / d / "ck"))

    def adapts(out):
        return [int(m) for m in re.findall(r"bh adapt at step (\d+):", out)]

    scene = init_scene(cfg, device="cpu")
    capsys.readouterr()
    got = run_simulation(dataclasses.replace(cfg, **paths("t")),
                         device="cpu", state=scene)
    t_adapts = adapts(capsys.readouterr().out)
    want = jax_run(JaxConfig(**dict(dataclasses.asdict(cfg), backend="jnp",
                                    **paths("j"))),
                   state=jstate.make_state(*(x.numpy() for x in scene[:4])))
    j_adapts = adapts(capsys.readouterr().out)
    assert got.windows == want.windows
    assert probes["port"] == probes["nbodyax"]
    assert t_adapts == j_adapts
    assert saved("t") == saved("j")
    # not vacuous: an off-cadence probe from the drop alone adapts, and
    # one comes from drift mode alone
    dropped = [s for s, drift, drop in causes if drop and not drift]
    assert dropped and set(dropped) & set(t_adapts)
    assert [s for s, drift, drop in causes if drift and not drop]


def test_f9_bh_bootstrap_window_at_scale(tmp_path, monkeypatch, one_thread):
    """Fault F9: nbodyax's bh driver takes a first window of at most
    BOOTSTRAP_WINDOW_STEPS when its step is fresh (a start, a resume, a
    compaction's rebuild) at a capacity of 2^20 or more
    (nbodyax/driver.py:689-691), so its drift probe sees a merger from
    step 8; the port ran its first window to the first log point. Here the
    port's threshold is lowered to this run's 1,024 bodies: its first
    window, started and resumed, is 8 steps, and below the threshold it is
    the window to the log point, as in nbodyax."""
    import inspect

    from nbodyax import driver as jdriver
    assert driver.BOOTSTRAP_WINDOW_STEPS == jdriver.BOOTSTRAP_WINDOW_STEPS
    assert driver.BOOTSTRAP_MIN_CAPACITY == 1 << 20
    assert ("state.capacity >= (1 << 20)"
            in inspect.getsource(jdriver))
    windows = []
    advance = driver._EagerWindows.advance

    def spy(self, k, frames):
        windows.append((self.state.step, k))
        return advance(self, k, frames)

    monkeypatch.setattr(driver._EagerWindows, "advance", spy)
    cfg = SimConfig(particle_count=1024, scene="galaxy", softening=100.0,
                    force_model="bh", total_iterations=25, log_every=25,
                    checkpoint_every=25, checkpoint_keep=0,
                    checkpoint_path=str(tmp_path / "ck"), save_images=False)
    run_simulation(cfg, device="cpu", quiet=True)
    assert windows[0] == (0, 25)
    monkeypatch.setattr(driver, "BOOTSTRAP_MIN_CAPACITY", 1024)
    windows.clear()
    run_simulation(dataclasses.replace(
        cfg, checkpoint_path=str(tmp_path / "ck2")), device="cpu", quiet=True)
    assert windows[0] == (0, driver.BOOTSTRAP_WINDOW_STEPS)
    assert sum(k for _, k in windows) == 25
    windows.clear()
    run_simulation(dataclasses.replace(
        cfg, total_iterations=50, resume_from=str(
            tmp_path / "ck2" / "step_000000025.npz")), device="cpu",
        quiet=True)
    assert windows[0] == (25, driver.BOOTSTRAP_WINDOW_STEPS)


def test_f10_bh_probes_every_step_while_drifting_at_scale(
        tmp_path, monkeypatch, one_thread):
    """Fault F10: while a bh run at a capacity of 2^20 or more merges
    (drift mode), nbodyax's driver probed almost every step, because its
    wall-clock clip (MAX_WINDOW_SECONDS over a merger step's minute at 4M)
    cut its windows to one step; the port kept 16-step drift windows and a
    4M galaxy dropped merges between probes. Here the threshold is lowered
    to this run's 2,048 bodies (the merging scene of the F5 test above):
    every window that starts in drift mode is one step long, with a probe
    after it; below the threshold drift windows are longer, up to
    nbodyax's 16."""
    cfg = dataclasses.replace(
        parse_config_file(os.path.join(ROOT, "examples",
                                       "galaxy_momentum.txt")),
        particle_count=2048, total_iterations=60, log_every=25,
        save_images=False, force_model="bh", bh_near="rows", bh_levels=3,
        bh_neighbor_k=40)
    events = []
    advance, probe = driver._EagerWindows.advance, driver._BhProbe.probe

    def spy_advance(self, k, frames):
        events.append(("window", self.state.step, k))
        return advance(self, k, frames)

    def spy_probe(self, c, s, alive_now, at_step, quiet):
        out = probe(self, c, s, alive_now, at_step, quiet)
        events.append(("probe", at_step, self.drift_mode))
        return out

    monkeypatch.setattr(driver._EagerWindows, "advance", spy_advance)
    monkeypatch.setattr(driver._BhProbe, "probe", spy_probe)

    def drift_windows():
        events.clear()
        run_simulation(cfg, device="cpu", quiet=True)
        drift, probed, out = False, set(), []
        for kind, step, x in events:
            if kind == "probe":
                drift = x
                probed.add(step)
            elif drift:
                out.append((step, x))
        return out, probed

    below, _ = drift_windows()
    assert below and max(k for _, k in below) > 1
    assert max(k for _, k in below) <= driver.DRIFT_WINDOW_STEPS
    monkeypatch.setattr(driver, "BOOTSTRAP_MIN_CAPACITY", 2048)
    at_scale, probed = drift_windows()
    assert len(at_scale) > len(below)
    assert all(k == driver.SCALE_DRIFT_WINDOW_STEPS == 1
               for _, k in at_scale)
    assert all(s + 1 in probed for s, _ in at_scale
               if s + 1 < cfg.total_iterations)
