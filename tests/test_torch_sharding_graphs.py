"""The sharded graph windows (``driver._ShardedGraphWindows``) on the CPU.

On a card a sharded window is one replay of a CUDA graph that holds the
NCCL collectives. The CPU has no graphs, so here each window's graph is
stood in for by its body (``_ShardedGraphWindows.body``, what the capture
records), run where a replay would run it, on two gloo ranks (one spawn
for the module, each rank on one thread), with the capture-side code path
taken: ``graph_if.run_if`` in its capture form, with the IF node stubbed
(the stub decides on the predicate as the card would, by a read of its
own). While a body runs, every host read of a tensor raises. For the
exact ring in reference mode, momentum mode with adaptive dt (the minimum
over ranks), elastic mode and leapfrog, and for the cell-range bh step:

- (a) no window body reads a tensor back to the host;
- (b) a stride window with frames (the body alone, 4 steps, a frame every
  2) and a window of one-step graphs (``advance`` over 3 steps, frames
  rendered from ``full`` between replays) equal ``_ShardedWindows.advance``
  bit for bit: this rank's rows, ``full``, the conservation vector and
  rank 0's frames;
- (c) no collective runs inside a bh IF body, and both ranks take the same
  collectives in the same order;
- suite config 5 runs sharded (cut to 1,024 bodies), its bh step bitwise
  the single-device one;
- a failed run closes its graph runner, and a failed rank aborts its NCCL
  group rather than destroying it: NCCL tears a communicator down only
  once every graph that captured its collectives is gone, and a 4-card
  launch whose rank 1 raised between replays hung on its way out.

The card's form (a one-rank NCCL group, graph against eager against one
card) is ``test_one_rank_nccl_graph_windows`` and ``chip_smoke.py`` phase
41.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
# case -> config overrides (the 64-body scene merges within a few steps)
CASES = {
    "reference": {},
    "momentum-adaptive-dt": {"collision_mode": "momentum",
                             "adaptive_dt": True},
    "elastic": {"collision_mode": "elastic"},
    "leapfrog": {"integrator": "leapfrog"},
    "bh": {"force_model": "bh", "particle_count": 256,
           "bh_near": "rows", "bh_comp_cap": 1024},
}
RING = [c for c in CASES if c != "bh"]
WINDOWS = [(c, "stride") for c in RING] + [(c, "one_step") for c in CASES]

CHILD = r"""
import contextlib, json, sys
import numpy as np, torch, torch.distributed as dist
rank, size, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=size)
from nbodyax_torch import driver
from nbodyax_torch.config import SimConfig
from nbodyax_torch.metrics import conservation_vec
from nbodyax_torch.physics import graph_if
from nbodyax_torch.scenes import init_scene
from nbodyax_torch.sharding import make_group, mesh, pad_to_shards
g = make_group(size, "cpu")
cases = json.loads(sys.argv[5])
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
              "__float__", "__index__")
item = torch.Tensor.item
log = {"collectives": [], "in_body": [], "ifs": 0, "host_reads": []}
flags = {"in_body": False}

def track(name, fn):
    def call(*a, **k):
        log["collectives"].append(name)
        if flags["in_body"]:
            log["in_body"].append(name)
        return fn(*a, **k)
    return call

mesh._all_gather = track("all_gather", mesh._all_gather)
mesh._reduce_scatter = track("reduce_scatter", mesh._reduce_scatter)
dist.all_reduce = track("all_reduce", dist.all_reduce)
dist.batch_isend_irecv = track("shift", dist.batch_isend_irecv)

def if_node(pred, body):
    # the IF node: the card decides on pred, the step does not read it
    log["ifs"] += 1
    if item(pred):
        flags["in_body"] = True
        try:
            body()
        finally:
            flags["in_body"] = False

@contextlib.contextmanager
def capture_side():
    # run_if in its capture form, and every host read of a tensor refused
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}
    def refuse(name):
        def read(*a, **k):
            log["host_reads"].append(name)
            raise AssertionError(f"host read {name} in a window body")
        return read
    old = graph_if._capturing, graph_if._capture_if
    graph_if._capturing, graph_if._capture_if = (lambda pred: True), if_node
    for n in HOST_READS:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        graph_if._capturing, graph_if._capture_if = old

def graph_runner(step, full, cfg, stride):
    # _ShardedGraphWindows whose graphs are their bodies, run at replay
    r = driver._ShardedGraphWindows(step, full, cfg, 2, stride, None, g)
    def capture(k, frames):
        vec = torch.empty_like(conservation_vec(r.full))
        fbuf = (torch.empty((-(-k // r.k_img), cfg.img_height, cfg.img_width),
                            dtype=torch.uint8) if frames and r.renders else None)
        class Graph:
            def replay(self):
                with capture_side():
                    r.body(k, frames, vec, fbuf)
        return Graph(), vec, fbuf, [0] * 5, None
    r._capture = capture
    return r

def same(a, b):
    return bool(torch.equal(a, b))

def states_equal(a, b):
    return {f: same(x, y) for f, x, y in zip(
        ("pos", "vel", "mass", "radius", "sim_time"), (*a[:4], a.sim_time),
        (*b[:4], b.sim_time))}

out = {}
for name, over in cases.items():
    cfg = SimConfig(**{**dict(particle_count=64, field_width=5000,
                              field_height=5000, img_width=32, img_height=32,
                              save_image_every=2, shards=size), **over})
    full = pad_to_shards(init_scene(cfg, device="cpu"), size)
    cfg = driver.resolve_bh_config(cfg, full)
    step = driver.build_step(cfg, "cpu", g)
    res = {}
    windows = (("one_step", 3),) if cfg.force_model == "bh" else (
        ("stride", 4), ("one_step", 3))
    for window, k in windows:
        mark = len(log["collectives"])
        ifs = log["ifs"]
        e = driver._ShardedWindows(step, full, cfg, 2, g)
        vec_e, frames_e = e.advance(k, True)
        eager_calls = log["collectives"][mark:]
        mark = len(log["collectives"])
        r = graph_runner(step, full, cfg, k if window == "stride" else 4)
        try:
            if window == "stride":
                vec = torch.empty_like(vec_e)
                fbuf = (torch.empty((2, cfg.img_height, cfg.img_width),
                                    dtype=torch.uint8) if rank == 0 else None)
                with capture_side():
                    r.body(k, True, vec, fbuf)
                frames = [] if fbuf is None else [(2 * m, fbuf[m])
                                                   for m in range(2)]
            else:
                vec, fl = r.advance(k, True)
                frames = [(it, img) for it, img, _ in fl]
            err = None
        except AssertionError as exc:
            err = str(exc)
        row = {"error": err, "host_reads": list(log["host_reads"]),
               "graph_collectives": log["collectives"][mark:],
               "eager_collectives": eager_calls,
               "ifs": log["ifs"] - ifs, "in_body": list(log["in_body"])}
        log["host_reads"].clear()
        if err is None:
            row["state"] = states_equal(r.buf, e.state)
            row["full"] = states_equal(r.full, e.full)
            row["vec"] = same(vec, vec_e)
            row["frames"] = ([it for it, _ in frames]
                             == [it for it, _, _ in frames_e]
                             and all(same(a, b) for (_, a), (_, b, _)
                                     in zip(frames, frames_e)))
            row["frame_steps"] = [it for it, _ in frames]
            row["steps"] = [r.buf.step if window == "one_step" else k,
                            e.state.step]
        res[window] = row
    out[name] = res
# suite config 5 sharded (a torchrun launch's work), cut to 1,024 bodies
from nbodyax_torch import bench_suite
line, st = bench_suite.config5_galaxy_4m(torch.device("cpu"), n=1024, steps=1,
                                         exact_steps=1, group=g)
scene = dict(particle_count=1024, scene="galaxy", collision_mode="reference",
             softening=100.0)
one = bench_suite._bh_run(torch.device("cpu"), 1, **scene)[1]
out["config5"] = {"line": line, "bh_equal": all(
    same(a, b) for a, b in zip(st["bh"][:4], one[:4])),
    "exact_step": st["exact"].step, "exact_rows": st["exact"].capacity}
with open(f"{work}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's rows of results, from one two-rank gloo spawn."""
    work = tmp_path_factory.mktemp("sharded_graphs")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(RANKS),
         str(work / "store"), str(work), json.dumps(CASES)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(RANKS)]


@pytest.mark.parametrize("case", list(CASES))
def test_window_bodies_read_nothing_back(ranks, case):
    """(a) Every window body of the case ran with host reads refused."""
    for res in ranks:
        for window, row in res[case].items():
            assert row["error"] is None and not row["host_reads"], (
                window, row["error"], row["host_reads"])


@pytest.mark.parametrize("case,window", WINDOWS,
                         ids=[f"{c}-{w}" for c, w in WINDOWS])
def test_graph_window_equals_the_eager_window(ranks, case, window):
    """(b) The graph runner's window equals ``_ShardedWindows.advance``
    bit for bit on every rank; rank 0 renders the frames, the others
    none."""
    for rank, res in enumerate(ranks):
        row = res[case][window]
        assert row["error"] is None, row["error"]
        assert all(row["state"].values()), row["state"]
        assert all(row["full"].values()), row["full"]
        assert row["vec"]
        assert row["frames"], row["frame_steps"]
        assert row["frame_steps"] == ([0, 2] if rank == 0 else [])
        assert row["steps"][0] == row["steps"][1]


def test_no_collective_inside_an_if_body(ranks):
    """(c) The bh step's gathers and reduce_scatter stay outside every IF
    body: its tiers opened IF nodes, the windows ran collectives, none
    of them inside a body."""
    for res in ranks:
        row = res["bh"]["one_step"]
        assert row["ifs"] > 0
        assert {"all_gather", "reduce_scatter"} <= set(
            row["graph_collectives"])
        assert row["in_body"] == []


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_takes_the_same_collectives(ranks, case):
    """Both ranks' windows call the same collectives in the same order, in
    the graph runner as in the eager one; the ring shifts its tiles."""
    for window in ranks[0][case]:
        a, b = (res[case][window] for res in ranks)
        assert a["graph_collectives"] == b["graph_collectives"]
        assert a["eager_collectives"] == b["eager_collectives"]
        if case != "bh":
            assert "shift" in a["graph_collectives"]


def test_suite_config5_runs_sharded(ranks):
    """Suite config 5 under a shard group (cut to 1,024 bodies): the
    sharded line of each rank, with the whole states; its bh step ends
    bit for bit on the single-device bh step's state."""
    for res in ranks:
        c5 = res["config5"]
        line = c5["line"]
        assert line["shards"] == RANKS and line["finite"] is True
        assert "sharded over 2 ranks" in line["workload"]
        for key in ("steps_per_sec", "exact_steps_per_sec",
                    "exact_step_ms_median", "step_ms_median"):
            assert line[key] > 0
        assert "ring_dryrun_8dev_ok" not in line
        assert c5["bh_equal"]
        assert (c5["exact_step"], c5["exact_rows"]) == (2, 1024)


@pytest.mark.parametrize("backend,failed,want", [
    ("nccl", True, ["abort"]), ("nccl", False, ["destroy"]),
    ("gloo", True, ["destroy"]), ("gloo", False, ["destroy"])])
def test_close_group_aborts_a_failed_nccl_group(monkeypatch, backend, failed,
                                                want):
    """A rank that fails leaves an NCCL group by aborting it, so that it
    waits for no peer stuck in a replay; a run that ends well, and gloo,
    destroy it."""
    import torch.distributed.distributed_c10d as c10d

    from nbodyax_torch.sharding import mesh
    calls = []
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh.dist, "get_backend", lambda: backend)
    monkeypatch.setattr(mesh.dist, "destroy_process_group",
                        lambda: calls.append("destroy"))
    monkeypatch.setattr(c10d, "_abort_process_group",
                        lambda: calls.append("abort"))
    mesh.close_group(failed)
    assert calls == want


def test_a_failed_run_closes_its_graph_runner(monkeypatch):
    """A run that fails lets its graphs go before it raises: NCCL destroys
    or aborts a communicator only once every graph holding its collectives
    is gone, and a rank whose traceback kept them hung on its way out.
    Here the graph runner stands on the CPU, where its first capture
    fails."""
    from nbodyax_torch import driver
    from nbodyax_torch.config import SimConfig
    closed = []
    monkeypatch.setattr(driver, "_runner_class",
                        lambda dev, eager: driver._GraphWindows)
    monkeypatch.setattr(driver._GraphWindows, "close",
                        lambda self: closed.append(self))
    with pytest.raises(Exception):
        driver.run_simulation(SimConfig(particle_count=64, save_images=False,
                                        total_iterations=4), device="cpu",
                              quiet=True)
    assert len(closed) == 1 and isinstance(closed[0], driver._GraphWindows)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


ONE_RANK_CHILD = r"""
import dataclasses, json, os, sys
import torch
sys.path.insert(0, sys.argv[1])
from nbodyax_torch import driver
from nbodyax_torch.config import SimConfig
from nbodyax_torch.sharding import make_group
g = make_group(1, "cuda")
out = {}
for name, over in (("exact", {}), ("bh", {"force_model": "bh"})):
    cfg = SimConfig(particle_count=4096, total_iterations=24,
                    save_images=False, checkpoint_every=0, log_every=8,
                    **over)
    runs = {
        "sharded_graph": driver.run_simulation(cfg, device="cuda",
                                               quiet=True, _group=g),
        "sharded_eager": driver.run_simulation(cfg, device="cuda", quiet=True,
                                               _group=g, _eager=True),
        "one_card": driver.run_simulation(cfg, device="cuda", quiet=True)}
    ref = runs["one_card"].state
    out[name] = {k: all(torch.equal(a, b) for a, b in zip(r.state[:4], ref[:4]))
                 for k, r in runs.items()}
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_one_rank_nccl_graph_windows(cuda, tmp_path):
    """On a card, a one-rank NCCL group: the sharded graph windows, the
    sharded eager windows and the single-device graph windows end on the
    same state bit for bit, exact and bh."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(29500 + os.getpid() % 1000))
    r = subprocess.run([sys.executable, "-c", ONE_RANK_CHILD, ROOT],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert all(all(v.values()) for v in res.values()), res
