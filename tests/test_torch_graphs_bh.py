"""``forceModel=bh`` through CUDA-graph windows against the eager runner,
on a card.

The bh step reads nothing back to the host: its completion and giant
budgets are static lists under tiers, and each tier is a CUDA-graph IF node
under a capture (``physics/graph_if.py``). Graph windows must equal eager
windows bit for bit (final state, every log value but the timings, every
frame) in 2-D and 3-D, on states that reach each completion tier (none,
the first 1,024 entries, the whole list) and the giant tiers, across a
bhAdapt knob change and across compactions (each old runner's graphs and
IF-body pools gone after its close), with B3 and B5 launched once a step
as the replays count them. A step that reads the card from the host
cannot be captured, and the run raises.

These tests need a CUDA card and skip without one. The file imports
neither JAX nor nbodyax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_graphs_bh.py
"""

import json
import os
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch import driver  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch.physics import bh_grid  # noqa: E402
from nbodyax_torch.physics.near_kernel import slots_near  # noqa: E402
from nbodyax_torch.physics.slotpack_kernel import pack_slots  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402

pytestmark = pytest.mark.cuda
TIMINGS = ("wall_ms", "steps_per_sec", "equivalent_pairs_per_sec")
FIELD = 40000.0
LEVELS = {2: 5, 3: 3}
# crowded bodies in one cell, giants, bhCompCap
KINDS = {"clean": (0, 0, 0), "small": (300, 0, 0), "full": (1400, 0, 2048),
         "giants": (0, 12, 0), "many_giants": (0, 100, 0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def arrays(kind, dim, n=8192, seed=7, crowd=None):
    crowd = KINDS[kind][0] if crowd is None else crowd
    giants = KINDS[kind][1]
    rng = np.random.RandomState(seed + dim)
    pos = rng.uniform(-FIELD, FIELD, (n, dim)).astype(np.float32)
    pos[:crowd] = rng.uniform(200, 1200, (crowd, dim)).astype(np.float32)
    vel = rng.uniform(-5, 5, (n, dim)).astype(np.float32)
    mass = rng.uniform(1e4, 1e9, n).astype(np.float32)
    radius = rng.uniform(1, 20, n).astype(np.float32)
    mass[rng.rand(n) < 0.05] = 0.0
    if giants:
        idx = rng.choice(np.arange(crowd, n), giants, replace=False)
        radius[idx] = rng.uniform(9000, 15000, giants).astype(np.float32)
        mass[idx] = 1e12
    return pos, vel, mass, radius


def config(tmp_path, name, dim, kind, **kw):
    d = dict(particle_count=8192, total_iterations=12, field_width=FIELD,
             field_height=FIELD, log_every=4, save_image_every=2,
             img_width=64, img_height=64, dimensions=dim, force_model="bh",
             bh_levels=LEVELS[dim], bh_near="slots", bh_neighbor_k=40,
             bh_comp_cap=KINDS[kind][2],
             image_path=str(tmp_path / name / "frames"),
             log_path=str(tmp_path / name / "log.jsonl"))
    d.update(kw)
    return SimConfig(**d)


def run(cfg, eager, a):
    """The run of ``cfg`` from the arrays ``a``; (result, logs without
    the timings, frames, (B3, B5) launches)."""
    slots_near.launches = pack_slots.moment_launches = 0
    res = driver.run_simulation(cfg, device="cuda", quiet=True,
                                state=make_state(*a, device="cuda"),
                                _eager=eager)
    with open(cfg.log_path) as f:
        logs = [{k: v for k, v in json.loads(line).items()
                 if k not in TIMINGS} for line in f]
    frames = {}
    if cfg.save_images and os.path.isdir(cfg.image_path):
        for nm in os.listdir(cfg.image_path):
            with open(os.path.join(cfg.image_path, nm), "rb") as f:
                frames[nm] = f.read()
    return res, logs, frames, (slots_near.launches,
                               pack_slots.moment_launches)


def assert_same_run(g, e):
    (gr, g_logs, g_frames, _), (er, e_logs, e_frames, _) = g, e
    for x, y in zip(gr.state[:4], er.state[:4]):
        assert torch.equal(x, y)
    assert torch.equal(gr.state.sim_time, er.state.sim_time)
    assert g_logs == e_logs and g_frames == e_frames
    assert gr.capacities == er.capacities


def tier_reached(a, dim, comp_cap):
    """(completion-list entries that are real, list length, qualifying
    giants) of the starting state, read on the host."""
    t = [torch.from_numpy(x) for x in a]
    n = t[0].shape[0]
    g = 1 << LEVELS[dim]
    ncells = g ** dim
    ext = bh_grid._extent(t[0], t[2] > 0)
    _, s_cell, starts, _, _ = bh_grid._partner_structure(*t, ext, g, False)
    over = tbh._over_slots(s_cell, starts, ncells, tbh.slot_cap(n, ncells))
    ps = tbh._completion_list(over, n, comp_cap)
    key = tbh._giant_key(t[2], t[3], ext, LEVELS[dim], 1)
    return int((ps < n).sum()), ps.shape[0], int((key > 0).sum())


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dim", [2, 3])
def test_bh_graph_windows_equal_eager(cuda, tmp_path, dim, kind):
    a = arrays(kind, dim)
    real, length, giants = tier_reached(a, dim, KINDS[kind][2])
    want_tier = {"clean": real == 0, "small": 0 < real <= 1024,
                 "full": real > 1024 and length > 1024,
                 "giants": 0 < giants <= 64 and real == 0,
                 "many_giants": giants > 64}
    assert want_tier[kind], (real, length, giants)
    g = run(config(tmp_path, "g", dim, kind), False, a)
    e = run(config(tmp_path, "e", dim, kind), True, a)
    assert_same_run(g, e)
    assert len(g[2]) == 6
    assert g[3] == e[3] == (12, 12)    # B3 and B5 once a step, by replays


def test_bh_across_a_knob_change_and_compactions(cuda, tmp_path,
                                                 monkeypatch):
    """A patch of small bodies overflows K = 40, so bhAdapt widens K; the
    large bodies around it merge, and the run compacts. Each change
    replaces the graph runner: its graphs and their IF-body pools are gone
    after its close. A probe off the log cadence can adapt at the window's
    end where the run then compacts, as nbodyax's driver does: that runner
    is closed before its first window and holds no graph."""
    closed, knobs = [], []
    real_close = driver._GraphWindows.close
    real_init = driver._GraphWindows.__init__

    def init(self, step, state, cfg, *a, **k):
        knobs.append((state.capacity, cfg.bh_neighbor_k))
        real_init(self, step, state, cfg, *a, **k)

    def close(self):
        graphs = [g[0] for g in self.graphs.values()]
        pools = ({tuple(g.pool()) for g in graphs}
                 | {tuple(g[4].pool) for g in self.graphs.values()})
        refs = [weakref.ref(g) for g in graphs]
        del graphs
        real_close(self)
        kept = {tuple(seg["segment_pool_id"])
                for seg in torch.cuda.memory_snapshot()} & pools
        closed.append((len(refs), [r() for r in refs], kept))

    monkeypatch.setattr(driver._GraphWindows, "close", close)
    monkeypatch.setattr(driver._GraphWindows, "__init__", init)
    a = arrays("full", 2, n=4096)
    rng = np.random.RandomState(3)
    a[3][:1400] = rng.uniform(1, 3, 1400)         # the patch stays crowded
    a[3][1400:] = rng.uniform(600, 1500, 4096 - 1400)   # the rest merges
    kw = dict(particle_count=4096, total_iterations=40, log_every=5,
              compact_every=10, bh_levels=4)
    g = run(config(tmp_path, "g", 2, "full", **kw), False, a)
    e = run(config(tmp_path, "e", 2, "full", **kw), True, a)
    assert_same_run(g, e)
    assert g[0].capacities, "no compaction"
    assert g[3] == e[3] == (40, 40)
    # runners by (capacity, K): a knob change keeps the capacity, a
    # compaction changes it
    pairs = list(zip(knobs, knobs[1:]))
    assert any(a[0] == b[0] and a[1] != b[1] for a, b in pairs), knobs
    assert any(a[0] != b[0] for a, b in pairs), knobs
    assert len(closed) == len(knobs) - 1
    assert any(n_graphs for n_graphs, _, _ in closed)
    for n_graphs, alive, kept in closed:
        assert alive == [None] * n_graphs and not kept


def test_a_host_read_in_the_bh_step_fails_the_capture(cuda, tmp_path,
                                                      monkeypatch):
    real = tbh._Tiers.__init__

    def reading(self, ps, n):
        real(self, ps, n)
        int((ps < n).sum())

    monkeypatch.setattr(tbh._Tiers, "__init__", reading)
    with pytest.raises(driver.GraphCaptureError):
        driver.run_simulation(config(tmp_path, "x", 2, "small",
                                     save_images=False),
                              device="cuda", quiet=True,
                              state=make_state(*arrays("small", 2),
                                               device=cuda))
