"""nbodyax_torch's 3-D steps against the benchmark's plain 3-D reference
(``perfbench/reference/reference_euler_3d.py``, the reference of the
configuration ``reference-bh-3d`` and its cell ``bh3d-million``), on
seeded random states on the CPU, held to the numbers the cell's check
computes (``perfbench.check.compare``):

- the exact 3-D step at N = 512, with merges and bodies on every wall, to
  float32 rounding;
- the bh 3-D step at N = 2,048, within the cell's limits (its ``dv`` is
  the FMM's error against exact forces);
- on a planar state (z = 0) the 3-D reference's rows are
  ``reference_euler_2d``'s, bit for bit;
- the bfloat16 control fails the cell's limits at the bh test's size.
"""

import numpy as np
import pytest
import torch

from nbodyax_torch.config import parse_config_text
from nbodyax_torch.driver import build_step, resolve_bh_config
from nbodyax_torch.state import make_state
from perfbench.check import compare, judge
from perfbench.spec import config_text, load_cell, load_module

REF3 = load_module("reference", "reference_euler_3d")
REF2 = load_module("reference", "reference_euler_2d")


@pytest.fixture
def one_thread():
    """Run torch on one thread: a CPU bh step is thousands of small ops,
    and beside the suite's other workers each op's thread pool contends
    with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_params(n, field, **kw):
    """The cell's configuration at ``n`` bodies in a cube of half-width
    ``field`` (``kw``: further keys)."""
    p = dict(load_cell("bh3d-million").params, particleCount=n,
             fieldWidth=field, fieldHeight=field)
    p.update(kw)
    return p


def state(n, seed, field, depth=None, dim=3, speed=5.0):
    """Seeded bodies uniform over the box, moving, with masses and radii
    over the cell's ranges; the first 6 sit just inside a wall each (x,
    y, z; low and high), where ``accel * dt`` can cross it."""
    g = np.random.default_rng(seed)
    half = np.array([field, field, depth or field][:dim])
    pos = g.uniform(-1, 1, (n, dim)) * half
    vel = g.uniform(-speed, speed, (n, dim))
    mass = g.uniform(1e4, 1e17, n)
    radius = g.uniform(50, 200, n)
    for i in range(min(2 * dim, n)):
        axis, side = i // 2, 1 - 2 * (i % 2)
        pos[i, axis] = side * (half[axis] - radius[i] - 0.25)
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (pos, vel, mass, radius))


def port_step(params, start):
    """One step of the port's own step function (``driver.build_step``,
    the knobs resolved as a run resolves them) from ``start``."""
    cfg = parse_config_text(config_text(params))
    s = make_state(*start, device="cpu")
    cfg = resolve_bh_config(cfg, s)
    out = build_step(cfg, "cpu")(s)
    return tuple(out[:4]), cfg


def numbers(params, start, nxt, rows=None, precision="reference"):
    rows = torch.arange(start[0].shape[0]) if rows is None else rows
    ref = REF3.step(*start, rows, params, precision=precision)
    field = max(float(params["fieldWidth"]), float(params["fieldHeight"]))
    return compare(start, nxt, ref, rows, field)


@pytest.mark.parametrize("depth", [0, 2000])
def test_exact_3d_step_equals_the_reference_to_float32_rounding(
        depth, one_thread):
    """The exact step (the port's all-pairs oracle) from a merging state
    with a body on each wall, z walls at ``fieldDepth`` or, at 0,
    ``fieldWidth``. Tolerances: ``collide`` 2^-22 (two float32 ulps
    relative): both sides test overlap with the same float32 expression,
    so they agree on every contact, and a body here absorbs one or two
    partners, each float32 add rounding once where the reference rounds
    its float64 sum once (readings 0 and 1.05e-7); ``dv`` 1e-5, since the port sums 512 float32 force terms
    where the reference sums in float64 (readings 1e-7 to 1e-6); ``dx``
    one float32 ulp of the largest coordinate over the field (2.4e-4 /
    3,000)."""
    p = cell_params(512, 3000.0, forceModel="exact", fieldDepth=depth)
    start = state(512, 22, 3000.0, depth or None)
    nxt, _ = port_step(p, start)
    got = numbers(p, start, nxt)
    assert (start[2] > 0).sum() > (nxt[2] > 0).sum()      # merges happened
    assert got["collide"] <= 2.0 ** -22, got
    assert got["dv"] <= 1e-5, got
    assert got["dx"] <= float(np.spacing(np.float32(3000))) / 3000, got
    # the walls flipped: every wall body moves inward on its axis
    for i in range(6):
        axis, side = i // 2, 1 - 2 * (i % 2)
        if nxt[2][i] > 0:
            assert side * float(nxt[1][i, axis]) < 0


def test_bh_3d_step_is_inside_the_cells_limits(one_thread):
    """The bh step at N = 2,048 (bhLevels pinned at 3, so the far field
    beyond the 27-cell near window carries the FMM's error; the other
    knobs auto) against the exact reference: inside every limit of
    ``bh3d-million``'s check, whose ``dv`` is set for FMM against exact
    forces."""
    p = cell_params(2048, 20000.0, bhLevels=3)
    start = state(2048, 23, 20000.0)
    nxt, cfg = port_step(p, start)
    assert cfg.bh_levels == 3 and cfg.force_model == "bh"
    got = numbers(p, start, nxt)
    limits = load_cell("bh3d-million").check["limits"]
    verdicts = judge(got, {k: v for k, v in limits.items() if k in got})
    assert all(ok for _, _, ok in verdicts.values()), verdicts
    assert got["dv"] > 1e-6            # the FMM's error is there to see


def test_planar_state_rows_equal_the_2d_reference():
    """On a planar state (z = 0, no z velocity) the 3-D reference's rows
    are ``reference_euler_2d``'s bit for bit, with z = 0: the extra axis
    adds +0 to every squared distance and no force."""
    n = 384
    pos2, vel2, mass, radius = state(n, 24, 3000.0, dim=2)
    pos3 = torch.cat([pos2, torch.zeros(n, 1)], 1)
    vel3 = torch.cat([vel2, torch.zeros(n, 1)], 1)
    rows = torch.arange(0, n, 3)
    p = cell_params(n, 3000.0)
    p2 = dict(p, dimensions=2)
    a = REF3.step(pos3, vel3, mass, radius, rows, p)
    b = REF2.step(pos2, vel2, mass, radius, rows, p2)
    assert (b[2] == 0).any()                          # a body died
    assert torch.equal(a[0][:, :2], b[0]) and torch.equal(a[1][:, :2], b[1])
    assert not a[0][:, 2].any() and not a[1][:, 2].any()
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


def test_the_bfloat16_control_fails_the_cells_limits():
    """The control, the reference in bfloat16 in the program's place, at
    the bh test's size and scene: at least one of the cell's limits
    fails (positions of 2e4 keep 8 bits in bfloat16)."""
    p = cell_params(2048, 20000.0)
    start = state(2048, 25, 20000.0)
    rows = torch.arange(0, 2048, 4)
    ctrl = REF3.step(*start, rows, p, precision="control")
    whole = [t.clone() for t in start]
    for w, c in zip(whole, ctrl):
        w[rows] = c
    got = numbers(p, start, whole, rows)
    limits = load_cell("bh3d-million").check["limits"]
    fails = [k for k, (_, _, ok) in judge(
        got, {k: v for k, v in limits.items() if k in got}).items()
        if not ok]
    assert fails, got


def test_the_reference_refuses_other_physics_and_runs_without_tf32(
        monkeypatch):
    """Both TF32 switches are off while the reference computes, and back
    as they were after; a 2-D state or 2-D physics is refused."""
    p = cell_params(8, 3000.0)
    start = state(8, 26, 3000.0)
    with pytest.raises(ValueError, match="dimensions"):
        REF3.step(*start, torch.arange(8), dict(p, dimensions=2))
    with pytest.raises(ValueError, match="3-D"):
        REF3.step(*state(8, 26, 3000.0, dim=2), torch.arange(8), p)
    seen, chunk = [], REF3._chunk

    def spy(*a):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return chunk(*a)
    monkeypatch.setattr(REF3, "_chunk", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    REF3.step(*start, torch.arange(8), p)
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
