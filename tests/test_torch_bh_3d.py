"""nbodyax_torch's forceModel=bh in 3-D (``dimensions=3``), stage by stage,
against nbodyax on the CPU.

The same numpy-made inputs go through each nbodyax function and its port at
``dim = 3``: the partner structure and the slot grid at L = 7 and L = 10
(exact), the 10 finest moments (2e-6 of the per-channel scale, the gate of
tests/test_barneshut.py:803), the level grids and the M2L ``conv3d`` (2e-6
of the scale, test_barneshut.py:680), the L2L shift, the local-expansion
table, the slot-side L2P and the annulus (2e-5 of the scale,
test_barneshut.py:473), the chunked annulus against the unchunked one (bit
for bit), ``bhFar=direct``'s 216-cell window path at levels 4, the knob
heuristics and the health terms (equal integers), and the guards of the
kernel wrappers. The near field is in
test_torch_bh_3d_near.py; the whole ``bh_accumulators``, the giant pass and
the CLI are in test_torch_bh_3d_slice.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch.physics import bh_grid, fmm  # noqa: E402
from nbodyax_torch.physics.near_kernel import (  # noqa: E402
    NEAR_MAX_CAP, NEAR_WARPS, SHARED_LIMIT, near_plan, slots_near)
from nbodyax_torch.physics.slotpack_kernel import (  # noqa: E402
    MOMENT_CHUNK, build_slot_grid_reference, finest_moments_reference,
    moment_plan, num_moments, pack_slots)
from test_torch_bh_stages import (both_ext, rel_err, state,  # noqa: E402
                                  structures)

EXT_J = ((-1e5,) * 3, (2e5,) * 3)
EXT_T = tuple(tuple(torch.tensor(v, dtype=torch.float32) for v in x)
              for x in EXT_J)


@pytest.mark.parametrize("hot", [None, "mid"])
@pytest.mark.parametrize("need_vel", [False, True])
def test_partner_structure_3d_exact(hot, need_vel):
    """Gate: extent, order, sorted cells, starts/ends and the L = 7 or 10
    rows all exact."""
    arrays = state(2048, 1, hot=hot, dim=3)
    (je, js), (te, ts) = structures(arrays, 3, need_vel)
    for a, b in zip(je, te):
        for x, y in zip(a, b):
            assert float(x) == float(y)
    assert ts[4].shape[1] == (10 if need_vel else 7)
    for name, a, b in zip(("order", "s_cell", "starts", "ends", "sf"), js,
                          ts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("n,levels,S,hot,need_vel", [
    (2048, 3, 8, None, False),      # L = 7, cells past S
    (2048, 3, 40, "mid", False),    # a crowded cell
    (2048, 2, 80, "last", True),    # L = 10 (elastic rows), hot last cell
])
def test_slot_pack_plain_3d_matches_nbodyax(n, levels, S, hot, need_vel):
    """The plain versions behind B4 and B5 in 3-D: rows bitwise equal to
    ``_build_slot_grid``, the 10 moments within 2e-6 x max(per-channel
    scale, 1) of ``_finest_moments_scatter``, in its column order; the CPU
    wrapper returns the same and counts no launch."""
    arrays = state(n, 7, field=1e5, hot=hot, dim=3, big=True)
    (je, js), (te, ts) = structures(arrays, levels, need_vel)
    ncells = (1 << levels) ** 3
    want = np.asarray(jbh._build_slot_grid(js[4], js[2], js[3], n, ncells, S))
    got = build_slot_grid_reference(ts[4], ts[2], ts[3], n, ncells, S)
    np.testing.assert_array_equal(got.numpy(), want)
    pos, _, mass, _ = arrays
    jm = np.asarray(jbh._finest_moments_scatter(jnp.asarray(pos),
                                                jnp.asarray(mass), je,
                                                levels))
    tpos, tmass = torch.from_numpy(pos), torch.from_numpy(mass)
    tm = finest_moments_reference(tpos, tmass, te, levels).numpy()
    assert tm.shape == jm.shape == (ncells, 10)
    scale = np.maximum(np.abs(jm).max(axis=0), 1.0)
    assert (np.abs(tm - jm).max(axis=0) <= 2e-6 * scale).all()
    before = (pack_slots.launches, pack_slots.moment_launches)
    rows, mom = pack_slots(ts[4], ts[2], ts[3], S,
                           moments=(tpos, tmass, te, levels))
    assert torch.equal(rows, got) and np.array_equal(mom.numpy(), tm)
    assert torch.equal(pack_slots(ts[4], ts[2], ts[3], S), got)
    assert (pack_slots.launches, pack_slots.moment_launches) == before


@pytest.mark.parametrize("order", [1, 2])
def test_level_grids_3d(order):
    """Every level's channels (4 at order 1, 10 at order 2) within 2e-6 of
    the per-channel scale."""
    pos, _, mass, _ = state(2048, 3, field=1e5, dim=3, big=True)
    je, te = both_ext(pos, mass)
    jg = jbh._level_grids(jnp.asarray(pos), jnp.asarray(mass), je, 3, order)
    tg = fmm._level_grids(torch.from_numpy(pos), torch.from_numpy(mass), te,
                          3, order)
    assert sorted(jg) == sorted(tg) == [2, 3]
    for lv in jg:
        assert len(tg[lv]) == len(jg[lv]) == (4 if order == 1 else 10)
        for a, b in zip(jg[lv], tg[lv]):
            assert rel_err(b.numpy(), a) < 2e-6, lv


@pytest.mark.parametrize("ring", [1, 2])
@pytest.mark.parametrize("order", [1, 2])
def test_m2l_level_conv_3d(ring, order):
    """The parent-folded ``conv3d`` (8 parity classes, a (2 ring + 1)^3
    stencil) against nbodyax's, 2e-6 of the scale (the gate nbodyax holds
    its conv to its scan form)."""
    rng = np.random.RandomState(7)
    s, n_src = 8, 10
    packed = (rng.normal(size=(s ** 3, n_src)) * 1e3).astype(np.float32)
    a = np.asarray(jbh._m2l_level_conv(jnp.asarray(packed), s, EXT_J,
                                       100.0 ** 2, ring, 3, order, 3))
    b = fmm._m2l_level_conv(torch.from_numpy(packed), s, EXT_T, 1e4, ring,
                            3, order, 3).numpy()
    assert a.shape == b.shape == (s ** 3, 34)
    assert rel_err(b, a) < 2e-6


def test_m2l_level_conv_restores_the_tf32_switches():
    """The convolution runs with TF32 off and leaves both switches as it
    found them."""
    packed = torch.ones((4 ** 3, 10))
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fmm._m2l_level_conv(packed, 4, EXT_T, 1e4, 1, 3, 2, 3)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with fmm._no_tf32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
    assert torch.backends.cudnn.allow_tf32 == before[1]
    with pytest.raises(ValueError, match="2 or 3 dimensions"):
        fmm._m2l_level_conv(torch.ones((16, 3)), 4, EXT_T, 1e4, 1, 1, 1, 3)


def test_l2l_3d():
    """The shift of parent expansions to their 8 children: 2e-6 of the
    scale."""
    rng = np.random.RandomState(3)
    loc = rng.normal(size=(4 ** 3, 34)).astype(np.float32)
    a = np.asarray(jbh._l2l(jnp.asarray(loc), 4, 3, EXT_J, 3))
    b = fmm._l2l(torch.from_numpy(loc), 4, 3, EXT_T, 3).numpy()
    assert a.shape == b.shape == (8 ** 3, 34)
    assert rel_err(b, a) < 2e-6


@pytest.fixture(scope="module")
def far_case():
    """A field-scale 3-D state at levels 3 through nbodyax's far-field
    stages, shared by the tests below."""
    arrays = state(2048, 9, field=1e5, dim=3, big=True)
    pos, _, mass, _ = arrays
    levels, ring, eps2 = 3, 1, 100.0 ** 2
    (je, js), (te, ts) = structures(arrays, levels, False)
    jg = jbh._level_grids(jnp.asarray(pos), jnp.asarray(mass), je, levels, 2)
    jloc = jbh._fmm_local_table(jnp.asarray(pos), jnp.asarray(mass), je,
                                levels, ring + 1, eps2, 2, grids=jg)
    tg = fmm._level_grids(torch.from_numpy(pos), torch.from_numpy(mass), te,
                          levels, 2)
    tloc = fmm._fmm_local_table(torch.from_numpy(pos), torch.from_numpy(mass),
                                te, levels, ring + 1, eps2, 2, grids=tg)
    return dict(arrays=arrays, levels=levels, ring=ring, eps2=eps2, je=je,
                js=js, te=te, ts=ts, jg=jg, tg=tg, jloc=np.asarray(jloc),
                tloc=tloc)


def test_fmm_local_table_3d(far_case):
    """Local expansions of every finest cell (M2L at levels 2 and 3 chained
    by L2L): 2e-5 of each channel's scale."""
    a, b = far_case["jloc"], far_case["tloc"].numpy()
    assert a.shape == b.shape == (512, 34)
    scale = np.abs(a).max(axis=0)
    assert (np.abs(b - a).max(axis=0) <= 2e-5 * scale).all()


def test_l2p_slots_3d(far_case):
    """The slot-side and the per-body L2P over each package's own table:
    2e-5 of the scale."""
    levels = far_case["levels"]
    n = far_case["arrays"][0].shape[0]
    ncells = (1 << levels) ** 3
    ci = tbh.slot_cap(n, ncells)
    js, ts = far_case["js"], far_case["ts"]
    jf = jbh._build_slot_grid(js[4], js[2], js[3], n, ncells, ci)
    tf = build_slot_grid_reference(ts[4], ts[2], ts[3], n, ncells, ci)
    a = np.asarray(jbh._l2p_slots(jnp.asarray(far_case["jloc"]),
                                  jf[:, :ci, 0:3], far_case["je"], levels, 3))
    b = fmm._l2p_slots(far_case["tloc"], tf[:, :ci, 0:3], far_case["te"],
                       levels, 3).numpy()
    assert a.shape == b.shape == (ncells, ci, 3)
    assert rel_err(b, a) < 2e-5
    pos = far_case["arrays"][0]
    pa = np.asarray(jbh._l2p(jnp.asarray(far_case["jloc"]), jnp.asarray(pos),
                             far_case["je"], levels, 3))
    pb = fmm._l2p(far_case["tloc"], torch.from_numpy(pos), far_case["te"],
                  levels, 3).numpy()
    assert rel_err(pb, pa) < 2e-5


def test_annulus_3d(far_case, monkeypatch):
    """The exact-target shell of 98 cells, per slot and per body: 2e-5 of
    the scale, the slot scatter ids exact; and cut into cell chunks it
    equals the single pass bit for bit."""
    levels, ring, eps2 = (far_case[k] for k in ("levels", "ring", "eps2"))
    n = far_case["arrays"][0].shape[0]
    ci = tbh.slot_cap(n, (1 << levels) ** 3)
    jp = jnp.stack(far_case["jg"][levels], axis=1)
    tp = torch.stack(far_case["tg"][levels], 1)
    assert len(fmm._annulus_offsets(ring, ring + 1, 3)) == 98
    a, ai = jbh._annulus_force_cells(jp, far_case["je"], levels, ring,
                                     ring + 1, eps2, 2, far_case["js"],
                                     ci_cap=ci)
    args = (tp, far_case["te"], levels, ring, ring + 1, eps2, 2,
            far_case["ts"], ci)
    b, bi = fmm._annulus_force_cells(*args)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ai))
    ok = np.asarray(ai) < n
    assert rel_err(b.numpy()[ok], np.asarray(a)[ok]) < 2e-5
    # 512 cells x ci x 98 offsets in chunks of 16 cells
    monkeypatch.setattr(fmm, "_ANNULUS_ELEMS", 16 * ci * 98)
    c, cidx = fmm._annulus_force_cells(*args)
    assert torch.equal(c, b) and torch.equal(cidx, bi)
    pos = far_case["arrays"][0][:300]
    a = jbh._annulus_force_bodies(jnp.asarray(pos), jp, far_case["je"],
                                  levels, ring, ring + 1, eps2, 2)
    b = fmm._annulus_force_bodies(torch.from_numpy(pos), tp, far_case["te"],
                                  levels, ring, ring + 1, eps2, 2)
    assert rel_err(b.numpy(), a) < 2e-5


@pytest.mark.parametrize("order", [1, 2])
def test_far_force_3d_window_path(order):
    """``bhFar=direct`` at levels 4: the 4,096-cell finest level is past
    the dense threshold (512 cells in 3-D), so it goes through the gathered
    6 x 6 x 6 = 216-cell interaction-list window, levels 2 and 3 through
    the dense path. Per body against nbodyax's ``_far_force`` (2e-5 of the
    scale), and the per-cell pass against the per-body one on the bodies
    that hold a slot."""
    arrays = state(1024, 13, field=1e5, dim=3, big=True)
    pos, _, mass, _ = arrays
    levels, eps2 = 4, 100.0 ** 2
    (je, _), (te, ts) = structures(arrays, levels, False)
    assert (1 << levels) ** 3 > fmm._DENSE_FAR_CELLS[3] >= 8 ** 3
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    a = jbh._far_force(jnp.asarray(pos[:200]), jnp.asarray(pos),
                       jnp.asarray(mass), je, levels, 1, eps2, 256, order)
    b = fmm._far_force(tp[:200], tp, tm, te, levels, 1, eps2, order)
    assert rel_err(b.numpy(), a) < 2e-5
    cells, sidx = fmm._far_force_cells(tp, tm, te, levels, 1, eps2, order,
                                       ts, 8)
    full = fmm._far_force(tp, tp, tm, te, levels, 1, eps2, order)
    held = sidx < 1024
    assert held.sum() >= (mass > 0).sum() - 8
    assert rel_err(cells[held].numpy(), full[sidx[held]].numpy()) < 2e-5


def test_annulus_chunks_2d_equal_one_pass(monkeypatch):
    """The chunked annulus in 2-D: bit for bit the single pass."""
    arrays = state(2048, 9, field=1e5, big=True)
    pos, _, mass, _ = arrays
    _, (te, ts) = structures(arrays, 4, False)
    tg = fmm._level_grids(torch.from_numpy(pos), torch.from_numpy(mass), te,
                          4, 2)
    args = (torch.stack(tg[4], 1), te, 4, 1, 2, 1e4, 2, ts, 32)
    one, idx = fmm._annulus_force_cells(*args)
    monkeypatch.setattr(fmm, "_ANNULUS_ELEMS", 8 * 32 * 16)
    cut, cidx = fmm._annulus_force_cells(*args)
    assert torch.equal(cut, one) and torch.equal(cidx, idx)


@pytest.mark.parametrize("L", [7, 10])
@pytest.mark.parametrize("ring", [1, 2])
@pytest.mark.parametrize("S", [64, 80, 1024])
def test_near_plan_3d_fits_shared_memory(S, ring, L):
    """B3's 3-D staging buffer: 6 words a partner, 9 with a velocity, at
    the full capacity, inside the 48 KB a block takes without opting in."""
    cap, nbytes = near_plan(S, ring, L, 3)
    assert cap == NEAR_MAX_CAP
    assert nbytes == NEAR_WARPS * (cap * (9 if L == 10 else 6) + 32) * 4
    assert nbytes <= 37376 <= SHARED_LIMIT
    assert nbytes % (16 * NEAR_WARPS) == 0   # each warp's float4s aligned


@pytest.mark.parametrize("S,ring,want", [(1, 1, 32), (2, 1, 64),
                                         (9, 1, 256), (1, 2, 128)])
def test_near_plan_3d_small_windows(S, ring, want):
    """A 3-D window smaller than the largest capacity is staged whole:
    (2 ring + 1)^3 S rounded up to 32."""
    assert near_plan(S, ring, 7, 3)[0] == want


@pytest.mark.parametrize("n,chunks", [(0, 0), (1, 1), (MOMENT_CHUNK, 1),
                                      (1 << 20, 4096)])
def test_moment_plan_3d(n, chunks):
    """Ten floats a partial in 3-D, six in 2-D."""
    assert num_moments(3) == 10 and num_moments(2) == 6
    assert moment_plan(n, 3) == (chunks, chunks * 20)
    assert moment_plan(n, 2) == moment_plan(n)


def _grid(ncells, S, L):
    return torch.zeros((ncells, S, L))


@pytest.mark.parametrize("case", ["dim", "width_for_dim", "elastic_width",
                                  "cells", "ci", "rank"])
def test_slots_near_refuses_what_the_kernel_does_not_take(case):
    """A dimension other than 2 or 3, a row width that is not the mode's in
    that dimension (a 2-D grid passed as 3-D and the reverse), a cell count
    that is not g^dim, ci past S: all raise, on any device."""
    kw = dict(mode="reference", eps2=0.0, growth=0.1, g=4, ring=1, ci=8,
              dim=3)
    fslot = _grid(64, 16, 7)
    slots_near(fslot, **kw)                          # the accepted form
    if case == "dim":
        bad = dict(fslot=_grid(256, 16, 8), **dict(kw, dim=4))
    elif case == "width_for_dim":
        bad = dict(fslot=_grid(64, 16, 6), **kw)      # 2-D rows as 3-D
    elif case == "elastic_width":
        bad = dict(fslot=fslot, **dict(kw, mode="elastic"))   # wants L = 10
    elif case == "cells":
        bad = dict(fslot=_grid(16, 16, 7), **kw)      # g^2 cells as 3-D
    elif case == "ci":
        bad = dict(fslot=fslot, **dict(kw, ci=17))
    else:
        bad = dict(fslot=torch.zeros((64, 7)), **kw)
    with pytest.raises(ValueError):
        slots_near(**bad)
    with pytest.raises(ValueError):                  # 3-D rows at the default
        slots_near(fslot, **{k: v for k, v in kw.items() if k != "dim"})


@pytest.mark.parametrize("case", ["width", "dim_rows", "levels", "S",
                                  "dtype"])
def test_pack_slots_refuses_what_the_kernels_do_not_take(case):
    """Rows of a width no dimension has, 3-D positions with 2-D rows, a
    level count that does not give the cell count in that dimension, S out
    of range, a pack that is not float32: all raise, on any device."""
    arrays = state(256, 2, dim=3)
    (_, _), (te, ts) = structures(arrays, 2, False)
    pos, mass = torch.from_numpy(arrays[0]), torch.from_numpy(arrays[2])
    sf, starts, ends = ts[4], ts[2], ts[3]
    pack_slots(sf, starts, ends, 8, moments=(pos, mass, te, 2))
    with pytest.raises(ValueError):
        if case == "width":
            pack_slots(torch.zeros((257, 9)), starts, ends, 8)
        elif case == "dim_rows":
            pack_slots(sf[:, :6].contiguous(), starts, ends, 8,
                       moments=(pos, mass, te, 2))
        elif case == "levels":
            pack_slots(sf, starts, ends, 8, moments=(pos, mass, te, 3))
        elif case == "S":
            pack_slots(sf, starts, ends, 1025)
        else:
            pack_slots(sf.double(), starts, ends, 8)


def probe_states_3d():
    rng = np.random.RandomState(11)
    n = 2048
    uni = rng.uniform(-2000, 2000, (n, 3)).astype(np.float32)
    clu = uni.copy()
    clu[: n // 4] = rng.normal(0.0, 3.0, (n // 4, 3)).astype(np.float32)
    mass = rng.uniform(1, 10, n).astype(np.float32)
    mass[::97] = 0.0
    radius = rng.uniform(0.5, 400, n).astype(np.float32)
    return {"uniform": uni, "clustered": clu}, mass, radius


@pytest.mark.parametrize("scene", ["uniform", "clustered"])
def test_pick_levels_and_health_3d_match_nbodyax(scene):
    """``pick_levels`` (3-D occupancy target 32, level cap 7), the overflow
    count and the health vector are nbodyax's integers on a uniform and a
    clustered 3-D state."""
    states, mass, radius = probe_states_3d()
    pos = states[scene]
    tp, tm, tr = map(torch.from_numpy, (pos, mass, radius))
    for prefer in (False, True):
        want = jbh.pick_levels(jnp.asarray(pos), jnp.asarray(mass),
                               prefer_slots=prefer)
        got = tbh.pick_levels(tp, tm, prefer_slots=prefer)
        assert got == tuple(int(x) if not isinstance(x, str) else x
                            for x in want)
        assert got[0] <= 7
    lv, near, k, comp = got
    for lv_, near_, k_ in ((lv, near, k), (lv, "rows", 32), (2, "slots", 8)):
        kw = dict(levels=lv_, neighbor_k=k_, near=near_)
        assert int(tbh.overflow_count(tp, tm, **kw)) == int(
            jbh.overflow_count(jnp.asarray(pos), jnp.asarray(mass), **kw))
        h_j = np.asarray(jbh.bh_health(jnp.asarray(pos), jnp.asarray(mass),
                                       jnp.asarray(radius), n_giants=16,
                                       comp_cap=comp, **kw))
        h_t = tbh.bh_health(tp, tm, tr, n_giants=16, comp_cap=comp,
                            **kw).numpy()
        np.testing.assert_array_equal(h_t, h_j)


def test_auto_knobs_of_the_million_body_3d_scene():
    """The 3-D million-body scene's uniform-density knobs: levels 5
    (32,768 cells at occupancy 32), slots K = 80, slot cap 64."""
    n = 1 << 20
    assert tbh.auto_levels(n, dim=3) == jbh.auto_levels(n, dim=3) == 5
    assert tbh.auto_neighbor_k(n, 5, 1, 3, "slots") == 80
    assert tbh.slot_cap(n, 1 << 15) == jbh.slot_cap(n, 1 << 15) == 64
    assert tbh.auto_levels(10 ** 9, dim=3) == 7      # the octree's cap
