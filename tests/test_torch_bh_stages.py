"""nbodyax_torch's forceModel=bh, stage by stage, against nbodyax on the CPU.

The same numpy-made inputs go through each nbodyax function and its port:
the partner structure and the slot grid (exact), the slot-pack plain
versions (rows bitwise, moments within 2e-6 of the per-channel scale, as
tests/test_barneshut.py:803), the level grids (2e-6 of the per-channel
scale), the M2L convolution (2e-6 of the scale, as test_barneshut.py:680),
the slot-side L2P (2e-5, as test_barneshut.py:473), the local-expansion
table and the annulus (2e-5 of the scale), and the knob heuristics.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch.physics import bh_grid, fmm  # noqa: E402
from nbodyax_torch.physics.slotpack_kernel import (  # noqa: E402
    build_slot_grid_reference, finest_moments_reference, pack_slots)


def state(n, seed, field=1000.0, hot=None, dim=2, big=False):
    """Uniform bodies with 10% dead; ``hot`` crowds bodies into one cell:
    "mid" (a quarter near the centre) or "last" (the max corner)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, dim)).astype(np.float32)
    if hot == "mid":
        pos[: n // 4] = rng.uniform(-field / 100, field / 100, (n // 4, dim))
    elif hot == "last":
        pos[: n // 4] = rng.uniform(0.97 * field, field, (n // 4, dim))
    vel = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    if big:
        mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
        radius = rng.uniform(50, 200, n).astype(np.float32)
    else:
        mass = rng.uniform(1, 10, n).astype(np.float32)
        radius = rng.uniform(1, 12, n).astype(np.float32)
    mass[rng.rand(n) < 0.1] = 0.0
    return pos, vel, mass, radius


def both_ext(pos, mass):
    je = jbh._extent(jnp.asarray(pos), jnp.asarray(mass) > 0)
    te = bh_grid._extent(torch.from_numpy(pos), torch.from_numpy(mass) > 0)
    return je, te


def structures(arrays, levels, need_vel):
    pos, vel, mass, radius = arrays
    je, te = both_ext(pos, mass)
    g = 1 << levels
    js = jbh._partner_structure(*map(jnp.asarray, arrays), je, g, need_vel)
    ts = bh_grid._partner_structure(*map(torch.from_numpy, arrays), te, g,
                                    need_vel)
    return (je, js), (te, ts)


def rel_err(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    return np.abs(got - want).max() / max(scale, 1e-30)


@pytest.mark.parametrize("hot", [None, "mid"])
@pytest.mark.parametrize("need_vel", [False, True])
def test_extent_and_partner_structure_exact(hot, need_vel):
    """Gate: order, sorted cells, starts/ends and sf all exact."""
    arrays = state(2048, 1, hot=hot)
    (je, js), (te, ts) = structures(arrays, 4, need_vel)
    for a, b in zip(je, te):
        for x, y in zip(a, b):
            assert float(x) == float(y)
    for name, a, b in zip(("order", "s_cell", "starts", "ends", "sf"), js,
                          ts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("n,levels,S,hot,need_vel", [
    (2048, 4, 8, None, False),      # uniform
    (2048, 4, 8, "mid", False),     # crowded mid-block cell
    (2048, 4, 40, "last", False),   # hot last cell
    (1024, 3, 40, None, True),      # elastic row layout, L = 2 dim + 4
])
def test_slot_pack_plain_matches_nbodyax(n, levels, S, hot, need_vel):
    """B5's plain versions: rows bitwise equal to ``_build_slot_grid``,
    moments within 2e-6 x max(per-channel scale, 1) of
    ``_finest_moments_scatter`` (field-scale positions, heavy masses); the
    CPU wrapper returns the same."""
    arrays = state(n, 7, field=1e5, hot=hot, big=True)
    (je, js), (te, ts) = structures(arrays, levels, need_vel)
    g = 1 << levels
    ncells = g * g
    want = np.asarray(jbh._build_slot_grid(js[4], js[2], js[3], n, ncells, S))
    got = build_slot_grid_reference(ts[4], ts[2], ts[3], n, ncells, S)
    np.testing.assert_array_equal(got.numpy(), want)
    pos, _, mass, _ = arrays
    jm = np.asarray(jbh._finest_moments_scatter(jnp.asarray(pos),
                                                jnp.asarray(mass), je,
                                                levels))
    tpos, tmass = torch.from_numpy(pos), torch.from_numpy(mass)
    tm = finest_moments_reference(tpos, tmass, te, levels).numpy()
    scale = np.maximum(np.abs(jm).max(axis=0), 1.0)
    assert (np.abs(tm - jm).max(axis=0) <= 2e-6 * scale).all()
    rows, mom = pack_slots(ts[4], ts[2], ts[3], S,
                           moments=(tpos, tmass, te, levels))
    assert torch.equal(rows, got) and np.array_equal(mom.numpy(), tm)
    before = (pack_slots.launches, pack_slots.moment_launches)
    assert torch.equal(pack_slots(ts[4], ts[2], ts[3], S), got)
    assert (pack_slots.launches, pack_slots.moment_launches) == before


@pytest.mark.parametrize("order", [1, 2])
def test_level_grids(order):
    """Every level's channels within 2e-6 of the per-channel scale."""
    pos, _, mass, _ = state(2048, 3, field=1e5, big=True)
    je, te = both_ext(pos, mass)
    jg = jbh._level_grids(jnp.asarray(pos), jnp.asarray(mass), je, 5, order)
    tg = fmm._level_grids(torch.from_numpy(pos), torch.from_numpy(mass), te,
                          5, order)
    assert sorted(jg) == sorted(tg)
    for lv in jg:
        for a, b in zip(jg[lv], tg[lv]):
            assert rel_err(b.numpy(), a) < 2e-6, lv


@pytest.mark.parametrize("ring", [1, 2])
@pytest.mark.parametrize("order", [1, 2])
def test_m2l_level_conv(ring, order):
    """The parent-folded convolution, 2e-6 of the scale (the gate nbodyax
    holds its conv to its scan form)."""
    rng = np.random.RandomState(7)
    s, n_src = 16, 6
    packed = (rng.normal(size=(s * s, n_src)) * 1e3).astype(np.float32)
    ext_j = ((-1e5, -1e5), (2e5, 2e5))
    ext_t = tuple(tuple(torch.tensor(v, dtype=torch.float32) for v in x)
                  for x in ext_j)
    a = np.asarray(jbh._m2l_level_conv(jnp.asarray(packed), s, ext_j,
                                       100.0 ** 2, ring, 2, order, 3))
    b = fmm._m2l_level_conv(torch.from_numpy(packed), s, ext_t, 1e4, ring,
                            2, order, 3).numpy()
    assert rel_err(b, a) < 2e-6


@pytest.fixture(scope="module")
def far_case():
    """A field-scale state at levels 4 through nbodyax's far-field stages,
    shared by the tests below."""
    arrays = state(2048, 9, field=1e5, big=True)
    pos, _, mass, _ = arrays
    levels, ring, eps2 = 4, 1, 100.0 ** 2
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


def test_fmm_local_table(far_case):
    """Local expansions of every finest cell: 2e-5 of each channel's
    scale."""
    a, b = far_case["jloc"], far_case["tloc"].numpy()
    scale = np.abs(a).max(axis=0)
    assert (np.abs(b - a).max(axis=0) <= 2e-5 * scale).all()


def test_l2p_slots(far_case):
    """The slot-side L2P of the port over its own table against nbodyax's
    over its own: 2e-5 of the scale, the gate of test_barneshut.py:473."""
    levels = far_case["levels"]
    n = far_case["arrays"][0].shape[0]
    ncells = (1 << levels) ** 2
    ci = tbh.slot_cap(n, ncells)
    js, ts = far_case["js"], far_case["ts"]
    jf = jbh._build_slot_grid(js[4], js[2], js[3], n, ncells, ci)
    tf = build_slot_grid_reference(ts[4], ts[2], ts[3], n, ncells, ci)
    a = np.asarray(jbh._l2p_slots(jnp.asarray(far_case["jloc"]),
                                  jf[:, :ci, 0:2], far_case["je"], levels, 2))
    b = fmm._l2p_slots(far_case["tloc"], tf[:, :ci, 0:2], far_case["te"],
                       levels, 2).numpy()
    assert rel_err(b, a) < 2e-5
    pos = far_case["arrays"][0]
    pa = np.asarray(jbh._l2p(jnp.asarray(far_case["jloc"]), jnp.asarray(pos),
                             far_case["je"], levels, 2))
    pb = fmm._l2p(far_case["tloc"], torch.from_numpy(pos), far_case["te"],
                  levels, 2).numpy()
    assert rel_err(pb, pa) < 2e-5


def test_annulus(far_case):
    """The exact-target annulus shell, per slot and per body: 2e-5 of the
    scale; the slot scatter ids exact."""
    levels, ring, eps2 = (far_case[k] for k in ("levels", "ring", "eps2"))
    n = far_case["arrays"][0].shape[0]
    ci = tbh.slot_cap(n, (1 << levels) ** 2)
    jp = jnp.stack(far_case["jg"][levels], axis=1)
    tp = torch.stack(far_case["tg"][levels], 1)
    a, ai = jbh._annulus_force_cells(jp, far_case["je"], levels, ring,
                                     ring + 1, eps2, 2, far_case["js"],
                                     ci_cap=ci)
    b, bi = fmm._annulus_force_cells(tp, far_case["te"], levels, ring,
                                     ring + 1, eps2, 2, far_case["ts"], ci)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ai))
    ok = np.asarray(ai) < n
    assert rel_err(b.numpy()[ok], np.asarray(a)[ok]) < 2e-5
    pos = far_case["arrays"][0][:300]
    a = jbh._annulus_force_bodies(jnp.asarray(pos), jp, far_case["je"],
                                  levels, ring, ring + 1, eps2, 2)
    b = fmm._annulus_force_bodies(torch.from_numpy(pos), tp, far_case["te"],
                                  levels, ring, ring + 1, eps2, 2)
    assert rel_err(b.numpy(), a) < 2e-5


@pytest.mark.parametrize("n", [5, 1024, 4096, 1_048_576, 100_000_000])
def test_knob_heuristics(n):
    """auto_levels, auto_neighbor_k, slot_cap and the completion cap are
    nbodyax's integers."""
    for dim in (2, 3):
        lv = tbh.auto_levels(n, dim=dim)
        assert lv == jbh.auto_levels(n, dim=dim)
        for near in ("rows", "slots"):
            for ring in (1, 2):
                assert (tbh.auto_neighbor_k(n, lv, ring, dim, near)
                        == jbh.auto_neighbor_k(n, lv, ring, dim, near))
        assert tbh.slot_cap(n, 1 << (dim * lv)) == jbh.slot_cap(
            n, 1 << (dim * lv))
    for cap in (0, 3000):
        assert tbh._completion_cap(n, cap) == jbh._completion_cap(n, cap)


def test_id_packing_exact():
    ids = torch.tensor([0, 1, 4095, 4096, (1 << 24) + 1, (1 << 31) - 1])
    assert torch.equal(bh_grid._unpack_id(*bh_grid._pack_id(ids)), ids)
