"""The bh step's static budgets against nbodyax on the CPU, and the step
without host reads.

nbodyax never reads a count back to the host on its bh path: the crowded
bodies go into a static list (``_completion_slice``) under ``lax.cond``
tiers (``_tiered``), and the giant pass takes a static top-B list with the
bodies that do not qualify masked. The port does the same, with its tiers
as ``graph_if.run_if`` branches. Here, on numpy-made seeded states:

- the completion list equals nbodyax's bit for bit (fill ``n``) on a clean
  state, a crowded one under the 1,024 tier, one over it and one past
  ``bhCompCap``, in 2-D and 3-D;
- ``bh_accumulators`` equals nbodyax's at each completion tier, for four
  groups that cover both near engines, both far fields and all four
  collision modes, at the gates of ``tests/test_torch_bh_slice.py``;
- the giant list equals ``lax.top_k``'s, and the giant pass equals
  nbodyax's at each of its tiers (none qualifies, fewer than the small
  tier, more), and at n < 8 equals nbodyax's on the state padded with
  dead bodies to n = 8 (nbodyax fails below 8);
- the step, with ``run_if`` in its capture form (stubbed on the CPU), runs
  with every host read of a tensor made to raise.

Like the other bh tests, torch runs on one thread (``one_thread``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch.physics import bh_grid, graph_if  # noqa: E402

FIELD = 20000.0
# (crowded bodies in one cell, bhCompCap): the completion tier each reaches
TIERS = {"clean": (0, 0), "small": (300, 0), "full": (1300, 2048),
         "past_cap": (1700, 1536)}
LEVELS = {2: 4, 3: 3}       # 256 and 512 cells: about 8 and 4 a cell


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tier_state(kind, dim, n=2048, seed=5, giants=0):
    """Uniform bodies over the field, ``TIERS[kind][0]`` of them packed
    into one cell, 5% dead, and ``giants`` bodies with radii far past the
    ring-1 window (two of them tied)."""
    rng = np.random.RandomState(seed + dim)
    pos = rng.uniform(-FIELD, FIELD, (n, dim)).astype(np.float32)
    crowd = TIERS[kind][0]
    pos[:crowd] = rng.uniform(100, 900, (crowd, dim)).astype(np.float32)
    vel = rng.uniform(-5, 5, (n, dim)).astype(np.float32)
    mass = rng.uniform(1e10, 1e14, n).astype(np.float32)
    radius = rng.uniform(1, 30, n).astype(np.float32)
    mass[rng.rand(n) < 0.05] = 0.0
    if giants:
        idx = rng.choice(np.arange(crowd, n), giants, replace=False)
        radius[idx] = rng.uniform(5000, 9000, giants).astype(np.float32)
        radius[idx[1]] = radius[idx[0]]
        mass[idx] = rng.uniform(1e12, 1e14, giants).astype(np.float32)
        mass[idx[:3]] = 1e16
        mass[idx[3]] = 0.0                  # a dead giant never counts
    return pos, vel, mass, radius


def over_masks(arrays, dim):
    """The crowded-body mask by the port's structure and by nbodyax's,
    and the cell count."""
    pos, vel, mass, radius = arrays
    g = 1 << LEVELS[dim]
    ncells = g ** dim
    n = pos.shape[0]
    t = [torch.from_numpy(x) for x in arrays]
    ext = bh_grid._extent(t[0], t[2] > 0)
    _, s_cell, starts, _, _ = bh_grid._partner_structure(*t, ext, g, False)
    cap = tbh.slot_cap(n, ncells)
    got = tbh._over_slots(s_cell, starts, ncells, cap)
    je = jbh._extent(jnp.asarray(pos), jnp.asarray(mass) > 0)
    _, js_cell, jstarts, _, _ = jbh._partner_structure(
        *map(jnp.asarray, arrays), je, g, False)
    srank = jnp.arange(n, dtype=jnp.int32) - jstarts[
        jnp.clip(js_cell, 0, ncells - 1)]
    want = (srank >= cap) & (js_cell < ncells)
    return got, np.asarray(want)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", list(TIERS))
def test_completion_list_equals_nbodyax(kind, dim):
    """Bitwise, fill n; the tier the state reaches is the one named."""
    arrays = tier_state(kind, dim)
    n = arrays[0].shape[0]
    over, jover = over_masks(arrays, dim)
    np.testing.assert_array_equal(over.numpy(), jover)
    comp_cap = TIERS[kind][1]
    got = tbh._completion_list(over, n, comp_cap)
    want = np.asarray(jbh._completion_slice(jnp.asarray(jover), n, None,
                                            comp_cap))
    np.testing.assert_array_equal(got.numpy(), want)
    real = int((want < n).sum())
    tier = ("clean" if real == 0 else "small" if real <= 1024
            else "full" if real < want.shape[0] else "past_cap")
    assert tier == kind, (real, want.shape[0])
    if kind == "past_cap":
        assert int(over.sum()) > comp_cap      # crowded bodies dropped


# (collision mode, near engine, far field, far order): together both
# engines, both far fields and all four modes
GROUPS = [("reference", "slots", "fmm", 2), ("momentum", "rows", "fmm", 2),
          ("elastic", "slots", "direct", 1), ("none", "rows", "direct", 1)]


def check_accumulators(got, want, mode):
    """tests/test_torch_bh_slice.py's gates."""
    f = np.asarray(want.force)
    assert np.abs(got.force.numpy() - f).max() <= 2e-5 * np.abs(f).max()
    np.testing.assert_array_equal(got.died.numpy(), np.asarray(want.died))
    np.testing.assert_array_equal(got.parent.numpy(),
                                  np.asarray(want.parent))
    np.testing.assert_allclose(got.gained_mass.numpy(),
                               np.asarray(want.gained_mass), rtol=1e-5)
    if mode == "elastic":
        dv = np.asarray(want.dv)
        assert np.abs(got.dv.numpy() - dv).max() <= 2e-5 * np.abs(dv).max()


@pytest.mark.parametrize("group", GROUPS, ids=["-".join(map(str, g))
                                               for g in GROUPS])
@pytest.mark.parametrize("kind", ["clean", "small", "full"])
def test_bh_accumulators_at_each_tier_equal_nbodyax(kind, group):
    mode, near, far, order = group
    arrays = tier_state(kind, 2, giants=4)
    kw = dict(eps=20.0, growth_rate=0.1, mode=mode, levels=LEVELS[2],
              ring=1, neighbor_k=0, order=order, far=far, near=near,
              comp_cap=TIERS[kind][1], n_giants=1024)
    want = jbh.bh_accumulators(*arrays, near_pallas="off", **kw)
    got = tbh.bh_accumulators(*map(torch.from_numpy, arrays),
                              near_kernel="off", **kw)
    check_accumulators(got, want, mode)
    if mode == "reference":
        assert np.asarray(want.died).any()     # merges happen in this state


@pytest.mark.parametrize("group", [GROUPS[0], GROUPS[2]],
                         ids=["reference-slots-fmm", "elastic-slots-direct"])
@pytest.mark.parametrize("kind", ["clean", "small", "full"])
def test_bh_accumulators_3d_at_each_tier_equal_nbodyax(kind, group):
    mode, near, far, order = group
    arrays = tier_state(kind, 3, giants=4)
    kw = dict(eps=20.0, growth_rate=0.1, mode=mode, levels=LEVELS[3],
              ring=1, neighbor_k=0, order=order, far=far, near=near,
              comp_cap=TIERS[kind][1], n_giants=1024)
    want = jbh.bh_accumulators(*arrays, near_pallas="off", **kw)
    got = tbh.bh_accumulators(*map(torch.from_numpy, arrays),
                              near_kernel="off", **kw)
    check_accumulators(got, want, mode)


def test_giant_list_equals_top_k():
    """Ties to the lower index, the non-qualifying entries (key -1) in
    index order after the qualifying ones, as lax.top_k gives them."""
    rng = np.random.RandomState(3)
    key = np.full(300, -1.0, np.float32)
    key[rng.choice(300, 40, replace=False)] = rng.choice(
        [5.0, 7.0, 9.0], 40).astype(np.float32)
    for count in (8, 64, 300):
        topi, gmask = tbh._giant_list(torch.from_numpy(key), count)
        _, jtop = jax.lax.top_k(jnp.asarray(key), count)
        np.testing.assert_array_equal(topi.numpy(), np.asarray(jtop))
        np.testing.assert_array_equal(gmask.numpy(), key[np.asarray(jtop)]
                                      > 0)


def check_giants(got, want):
    """tests/test_torch_bh_giants.py's gates: decisions exact, summed
    channels within float32 sum order (nbodyax sums over its whole
    B-entry list, the port over its tier's)."""
    assert not got.force.any()
    for name in ("died", "parent", "best_mass"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("gained_mass", "gained_radius"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    x = np.asarray(want.dv)
    assert np.abs(got.dv.numpy() - x).max() <= 1e-6 * max(np.abs(x).max(),
                                                          1e-30)


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
@pytest.mark.parametrize("giants", [0, 12, 100])
def test_giant_pass_at_each_tier_equals_nbodyax(giants, mode):
    """No qualifying body (the pass is skipped), 12 (under the 64-entry
    tier) and 100 (the whole 1,024-entry list)."""
    pos, vel, mass, radius = tier_state("clean", 2, giants=giants)
    je = jbh._extent(jnp.asarray(pos), jnp.asarray(mass) > 0)
    te = bh_grid._extent(torch.from_numpy(pos), torch.from_numpy(mass) > 0)
    kw = dict(levels=LEVELS[2], ring=1, growth_rate=0.1, mode=mode,
              n_giants=1024)
    key = tbh._giant_key(torch.from_numpy(mass), torch.from_numpy(radius),
                         te, LEVELS[2], 1)
    assert int((key > 0).sum()) == max(0, giants - 1)
    want = jbh.giant_collision_accumulators(pos, vel, mass, radius, ext=je,
                                            **kw)
    got = tbh.giant_collision_accumulators(
        *map(torch.from_numpy, (pos, vel, mass, radius)), ext=te, **kw)
    check_giants(got, want)
    if giants and mode == "reference":
        assert np.asarray(want.died).any()      # the giants do eat


@pytest.mark.parametrize("n", [3, 6])
def test_giant_pass_below_eight_bodies(n):
    """The port clamps B to n; nbodyax needs n >= 8. Padded with dead
    bodies to 8, nbodyax's rows of the n real bodies are the port's."""
    rng = np.random.RandomState(n)
    pos = rng.uniform(-500, 500, (8, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
    mass = rng.uniform(1, 10, 8).astype(np.float32)
    radius = np.full(8, 400.0, np.float32)
    mass[n:] = 0.0
    radius[n:] = 0.0
    je = jbh._extent(jnp.asarray(pos), jnp.asarray(mass) > 0)
    te = bh_grid._extent(torch.from_numpy(pos[:n]),
                         torch.from_numpy(mass[:n]) > 0)
    kw = dict(levels=3, ring=1, growth_rate=0.1, mode="reference",
              n_giants=1024)
    want = jbh.giant_collision_accumulators(pos, vel, mass, radius, ext=je,
                                            **kw)
    want = type(want)(*(np.asarray(x)[:n] for x in want))
    got = tbh.giant_collision_accumulators(
        *map(torch.from_numpy, (pos[:n], vel[:n], mass[:n], radius[:n])),
        ext=te, **kw)
    check_giants(got, want)
    assert np.asarray(want.died).any()


HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
              "__float__", "__index__")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("group", GROUPS, ids=["-".join(map(str, g))
                                               for g in GROUPS])
def test_the_bh_step_reads_nothing_back(monkeypatch, group, dim):
    """``run_if`` in its capture form (the IF node stubbed: the body runs)
    on a state that reaches the full completion tier and both giant
    tiers' bodies: no tensor is read on the host, and each completion
    pass and the giant pass open one IF node a tier."""
    mode, near, far, order = group
    t = [torch.from_numpy(x) for x in tier_state("full", dim, giants=12)]
    bodies = []

    def stub(pred, body):
        assert pred.dtype == torch.bool and pred.dim() == 0
        bodies.append(pred)
        body()

    monkeypatch.setattr(graph_if, "_capturing", lambda pred: True)
    monkeypatch.setattr(graph_if, "_capture_if", stub)

    def refuse(*a, **k):
        raise AssertionError("a host read in the bh step")

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tbh.bh_accumulators(*t, eps=20.0, growth_rate=0.1, mode=mode,
                        levels=LEVELS[dim], ring=1, neighbor_k=0,
                        order=order, far=far, near=near,
                        comp_cap=TIERS["full"][1], near_kernel="off",
                        n_giants=1024)
    monkeypatch.undo()
    # near and far completion: 2 tiers each; the giants: 2 unless "none"
    assert len(bodies) == 4 + (2 if mode != "none" else 0)
