"""The hand-written CUDA kernels against their plain PyTorch versions: the
all-pairs forward kernel and its analytic backward kernel.

These tests need a CUDA card and skip without one. The file imports neither
JAX nor nbodyax, so on a machine with a card and no JAX it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch.physics import kernels  # noqa: E402
from nbodyax_torch.physics import kernels_bwd  # noqa: E402
from nbodyax_torch.physics.pairwise import combine_accumulators  # noqa: E402

pytestmark = pytest.mark.cuda
MODES = ["reference", "momentum", "elastic", "none"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def random_feats(n, seed, dev, field=1000.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(5, 40, n).astype(np.float32)
    mass[n // 2:n // 2 + 8] = mass[n // 2]          # equal-mass ties
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    return kernels.body_features(*t), t[2]


def assert_equivalent(a, b, mode):
    """tests/test_kernels.py's gates."""
    def rel(x, y):
        return float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))

    assert rel(a.force, b.force) < 2e-6
    if mode == "reference":
        torch.testing.assert_close(a.gained_mass, b.gained_mass, rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(a.gained_radius, b.gained_radius,
                                   rtol=1e-6, atol=0)
        assert torch.equal(a.died, b.died)
    if mode == "momentum":
        assert torch.equal(a.parent, b.parent)
        assert torch.equal(a.best_mass, b.best_mass)
    if mode == "elastic":
        assert rel(a.dv, b.dv) < 1e-5


def both(feats, mass, mode, i0=0, j0=0, fi=None, mi=None):
    fi = feats if fi is None else fi
    mi = mass if mi is None else mi
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
    rk, pk = kernels.tile_accumulators_raw(fi, feats, i0, j0, **kw)
    rp, pp = kernels.tile_accumulators_raw_reference(fi, feats, i0, j0, **kw)
    return (kernels.decode_raw(rk, pk, i0, mi, mode),
            kernels.decode_raw(rp, pp, i0, mi, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [64, 300, 1000, 4099])
def test_kernel_matches_plain_version(cuda, mode, n):
    feats, mass = random_feats(n, n, cuda)
    a, b = both(feats, mass, mode)
    assert_equivalent(a, b, mode)


@pytest.mark.parametrize("mode", ["reference", "momentum"])
def test_large_offsets_keep_exact_ids(cuda, mode):
    """Ids past 2^24, where an f32 id would round."""
    n, base = 300, (1 << 30) + 3
    feats, mass = random_feats(n, 5, cuda)
    a, b = both(feats, mass, mode, i0=base, j0=base)
    assert_equivalent(a, b, mode)
    assert int(a.parent.min()) >= base


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_offset_halves_combine_to_full(cuda, mode):
    n = 1000
    feats, mass = random_feats(n, 9, cuda)
    i0, i1, half = 200, 700, 500
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
    parts = []
    for j0, j1 in ((0, half), (half, n)):
        raw, par = kernels.tile_accumulators_raw(feats[i0:i1], feats[j0:j1],
                                                 i0, j0, **kw)
        parts.append(kernels.decode_raw(raw, par, i0, mass[i0:i1], mode))
    combined = combine_accumulators(*parts)
    _, full = both(feats, mass, mode)
    full = type(full)(*(x[i0:i1] for x in full))
    assert_equivalent(combined, full, mode)


def test_deterministic_and_counted(cuda):
    feats, _ = random_feats(2000, 3, cuda)
    kw = dict(mode="momentum", eps=0.0, growth_rate=0.1)
    before = kernels.tile_accumulators_raw.launches
    r1, p1 = kernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    r2, p2 = kernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    assert torch.equal(r1, r2) and torch.equal(p1, p2)
    assert kernels.tile_accumulators_raw.launches == before + 2


# Partner splits: the kernels split the partners of a row block across
# blocks when the rows alone do not fill the card; at N = 16,384 on an H100
# the split is active. These calls cover lopsided shapes, a partner count
# that is no multiple of the 256-partner tile, ties across split boundaries,
# ids past 2^24 and bitwise repeats.

BIG = 16384
SHAPES = [(1, BIG), (129, BIG), (BIG, 1), (BIG, 130), (300, 5000 + 77)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ni,nj", SHAPES)
def test_kernel_lopsided_and_ragged_calls(cuda, mode, ni, nj):
    feats, mass = random_feats(BIG, 11, cuda)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
    fi, fj = feats[:ni], feats[:nj]
    rk, pk = kernels.tile_accumulators_raw(fi, fj, 0, 0, **kw)
    rp, pp = kernels.tile_accumulators_raw_reference(fi, fj, 0, 0, **kw)
    assert_equivalent(kernels.decode_raw(rk, pk, 0, mass[:ni], mode),
                      kernels.decode_raw(rp, pp, 0, mass[:ni], mode), mode)


def split_chunk(n, splits):
    """Partners a split walks: ceil(n / splits) rounded up to 32, as
    csrc/pair_common.cuh's split_chunk."""
    c = -(-n // splits)
    return -(-c // 32) * 32


def tie_state(n, dev, chunk):
    """Body 0 overlapped by equal-mass bodies that beat it, on both sides
    of the split boundaries at ``chunk`` and ``2 * chunk``, and elsewhere
    far apart."""
    rng = np.random.RandomState(4)
    pos = rng.uniform(-1e6, 1e6, (n, 2)).astype(np.float32)
    vel = np.zeros((n, 2), np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = np.full(n, 1.0, np.float32)
    ties = [c for c in (chunk - 1, chunk, 2 * chunk + 5) if 0 < c < n]
    pos[[0] + ties] = 0.0
    mass[0] = 50.0
    mass[ties] = 500.0
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    return kernels.body_features(*t), t[2], ties


def test_momentum_tie_across_splits(cuda):
    splits = kernels.forward_splits(BIG, BIG, "momentum", cuda)
    assert splits > 1
    chunk = split_chunk(BIG, splits)
    feats, mass, ties = tie_state(BIG, cuda, chunk)
    a, b = both(feats, mass, "momentum")
    assert_equivalent(a, b, "momentum")
    assert int(a.parent[0]) == min(ties) == int(b.parent[0])
    # the tied bodies beat each other by id: each takes the lowest tie
    assert int(a.parent[max(ties)]) == min(ties)


@pytest.mark.parametrize("mode", ["reference", "momentum"])
def test_large_offsets_with_splits(cuda, mode):
    """Ids past 2^24 at a size where the partners are split."""
    base = (1 << 30) + 3
    assert kernels.forward_splits(BIG, BIG, mode, cuda) > 1
    feats, mass = random_feats(BIG, 6, cuda)
    a, b = both(feats, mass, mode, i0=base, j0=base)
    assert_equivalent(a, b, mode)


@pytest.mark.parametrize("mode", MODES)
def test_split_kernel_repeats_bitwise(cuda, mode):
    feats, _ = random_feats(BIG, 3, cuda)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
    r1, p1 = kernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    r2, p2 = kernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    assert torch.equal(r1, r2)
    assert (p1 is None and p2 is None) or torch.equal(p1, p2)


def test_softening(cuda):
    feats, mass = random_feats(500, 2, cuda)
    kw = dict(mode="elastic", eps=25.0, growth_rate=0.1)
    rk, _ = kernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    rp, _ = kernels.tile_accumulators_raw_reference(feats, feats, 0, 0, **kw)
    a = kernels.decode_raw(rk, None, 0, mass, "elastic")
    b = kernels.decode_raw(rp, None, 0, mass, "elastic")
    assert_equivalent(a, b, "elastic")


# ---------------------------------------------------------------------------
# B1's cold path: the mode bookkeeping runs only for the row groups of a
# warp that overlapped a partner of a 32-partner sub-tile. Scenes of bodies
# far apart (radius 0.5 over a 1e6 field: no overlap but the self pairs)
# with overlaps planted where the vote could miss them.
# ---------------------------------------------------------------------------

def far_apart(n, seed, dim=2):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1e6, 1e6, (n, dim)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = np.full(n, 0.5, np.float32)
    return pos, vel, mass, radius


def plant(arrays, i, j, dx=0.5, v=1.0):
    """Put body i half a unit to the left of body j, both of radius 1,
    moving at each other with speed v (apart for v < 0)."""
    pos, vel, mass, radius = arrays
    pos[i] = pos[j]
    pos[i, 0] -= dx
    vel[i] = 0.0
    vel[j] = 0.0
    vel[i, 0], vel[j, 0] = v, -v
    radius[[i, j]] = 1.0


def to_feats(arrays, dev):
    t = [torch.from_numpy(x).to(dev) for x in arrays]
    return kernels.body_features(*t), t[2]


def cold_one_lane(dev, dim, mode):
    """A ring tile (i ids 0-511 against j ids 512-4095: no self pair) with
    one overlapping pair: one lane of one warp sees it, in one sub-tile."""
    a = far_apart(4096, 21, dim)
    plant(a, 37, 1512)
    feats, mass = to_feats(a, dev)
    return dict(fi=feats[:512], fj=feats[512:], i0=0, j0=512,
                mass_i=mass[:512], cold=1)


def cold_split_edges(dev, dim, mode):
    """Overlaps with the first partner of split 1, the last partner of
    split 1 and the last partner of a ragged last tile (nj = 16,307)."""
    nj = BIG - 77
    splits = kernels.forward_splits(BIG, nj, mode, dev, dim=dim)
    assert splits > 2
    chunk = split_chunk(nj, splits)
    a = far_apart(BIG, 22, dim)
    for i, j in ((3, chunk), (700, 2 * chunk - 1), (9000, nj - 1)):
        plant(a, i, j)
    feats, mass = to_feats(a, dev)
    return dict(fi=feats, fj=feats[:nj], i0=0, j0=0, mass_i=mass)


def cold_large_ids(dev, dim, mode):
    """i ids base+256..base+767 against j ids base..base+1023: every row's
    self pair sits 256 partners off the tile's diagonal, at ids past 2^30;
    one planted pair shares a self pair's sub-tile, one has its own."""
    base = (1 << 30) + 3
    a = far_apart(2048, 23, dim)
    plant(a, 300, 301)
    plant(a, 600, 5)
    feats, mass = to_feats(a, dev)
    return dict(fi=feats[256:768], fj=feats[:1024], i0=base + 256, j0=base,
                mass_i=mass[256:768], cold=512 // 32 + 1)


def cold_giant_on_dead(dev, dim, mode):
    """A giant of radius 5,000 on 300 dead slots left where they died
    (two of them on one spot), with 5 live bodies inside it."""
    rng = np.random.RandomState(24)
    pos, vel, mass, radius = a = far_apart(4096, 24, dim)
    pos[100], mass[100], radius[100] = 0.0, 1e6, 5000.0
    inside = np.arange(200, 505)
    pos[inside] = rng.uniform(-3000, 3000, (inside.size, dim))
    mass[inside[:300]] = 0.0
    pos[inside[1]] = pos[inside[0]]
    feats, mass = to_feats(a, dev)
    return dict(fi=feats, fj=feats, i0=0, j0=0, mass_i=mass)


def cold_momentum_tie(dev, dim, mode):
    """Body 40 overlapped by three equal masses that beat it, 45, 50 and
    60, all in the sub-tile of partners 32-63: the lowest id wins."""
    pos, vel, mass, radius = a = far_apart(1024, 25, dim)
    for j, dx in ((45, 0.3), (50, -0.3), (60, 0.2)):
        pos[j] = pos[40]
        pos[j, 0] += dx
    radius[[40, 45, 50, 60]] = 1.0
    mass[40], mass[[45, 50, 60]] = 50.0, 500.0
    feats, mass = to_feats(a, dev)
    return dict(fi=feats, fj=feats, i0=0, j0=0, mass_i=mass,
                parents={40: 45, 45: 45, 50: 45, 60: 45})


def cold_elastic(dev, dim, mode):
    """Overlapping pairs approaching (10, 11) and receding (20, 21): only
    the approaching pair gains an impulse."""
    a = far_apart(1024, 26, dim)
    plant(a, 10, 11, v=1.0)
    plant(a, 20, 21, v=-1.0)
    feats, mass = to_feats(a, dev)
    return dict(fi=feats, fj=feats, i0=0, j0=0, mass_i=mass,
                bounced=(10, 11), still=(20, 21))


def cold_diagonal(dev, dim, mode):
    """No overlap but the self pairs: each 32-row group enters the cold
    path once, in the sub-tile of its own ids."""
    feats, mass = to_feats(far_apart(4096, 27, dim), dev)
    return dict(fi=feats, fj=feats, i0=0, j0=0, mass_i=mass,
                cold=4096 // 32)


COLD_CASES = {"one_lane": cold_one_lane, "split_edges": cold_split_edges,
              "large_ids": cold_large_ids,
              "giant_on_dead": cold_giant_on_dead,
              "momentum_tie": cold_momentum_tie, "elastic": cold_elastic,
              "diagonal": cold_diagonal}


@pytest.mark.parametrize("case,mode,dim", [
    *((c, m, 2) for c in ("one_lane", "split_edges", "large_ids",
                          "giant_on_dead", "diagonal") for m in MODES),
    ("giant_on_dead", "reference", 3), ("giant_on_dead", "momentum", 3),
    ("giant_on_dead", "elastic", 3), ("diagonal", "reference", 3),
    ("momentum_tie", "momentum", 2), ("momentum_tie", "momentum", 3),
    ("elastic", "elastic", 2), ("elastic", "elastic", 3)])
def test_cold_path_cases(cuda, case, mode, dim):
    c = COLD_CASES[case](cuda, dim, mode)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1, dim=dim)
    kernels.reset_cold_counts(cuda)
    rk, pk = kernels.tile_accumulators_raw(c["fi"], c["fj"], c["i0"],
                                           c["j0"], **kw)
    cold, walked = kernels.cold_counts(cuda)
    rp, pp = kernels.tile_accumulators_raw_reference(c["fi"], c["fj"],
                                                     c["i0"], c["j0"], **kw)
    a = kernels.decode_raw(rk, pk, c["i0"], c["mass_i"], mode, dim=dim)
    b = kernels.decode_raw(rp, pp, c["i0"], c["mass_i"], mode, dim=dim)
    assert_equivalent(a, b, mode)
    ni, nj = c["fi"].shape[0], c["fj"].shape[0]
    splits = kernels.forward_splits(ni, nj, mode, cuda, dim=dim)
    _, rows = kernels.launch_shape("forward", mode, cuda.index, dim)
    chunk = split_chunk(nj, splits)
    # each split's warps walk ceil(partners / 32) sub-tiles, 4 warps a block
    assert walked == -(-ni // rows) * 4 * sum(
        -(-max(0, min(nj, (s + 1) * chunk) - s * chunk) // 32)
        for s in range(splits))
    if mode == "none":
        assert cold == 0
    elif "cold" in c:
        assert cold == c["cold"]
    else:
        assert 0 < cold < walked
    if "parents" in c:
        assert {i: int(a.parent[i]) for i in c["parents"]} == c["parents"]
    if "bounced" in c:
        assert all(float(a.dv[i].abs().max()) > 0 for i in c["bounced"])
        assert all(float(a.dv[i].abs().max()) == 0 for i in c["still"])


# ---------------------------------------------------------------------------
# The backward kernel (csrc/pair_bwd_kernel.cu)
# ---------------------------------------------------------------------------

BWD_GATE = 3e-6   # of the largest component, per output (test_autodiff.py)


def cotangent(n, seed, dev):
    g = np.random.RandomState(seed).standard_normal((n, 8)).astype(np.float32)
    return torch.from_numpy(g).to(dev)


def assert_bwd_close(got, want):
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) / scale < BWD_GATE


def bwd_both(fi, fj, i0, j0, g, mode, eps=0.0):
    kw = dict(mode=mode, eps=eps, growth_rate=0.1)
    _, par = kernels.tile_accumulators_raw(fi, fj, i0, j0, **kw)
    return (kernels_bwd.raw_backward(fi, fj, i0, j0, par, g, **kw),
            kernels_bwd.raw_backward_reference(fi, fj, i0, j0, par, g, **kw))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [64, 300, 1000, 4099])
def test_backward_kernel_matches_plain_version(cuda, mode, n):
    feats, _ = random_feats(n, n, cuda)
    got, want = bwd_both(feats, feats, 0, 0, cotangent(n, n, cuda), mode)
    assert_bwd_close(got, want)


@pytest.mark.parametrize("mode", ["reference", "elastic"])
def test_backward_kernel_softened(cuda, mode):
    feats, _ = random_feats(500, 2, cuda)
    got, want = bwd_both(feats, feats, 0, 0, cotangent(500, 2, cuda), mode,
                         eps=5.0)
    assert_bwd_close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_backward_large_offsets_and_halves(cuda, mode):
    """An i range against two j halves at ids past 2^30: each call matches
    the plain version, and the halves' d_feats_i sum to the full call's."""
    n, base = 1000, (1 << 30) + 3
    feats, _ = random_feats(n, 5, cuda)
    i0, i1, half = 200, 700, 500
    g = cotangent(i1 - i0, 5, cuda)
    d_fi = 0
    for j0, j1 in ((0, half), (half, n)):
        got, want = bwd_both(feats[i0:i1], feats[j0:j1], base + i0,
                             base + j0, g, mode)
        assert_bwd_close(got, want)
        d_fi = d_fi + got[0]
    full, _ = bwd_both(feats[i0:i1], feats, base + i0, base, g, mode)
    assert_bwd_close((d_fi,), (full[0],))


def test_backward_deterministic_and_counted(cuda):
    feats, _ = random_feats(2000, 3, cuda)
    g = cotangent(2000, 3, cuda)
    kw = dict(mode="elastic", eps=0.0, growth_rate=0.1)
    before = kernels_bwd.raw_backward.launches
    a = kernels_bwd.raw_backward(feats, feats, 0, 0, None, g, **kw)
    b = kernels_bwd.raw_backward(feats, feats, 0, 0, None, g, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert kernels_bwd.raw_backward.launches == before + 4


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ni,nj", SHAPES)
def test_backward_lopsided_and_ragged_calls(cuda, mode, ni, nj):
    feats, _ = random_feats(BIG, 12, cuda)
    got, want = bwd_both(feats[:ni], feats[:nj], 0, 0,
                         cotangent(ni, 12, cuda), mode)
    assert_bwd_close(got, want)


@pytest.mark.parametrize("mode", ["reference", "momentum"])
def test_backward_large_offsets_with_splits(cuda, mode):
    base = (1 << 30) + 3
    assert max(kernels_bwd.backward_splits(BIG, BIG, mode, cuda)) > 1
    feats, _ = random_feats(BIG, 7, cuda)
    got, want = bwd_both(feats, feats, base, base, cotangent(BIG, 7, cuda),
                         mode)
    assert_bwd_close(got, want)


def test_backward_momentum_tie_across_splits(cuda):
    splits = kernels.forward_splits(BIG, BIG, "momentum", cuda)
    chunk = split_chunk(BIG, splits)
    feats, _, _ = tie_state(BIG, cuda, chunk)
    got, want = bwd_both(feats, feats, 0, 0, cotangent(BIG, 8, cuda),
                         "momentum")
    assert_bwd_close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_backward_split_repeats_bitwise(cuda, mode):
    feats, _ = random_feats(BIG, 3, cuda)
    g = cotangent(BIG, 3, cuda)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
    a = kernels_bwd.raw_backward(feats, feats, 0, 0, None, g, **kw)
    b = kernels_bwd.raw_backward(feats, feats, 0, 0, None, g, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mode", MODES)
def test_autograd_function_on_the_card(cuda, mode):
    """Gradients through pair_accumulators_kernel on the card (forward and
    backward kernels) against the same loss through the plain versions on
    the CPU."""
    n = 700
    feats, mass = random_feats(n, 8, cuda)
    w = cotangent(n, 9, cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [t.detach().to(dev).requires_grad_(True) for t in
              (feats[:, 0:2], feats[:, 2:4], mass, feats[:, 5])]
        acc = kernels.pair_accumulators_kernel(*xs, mode=mode)
        wd = w.to(dev)
        out = ((acc.force * wd[:, 0:2]).sum() + (acc.dv * wd[:, 2:4]).sum()
               + (acc.gained_mass * wd[:, 4]).sum()
               + (acc.gained_radius * wd[:, 5]).sum())
        grads.append([g.cpu() for g in torch.autograd.grad(out, xs)])
    assert_bwd_close(*grads)


# ---------------------------------------------------------------------------
# The 3-D forms of B1 and B2 (dim = 3: pos[0:3], vel[3:6], mass 6, radius 7)
# ---------------------------------------------------------------------------

def random_feats_3d(n, seed, dev, field=300.0):
    """Dense 3-D overlaps, slot 7 dead, a run of equal-mass ties."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(5, 60, n).astype(np.float32)
    mass[n // 2:n // 2 + 8] = mass[n // 2]
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    return kernels.body_features(*t), t[2]


def both_3d(feats, mass, mode, i0=0, j0=0, fi=None, mi=None, eps=0.0):
    fi = feats if fi is None else fi
    mi = mass if mi is None else mi
    kw = dict(mode=mode, eps=eps, growth_rate=0.1, dim=3)
    rk, pk = kernels.tile_accumulators_raw(fi, feats, i0, j0, **kw)
    rp, pp = kernels.tile_accumulators_raw_reference(fi, feats, i0, j0, **kw)
    return (kernels.decode_raw(rk, pk, i0, mi, mode, dim=3),
            kernels.decode_raw(rp, pp, i0, mi, mode, dim=3))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [64, 300, 4099])
def test_kernel_3d_matches_plain_version(cuda, mode, n):
    feats, mass = random_feats_3d(n, n, cuda)
    a, b = both_3d(feats, mass, mode)
    assert a.force.shape == (n, 3) and a.dv.shape == (n, 3)
    assert_equivalent(a, b, mode)


@pytest.mark.parametrize("mode", ["reference", "elastic"])
def test_kernel_3d_softened(cuda, mode):
    feats, mass = random_feats_3d(500, 2, cuda)
    assert_equivalent(*both_3d(feats, mass, mode, eps=25.0), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ni,nj", SHAPES)
def test_kernel_3d_lopsided_and_ragged_calls(cuda, mode, ni, nj):
    feats, mass = random_feats_3d(BIG, 11, cuda, field=2000.0)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1, dim=3)
    fi, fj = feats[:ni], feats[:nj]
    rk, pk = kernels.tile_accumulators_raw(fi, fj, 0, 0, **kw)
    rp, pp = kernels.tile_accumulators_raw_reference(fi, fj, 0, 0, **kw)
    assert_equivalent(kernels.decode_raw(rk, pk, 0, mass[:ni], mode, dim=3),
                      kernels.decode_raw(rp, pp, 0, mass[:ni], mode, dim=3),
                      mode)


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_kernel_3d_offset_halves_combine_to_full(cuda, mode):
    n, base = 1000, (1 << 30) + 3
    feats, mass = random_feats_3d(n, 9, cuda)
    i0, i1, half = 200, 700, 500
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1, dim=3)
    parts = []
    for j0, j1 in ((0, half), (half, n)):
        raw, par = kernels.tile_accumulators_raw(
            feats[i0:i1], feats[j0:j1], base + i0, base + j0, **kw)
        parts.append(kernels.decode_raw(raw, par, base + i0, mass[i0:i1],
                                        mode, dim=3))
    combined = combine_accumulators(*parts)
    _, full = both_3d(feats, mass, mode, i0=base, j0=base)
    full = type(full)(*(x[i0:i1] for x in full))
    assert_equivalent(combined, full, mode)


def tie_state_3d(n, dev, chunk):
    """tie_state in 3-D: the tied bodies and body 0 at the origin."""
    rng = np.random.RandomState(4)
    pos = rng.uniform(-1e6, 1e6, (n, 3)).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = np.full(n, 1.0, np.float32)
    ties = [c for c in (chunk - 1, chunk, 2 * chunk + 5) if 0 < c < n]
    pos[[0] + ties] = 0.0
    mass[0] = 50.0
    mass[ties] = 500.0
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    return kernels.body_features(*t), t[2], ties


def test_momentum_3d_tie_across_splits(cuda):
    splits = kernels.forward_splits(BIG, BIG, "momentum", cuda, dim=3)
    assert splits > 1
    feats, mass, ties = tie_state_3d(BIG, cuda,
                                     split_chunk(BIG, splits))
    a, b = both_3d(feats, mass, "momentum")
    assert_equivalent(a, b, "momentum")
    assert int(a.parent[0]) == min(ties) == int(b.parent[max(ties)])


@pytest.mark.parametrize("mode", ["reference", "momentum"])
def test_large_offsets_3d_with_splits(cuda, mode):
    base = (1 << 30) + 3
    assert kernels.forward_splits(BIG, BIG, mode, cuda, dim=3) > 1
    feats, mass = random_feats_3d(BIG, 6, cuda, field=2000.0)
    a, b = both_3d(feats, mass, mode, i0=base, j0=base)
    assert_equivalent(a, b, mode)
    assert int(a.parent.min()) >= base


@pytest.mark.parametrize("mode", MODES)
def test_split_kernel_3d_repeats_bitwise_and_counts(cuda, mode):
    feats, _ = random_feats_3d(BIG, 3, cuda, field=2000.0)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1, dim=3)
    before = kernels.tile_accumulators_raw.launches
    r1, p1 = kernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    r2, p2 = kernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    assert kernels.tile_accumulators_raw.launches == before + 2
    assert torch.equal(r1, r2)
    assert (p1 is None and p2 is None) or torch.equal(p1, p2)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_3d_planar_equals_2d(cuda, mode):
    """A 3-D call on the z = 0 copy of a 2-D state takes the same merge
    decisions and gives the same xy force as the 2-D call; bit for bit
    where the two forms split the partners alike."""
    n = 4099
    feats2, mass = random_feats(n, 13, cuda)
    z = torch.zeros((n, 1), device=cuda)
    pos3 = torch.cat([feats2[:, 0:2], z], 1)
    vel3 = torch.cat([feats2[:, 2:4], z], 1)
    feats3 = kernels.body_features(pos3, vel3, mass, feats2[:, 5])
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
    r2, p2 = kernels.tile_accumulators_raw(feats2, feats2, 0, 0, **kw)
    r3, p3 = kernels.tile_accumulators_raw(feats3, feats3, 0, 0, dim=3, **kw)
    a2 = kernels.decode_raw(r2, p2, 0, mass, mode)
    a3 = kernels.decode_raw(r3, p3, 0, mass, mode, dim=3)
    assert not a3.force[:, 2].any() and not a3.dv[:, 2].any()
    assert torch.equal(a3.died, a2.died)
    assert torch.equal(a3.parent, a2.parent)
    same = (kernels.forward_splits(n, n, mode, cuda)
            == kernels.forward_splits(n, n, mode, cuda, dim=3))
    for x3, x2 in ((a3.force[:, :2], a2.force), (a3.dv[:, :2], a2.dv),
                   (a3.gained_mass, a2.gained_mass),
                   (a3.gained_radius, a2.gained_radius)):
        if same:
            assert torch.equal(x3, x2)
        else:
            assert float((x3 - x2).abs().max()) <= 3e-7 * max(
                float(x2.abs().max()), 1e-30)
    # against 300 partners both forms take one split: bit for bit
    r2, _ = kernels.tile_accumulators_raw(feats2, feats2[:300], 0, 0, **kw)
    r3, _ = kernels.tile_accumulators_raw(feats3, feats3[:300], 0, 0, dim=3,
                                          **kw)
    assert torch.equal(r3[:, 0:2], r2[:, 0:2]) and not r3[:, 2].any()
    assert torch.equal(r3[:, 3:6], r2[:, 2:5]) and torch.equal(r3[:, 6],
                                                               r2[:, 6])


def bwd_both_3d(fi, fj, i0, j0, g, mode, eps=0.0):
    kw = dict(mode=mode, eps=eps, growth_rate=0.1, dim=3)
    _, par = kernels.tile_accumulators_raw(fi, fj, i0, j0, **kw)
    return (kernels_bwd.raw_backward(fi, fj, i0, j0, par, g, **kw),
            kernels_bwd.raw_backward_reference(fi, fj, i0, j0, par, g, **kw))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [64, 300, 4099])
def test_backward_kernel_3d_matches_plain_version(cuda, mode, n):
    feats, _ = random_feats_3d(n, n, cuda)
    got, want = bwd_both_3d(feats, feats, 0, 0, cotangent(n, n, cuda), mode)
    assert_bwd_close(got, want)


@pytest.mark.parametrize("mode", ["reference", "elastic"])
def test_backward_kernel_3d_softened(cuda, mode):
    feats, _ = random_feats_3d(500, 2, cuda)
    got, want = bwd_both_3d(feats, feats, 0, 0, cotangent(500, 2, cuda),
                            mode, eps=5.0)
    assert_bwd_close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_backward_3d_large_offsets_and_halves(cuda, mode):
    n, base = 1000, (1 << 30) + 3
    feats, _ = random_feats_3d(n, 5, cuda)
    i0, i1, half = 200, 700, 500
    g = cotangent(i1 - i0, 5, cuda)
    d_fi = 0
    for j0, j1 in ((0, half), (half, n)):
        got, want = bwd_both_3d(feats[i0:i1], feats[j0:j1], base + i0,
                                base + j0, g, mode)
        assert_bwd_close(got, want)
        d_fi = d_fi + got[0]
    full, _ = bwd_both_3d(feats[i0:i1], feats, base + i0, base, g, mode)
    assert_bwd_close((d_fi,), (full[0],))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ni,nj", SHAPES)
def test_backward_3d_lopsided_and_ragged_calls(cuda, mode, ni, nj):
    feats, _ = random_feats_3d(BIG, 12, cuda, field=2000.0)
    got, want = bwd_both_3d(feats[:ni], feats[:nj], 0, 0,
                            cotangent(ni, 12, cuda), mode)
    assert_bwd_close(got, want)


def test_backward_3d_momentum_tie_across_splits(cuda):
    splits = kernels.forward_splits(BIG, BIG, "momentum", cuda, dim=3)
    feats, _, _ = tie_state_3d(BIG, cuda, split_chunk(BIG, splits))
    got, want = bwd_both_3d(feats, feats, 0, 0, cotangent(BIG, 8, cuda),
                            "momentum")
    assert_bwd_close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_backward_3d_split_repeats_bitwise_and_counts(cuda, mode):
    feats, _ = random_feats_3d(BIG, 3, cuda, field=2000.0)
    g = cotangent(BIG, 3, cuda)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1, dim=3)
    assert max(kernels_bwd.backward_splits(BIG, BIG, mode, cuda, 3)) > 1
    before = kernels_bwd.raw_backward.launches
    a = kernels_bwd.raw_backward(feats, feats, 0, 0, None, g, **kw)
    b = kernels_bwd.raw_backward(feats, feats, 0, 0, None, g, **kw)
    assert kernels_bwd.raw_backward.launches == before + 4
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mode", MODES)
def test_autograd_function_3d_on_the_card(cuda, mode):
    """3-D gradients through pair_accumulators_kernel on the card against
    the same loss through the plain versions on the CPU."""
    n = 700
    feats, mass = random_feats_3d(n, 8, cuda)
    w = cotangent(n, 9, cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [t.detach().to(dev).requires_grad_(True) for t in
              (feats[:, 0:3], feats[:, 3:6], mass, feats[:, 7])]
        acc = kernels.pair_accumulators_kernel(*xs, mode=mode)
        wd = w.to(dev)
        out = ((acc.force * wd[:, 0:3]).sum() + (acc.dv * wd[:, 3:6]).sum()
               + (acc.gained_mass * wd[:, 6]).sum()
               + (acc.gained_radius * wd[:, 7]).sum())
        bm = acc.best_mass
        out = out + (torch.where(torch.isfinite(bm), bm, 0.0)
                     * wd[:, 6]).sum()
        grads.append([g.cpu() for g in torch.autograd.grad(out, xs)])
    assert_bwd_close(*grads)


# ---------------------------------------------------------------------------
# The bh kernels: near field B3 (csrc/near_kernel.cu), slot pack B4 and B5
# (csrc/slotpack_kernel.cu)
# ---------------------------------------------------------------------------

NEAR_GATE = 2e-5    # of the channel's largest value (test_barneshut.py:385)


def bh_grid_inputs(n, seed, dev, levels, need_vel, crowd=True, dim=2):
    """A slot grid's inputs on ``dev``: a quarter of the bodies crowded
    into the centre cells, body 7 dead, the rest out to the grid edges."""
    from nbodyax_torch.physics.bh_grid import _extent, _partner_structure
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1e5, 1e5, (n, dim)).astype(np.float32)
    if crowd:
        pos[: n // 4] = rng.uniform(-30, 30, (n // 4, dim))
    vel = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(50, 200, n).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    ext = _extent(t[0], t[2] > 0)
    return t, ext, _partner_structure(*t, ext, 1 << levels, need_vel)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("eps", [0.0, 100.0])
@pytest.mark.parametrize("ring", [1, 2])
def test_near_kernel_matches_plain_version(cuda, mode, eps, ring):
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    _, _, st = bh_grid_inputs(8192, 3, cuda, 4, mode == "elastic")
    fslot = pack_slots(st[4], st[2], st[3], 48)
    kw = dict(mode=mode, eps2=eps * eps, growth=0.1, g=16, ring=ring, ci=40)
    k = slots_near(fslot, **kw)
    p = slots_near_reference(fslot, **kw)
    live = fslot[:, :40, 4 if mode == "elastic" else 2] > 0
    k, p = k[live], p[live]
    fin = torch.isfinite(p)
    assert torch.equal(fin, torch.isfinite(k))
    k, p = torch.where(fin, k, 0.0), torch.where(fin, p, 0.0)
    scale = p.abs().amax(0).clamp(min=1e-30)
    exact = {"reference": [4], "momentum": [3, 4]}.get(mode, [])
    for c in range(8):
        if c in exact:
            assert torch.equal(k[:, c], p[:, c]), c
        else:
            assert float((k[:, c] - p[:, c]).abs().max() / scale[c]) \
                < NEAR_GATE, c


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim,levels,S,ci", [(2, 4, 48, 40), (3, 3, 48, 40)])
@pytest.mark.parametrize("ring", [1, 2])
def test_near_kernel_slices_tile_the_full_launch(cuda, mode, dim, levels, S,
                                                 ci, ring):
    """B3's cell-slice form (the sharded bh step's): four slices of the
    cells are each within B3's gates of their plain version (flags and
    ids exact) and together the full launch bit for bit; a slice past the
    grid is refused; each slice counts as a launch."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    _, _, st = bh_grid_inputs(8192, 3, cuda, levels, mode == "elastic",
                              dim=dim)
    fslot = pack_slots(st[4], st[2], st[3], S)
    g = 1 << levels
    ne = g ** dim // 4
    kw = dict(mode=mode, eps2=100.0, growth=0.1, g=g, ring=ring, ci=ci,
              dim=dim)
    full = slots_near(fslot, **kw)
    before = slots_near.launches
    parts = []
    rest = 2 * dim if mode == "elastic" else dim
    exact = {"reference": [dim + 2], "momentum": [dim + 1, dim + 2]}.get(
        mode, [])
    for r in range(4):
        sl = dict(cell_base=r * ne, ncells_eval=ne)
        k = slots_near(fslot, **kw, **sl)
        parts.append(k)
        p = slots_near_reference(fslot, **kw, **sl)
        live = fslot[r * ne:(r + 1) * ne, :ci, rest] > 0
        k, p = k[live], p[live]
        fin = torch.isfinite(p)
        assert torch.equal(fin, torch.isfinite(k))
        k, p = torch.where(fin, k, 0.0), torch.where(fin, p, 0.0)
        scale = p.abs().amax(0).clamp(min=1e-30)
        for c in range(8):
            if c in exact:
                assert torch.equal(k[:, c], p[:, c]), (r, c)
            else:
                assert float((k[:, c] - p[:, c]).abs().max() / scale[c]) \
                    < NEAR_GATE, (r, c)
    assert slots_near.launches == before + 4
    assert torch.equal(torch.cat(parts), full)
    with pytest.raises(ValueError, match="leaves the grid"):
        slots_near(fslot, cell_base=3 * ne + 1, ncells_eval=ne, **kw)


def test_near_kernel_deterministic_and_counted(cuda):
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    _, _, st = bh_grid_inputs(4096, 5, cuda, 4, False)
    fslot = pack_slots(st[4], st[2], st[3], 40)
    kw = dict(mode="momentum", eps2=0.0, growth=0.1, g=16, ring=1, ci=32)
    before = slots_near.launches
    assert torch.equal(slots_near(fslot, **kw), slots_near(fslot, **kw))
    assert slots_near.launches == before + 2


@pytest.mark.parametrize("crowd", [False, True])
@pytest.mark.parametrize("need_vel", [False, True])
def test_slot_pack_kernels_match_plain_versions(cuda, crowd, need_vel):
    """B4 and B5 rows bitwise equal to the gather; B5 moments within 2e-6
    of max(per-channel scale, 1) of the scatter."""
    from nbodyax_torch.physics.slotpack_kernel import (
        build_slot_grid_reference, finest_moments_reference, pack_slots)
    (pos, _, mass, _), ext, st = bh_grid_inputs(32768, 7, cuda, 5, need_vel,
                                                crowd)
    before = (pack_slots.launches, pack_slots.moment_launches)
    rows4 = pack_slots(st[4], st[2], st[3], 40)
    rows5, mom = pack_slots(st[4], st[2], st[3], 40,
                            moments=(pos, mass, ext, 5))
    assert (pack_slots.launches, pack_slots.moment_launches) == (
        before[0] + 1, before[1] + 1)
    want = build_slot_grid_reference(st[4], st[2], st[3], 32768, 1024, 40)
    assert torch.equal(rows4, want) and torch.equal(rows5, want)
    ref = finest_moments_reference(pos, mass, ext, 5)
    scale = ref.abs().amax(0).clamp(min=1.0)
    assert float(((mom - ref).abs().amax(0) / scale).max()) < 2e-6


def test_bh_accumulators_kernels_match_plain_engine(cuda):
    """bh_accumulators through B3 and B5 against the same call on the
    plain torch engine (bhPallas=off) on the card."""
    from nbodyax_torch.physics.barneshut import bh_accumulators
    t, _, _ = bh_grid_inputs(16384, 9, cuda, 5, False)
    kw = dict(eps=0.0, mode="reference", levels=5, neighbor_k=0,
              near="slots")
    a = bh_accumulators(*t, near_kernel="on", **kw)
    b = bh_accumulators(*t, near_kernel="off", **kw)
    assert float((a.force - b.force).abs().max()
                 / b.force.abs().max()) < NEAR_GATE
    assert torch.equal(a.died, b.died)
    torch.testing.assert_close(a.gained_mass, b.gained_mass, rtol=1e-5,
                               atol=0)


# ---------------------------------------------------------------------------
# B3 and B5 on hand-built edge cases. The state builders are plain numpy and
# torch on the CPU; tests/test_torch_near_plan.py holds the plain versions
# to nbodyax on the same states.
# ---------------------------------------------------------------------------

# bodies a cell, cycled over the cells; with the dead body of every other
# cell the live i slots take 0-2, 5, 10, 15-17, 20, 24 and 30-40: one and
# two parts, k = 32 / next_pow2(n) of 1 to 32 lanes, and ci = 40 > 32
LIVE_COUNTS = [0, 1, 2, 3, 6, 11, 16, 17, 18, 21, 25, 31, 32, 33, 40]


def manual_slot_grid(g, S, counts, seed, vel, id_base=0, dim=2):
    """A slot grid f32[g^dim, S, L] built by hand: cell c holds
    ``counts[c % len(counts)]`` bodies in its own 100-wide square (cube in
    3-D; radii 5-40, so pairs overlap within and across cells), then zero
    rows. In an even cell of three or more, slot 1 is a dead body (mass 0,
    its id kept), so the live slots are not a prefix. Ids count up from
    ``id_base``."""
    rng = np.random.RandomState(seed)
    L = (2 * dim if vel else dim) + 4
    grid = np.zeros((g ** dim, S, L), np.float32)
    nid = id_base
    for c in range(g ** dim):
        k = counts[c % len(counts)]
        cell = [(c // g ** d) % g for d in range(dim)]     # x fastest
        for s in range(k):
            row = [(cd + rng.uniform()) * 100.0 for cd in cell]
            if vel:
                row += list(rng.uniform(-3, 3, dim))
            dead = s == 1 and k >= 3 and c % 2 == 0
            mass = 0.0 if dead else rng.uniform(1, 100)
            row += [mass, rng.uniform(5, 40), nid >> 12, nid & 0xFFF]
            grid[c, s] = row
            nid += 1
    return torch.from_numpy(grid)


def tie_slot_grid(S, dim=2):
    """Cell 0 of a 2 x 2 (x 2) grid: body A (mass 50, id 9) and three
    bodies of mass 500 at A's place (ids 10, 5, 7, in that slot order), all
    overlapping: A's parent is id 5, which is neither the first staged
    partner nor in the first lane share; so is id 10's (5 beats it on the
    equal-mass tie)."""
    L = dim + 4
    grid = np.zeros((2 ** dim, S, L), np.float32)
    for s, (m, i) in enumerate([(50.0, 9), (500.0, 10), (500.0, 5),
                                (500.0, 7)]):
        grid[0, s, :dim] = 50.0
        grid[0, s, L - 4:] = [m, 1.0, i >> 12, i & 0xFFF]
    return torch.from_numpy(grid)


def chunk_counts_state(counts, levels, seed, n_dead=10, dim=2):
    """pos, vel, mass, radius with exactly ``counts[c]`` live bodies in
    cell c of the 2^levels grid over [0, 1000]^dim (two bodies pin the
    extent's corners), plus ``n_dead`` dead ones."""
    rng = np.random.RandomState(seed)
    g = 1 << levels
    w = 1000.0 / g
    pos = []
    for c, k in enumerate(counts):
        cell = [(c // g ** d) % g for d in range(dim)]     # x fastest
        pos.append(np.stack([rng.uniform((cd + 0.1) * w, (cd + 0.9) * w, k)
                             for cd in cell], 1))
    pos = np.concatenate(pos).astype(np.float32)
    pos[0] = 0.0                         # in cell 0
    pos[-1] = 1000.0                     # in the last cell
    n = pos.shape[0] + n_dead
    pos = np.concatenate([pos, rng.uniform(0, 1000, (n_dead, dim))]).astype(
        np.float32)
    vel = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
    mass[-n_dead:] = 0.0
    radius = rng.uniform(1, 5, n).astype(np.float32)
    return pos, vel, mass, radius


# cell counts whose running sums put chunk boundaries (every 256 bodies)
# on cell edges (256, 768, 1024) and inside cells, with cells of more and
# of fewer than 256 bodies on both sides and a total not a multiple of 256
CHUNK_COUNTS = [256, 512, 1, 0, 255, 257, 300, 0, 700, 3, 0, 0, 1000, 256, 5,
                77]


def near_check(k, p, mode, dim=2):
    """B3 against its plain version at every slot: float channels within
    NEAR_GATE of the channel's largest value, died and ids exact, the
    momentum candidate sets equal."""
    fin = torch.isfinite(p)
    assert torch.equal(fin, torch.isfinite(k))
    k, p = torch.where(fin, k, 0.0), torch.where(fin, p, 0.0)
    scale = p.abs().amax((0, 1)).clamp(min=1e-30)
    exact = {"reference": [dim + 2],
             "momentum": [dim + 1, dim + 2]}.get(mode, [])
    for c in range(8):
        if c in exact:
            assert torch.equal(k[..., c], p[..., c]), c
        else:
            assert float((k[..., c] - p[..., c]).abs().max() / scale[c]) \
                < NEAR_GATE, c


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ring", [1, 2])
def test_near_kernel_live_counts_and_dead_mid_cell(cuda, mode, ring):
    """Cells of 0 to 40 live slots (LIVE_COUNTS: every lane share k, one
    and two parts, the ci = 40 > 32 second group, windows staged whole and
    in several passes), dead bodies between live ones as i and as partner,
    ring 2 at the corners of an 8 x 8 grid, ids past 2^24, at eps 0 and
    100, and bitwise repeats."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    fslot = manual_slot_grid(8, 48, LIVE_COUNTS, 21, mode == "elastic",
                             id_base=(1 << 25) + 3).to(cuda)
    for eps in (0.0, 100.0):
        kw = dict(mode=mode, eps2=eps * eps, growth=0.1, g=8, ring=ring,
                  ci=40)
        k = slots_near(fslot, **kw)
        near_check(k, slots_near_reference(fslot, **kw), mode)
        assert torch.equal(k, slots_near(fslot, **kw))


def test_near_kernel_momentum_tie_across_lane_shares(cuda):
    """n_i = 4 gives each i slot 8 lanes, so the three equal-mass winners
    are summed in three different lane shares: the fold must pick id 5."""
    from nbodyax_torch.physics.bh_grid import _unpack_id
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    fslot = tie_slot_grid(8).to(cuda)
    kw = dict(mode="momentum", eps2=0.0, growth=0.1, g=2, ring=1, ci=8)
    k = slots_near(fslot, **kw)
    near_check(k, slots_near_reference(fslot, **kw), "momentum")
    assert int(_unpack_id(k[0, 0, 3], k[0, 0, 4])) == 5
    assert int(_unpack_id(k[0, 1, 3], k[0, 1, 4])) == 5


@pytest.mark.parametrize("mode", MODES)
def test_near_kernel_s1024_crowded(cuda, mode):
    """S = 1024 and ring 2: a crowded cell's window is 25,600 slots, staged
    through the fixed buffer in many passes."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    counts = [1000, 3, 0, 700, 1024, 17]
    fslot = manual_slot_grid(4, 1024, counts, 23, mode == "elastic").to(cuda)
    # crowd each cell into a 10 x 10 corner so every pair overlaps often
    fslot[..., :2] = torch.floor(fslot[..., :2] / 100.0) * 100.0 \
        + torch.remainder(fslot[..., :2], 10.0)
    kw = dict(mode=mode, eps2=0.0, growth=0.1, g=4, ring=2, ci=64)
    k = slots_near(fslot, **kw)
    near_check(k, slots_near_reference(fslot, **kw), mode)
    assert torch.equal(k, slots_near(fslot, **kw))


def test_near_shared_bytes_match_plan(cuda):
    from nbodyax_torch.physics._build import load_library
    from nbodyax_torch.physics.near_kernel import MODES as NMODES, near_plan
    lib = load_library()
    for S in (40, 48, 1024):
        for ring in (1, 2):
            for mode in NMODES:
                for dim in (2, 3):
                    L = (2 * dim if mode == "elastic" else dim) + 4
                    cap, nbytes = near_plan(S, ring, L, dim)
                    assert lib.nbodyax_near_shared_bytes(
                        NMODES.index(mode), cap, dim) == nbytes


def slot_pack_check(arrays, levels, S, dev, need_vel=False):
    """B4 and B5 rows bitwise equal to the gather, B5 moments within 2e-6
    of max(per-channel scale, 1), and both bitwise on a repeat, in the
    dimension of ``arrays``."""
    from nbodyax_torch.physics.bh_grid import _extent, _partner_structure
    from nbodyax_torch.physics.slotpack_kernel import (
        build_slot_grid_reference, finest_moments_reference, pack_slots)
    pos, vel, mass, radius = (torch.from_numpy(x).to(dev) for x in arrays)
    ext = _extent(pos, mass > 0)
    st = _partner_structure(pos, vel, mass, radius, ext, 1 << levels,
                            need_vel)
    n, ncells = pos.shape[0], 1 << (pos.shape[1] * levels)
    want = build_slot_grid_reference(st[4], st[2], st[3], n, ncells, S)
    rows4 = pack_slots(st[4], st[2], st[3], S)
    rows5, mom = pack_slots(st[4], st[2], st[3], S,
                            moments=(pos, mass, ext, levels))
    assert torch.equal(rows4, want) and torch.equal(rows5, want)
    ref = finest_moments_reference(pos, mass, ext, levels)
    scale = ref.abs().amax(0).clamp(min=1.0)
    assert float(((mom - ref).abs().amax(0) / scale).max()) < 2e-6
    again, mom2 = pack_slots(st[4], st[2], st[3], S,
                             moments=(pos, mass, ext, levels))
    assert torch.equal(again, rows5) and torch.equal(mom2, mom)
    return st


@pytest.mark.parametrize("S", [40, 33, 256])
def test_slot_pack_chunk_boundaries(cuda, S):
    """Chunk boundaries on cell edges and inside cells of more and fewer
    than 256 bodies, empty cells, n not a multiple of 256; S * L a multiple
    of 4 (16-byte stores), of 2 only (S = 33), and cells shorter than S."""
    st = slot_pack_check(chunk_counts_state(CHUNK_COUNTS, 2, 31), 2, S, cuda)
    assert (st[3] - st[2]).tolist() == CHUNK_COUNTS


def test_slot_pack_crowded_cell_beside_empty_cells(cuda):
    """A cell of 70,000 bodies (274 chunks) beside 1,000 empty cells."""
    counts = [0] * 1024
    counts[517] = 70000
    counts[0] = counts[-1] = 1
    counts[300] = 300
    slot_pack_check(chunk_counts_state(counts, 5, 33), 5, 40, cuda)


# ---------------------------------------------------------------------------
# The 3-D forms of B3, B4 and B5 (``dim = 3``: rows of 7 and 10, 10 moments)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("eps", [0.0, 100.0])
@pytest.mark.parametrize("ring", [1, 2])
def test_near_kernel_3d_matches_plain_version(cuda, mode, eps, ring):
    """B3's 3-D form on a sorted state with a crowded centre, a dead body
    and grid edges (8 x 8 x 8 cells): float channels within NEAR_GATE of
    the channel's largest value at the live slots, flags and ids exact."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    _, _, st = bh_grid_inputs(16384, 3, cuda, 3, mode == "elastic", dim=3)
    fslot = pack_slots(st[4], st[2], st[3], 48)
    kw = dict(mode=mode, eps2=eps * eps, growth=0.1, g=8, ring=ring, ci=40,
              dim=3)
    k = slots_near(fslot, **kw)
    p = slots_near_reference(fslot, **kw)
    live = fslot[:, :40, 6 if mode == "elastic" else 3] > 0
    near_check(k[live][None], p[live][None], mode, dim=3)
    assert not k[..., 6:].any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ring", [1, 2])
def test_near_kernel_3d_live_counts_and_dead_mid_cell(cuda, mode, ring):
    """test_near_kernel_live_counts_and_dead_mid_cell on a 4 x 4 x 4 grid:
    cells of 0 to 40 live slots, dead bodies between live ones, every cell
    within ring 2 of a face, ids past 2^24, eps 0 and 100, every slot held
    (live or not), and bitwise repeats."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    fslot = manual_slot_grid(4, 48, LIVE_COUNTS, 21, mode == "elastic",
                             id_base=(1 << 25) + 3, dim=3).to(cuda)
    for eps in (0.0, 100.0):
        kw = dict(mode=mode, eps2=eps * eps, growth=0.1, g=4, ring=ring,
                  ci=40, dim=3)
        k = slots_near(fslot, **kw)
        near_check(k, slots_near_reference(fslot, **kw), mode, dim=3)
        assert torch.equal(k, slots_near(fslot, **kw))


def test_near_kernel_3d_momentum_tie_across_lane_shares(cuda):
    from nbodyax_torch.physics.bh_grid import _unpack_id
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    fslot = tie_slot_grid(8, dim=3).to(cuda)
    kw = dict(mode="momentum", eps2=0.0, growth=0.1, g=2, ring=1, ci=8,
              dim=3)
    k = slots_near(fslot, **kw)
    near_check(k, slots_near_reference(fslot, **kw), "momentum", dim=3)
    assert int(_unpack_id(k[0, 0, 4], k[0, 0, 5])) == 5
    assert int(_unpack_id(k[0, 1, 4], k[0, 1, 5])) == 5


@pytest.mark.parametrize("mode", MODES)
def test_near_kernel_3d_s1024_crowded(cuda, mode):
    """S = 1024 on a 2 x 2 x 2 grid: every window is the whole grid, up to
    8,192 slots staged through the fixed buffer in many passes."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    counts = [1000, 3, 0, 700, 1024, 17]
    fslot = manual_slot_grid(2, 1024, counts, 23, mode == "elastic",
                             dim=3).to(cuda)
    fslot[..., :3] = torch.floor(fslot[..., :3] / 100.0) * 100.0 \
        + torch.remainder(fslot[..., :3], 10.0)
    kw = dict(mode=mode, eps2=0.0, growth=0.1, g=2, ring=1, ci=64, dim=3)
    k = slots_near(fslot, **kw)
    near_check(k, slots_near_reference(fslot, **kw), mode, dim=3)
    assert torch.equal(k, slots_near(fslot, **kw))


def test_near_kernel_3d_misaligned_grid_and_counter(cuda):
    """A slot grid of 7-float rows that starts 4 bytes into an allocation
    (the wrapper copies nothing: such rows need only 4-byte alignment) and
    one of 10-float rows that does (copied to 8 bytes): both equal the
    aligned call; each call counts one launch."""
    from nbodyax_torch.physics.near_kernel import slots_near
    for vel in (False, True):
        fslot = manual_slot_grid(2, 40, LIVE_COUNTS, 5, vel, dim=3).to(cuda)
        mode = "elastic" if vel else "reference"
        kw = dict(mode=mode, eps2=0.0, growth=0.1, g=2, ring=1, ci=32, dim=3)
        buf = torch.zeros(fslot.numel() + 1, device=cuda)
        off = buf[1:].view(fslot.shape)
        off.copy_(fslot)
        assert off.data_ptr() % 8 == 4
        before = slots_near.launches
        assert torch.equal(slots_near(off, **kw), slots_near(fslot, **kw))
        assert slots_near.launches == before + 2


@pytest.mark.parametrize("crowd", [False, True])
@pytest.mark.parametrize("need_vel", [False, True])
def test_slot_pack_kernels_3d_match_plain_versions(cuda, crowd, need_vel):
    """B4 and B5 at L = 7 and L = 10: rows bitwise equal to the gather;
    B5's 10 moments within 2e-6 of max(per-channel scale, 1)."""
    from nbodyax_torch.physics.slotpack_kernel import (
        build_slot_grid_reference, finest_moments_reference, pack_slots)
    (pos, _, mass, _), ext, st = bh_grid_inputs(32768, 7, cuda, 3, need_vel,
                                                crowd, dim=3)
    assert st[4].shape[1] == (10 if need_vel else 7)
    before = (pack_slots.launches, pack_slots.moment_launches)
    for S in (80, 33):
        rows4 = pack_slots(st[4], st[2], st[3], S)
        rows5, mom = pack_slots(st[4], st[2], st[3], S,
                                moments=(pos, mass, ext, 3))
        want = build_slot_grid_reference(st[4], st[2], st[3], 32768, 512, S)
        assert torch.equal(rows4, want) and torch.equal(rows5, want)
        ref = finest_moments_reference(pos, mass, ext, 3)
        assert mom.shape == ref.shape == (512, 10)
        scale = ref.abs().amax(0).clamp(min=1.0)
        assert float(((mom - ref).abs().amax(0) / scale).max()) < 2e-6
    assert (pack_slots.launches, pack_slots.moment_launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("need_vel", [False, True])
def test_slot_pack_3d_chunk_boundaries_and_crowded_cell(cuda, need_vel):
    """B5's chunk pass in 3-D: chunk boundaries on cell edges and inside
    cells (CHUNK_COUNTS over the first 16 of 64 cells), then a cell of
    70,000 bodies beside empty cells."""
    counts = CHUNK_COUNTS + [0] * 47 + [1]
    st = slot_pack_check(chunk_counts_state(counts, 2, 31, dim=3), 2, 40,
                         cuda, need_vel)
    assert (st[3] - st[2]).tolist() == counts
    counts = [0] * 512
    counts[300] = 70000
    counts[0] = counts[-1] = 1
    counts[77] = 300
    slot_pack_check(chunk_counts_state(counts, 3, 33, dim=3), 3, 80, cuda,
                    need_vel)


@pytest.mark.parametrize("mode", ["reference", "elastic"])
def test_bh_accumulators_3d_kernels_match_plain_engine(cuda, mode):
    """3-D bh_accumulators through B3 and B5 against the same call on the
    plain torch engine (bhPallas=off) on the card, and through B4 with
    bhFar=direct bhOrder=1."""
    from nbodyax_torch.physics.barneshut import bh_accumulators
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    t, _, _ = bh_grid_inputs(16384, 9, cuda, 3, False, dim=3)
    for far, order in (("fmm", 2), ("direct", 1)):
        kw = dict(eps=0.0, mode=mode, levels=3, neighbor_k=0, near="slots",
                  far=far, order=order)
        before = (pack_slots.launches, pack_slots.moment_launches)
        a = bh_accumulators(*t, near_kernel="on", **kw)
        assert (pack_slots.launches - before[0],
                pack_slots.moment_launches - before[1]) == (
            (0, 1) if far == "fmm" else (1, 0))
        b = bh_accumulators(*t, near_kernel="off", **kw)
        assert float((a.force - b.force).abs().max()
                     / b.force.abs().max()) < NEAR_GATE
        assert torch.equal(a.died, b.died)
        torch.testing.assert_close(a.gained_mass, b.gained_mass, rtol=1e-5,
                                   atol=0)
        if mode == "elastic":
            assert float((a.dv - b.dv).abs().max()
                         / b.dv.abs().max().clamp(min=1e-30)) < NEAR_GATE


# ---------------------------------------------------------------------------
# The bh annulus kernel (csrc/annulus_kernel.cu) against the plain
# fmm._annulus_force_cells on the card
# ---------------------------------------------------------------------------

ANNULUS_GATE = 1e-5   # of the largest force magnitude: float32 reordering


def annulus_setup(arrays, dev, levels, S):
    """The finest moment grid, the partner structure and the slot grid
    (S slots a cell, B5's pack) of the numpy state ``arrays`` on ``dev``."""
    from nbodyax_torch.physics.bh_grid import _extent, _partner_structure
    from nbodyax_torch.physics.fmm import _level_grids
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    pos, vel, mass, radius = (torch.from_numpy(np.ascontiguousarray(x)).to(
        dev) for x in arrays)
    ext = _extent(pos, mass > 0)
    st = _partner_structure(pos, vel, mass, radius, ext, 1 << levels, False)
    grids = _level_grids(pos, mass, ext, levels, order=2)
    fslot = pack_slots(st[4], st[2], st[3], S)
    return torch.stack(grids[levels], 1), ext, st, fslot


def annulus_check(packed, ext, levels, ring, eps2, st, ci, fslot=None,
                  cell_range=None):
    """The kernel against the plain version: ids equal everywhere, the
    force at every slot below its cell's count within ANNULUS_GATE of the
    largest, 0 past it. Returns the kernel's (force, ids)."""
    from nbodyax_torch.physics.annulus_kernel import annulus_cells
    from nbodyax_torch.physics.fmm import _annulus_force_cells
    args = (packed, ext, levels, ring, ring + 1, eps2, 2, st, ci)
    kw = dict(fslot=fslot, cell_range=cell_range)
    before = annulus_cells.launches
    k, kid = annulus_cells(*args, **kw)
    assert annulus_cells.launches == before + 1
    p, pid = _annulus_force_cells(*args, **kw)
    assert torch.equal(kid, pid)
    c0, nc = cell_range or (0, packed.shape[0])
    count = (st[3] - st[2])[c0:c0 + nc].clamp(max=ci)
    live = (torch.arange(ci, device=k.device)[None, :]
            < count[:, None]).reshape(-1)
    assert bool(live.any())
    scale = float(p[live].abs().max())
    err = float((k[live] - p[live]).abs().max()) / scale
    assert err < ANNULUS_GATE, err
    assert not bool(k[~live].any())
    return k, kid


@pytest.fixture(scope="module")
def million_scenes():
    """The bh cells' 1M scenes as numpy arrays: the 2-D scene of
    examples/million_bodies.txt and its 3-D uniform cube."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.scenes import init_scene
    out = {}
    for dim in (2, 3):
        cfg = SimConfig(particle_count=1 << 20, field_width=1_000_000,
                        field_height=1_000_000, force_model="bh",
                        dimensions=dim)
        state = init_scene(cfg, device="cpu")
        out[dim] = [x.numpy().copy() for x in state[:4]]
    return out


# the scenes' auto knobs: levels, S, ci (chip_smoke.py phases 16 and 27)
MILLION_KNOBS = {2: (8, 40, 32), 3: (5, 80, 64)}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("ring", [1, 2])
@pytest.mark.parametrize("source", ["fslot", "rows"])
def test_annulus_kernel_on_the_million_scenes(cuda, million_scenes, dim,
                                              ring, source):
    from nbodyax_torch.physics.barneshut import slot_cap
    levels, S, ci = MILLION_KNOBS[dim]
    assert ci == slot_cap(1 << 20, (1 << levels) ** dim)
    packed, ext, st, fslot = annulus_setup(million_scenes[dim], cuda, levels,
                                           S)
    annulus_check(packed, ext, levels, ring, 0.0, st, ci,
                  fslot=fslot if source == "fslot" else None)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("ci", [32, 64, 1024])
@pytest.mark.parametrize("source", ["fslot", "rows"])
def test_annulus_kernel_slot_budgets_and_crowded_cells(cuda, dim, ci,
                                                       source):
    """A crowded centre (a quarter of the bodies in one cell, which fills
    1,024 slots), empty cells, boundary cells whose shells leave the grid,
    softening, ring 1 and 2; for the slot grid, every third cell's slot 1
    made a dead body, so dead slots sit between live ones."""
    levels = 4 if dim == 2 else 3
    arrays = crowded_like_bh(16384 if dim == 2 else 32768, 21, dim)
    packed, ext, st, fslot = annulus_setup(arrays, cuda, levels, ci)
    count = st[3] - st[2]
    assert int(count.max()) >= 1024 and int((count == 0).sum()) > 0
    fslot[::3, 1, dim] = 0.0
    for ring, eps in ((1, 0.0), (2, 100.0)):
        annulus_check(packed, ext, levels, ring, eps * eps, st, ci,
                      fslot=fslot if source == "fslot" else None)


def crowded_like_bh(n, seed, dim):
    """Bodies over +-1e5 but for a band of x that leaves columns of cells
    empty, a quarter of them inside one cell (a 60-wide patch off the
    cells' edges), body 7 dead."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1e5, 1e5, (n, dim)).astype(np.float32)
    pos[:, 0] = np.where(np.abs(pos[:, 0]) < 3e4, 1e5, pos[:, 0])
    pos[: n // 4] = rng.uniform(1000, 1060, (n // 4, dim))
    vel = np.zeros((n, dim), np.float32)
    mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
    mass[7] = 0.0
    return pos, vel, mass, rng.uniform(50, 200, n).astype(np.float32)


@pytest.mark.parametrize("dim", [2, 3])
def test_annulus_kernel_slices_tile_the_full_launch(cuda, dim):
    """Eight cell ranges, as the sharded bh step takes them, make the full
    launch bit for bit; two full launches are bitwise equal."""
    from nbodyax_torch.physics.annulus_kernel import annulus_cells
    levels = 4 if dim == 2 else 3
    packed, ext, st, fslot = annulus_setup(
        crowded_like_bh(16384, 22, dim), cuda, levels, 64)
    args = (packed, ext, levels, 1, 2, 0.0, 2, st, 64)
    full, ids = annulus_cells(*args, fslot=fslot)
    again, ids2 = annulus_cells(*args, fslot=fslot)
    assert torch.equal(full, again) and torch.equal(ids, ids2)
    ncells = packed.shape[0]
    parts = [annulus_check(packed, ext, levels, 1, 0.0, st, 64, fslot=fslot,
                           cell_range=(r * ncells // 8, ncells // 8))
             for r in range(8)]
    assert torch.equal(torch.cat([f for f, _ in parts]), full)
    assert torch.equal(torch.cat([i for _, i in parts]), ids)


@pytest.mark.parametrize("dim", [2, 3])
def test_bh_accumulators_take_the_annulus_kernel(cuda, dim, monkeypatch):
    """The bh step on the card runs the annulus kernel once a call, on
    both engines, and its far force stays within the near field's gate of
    the step with the plain annulus."""
    from nbodyax_torch.physics import barneshut, fmm
    from nbodyax_torch.physics.annulus_kernel import annulus_cells
    t, _, _ = bh_grid_inputs(16384, 9, cuda, 4, False, dim=dim)
    for near in ("slots", "rows"):
        kw = dict(eps=0.0, mode="reference", levels=4 if dim == 2 else 3,
                  neighbor_k=0, near=near)
        before = annulus_cells.launches
        a = barneshut.bh_accumulators(*t, **kw)
        assert annulus_cells.launches == before + 1
        with monkeypatch.context() as m:
            m.setattr(barneshut, "annulus_cells", fmm._annulus_force_cells)
            b = barneshut.bh_accumulators(*t, **kw)
        assert float((a.force - b.force).abs().max()
                     / b.force.abs().max()) < NEAR_GATE
        assert torch.equal(a.died, b.died)
