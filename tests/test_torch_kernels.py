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


def test_softening(cuda):
    feats, mass = random_feats(500, 2, cuda)
    kw = dict(mode="elastic", eps=25.0, growth_rate=0.1)
    rk, _ = kernels.tile_accumulators_raw(feats, feats, 0, 0, **kw)
    rp, _ = kernels.tile_accumulators_raw_reference(feats, feats, 0, 0, **kw)
    a = kernels.decode_raw(rk, None, 0, mass, "elastic")
    b = kernels.decode_raw(rp, None, 0, mass, "elastic")
    assert_equivalent(a, b, "elastic")


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
