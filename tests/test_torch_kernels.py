"""The hand-written CUDA all-pairs kernel against its plain PyTorch version.

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
