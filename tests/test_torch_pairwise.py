"""nbodyax_torch all-pairs accumulators against the JAX package.

The port's torch oracle and the plain version of its CUDA kernel are held
to ``nbodyax.physics.pairwise.pair_accumulators``, and the plain version's
raw channels to the Pallas kernel run in interpret mode, at the gates of
tests/test_kernels.py. Everything here runs on the CPU; the kernel itself
is tested on the card by tests/test_torch_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.physics import kernels as jkernels  # noqa: E402
from nbodyax.physics.pairwise import \
    pair_accumulators as jax_pair_accumulators  # noqa: E402
from nbodyax_torch.backends import build_accum_fn  # noqa: E402
from nbodyax_torch.physics import kernels as tkernels  # noqa: E402
from nbodyax_torch.physics.pairwise import (  # noqa: E402
    combine_accumulators, pair_accumulators)
from nbodyax_torch.physics.step import PhysicsParams  # noqa: E402

MODES = ["reference", "momentum", "elastic", "none"]


def random_state(n, seed=0, field=1000.0):
    """tests/test_kernels.py's inputs: dense overlaps, slot 7 dead."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    if n > 10:
        mass[7] = 0.0
    radius = rng.uniform(5, 40, n).astype(np.float32)
    return pos, vel, mass, radius


def tensors(arrays):
    return [torch.from_numpy(x) for x in arrays]


def assert_equivalent(a, b, mode):
    """tests/test_kernels.py::assert_equivalent, for a port result ``a``."""
    fa, fb = a.force.numpy(), np.asarray(b.force)
    assert np.abs(fa - fb).max() / max(np.abs(fb).max(), 1e-30) < 2e-6
    if mode == "reference":
        np.testing.assert_allclose(a.gained_mass.numpy(),
                                   np.asarray(b.gained_mass), rtol=1e-6)
        np.testing.assert_allclose(a.gained_radius.numpy(),
                                   np.asarray(b.gained_radius), rtol=1e-6)
        np.testing.assert_array_equal(a.died.numpy(), np.asarray(b.died))
    if mode == "momentum":
        np.testing.assert_array_equal(a.parent.numpy(), np.asarray(b.parent))
        bm = np.asarray(b.best_mass)
        np.testing.assert_array_equal(a.best_mass.numpy(), bm)
    if mode == "elastic":
        da, db = a.dv.numpy(), np.asarray(b.dv)
        assert np.abs(da - db).max() / max(np.abs(db).max(), 1e-30) < 1e-5


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [64, 100, 300])
def test_oracle_matches_jax_oracle(mode, n):
    arrays = random_state(n, seed=n)
    a = pair_accumulators(*tensors(arrays), mode=mode, growth_rate=0.1)
    b = jax_pair_accumulators(*arrays, mode=mode, growth_rate=0.1)
    assert_equivalent(a, b, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [64, 100, 300])
def test_kernel_plain_version_matches_jax_oracle(mode, n):
    arrays = random_state(n, seed=n)
    a = tkernels.pair_accumulators_kernel(*tensors(arrays), mode=mode,
                                          growth_rate=0.1)
    b = jax_pair_accumulators(*arrays, mode=mode, growth_rate=0.1)
    assert_equivalent(a, b, mode)


@pytest.mark.parametrize("eps", [0.0, 25.0])
def test_softened_force_matches_jax_oracle(eps):
    arrays = random_state(120, seed=5)
    b = jax_pair_accumulators(*arrays, mode="elastic", eps=eps)
    for fn in (pair_accumulators, tkernels.pair_accumulators_kernel):
        a = fn(*tensors(arrays), mode="elastic", eps=eps)
        assert_equivalent(a, b, "elastic")


@pytest.mark.parametrize("mode", MODES)
def test_raw_channels_match_pallas_interpret(mode):
    """The plain version's raw layout, with i/j offsets, against the Pallas
    kernel in interpret mode: i rows 0..64 (slot 7 dead) against each j
    half."""
    n = 160
    arrays = random_state(n, seed=11)
    tf = tkernels.body_features(*tensors(arrays))
    jf = np.asarray(jkernels.body_features(*arrays))
    np.testing.assert_array_equal(tf.numpy(), jf)
    i0, i1 = 0, 64
    for j0, j1 in ((0, 80), (80, 160)):
        raw, par = tkernels.tile_accumulators_raw_reference(
            tf[i0:i1], tf[j0:j1], i0, j0, mode=mode, eps=0.0,
            growth_rate=0.1)
        jraw, jpar = jkernels.tile_accumulators_raw(
            jf[i0:i1], jf[j0:j1].T, i0, j0, mode=mode, eps=0.0,
            growth_rate=0.1, tile_i=32, tile_j=128, interpret=True)
        raw, jraw = raw.numpy(), np.asarray(jraw)
        scale = max(np.abs(jraw[:, 0:2]).max(), 1e-30)
        assert np.abs(raw[:, 0:2] - jraw[:, 0:2]).max() / scale < 2e-6
        tol = 1e-5 if mode == "elastic" else 1e-6
        np.testing.assert_allclose(raw[:, 2:6], jraw[:, 2:6], rtol=tol,
                                   atol=tol * max(np.abs(jraw[:, 2:6]).max(),
                                                  1e-30))
        np.testing.assert_array_equal(raw[:, 6], np.asarray(jraw)[:, 6])
        if mode == "momentum":
            np.testing.assert_array_equal(par.numpy(), np.asarray(jpar)[:, 0])
        else:
            assert par is None and jpar is None


@pytest.mark.parametrize("mode", ["reference", "momentum"])
def test_offset_partition_equals_full(mode):
    """i rows 32..64 against two offset j halves, combined, equal the full
    pass (the building block of split and ring paths)."""
    n = 128
    pos, vel, mass, radius = tensors(random_state(n, seed=9))
    feats = tkernels.body_features(pos, vel, mass, radius)
    i0, i1, half = 32, 64, n // 2
    parts = []
    for j0, j1 in ((0, half), (half, n)):
        raw, par = tkernels.tile_accumulators_raw(
            feats[i0:i1], feats[j0:j1], i0, j0, mode=mode, eps=0.0,
            growth_rate=0.1)
        parts.append(tkernels.decode_raw(raw, par, i0, mass[i0:i1], mode))
    combined = combine_accumulators(*parts)
    full = pair_accumulators(pos, vel, mass, radius, mode=mode)
    np.testing.assert_array_equal(combined.parent.numpy(),
                                  full.parent[i0:i1].numpy())
    np.testing.assert_array_equal(combined.died.numpy(),
                                  full.died[i0:i1].numpy())
    np.testing.assert_allclose(combined.force.numpy(),
                               full.force[i0:i1].numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_chunking_does_not_change_results(mode):
    arrays = tensors(random_state(200, seed=2))
    a = pair_accumulators(*arrays, mode=mode)
    b = pair_accumulators(*arrays, mode=mode, chunk=17)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    feats = tkernels.body_features(*arrays)
    ra, pa = tkernels.tile_accumulators_raw_reference(
        feats, feats, 0, 0, mode=mode, eps=0.0, growth_rate=0.1)
    rb, pb = tkernels.tile_accumulators_raw_reference(
        feats, feats, 0, 0, mode=mode, eps=0.0, growth_rate=0.1, chunk=13)
    alive = arrays[2] > 0
    torch.testing.assert_close(ra[alive], rb[alive], rtol=1e-6, atol=1e-6)
    if pa is not None:
        assert torch.equal(pa, pb)


def test_cpu_wrapper_runs_plain_version_and_counts_nothing():
    feats = tkernels.body_features(*tensors(random_state(50, seed=1)))
    before = tkernels.tile_accumulators_raw.launches
    raw, _ = tkernels.tile_accumulators_raw(feats, feats, 0, 0,
                                            mode="reference", eps=0.0,
                                            growth_rate=0.1)
    ref, _ = tkernels.tile_accumulators_raw_reference(
        feats, feats, 0, 0, mode="reference", eps=0.0, growth_rate=0.1)
    assert torch.equal(raw, ref)
    assert tkernels.tile_accumulators_raw.launches == before


@pytest.mark.parametrize("bad", ["dtype", "width", "mode", "dim3"])
def test_wrapper_rejects_bad_input(bad):
    feats = tkernels.body_features(*tensors(random_state(20, seed=1)))
    kw = dict(mode="reference", eps=0.0, growth_rate=0.1)
    if bad == "dtype":
        with pytest.raises(ValueError):
            tkernels.tile_accumulators_raw(feats.double(), feats, 0, 0, **kw)
    elif bad == "width":
        with pytest.raises(ValueError):
            tkernels.tile_accumulators_raw(feats[:, :6], feats, 0, 0, **kw)
    elif bad == "mode":
        with pytest.raises(ValueError):
            tkernels.tile_accumulators_raw(feats, feats, 0, 0, mode="bogus",
                                           eps=0.0, growth_rate=0.1)
    else:
        z = torch.zeros((4, 3))
        with pytest.raises(NotImplementedError):
            tkernels.body_features(z, z, torch.ones(4), torch.ones(4))


def test_backends_map_config_values():
    p = PhysicsParams()
    assert build_accum_fn("jnp", p, "cpu").func is pair_accumulators
    auto = build_accum_fn("auto", p, "cpu")
    assert auto.func is tkernels.pair_accumulators_kernel
    with pytest.raises(ValueError, match="pallas"):
        build_accum_fn("pallas", p, "cpu")
    with pytest.raises(ValueError):
        build_accum_fn("bogus", p, "cpu")
