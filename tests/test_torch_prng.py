"""nbodyax_torch.prng against jax.random, bit for bit, on the CPU.

``prng_key``, ``split``, ``bits`` and ``uniform`` at the seeds 0, 1, 1024,
2^31 - 1 and -1, over a 1-D range and a range broadcast over (n, 3), with
n up to 2^20: every word and every float equal (tolerance: none). The
fused multiply-add of ``uniform`` rounds once, also where rounding twice
would not.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nbodyax_torch import prng  # noqa: E402

SEEDS = [0, 1, 1024, 2 ** 31 - 1, -1]


def words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + [-2 ** 31, 2 ** 32 - 1, 2 ** 40 + 5])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  words(jax.random.PRNGKey(seed)))


def test_prng_key_words():
    assert prng.prng_key(-1).tolist() == [0, 4294967295]
    assert prng.prng_key(2 ** 31 - 1).tolist() == [0, 2147483647]


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_bits(seed):
    """``split`` at 2, 3, 5 and 6 keys (the scenes' fan-outs), twice down
    the tree, and 32-bit ``bits`` in 1-D and 2-D shapes."""
    key, want = prng.prng_key(seed), jax.random.PRNGKey(seed)
    for num in (2, 3, 5, 6):
        got = prng.split(key, num)
        np.testing.assert_array_equal(got.numpy(),
                                      words(jax.random.split(want, num)))
    key, want = prng.split(key, 5)[4], jax.random.split(want, 5)[4]
    np.testing.assert_array_equal(prng.split(key).numpy(),
                                  words(jax.random.split(want)))
    for shape in ((1,), (4097,), (1000, 3)):
        np.testing.assert_array_equal(
            prng.random_bits(key, shape).numpy(),
            words(jax.random.bits(want, shape)))


def test_threefry2x32_broadcasts_its_counts():
    """The hash itself: the second count word broadcast against the
    first, against split's (0, i) counts."""
    key = prng.prng_key(1024)
    k1, k2 = key.tolist()
    x1, x2 = prng.threefry2x32(k1, k2, torch.zeros(1, dtype=torch.int64),
                               torch.arange(6))
    np.testing.assert_array_equal(torch.stack([x1, x2], 1).numpy(),
                                  prng.split(key, 6).numpy())


RANGES = {
    "1-D": ((1 << 20,), 0.01, 1.0),
    "1-D, wide": ((1 << 16,), 1e4, 1e15),
    "(n, 3)": ((1 << 17, 3), np.array([-1e5, -3e4, -7.5], np.float32),
               np.array([1e5, 3e4, 7.5], np.float32)),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", list(RANGES))
def test_uniform_bitwise(seed, which):
    shape, lo, hi = RANGES[which]
    key = prng.split(prng.prng_key(seed), 3)[1]
    jkey = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    got = prng.uniform(key, shape, torch.as_tensor(lo), torch.as_tensor(hi))
    want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32,
                                         minval=jnp.asarray(lo),
                                         maxval=jnp.asarray(hi)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    lo32, hi32 = np.float32(lo), np.float32(hi)
    assert float(got.min()) >= np.min(lo32) and float(got.max()) < np.max(hi32)


def test_uniform_defaults_and_python_bounds():
    key, jkey = prng.prng_key(7), jax.random.PRNGKey(7)
    np.testing.assert_array_equal(prng.uniform(key, (999,)).numpy(),
                                  np.asarray(jax.random.uniform(jkey,
                                                                (999,))))
    np.testing.assert_array_equal(
        prng.uniform(key, (999,), maxval=2 * np.pi).numpy(),
        np.asarray(jax.random.uniform(jkey, (999,), maxval=2 * jnp.pi)))


def f32_nearest(x: Fraction) -> np.float32:
    """The float32 nearest ``x`` (ties to even), exactly."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        even = (np.array(c).view(np.int32) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_fma_rounds_once():
    """a * b + c of float32s rounded once: a case where the float64 sum
    lands on a float32 midpoint (rounding twice gives the even neighbour)
    in both signs, and random triples, against exact rationals."""
    a = np.float32(2.0 ** -12 * (1 + 2.0 ** -23))
    b = np.float32(2.0 ** -12 * (1 - 2.0 ** -23))
    c = np.float32(1 + 2.0 ** -23)
    twice = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert twice == np.float32(1 + 2.0 ** -22)       # the midpoint's tie
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (3, 2000)).astype(np.float32)
    x[:, 0] = a, b, c
    x[:, 1] = a, b, -c
    x[:, 2] = -a, b, -c
    got = prng._fma_f32(*(torch.from_numpy(r) for r in x)).numpy()
    want = [f32_nearest(Fraction(float(p)) * Fraction(float(q))
                        + Fraction(float(s))) for p, q, s in x.T]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    assert got[0] == c and got[1] == got[2] == -c
