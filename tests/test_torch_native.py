"""nbodyax_torch's C++ scene fill against its pure-Python draw, on the CPU.

``native.scene_arrays`` (``csrc/scene_fill.cpp``, built with g++ at first
use) draws the reference scene bit for bit as ``rng.scene_arrays`` does in
pure Python, and its raw stream is ``RefRandgen``'s and nbodyax's native
library's (tolerance: none). Without a C++ compiler the tests that need
the library skip.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.native import binding as jax_native  # noqa: E402
from nbodyax_torch import native, rng  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.scenes import init_scene  # noqa: E402


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("no C++ compiler to build the scene fill")


@pytest.mark.parametrize("seed", [1024, 42, 0, 2 ** 63 + 5])
def test_ival64_stream_matches_python(lib, seed):
    g = rng.RefRandgen(seed)
    want = np.array([g.ival64() for _ in range(64)], np.uint64)
    np.testing.assert_array_equal(native.ival64_sequence(seed, 64), want)


def test_scene_fill_equals_pure_python_at_default_size(lib):
    """N = 16,384 and seed 1024, the default scene: every array bitwise."""
    cfg = SimConfig()
    args = (cfg.seed, cfg.particle_count, cfg.field_width, cfg.field_height,
            cfg.min_body_mass, cfg.max_body_mass, cfg.min_radius,
            cfg.max_radius)
    got = native.scene_arrays(*args)
    want = rng.scene_arrays(*args, native=False)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # and the scene the port builds uses it
    st = init_scene(cfg, device="cpu")
    np.testing.assert_array_equal(st.pos.numpy(), want[0])


@pytest.mark.parametrize("n,field,seed", [(500, 100000, 1024),
                                          (1000, 1000000, 7)])
def test_scene_fill_equals_nbodyax_native(lib, n, field, seed):
    if not jax_native.available():
        pytest.skip("nbodyax's native library is not available")
    args = (seed, n, field, field, 1e4, 1e17, 50.0, 200.0)
    for a, b in zip(native.scene_arrays(*args),
                    jax_native.scene_arrays(*args)):
        np.testing.assert_array_equal(a, b)


def test_scene_fill_golden_values(lib):
    # the goldens of tests/test_rng.py, captured from the reference RNG
    pos, vel, mass, radius = native.scene_arrays(
        1024, 4, 100000, 100000, 1e4, 1e17, 50.0, 200.0)
    assert pos[0, 0] == np.float32(84755.8203)
    assert pos[0, 1] == np.float32(-9983.19141)
    assert mass[0] == np.float32(2.55396902e+15)
    assert radius[0] == np.float32(189.339737)
    assert not vel.any()


def test_without_the_library_scene_arrays_draws_in_python(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    called = []
    monkeypatch.setattr(native, "scene_arrays",
                        lambda *a: called.append(a))
    pos, vel, mass, radius = rng.scene_arrays(1024, 4, 100000, 100000, 1e4,
                                              1e17, 50.0, 200.0)
    assert not called and pos[0, 0] == np.float32(84755.8203)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """``cached_build`` into a directory of the test's own."""
    from nbodyax_torch.physics import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return _build


def test_cached_build_keys_on_source_and_flags(lib, build_dir, tmp_path):
    """The scene fill and the CUDA kernels share one build step: a library
    is built once for each hash of its source and flags, and loaded from
    the cache after that without asking for the compiler."""
    import shutil
    src = tmp_path / "answer.cpp"
    src.write_text('extern "C" int answer() { return 42; }\n')
    gxx = shutil.which("g++") or shutil.which("c++")
    asked = []

    def find():
        asked.append(1)
        return gxx

    (so,) = build_dir.cached_build(find, native.FLAGS, (src,))
    assert so.exists() and so.parent == build_dir.BUILD_DIR and asked == [1]
    assert build_dir.cached_build(find, native.FLAGS, (src,)) == [so]
    assert asked == [1]
    (other,) = build_dir.cached_build(find, native.FLAGS + ("-g",), (src,))
    assert other != so and asked == [1, 1]
    src.write_text('extern "C" int answer() { return 43; }\n')
    (edited,) = build_dir.cached_build(find, native.FLAGS, (src,))
    assert edited not in (so, other)
    assert sorted(p.suffix for p in build_dir.BUILD_DIR.iterdir()) == [
        ".log", ".log", ".log", ".so", ".so", ".so"]     # no temp file left


def test_a_failed_scene_fill_build_falls_back(lib, build_dir, tmp_path,
                                               monkeypatch):
    """A source g++ refuses: ``cached_build`` raises KernelCompileError,
    ``native.available()`` is False, and the scene is drawn in Python."""
    bad = tmp_path / "scene_fill.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(build_dir.KernelCompileError):
        build_dir.cached_build(native._gxx, native.FLAGS, (bad,))
    assert not any(build_dir.BUILD_DIR.glob("*.so"))
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    pos, _, _, _ = rng.scene_arrays(1024, 4, 100000, 100000, 1e4, 1e17,
                                    50.0, 200.0)
    assert pos[0, 0] == np.float32(84755.8203)
