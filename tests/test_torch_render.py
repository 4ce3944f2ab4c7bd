"""nbodyax_torch rasterizer and P5 writer.

Byte equality with the external C++ oracle's frames
(tests/golden/ref_frames_*.npz), and pixel equality with
``nbodyax.render.rasterize`` on the scenes of tests/test_render.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import render as jrender  # noqa: E402
from nbodyax_torch.render import (BACKGROUND, FrameWriteError,  # noqa: E402
                                  FrameWriter, pgm_bytes, rasterize,
                                  write_pgm)

HERE = os.path.dirname(os.path.abspath(__file__))


def port_rasterize(pos, mass, radius, **kw):
    return rasterize(torch.from_numpy(pos), torch.from_numpy(mass),
                     torch.from_numpy(radius), **kw).numpy()


@pytest.mark.parametrize("frames_name,traj_name", [
    ("ref_frames_n64", "ref_n64_dense"),
    ("ref_frames_n1k", "ref_n1k"),
])
def test_frames_match_external_cpp_fixture(frames_name, traj_name):
    """Frame iteration_s renders trajectory record s+1 (the state after
    0-based step s); pixels and the P5 byte stream must match exactly."""
    fx = np.load(os.path.join(HERE, "golden", frames_name + ".npz"))
    traj = np.load(os.path.join(HERE, "golden", traj_name + ".npz"))
    img_w, img_h = (int(v) for v in fx["img"])
    field_w, field_h = (int(v) for v in fx["field"])
    for fi, s in enumerate(fx["steps"]):
        got = port_rasterize(traj["pos"][s + 1], traj["mass"][s + 1],
                             traj["radius"][s + 1], img_width=img_w,
                             img_height=img_h, field_width=field_w,
                             field_height=field_h)
        assert got.dtype == np.uint8 and got.shape == (img_h, img_w)
        np.testing.assert_array_equal(got, fx["frames"][fi],
                                      err_msg=f"frame iteration_{s}")
        assert pgm_bytes(got) == fx["file_bytes"][fi].tobytes()


def _scene(kind):
    rng = np.random.RandomState(1 if kind == "random" else 3)
    if kind == "random":
        n = 40
        pos = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
        mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
        mass[::7] = 0.0
        radius = rng.uniform(5, 80, n).astype(np.float32)
    elif kind == "offscreen":
        pos = np.array([[5000.0, 0.0], [0.0, -5000.0]], np.float32)
        mass = np.ones(2, np.float32)
        radius = np.full(2, 50.0, np.float32)
    elif kind == "oversized":
        n = 12
        pos = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
        mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
        radius = rng.uniform(5, 40, n).astype(np.float32)
        radius[0], radius[1] = 600.0, 900.0
        pos[1] = (950.0, -950.0)
    elif kind == "mid_tier":
        n = 30
        pos = rng.uniform(-900, 900, (n, 2)).astype(np.float32)
        mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
        radius = rng.uniform(200, 450, n).astype(np.float32)  # 2-4x patch
    else:  # oversized_dead
        pos = np.array([[0, 0], [500, 500], [-500, 500], [0, -500]],
                       np.float32)
        mass = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
        radius = np.array([900.0, 5.0, 5.0, 5.0], np.float32)
    return pos, mass, radius


@pytest.mark.parametrize("kind", ["random", "offscreen", "oversized",
                                  "mid_tier", "oversized_dead"])
def test_rasterize_matches_jax(kind):
    pos, mass, radius = _scene(kind)
    kw = dict(img_width=64, img_height=64, field_width=1000,
              field_height=1000, patch=16)
    got = port_rasterize(pos, mass, radius, **kw)
    want = np.asarray(jrender.rasterize(pos, mass, radius, **kw))
    np.testing.assert_array_equal(got, want)
    if kind == "offscreen":
        assert (got == BACKGROUND).all()


def test_pgm_bytes_header_layout():
    img = np.arange(6, dtype=np.uint8).reshape(2, 3)
    assert pgm_bytes(img) == b"P5\n3 2\n255\n" + bytes(range(6))
    assert pgm_bytes(img) == jrender.pgm_bytes(img)


def test_write_pgm_roundtrip(tmp_path):
    img = np.full((4, 5), 200, np.uint8)
    img[1, 2] = 0
    path = tmp_path / "frame.ppm"
    write_pgm(str(path), img)
    raw = path.read_bytes()
    assert raw.startswith(b"P5\n5 4\n255\n")
    body = np.frombuffer(raw.split(b"255\n", 1)[1], np.uint8).reshape(4, 5)
    np.testing.assert_array_equal(body, img)


def test_frame_writer_writes_and_reports_errors(tmp_path):
    w = FrameWriter(str(tmp_path / "frames"))
    for i in (0, 10):
        w.submit(i, torch.full((3, 4), i, dtype=torch.uint8))
    w.close()
    assert sorted(os.listdir(tmp_path / "frames")) == ["iteration_0.ppm",
                                                       "iteration_10.ppm"]
    raw = (tmp_path / "frames" / "iteration_10.ppm").read_bytes()
    assert raw == b"P5\n4 3\n255\n" + bytes([10] * 12)

    bad = FrameWriter(str(tmp_path / "frames2"))
    os.rmdir(tmp_path / "frames2")
    (tmp_path / "frames2").write_text("a file, not a directory")
    bad.submit(0, torch.zeros((2, 2), dtype=torch.uint8))
    with pytest.raises(FrameWriteError):
        bad.close()
