"""nbodyax_torch's post-processing tools, on the CPU.

The cases of tests/test_tools.py on ``nbodyax_torch.tools``: a P5 frame
round-trips through ``read_pgm``, frames assemble into a GIF (with
pillow), and ``dump`` prints a checkpoint in the reference's printData
format; plus the same dump text from a snapshot written by nbodyax.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.io.checkpoint import save_checkpoint as jax_save  # noqa: E402
from nbodyax.state import make_state as jax_make_state  # noqa: E402
from nbodyax.tools import main as jax_tools_main  # noqa: E402
from nbodyax_torch.io.checkpoint import save_checkpoint  # noqa: E402
from nbodyax_torch.render import write_pgm  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402
from nbodyax_torch.tools import (list_frames, main, make_gif,  # noqa: E402
                                 read_pgm)

BODIES = (np.array([[1.25, -2.5], [3.0, 4.0]], np.float32),
          np.array([[0.5, 0.0], [0.0, -1.0]], np.float32),
          np.array([10.0, 0.0], np.float32),
          np.array([2.0, 3.0], np.float32))


def test_read_pgm_roundtrip(tmp_path):
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    p = tmp_path / "iteration_0.ppm"
    write_pgm(str(p), img)
    np.testing.assert_array_equal(read_pgm(str(p)), img)
    (tmp_path / "x.txt").write_bytes(b"P6 nope")
    with pytest.raises(ValueError):
        read_pgm(str(tmp_path / "x.txt"))


def test_gif_assembly(tmp_path):
    pytest.importorskip("PIL")
    for i in (2, 0, 1):
        img = np.full((8, 8), 254, np.uint8)
        img[i, i] = 0
        write_pgm(str(tmp_path / f"iteration_{i * 10}.ppm"), img)
    assert [p.rsplit("/", 1)[-1] for p in list_frames(str(tmp_path))] == [
        "iteration_0.ppm", "iteration_10.ppm", "iteration_20.ppm"]
    out = make_gif(str(tmp_path), fps=10)
    assert out.endswith(".gif")
    assert open(out, "rb").read().startswith(b"GIF8")


def test_dump_checkpoint(tmp_path, capsys):
    path = save_checkpoint(str(tmp_path / "ck"),
                           make_state(*BODIES, device="cpu"))
    assert main(["dump", path]) == 0
    out = capsys.readouterr().out
    assert "Body #0" in out
    assert "Position: (1.2500, -2.5000)" in out     # printData format
    assert "Body #1 (dead)" in out
    assert "1 alive / 2 slots" in out
    assert main(["dump", path, "--alive-only"]) == 0
    assert "Body #1" not in capsys.readouterr().out


def test_dump_matches_nbodyax_on_its_snapshot(tmp_path, capsys):
    path = jax_save(str(tmp_path / "ck"), jax_make_state(*BODIES, step=3))
    assert jax_tools_main(["dump", path, "--limit", "1"]) == 0
    want = capsys.readouterr().out
    assert main(["dump", path, "--limit", "1"]) == 0
    assert capsys.readouterr().out == want
