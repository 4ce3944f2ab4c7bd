"""nbodyax_torch config parser, RNG and scene against the JAX package.

The port's parser and generator are copies of nbodyax's; these tests hold
them field for field and bit for bit, and hold the port's scene to the
external C++ oracle's record 0.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax import config as jconfig  # noqa: E402
from nbodyax import rng as jrng  # noqa: E402
from nbodyax_torch import config as tconfig  # noqa: E402
from nbodyax_torch import rng as trng  # noqa: E402
from nbodyax_torch.scenes import init_scene  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = sorted(glob.glob(os.path.join(HERE, "..", "examples", "*.txt")))


def test_defaults_equal():
    assert (dataclasses.asdict(tconfig.SimConfig())
            == dataclasses.asdict(jconfig.SimConfig()))


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_examples_parse_to_equal_fields(path):
    a = tconfig.parse_config_file(path)
    b = jconfig.parse_config_file(path)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("text", [
    "particleCount=12abc\ntimestep=0.5f\n",
    "bogusKey=1\nnoequals\n\n# comment\nseed=7\n",
    "collisionMode= momentum \nsoftening=2.5e1f\nadaptiveDt=yes\n",
    "fieldWidth=-3\nimagePath= spaced path \nsaveImages=off\n",
])
def test_parser_matches_with_warnings(text, capsys):
    a = tconfig.parse_config_text(text)
    a_err = capsys.readouterr().err
    b = jconfig.parse_config_text(text)
    b_err = capsys.readouterr().err
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a_err == b_err


@pytest.mark.parametrize("text", [
    "particleCount=x\n", "collisionMode=bogus\n", "dimensions=4\n",
    "adaptiveDt=maybe\n", "restitution=2\n", "energyEvery=5\nlogEvery=10\n",
])
def test_parser_errors_match(text):
    with pytest.raises(tconfig.ConfigError) as a:
        tconfig.parse_config_text(text)
    with pytest.raises(jconfig.ConfigError) as b:
        jconfig.parse_config_text(text)
    assert str(a.value) == str(b.value)


def test_overrides_match():
    sets = ["particleCount=128", "timestep=0.1f", "collisionMode=elastic"]
    a = tconfig.apply_overrides(tconfig.SimConfig(), sets)
    b = jconfig.apply_overrides(jconfig.SimConfig(), sets)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(tconfig.ConfigError):
        tconfig.apply_overrides(tconfig.SimConfig(), ["nope=1"])


@pytest.mark.parametrize("seed", [0, 7, 42, 1024])
def test_randgen_stream_matches(seed):
    a, b = trng.RefRandgen(seed), jrng.RefRandgen(seed)
    assert [a.ival64() for _ in range(64)] == [b.ival64() for _ in range(64)]
    assert [a.fval() for _ in range(16)] == [b.fval() for _ in range(16)]


@pytest.mark.parametrize("seed,n,field", [(1024, 4, 100000), (3, 1000, 5000),
                                          (1024, 16384, 100000)])
def test_scene_arrays_bitexact(seed, n, field):
    a = trng.scene_arrays(seed, n, field, field, 1e4, 1e17, 50.0, 200.0)
    b = jrng.scene_arrays(seed, n, field, field, 1e4, 1e17, 50.0, 200.0)
    for x, y in zip(a, b):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,n,field", [("ref_n64_dense", 64, 5000),
                                          ("ref_n64_sparse", 64, 100000),
                                          ("ref_n1k", 1024, 100000)])
def test_scene_matches_golden_record0(name, n, field):
    with np.load(os.path.join(HERE, "golden", name + ".npz")) as z:
        gpos, gmass, gradius = z["pos"][0], z["mass"][0], z["radius"][0]
    cfg = tconfig.SimConfig(particle_count=n, field_width=field,
                            field_height=field, seed=1024)
    st = init_scene(cfg, device="cpu")
    np.testing.assert_array_equal(st.pos.numpy(), gpos)
    np.testing.assert_array_equal(st.mass.numpy(), gmass)
    np.testing.assert_array_equal(st.radius.numpy(), gradius)
    assert st.pos.dtype == torch.float32 and not st.vel.any()

