"""examples/shooting_gradient_torch.py against examples/shooting_gradient.py
on the CPU.

The port's example runs with ``--device cpu`` (its plain torch oracle), the
JAX example through ``runpy`` as ``__main__`` (its jnp oracle). At iteration
0 the miss^2 and its gradient with respect to body 0's initial velocity
agree at rtol 1e-4 (the JAX value and gradient are read from the example's
own jitted ``value_and_grad``). Every printed miss^2 agrees within
``PRINT_RTOL`` / ``PRINT_ATOL``: measured on this CPU, the two runs differ
by 1.0e-5 at iteration 4 (2.071889 against 2.071879, 4.8e-6 relative) and
not at all in the other five printed digits, so the gate is 1e-5 relative
plus one unit of the last printed digit.
"""

import os
import re
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "examples", "shooting_gradient_torch.py")
JAX = os.path.join(ROOT, "examples", "shooting_gradient.py")
PRINT_RTOL, PRINT_ATOL = 1e-5, 1e-6


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def printed(out):
    rows = re.findall(r"iter +(\d+): miss\^2 = ([0-9.]+)", out)
    return [int(i) for i, _ in rows], np.array([float(v) for _, v in rows])


def test_shooting_example_matches_jax(capsys, monkeypatch, one_thread):
    port = runpy.run_path(PORT)
    assert port["main"](["--device", "cpu"]) == 0
    t_out = capsys.readouterr().out

    calls = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)
        if sys._getframe(1).f_code.co_filename != JAX:
            # a module that JAX imports meanwhile keeps the real jit
            return jitted

        def run(*args):
            out = jitted(*args)
            calls.append(out)
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    runpy.run_path(JAX, run_name="__main__")
    monkeypatch.undo()
    j_out = capsys.readouterr().out

    v0, vg = port["problem"]("cpu")
    val, g = vg(v0)
    j_val, j_g = calls[0]   # the example's value_and_grad at iteration 0
    np.testing.assert_allclose(float(val), float(j_val), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-4)

    t_iters, t_miss = printed(t_out)
    j_iters, j_miss = printed(j_out)
    assert t_iters == j_iters == [0, 4, 8, 12, 16, 20]
    np.testing.assert_allclose(t_miss, j_miss, rtol=PRINT_RTOL,
                               atol=PRINT_ATOL)
    assert t_miss[-1] < 0.01 * t_miss[0]   # the descent lands
    assert "optimized initial velocity for body 0:" in t_out


def test_shooting_example_asks_for_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    port = runpy.run_path(PORT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port["main"]([])
