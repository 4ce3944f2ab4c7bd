"""The check that a run loads nothing of JAX or of the JAX package."""

from __future__ import annotations

import subprocess
import sys

from perfbench.guard import forbidden_loaded
from perfbench.spec import ROOT


def test_top_level_names_are_compared_whole():
    assert forbidden_loaded(["nbodyax_torch", "nbodyax_torch.driver",
                             "jaxtyping", "numpy", "benchmarks",
                             "nbodyax_extra"]) == []
    assert forbidden_loaded(["nbodyax.physics.kernels", "jax.numpy",
                             "jaxlib", "flax.linen", "bench.suite",
                             "nbodyax_torch"]) == [
        "bench", "flax", "jax", "jaxlib", "nbodyax"]


def test_the_harness_and_the_program_load_no_jax():
    """Everything a run imports, in a fresh process: the harness, the
    program's entry and the kernels' wrappers."""
    code = ("import perfbench.run, perfbench.worker, perfbench.control, "
            "perfbench.check\n"
            "import nbodyax_torch.driver, nbodyax_torch.config, "
            "nbodyax_torch.state, nbodyax_torch.graphs\n"
            "import nbodyax_torch.physics.barneshut, nbodyax_torch.sharding\n"
            "from perfbench.spec import load_metric, load_benchmark\n"
            "for m in load_benchmark()['per_layer']: load_metric(m['name'])\n"
            "from perfbench.guard import forbidden_loaded\n"
            "print(forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
