"""Differentiable-simulation demo on nbodyax_torch: steer a body onto a
target with torch.autograd.

The PyTorch counterpart of ``examples/shooting_gradient.py``: the same 64
bodies, target and descent. It optimizes body 0's initial velocity so that
after a 40-step rollout (full physics: gravity from the 63 other bodies and
collision handling) it arrives at a target point, by descending the
gradient of the terminal miss distance through the whole simulation.
The JAX example's ``jax.jit(jax.value_and_grad(miss))`` is
``nbodyax_torch.autodiff.graphed_value_and_grad`` of ``make_loss``.

    python examples/shooting_gradient_torch.py [--device cuda|cpu]

On a card (the default) the step runs the hand-written kernels: the
all-pairs kernel forward and its backward kernel in the gradient
(``backend=pallas``), and each gradient is one replay of a CUDA graph
captured at the first call (``problem(device, eager=True)`` gives the
same gradient op by op).
``--device cpu`` runs the plain torch oracle (``physics/pairwise.py``),
as the JAX example runs its jnp oracle; asking for a card where there is
none is an error.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nbodyax_torch.autodiff import (graphed_value_and_grad,  # noqa: E402
                                    make_loss)
from nbodyax_torch.backends import build_accum_fn  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.driver import resolve_device  # noqa: E402
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402

N, SCALE, STEPS = 64, 100.0, 40
TARGET = (75.0, -60.0)


def problem(device, eager=False):
    """Body 0's initial velocity and ``value_and_grad(v0)``: the miss^2
    of body 0 after the rollout and its gradient with respect to v0, both
    overwritten by the next call on a card; ``value_and_grad.close()``
    releases its CUDA graph. ``eager``: the gradient op by op."""
    dev = resolve_device(device)
    rng = np.random.RandomState(7)
    state = make_state(
        rng.uniform(-SCALE, SCALE, (N, 2)).astype(np.float32),
        rng.uniform(-0.5, 0.5, (N, 2)).astype(np.float32),
        rng.uniform(0.5e12, 2e12, N).astype(np.float32),   # G*m ~ 1e2
        rng.uniform(0.5, 2.0, N).astype(np.float32), device=dev)
    cfg = SimConfig(particle_count=N, collision_mode="reference",
                    softening=5.0, field_width=10_000, field_height=10_000)
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn(
        "pallas" if dev.type == "cuda" else "jnp", p, dev))
    target = torch.tensor(TARGET, device=dev)

    vg = graphed_value_and_grad(make_loss(
        step, STEPS, lambda s: (((s.pos[0] - target) / SCALE) ** 2).sum()),
        wrt=("vel",))
    run = vg.eager if eager else vg

    def value_and_grad(v0):
        val, (g,) = run(state._replace(
            vel=torch.cat([v0[None], state.vel[1:]])))
        return val, g[0]

    value_and_grad.close = vg.close
    return state.vel[0].clone(), value_and_grad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the oracle)")
    args = ap.parse_args(argv)
    v0, vg = problem(args.device)
    val, g = vg(v0)
    print(f"iter  0: miss^2 = {float(val):.6f}")
    for it in range(1, 21):
        # curvature ~ (STEPS*dt/SCALE)^2 = 6.4e-3 => lr well under ~150
        v0 = v0 - 30.0 * g
        val, g = vg(v0)
        if it % 4 == 0 or it == 20:
            print(f"iter {it:2d}: miss^2 = {float(val):.6f}")
    print(f"optimized initial velocity for body 0: {v0.cpu().numpy()}")
    vg.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
