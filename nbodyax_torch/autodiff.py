"""Differentiable simulation: reverse-mode gradients through n-body rollouts.

Counterpart of ``nbodyax/autodiff.py``. Every step built by
``physics.step.make_step`` is a function of the SimState tensors, so
``torch.autograd`` flows through gravity, collision bookkeeping, boundary
handling and the integrator, on both all-pairs engines:

- ``backend=jnp``: autograd through the chunked torch oracle
  (``physics/pairwise.py``);
- ``backend=auto`` / ``pallas``: ``tile_accumulators_raw`` is a
  ``torch.autograd.Function`` whose backward is the analytic VJP of
  ``physics/kernels_bwd.py`` (the CUDA backward kernel on the card, its
  plain version on the CPU).

Design notes:

- A plain Python loop takes the place of ``lax.scan``; the state's ``step``
  stays a host int.
- Reverse mode through k steps stores each step's residuals, whose largest
  part is the O(N^2)-shaped pair temporaries of the oracle.
  ``rollout`` therefore wraps each step in ``torch.utils.checkpoint``
  (non-reentrant) by default: the backward pass re-runs each step's forward
  from its carried SimState, so residual memory is O(k * state). On the
  kernel path the re-run launches the forward kernel again.
- Collision masks, boundary flips and merge winners are step functions of
  the state: their derivative is zero, and the smooth gravity and
  integration path carries the gradient. At an event threshold the
  derivative is one-sided.
- Everything is float32; finite-difference checks need O(1)-conditioned
  losses (see tests/test_torch_autodiff.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from nbodyax_torch.state import SimState

__all__ = ["rollout", "make_loss"]


def rollout(step_fn: Callable[[SimState], SimState], state: SimState,
            steps: int, *, remat: bool = True, save_positions: bool = False
            ) -> Tuple[SimState, Optional[torch.Tensor]]:
    """Run ``steps`` simulation steps differentiably.

    remat: re-run each step's forward in the backward pass instead of
    storing its residuals (default True; turn off only for tiny N and few
    steps). save_positions: also return the f32[steps, N, D] position
    history for trajectory losses.

    Returns ``(final_state, positions_or_None)``. Differentiable with
    respect to any tensor of ``state`` that requires grad, and through
    tensors ``step_fn`` closes over.
    """
    traj = []
    for _ in range(steps):
        if remat:
            state = checkpoint(step_fn, state, use_reentrant=False)
        else:
            state = step_fn(state)
        if save_positions:
            traj.append(state.pos)
    return state, (torch.stack(traj) if save_positions else None)


def make_loss(step_fn: Callable[[SimState], SimState], steps: int,
              terminal_fn: Callable[[SimState], torch.Tensor], *,
              remat: bool = True) -> Callable[[SimState], torch.Tensor]:
    """Scalar loss ``terminal_fn(rollout(state))``, the common adjoint
    shape: ``torch.autograd.grad`` of it with respect to (parts of) the
    initial state gives the sensitivity of the terminal quantity."""

    def loss(state: SimState) -> torch.Tensor:
        final, _ = rollout(step_fn, state, steps, remat=remat)
        return terminal_fn(final)

    return loss
