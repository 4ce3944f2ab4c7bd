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
- ``forceModel=bh`` is forward-only, as in ``nbodyax``: a gradient request
  through it raises ``NotImplementedError``.

Across shards (``shards > 1``) the same ``make_loss`` runs over
``sharding.make_sharded_step``, one process a shard under torchrun:

    python -m torch.distributed.run --nproc-per-node P my_script.py

where each rank builds ``group = sharding.make_group(P, device)``, keeps
its rows (``shard_state(pad_to_shards(state, P), group)``), makes them
require grad and calls ``torch.autograd.grad`` on its share of the loss, a
sum over its bodies (the shares add up to the whole loss). The ring's
shifts and the gathers are ``torch.autograd.Function``s whose backward
passes are their transposes (``sharding/mesh.py``): each hop's pair
kernel call runs B2 with the hop's global offsets, and the remote tiles'
gradients travel back around the ring, so every rank ends with its rows
of the whole loss's gradient, as ``nbodyax`` does through its
``ppermute`` ring (tests/test_torch_sharding_grad.py). Adaptive dt under
shards is forward-only in both packages: the minimum over ranks raises
``NotImplementedError`` in the backward.

``graphed_value_and_grad(loss, wrt)`` is the caller's counterpart of
``jax.jit(jax.value_and_grad(loss))`` (``nbodyax/autodiff.py`` leaves
``jit`` to its callers, and they use it: ``examples/shooting_gradient.py``,
``bench/grad_step.py``). On a card its first call captures the whole
gradient, the forward of every step, each step's re-run inside the
backward and the backward with its kernels, into one CUDA graph; every
later call copies the state into the graph's static inputs and replays
it. On the CPU it runs the same code eagerly. The name says what it is:
``value_and_grad``, with the CUDA graph standing where ``jit`` stands.
Under shards each rank makes one over its ``make_sharded_step`` loss; the
graph then holds the ring's NCCL collectives and their transposes, and
every rank must call it alike (see ``_GraphedValueAndGrad``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from nbodyax_torch.graphs import add_counts, capture
from nbodyax_torch.state import SimState

__all__ = ["rollout", "make_loss", "graphed_value_and_grad"]

# the SimState fields a gradient may be taken with respect to
LEAVES = ("pos", "vel", "mass", "radius")


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
            # the step draws no random numbers, and a CUDA graph capture
            # refuses the read of the card's generator state
            state = checkpoint(step_fn, state, use_reentrant=False,
                               preserve_rng_state=False)
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


def graphed_value_and_grad(loss: Callable[[SimState], torch.Tensor],
                           wrt: Sequence[str] = ("pos", "vel", "mass")
                           ) -> "_GraphedValueAndGrad":
    """``jax.jit(jax.value_and_grad(loss))`` for a scalar ``loss`` of a
    SimState (a ``make_loss`` product): ``vg(state)`` returns ``(value,
    grads)``, the gradients with respect to the fields ``wrt`` of
    ``state``, in that order. On a card the first call captures one CUDA
    graph and every call replays it; ``close()`` (or leaving a ``with``
    block) releases it. See ``_GraphedValueAndGrad``."""
    return _GraphedValueAndGrad(loss, wrt)


class _GraphedValueAndGrad:
    """The value and gradient of ``loss`` as one CUDA-graph replay.

    ``body`` is what a capture records: ``loss(state)`` and
    ``torch.autograd.grad`` of it with respect to the ``wrt`` fields, that
    is the forward of every rollout step, each checkpointed step's re-run
    in the backward, B1 and B2 on the card and the step tail's own ops.

    A call on CUDA tensors: the first one copies the state into static
    buffers (the ``wrt`` fields as leaves that require grad), runs
    ``body`` once eagerly on a side stream (the kernel library's load,
    the launch shapes, the allocator's blocks and, under shards, NCCL's
    communicator and connections come from there, never from inside the
    capture), and captures ``body`` over the buffers (``graphs.capture``).
    Every call copies its state into the buffers and replays the graph. A
    capture that fails raises ``graphs.GraphCaptureError``; nothing falls
    back to the eager gradient.
    A later call whose shapes, dtypes, device or ``step`` differ from the
    first one's raises ``ValueError``: make another object. The value and
    gradients returned are the graph's static outputs, which the next call
    overwrites: clone what you keep. The kernel wrappers' launch counts
    move by what the capture recorded on every replay; warm-up and
    capture count nothing. ``capture_seconds`` is the warm-up's and the
    capture's host time.

    A call on CPU tensors runs ``body`` eagerly, and ``eager`` does so on
    any device: the same code op by op, the card's A/B reference.

    Under shards (``loss`` over ``sharding.make_sharded_step``), every rank
    makes its object alike and calls it in the same order: the warm-up
    runs every collective of the gradient eagerly, and then each rank
    captures the same NCCL collectives in the same order (the ring's
    shifts, ``_ShiftFn.backward``'s reverse shifts, the gathers and their
    reduce_scatters). Close the object before the process group goes, the
    failing rank too: NCCL tears a communicator down only once every graph
    that captured its collectives is destroyed. ``forceModel=bh`` and
    sharded adaptive dt have no gradient and raise as they do eagerly.
    """

    def __init__(self, loss: Callable[[SimState], torch.Tensor],
                 wrt: Sequence[str] = ("pos", "vel", "mass")):
        wrt = tuple(wrt)
        bad = [f for f in wrt if f not in LEAVES]
        if bad or not wrt or len(set(wrt)) != len(wrt):
            raise ValueError(f"wrt must name distinct fields of {LEAVES}, "
                             f"got {wrt}")
        self.loss, self.wrt = loss, wrt
        self.graph = None
        self.buf = None         # the static inputs
        self.out = None         # the static outputs: (value, grads)
        self.key = None
        self.delta = None       # launch counts a replay adds
        self.capture_seconds = 0.0

    def __enter__(self) -> "_GraphedValueAndGrad":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drop the graph, its static inputs and outputs, and hand its
        private memory pool back to the card (tensors a caller still holds
        from a call keep their blocks)."""
        captured = self.graph is not None
        self.graph = self.buf = self.out = self.key = None
        if captured:
            torch.cuda.empty_cache()

    def body(self, state: SimState):
        """``(value, grads)`` of ``loss`` at ``state``, whose ``wrt``
        fields require grad: what a capture records."""
        value = self.loss(state)
        # a field the loss does not read has a zero gradient, as in JAX
        grads = torch.autograd.grad(value,
                                    [getattr(state, f) for f in self.wrt],
                                    allow_unused=True, materialize_grads=True)
        return value.detach(), grads

    def eager(self, state: SimState):
        """``(value, grads)`` at ``state``, op by op, on any device."""
        return self.body(state._replace(**{
            f: getattr(state, f).detach().requires_grad_(True)
            for f in self.wrt}))

    def __call__(self, state: SimState):
        if state.pos.device.type != "cuda":
            return self.eager(state)
        key = (tuple((tuple(t.shape), t.dtype, t.device)
                     for t in (*state[:4], state.sim_time)), state.step)
        if self.graph is None:
            t0 = time.perf_counter()
            self._capture(state, key)
            self.capture_seconds += time.perf_counter() - t0
        elif key != self.key:
            raise ValueError(
                f"this gradient graph was captured for {self.key}, not "
                f"{key}: make another graphed_value_and_grad")
        with torch.no_grad():
            for dst, src in zip(self.buf[:4], state[:4]):
                dst.copy_(src)
            self.buf.sim_time.copy_(state.sim_time)
        self.graph.replay()
        add_counts(self.delta)
        return self.out

    def _capture(self, state: SimState, key) -> None:
        buf = SimState(
            *(t.detach().clone(memory_format=torch.contiguous_format)
              for t in state[:4]), state.step, state.sim_time.detach().clone())
        buf = buf._replace(**{f: getattr(buf, f).requires_grad_(True)
                              for f in self.wrt})
        graph, out, delta = capture(lambda _: self.body(buf),
                                    lambda: self.body(buf), "the gradient")
        self.graph, self.buf, self.out, self.key = graph, buf, out, key
        self.delta = delta
