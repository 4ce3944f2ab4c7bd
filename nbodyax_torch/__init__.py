"""nbodyax_torch — the nbodyax n-body simulation on PyTorch and CUDA.

A port of ``nbodyax`` (JAX, Pallas on a TPU) to PyTorch on an NVIDIA Hopper
card. ``nbodyax`` stays the reference the port is held against; the port
imports neither it nor JAX. Module names mirror ``nbodyax``:

- ``config``   — SimConfig and the nbodyConfig.txt parser.
- ``rng``      — the bit-exact reference scene generator; ``native`` — its
  C++ fill, built with g++ at first use; ``prng`` — ``jax.random``'s
  threefry draw, bit for bit, for the scenes ``nbodyax`` draws with it.
- ``state``    — SimState tensors and compaction; ``scenes`` — scene
  constructors (uniform, three_body, galaxy, plummer).
- ``physics``  — the torch oracle, the CUDA all-pairs kernel and its
  backward kernel, collisions, the step (euler, leapfrog, yoshida4).
- ``backends`` — which all-pairs engine a config selects.
- ``autodiff`` — differentiable rollouts (``rollout``, ``make_loss``) and
  their gradient as one CUDA-graph replay (``graphed_value_and_grad``).
- ``graphs``   — how a CUDA graph is captured (warm-up, launch counts,
  ``GraphCaptureError``), for the driver's windows and the gradient.
- ``render``   — rasterizer and P5 writer.
- ``metrics``  — conservation scalars, step meter, JSONL logging.
- ``io.checkpoint`` — checkpoint files, in ``nbodyax``'s format.
- ``driver`` / ``cli`` — the end-to-end run: windows, checkpoints, resume,
  recovery, compaction.
- ``tools``    — frames to a GIF, a checkpoint's bodies as text.

The names below load on first use, so importing the package has no side
effects.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "SimConfig": "nbodyax_torch.config",
    "parse_config_file": "nbodyax_torch.config",
    "SimState": "nbodyax_torch.state",
    "init_scene": "nbodyax_torch.scenes",
    "make_step": "nbodyax_torch.physics.step",
    "PhysicsParams": "nbodyax_torch.physics.step",
    "run_simulation": "nbodyax_torch.driver",
    "rollout": "nbodyax_torch.autodiff",
    "make_loss": "nbodyax_torch.autodiff",
    "graphed_value_and_grad": "nbodyax_torch.autodiff",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'nbodyax_torch' has no attribute {name!r}")
