"""Physics: all-pairs accumulators, collisions and the step.

- ``pairwise``   — dense torch all-pairs accumulators (the oracle, CPU path).
- ``kernels``    — the hand-written CUDA all-pairs kernel, its wrapper and
                   its plain PyTorch version.
- ``_build``     — nvcc build and ctypes binding of ``csrc/*.cu``.
- ``collisions`` — merge / bounce resolution modes.
- ``step``       — forces -> collisions -> boundary -> integrate.
"""
