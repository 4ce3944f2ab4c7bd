"""Physics: all-pairs accumulators, collisions and the step.

- ``pairwise``   — dense torch all-pairs accumulators (the oracle, CPU path).
- ``kernels``    — the hand-written CUDA all-pairs kernel, its wrapper and
                   its plain PyTorch version.
- ``_build``     — nvcc build and ctypes binding of ``csrc/*.cu``.
- ``barneshut``  — ``forceModel=bh``: near passes, giants, diagnostics,
                   ``bh_accumulators``; with ``bh_grid`` (cells, ids, the
                   partner structure) and ``fmm`` (the far field).
- ``near_kernel`` / ``slotpack_kernel`` — the bh CUDA kernels B3 and B4/B5,
                   their wrappers and plain versions.
- ``collisions`` — merge / bounce resolution modes.
- ``step``       — forces -> collisions -> boundary -> integrate.
"""
