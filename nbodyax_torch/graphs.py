"""How the port captures a CUDA graph, shared by the driver's windows
(``driver._GraphWindows``) and the graphed gradient
(``autodiff.graphed_value_and_grad``).

``capture(body, warm_up, what)`` runs ``warm_up()`` once eagerly on a side
stream and then records ``body`` into one ``torch.cuda.CUDAGraph``. The
kernel wrappers' launch counts only move while Python runs, that is during
the warm-up and the capture: ``capture`` leaves them as it found them,
whether it succeeds or raises, and returns what the capture added, which
the owner adds again on every replay (``add_counts``). A capture that fails
raises ``GraphCaptureError``; nothing falls back to an eager run.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["GraphCaptureError", "capture", "read_counters", "add_counts"]


class GraphCaptureError(RuntimeError):
    """Capturing a CUDA graph failed: its body does something a capture
    refuses (a host read, a copy from the host). Not retried."""


def _launch_counters():
    """(owner, attribute) of every kernel wrapper's launch count."""
    from nbodyax_torch.physics.annulus_kernel import annulus_cells
    from nbodyax_torch.physics.kernels import tile_accumulators_raw
    from nbodyax_torch.physics.kernels_bwd import raw_backward
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    return ((tile_accumulators_raw, "launches"), (raw_backward, "launches"),
            (slots_near, "launches"), (pack_slots, "launches"),
            (pack_slots, "moment_launches"), (annulus_cells, "launches"))


def read_counters() -> list:
    """Every kernel wrapper's launch count, in ``_launch_counters`` order."""
    return [getattr(o, a) for o, a in _launch_counters()]


def _write_counters(values) -> None:
    for (o, a), v in zip(_launch_counters(), values):
        setattr(o, a, v)


def add_counts(delta) -> None:
    """Add a capture's launch counts (a replay's launches) to the wrappers'."""
    _write_counters([a + d for a, d in zip(read_counters(), delta)])


def capture(body: Callable, warm_up: Callable, what: str):
    """``(graph, out, delta)``: ``warm = warm_up()`` run eagerly on a side
    stream (the kernel library's first load, the launch shapes, the
    allocator's blocks and, under shards, NCCL's communicator and
    connections come from there, never from inside the capture), then
    ``out = body(warm)`` captured into ``graph`` in thread-local mode.
    Tensors ``body`` allocates come from the graph's private pool and keep
    it reserved while anything holds them, after the graph is gone too:
    make static outputs that outlive the graph before the call.
    ``delta`` is the launch counts the capture added; the counts are put
    back as they were before the warm-up, also when either raises. A
    ``RuntimeError`` of the capture raises ``GraphCaptureError`` naming
    ``what``."""
    counts = read_counters()
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warm = warm_up()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = read_counters()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = body(warm)
        except RuntimeError as e:
            raise GraphCaptureError(
                f"capturing {what}'s CUDA graph failed: {e}") from e
        delta = [a - b for a, b in zip(read_counters(), before)]
    finally:
        _write_counters(counts)
    return graph, out, delta
