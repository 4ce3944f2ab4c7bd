"""Data-dependent branches that a CUDA graph can hold: the port's
counterpart of ``lax.cond``.

The bh step chooses its static budgets on the card (nbodyax's ``_tiered``
and ``_tiered_completion``, and the giant pass's list). ``run_if(pred,
body)`` runs ``body()`` where the 0-d bool tensor ``pred`` holds:

- under a stream capture on a card, the body's work is recorded into the
  body graph of a CUDA-graph IF node (``csrc/graph_cond.cu``, CUDA 12.4 or
  newer), and each replay decides on the card: no host read;
- elsewhere (the CPU, an eager run on a card) it reads ``pred`` and runs
  the body or not;
- inside ``warm()`` every body runs, whatever ``pred`` says: a warm-up of
  a capture must run each body once outside the capture (first-use work,
  such as a constant made on the host, cannot happen inside one).

A body writes its results into tensors that exist before it, in place; it
allocates only temporaries. Under a capture those come from a memory pool
of their own, which ``bodies()`` opens around the capture and which must
live as long as the graph; it also counts the IF nodes and their bodies'
nodes (``capture_nodes`` counts the graph's own). No kernel whose wrapper
counts its launches may run inside a body: a replay adds a graph's counts
whether a body ran or not.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

__all__ = ["run_if", "warm", "bodies", "Bodies", "capture_nodes"]

_state = {"warm": False, "bodies": None, "in_body": False}
_streams = {}


def _capturing(pred: torch.Tensor) -> bool:
    return (pred.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def warm():
    """Every ``run_if`` body runs (a capture's warm-up on a copy)."""
    old = _state["warm"]
    _state["warm"] = True
    try:
        yield
    finally:
        _state["warm"] = old


class Bodies:
    """A capture's IF bodies: the memory pool of their temporaries, the IF
    nodes and the nodes inside their bodies. The pool lives until
    ``release``, which the graph's owner calls once the graph is gone (a
    pool handed back to the allocator is freed by ``empty_cache``)."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.device = torch.cuda.current_device()
        self.held = False       # this record holds one use of the pool
        self.ifs = self.nodes = 0

    @contextlib.contextmanager
    def route(self):
        """This thread's allocations go to the pool (the first route makes
        it, and the record keeps that use)."""
        torch._C._cuda_beginAllocateCurrentThreadToPool(self.device,
                                                        self.pool)
        try:
            yield
        finally:
            torch._C._cuda_endAllocateToPool(self.device, self.pool)
            if self.held:
                torch._C._cuda_releasePool(self.device, self.pool)
            self.held = True

    def release(self) -> None:
        if self.held:
            torch._C._cuda_releasePool(self.device, self.pool)
            self.held = False


@contextlib.contextmanager
def bodies():
    """Open a capture's IF bodies (``Bodies``) around the capture."""
    old = _state["bodies"]
    rec = Bodies()
    _state["bodies"] = rec
    try:
        yield rec
    finally:
        _state["bodies"] = old


def capture_nodes(device=None) -> int:
    """Nodes so far of the graph being captured on the current stream
    (an IF node counts as one; ``Bodies.nodes`` counts their insides)."""
    from nbodyax_torch.physics._build import load_library
    nodes = ctypes.c_size_t(0)
    err = load_library().nbodyax_capture_nodes(
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
        ctypes.byref(nodes))
    if err:
        raise RuntimeError(f"counting a capture's nodes failed (CUDA error "
                           f"{err})")
    return nodes.value


def _body_stream(device) -> torch.cuda.Stream:
    """The stream IF bodies are captured on, one a device."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _capture_if(pred: torch.Tensor, body) -> None:
    """Record ``body`` into an IF node of the graph being captured."""
    from nbodyax_torch.physics._build import load_library
    rec = _state["bodies"]
    if rec is None:
        raise RuntimeError("an IF node needs graph_if.bodies() around the "
                           "capture")
    if _state["in_body"]:
        raise RuntimeError("IF nodes do not nest")
    lib = load_library()
    dev = pred.device
    flag = pred.to(torch.bool)
    side = _body_stream(dev)
    err = lib.nbodyax_if_begin(
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        ctypes.c_void_p(side.cuda_stream), ctypes.c_void_p(flag.data_ptr()))
    if err:
        raise RuntimeError(f"opening a CUDA-graph IF node failed (CUDA "
                           f"error {err})")
    _state["in_body"] = True
    nodes = ctypes.c_size_t(0)
    try:
        with torch.cuda.stream(side), rec.route():
            body()
    finally:
        _state["in_body"] = False
        err = lib.nbodyax_if_end(ctypes.c_void_p(side.cuda_stream),
                                 ctypes.byref(nodes))
    if err:
        raise RuntimeError(f"closing a CUDA-graph IF node failed (CUDA "
                           f"error {err})")
    rec.ifs += 1
    rec.nodes += nodes.value


def run_if(pred: torch.Tensor, body) -> None:
    """Run ``body()`` where the 0-d bool tensor ``pred`` holds (see the
    module docstring for the three forms)."""
    if _capturing(pred):
        _capture_if(pred, body)
    elif _state["warm"] or bool(pred):
        body()
