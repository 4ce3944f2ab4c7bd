"""Process groups and state placement for ``shards > 1``.

Counterpart of ``nbodyax/sharding/mesh.py``. Where nbodyax runs one
process over a mesh of P devices, the port runs one process a shard on
``torch.distributed``, launched with ``torch.distributed.run`` (torchrun):

    python -m torch.distributed.run --nproc-per-node P \\
        -m nbodyax_torch.cli --set shards=P [--device cpu]

``maybe_init_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and joins
the group: NCCL with rank r on ``cuda:LOCAL_RANK``, gloo on the CPU. The
group has a timeout (``GROUP_TIMEOUT``), so a rank that fails ends the run
rather than leaving its peers waiting. ``make_group`` is ``make_mesh``'s
rule: the shard count must equal the world size, and on cards there must
be a card for every rank on the host (NCCL refuses two ranks on one card).

Shard r owns the rows [r n / P, (r + 1) n / P) of a capacity ``n`` that
``pad_to_shards`` made a multiple of P with dead slots (mass 0).
``ShardGroup`` holds the rank, the size, the device and the process group,
and the four collectives the steps use. A CUDA tensor goes through NCCL
only: gloo, which runs the CPU groups, never sees one, and no collective
copies a card's tensor to the host. Each collective is a
``torch.autograd.Function`` whose backward is its transpose (the shift
the other way round the ring, reduce_scatter for all_gather and the
reverse; the minimum over ranks raises, as ``lax.pmin`` has no
derivative); its forward makes the calls it made before it had one. Under
torchrun each launch attempt's group keys its store entries by the attempt
(``TORCHELASTIC_RESTART_COUNT``), so a relaunch never reads the addresses
of the attempt before it.

Inside a CUDA-graph capture (the driver's sharded graph windows) NCCL
records each collective into the graph, and every replay runs it again.
The collectives here are safe there: all_gather, reduce_scatter and the
minimum are synchronous calls, so the current stream waits for NCCL's
before each returns; the ring shift's works are waited before its tiles
are read; outputs are allocated on the capturing stream's side, from the
graph's pool; and ``all_gather_into`` writes into a buffer made before the
capture (a graph's static output). A capture must follow an eager run of
the same collectives on every rank: NCCL makes its communicator and a
pair's connection at their first use, which a capture cannot hold.
``GROUP_TIMEOUT`` covers eager collectives only, since NCCL's watchdog
does not track a replay's work; so a rank that fails must not wait for its
peers on its way out (``close_group``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from nbodyax_torch.state import SimState

__all__ = ["ShardGroup", "maybe_init_distributed", "make_group",
           "pad_to_shards", "shard_state", "close_group", "GROUP_TIMEOUT"]

# how long a collective waits for a peer before the run fails
GROUP_TIMEOUT = datetime.timedelta(seconds=600)

# the tensor forms of all_gather and reduce_scatter (renamed in newer torch)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class _Shift:
    """A ring shift in flight: ``wait`` returns the received tensors."""

    def __init__(self, works, bufs):
        self.works, self.bufs = works, bufs

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        return self.bufs


def _post_shift(tensors, dst: int, src: int, group) -> _Shift:
    """Send ``tensors`` to rank ``dst`` and receive rank ``src``'s into new
    buffers of the same shapes, as one ``batch_isend_irecv``."""
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, src, group) for b in bufs]
    return _Shift(dist.batch_isend_irecv(ops), bufs)


class _ShiftFn(torch.autograd.Function):
    """The ring shift. The forward posts the shift and hands its works to
    the caller (``works``), who waits before reading the outputs, so the
    transfer runs beside the current hop. The backward is its transpose:
    the received tiles' cotangents go back to rank r + 1 and rank r - 1's
    come in, so the gradient of the tile held at hop h reaches its owner
    after h backward shifts."""

    @staticmethod
    def forward(ctx, g, works, *tensors):
        ctx.g = g
        shift = _post_shift(tensors, (g.rank - 1) % g.size,
                            (g.rank + 1) % g.size, g.group)
        works.extend(shift.works)
        return tuple(shift.bufs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        g = ctx.g
        back = _post_shift(grads, (g.rank + 1) % g.size,
                           (g.rank - 1) % g.size, g.group).wait()
        return (None, None, *back)


class _AllGatherFn(torch.autograd.Function):
    """all_gather; the backward is reduce_scatter_sum of the cotangent. The
    output is made here, where grad mode is off (gloo's gather into a
    tensor writes views of its output, which autograd refuses in grad
    mode)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return g._all_gather(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return ctx.g._reduce_scatter_sum(grad), None


class _ReduceScatterFn(torch.autograd.Function):
    """reduce_scatter_sum; the backward is all_gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return g._reduce_scatter_sum(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return ctx.g._all_gather(grad), None


class _AllMinFn(torch.autograd.Function):
    """all_min: the forward is the minimum over ranks, and the backward
    raises, as nbodyax's ``lax.pmin`` has no differentiation rule (sharded
    adaptive dt is forward-only in both packages)."""

    @staticmethod
    def forward(ctx, x, g):
        return g._all_min(x)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the minimum over ranks (adaptive dt under shards > 1) has no "
            "gradient, as nbodyax's lax.pmin has none: differentiate a "
            "sharded run with adaptiveDt=0")


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """One rank's view of the shard group. ``group`` None is the default
    process group. The collectives take and return tensors on ``device``
    and are called by every rank in the same order. Each is a
    ``torch.autograd.Function`` whose backward is its transpose
    (``all_min``'s raises); every rank's backward takes the transposed
    collectives in the same order, since every rank built the same
    graph."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` (equal shapes) stacked along dim 0 in rank
        order."""
        return _AllGatherFn.apply(x, self)

    def reduce_scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' ``x`` over rank, this rank's 1/size of dim 0."""
        return _ReduceScatterFn.apply(x, self)

    def shift(self, tensors) -> _Shift:
        """Start the ring shift: send ``tensors`` to rank r - 1 and receive
        rank r + 1's into new buffers of the same shapes."""
        works = []
        bufs = _ShiftFn.apply(self, works, *tensors)
        return _Shift(works, list(bufs))

    def all_min(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum of the ranks' ``x``."""
        return _AllMinFn.apply(x, self)

    def all_gather_into(self, out: torch.Tensor, x: torch.Tensor) -> None:
        """``all_gather`` into ``out`` (size x ``x``'s rows), which may be a
        graph's static buffer; not differentiable."""
        _all_gather(out, x.contiguous(), group=self.group)

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x, group=self.group)
        return out

    def _reduce_scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        _reduce_scatter(out, x, group=self.group)
        return out

    def _all_min(self, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MIN, group=self.group)
        return y


def maybe_init_distributed(device) -> Optional[ShardGroup]:
    """Join the process group that torchrun's environment describes, or
    the one the caller already initialised; None for a single process
    (no ``WORLD_SIZE`` in the environment and no group). On a card each
    rank takes ``cuda:LOCAL_RANK`` under NCCL; on the CPU the group is
    gloo."""
    dev = torch.device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return None
        if dev.type == "cuda":
            # every rank of the host checks before any joins the group
            ranks = int(os.environ.get("LOCAL_WORLD_SIZE",
                                       os.environ["WORLD_SIZE"]))
            cards = torch.cuda.device_count()
            if ranks > cards:
                raise ValueError(
                    f"{ranks} ranks on a host with {cards} card(s): NCCL "
                    "takes one rank a card")
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
        # under torchrun the store outlives a relaunch, and a rank of the
        # new attempt would read the old attempt's addresses: each
        # attempt's group takes keys of its own
        attempt = os.environ.get("TORCHELASTIC_RESTART_COUNT", "0")
        store, rank, size = next(dist.rendezvous("env://",
                                                 timeout=GROUP_TIMEOUT))
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.PrefixStore(f"attempt_{attempt}/", store),
            rank=rank, world_size=size, timeout=GROUP_TIMEOUT)
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return ShardGroup(dist.get_rank(), dist.get_world_size(), dev)


def close_group(failed: bool) -> None:
    """Leave the process group, if one was joined. After a failure an NCCL
    group is aborted rather than destroyed, so the failing rank waits for
    no peer (a peer may be stuck in a graph replay that waits for this
    rank); it exits with its error, and torchrun ends or relaunches its
    peers. Either way NCCL tears a communicator down only once every CUDA
    graph that captured its collectives is destroyed: a failed run closes
    its graph runner before this (``driver._run_simulation_once``)."""
    if not dist.is_initialized():
        return
    if failed and dist.get_backend() == "nccl":
        from torch.distributed.distributed_c10d import _abort_process_group
        _abort_process_group()
    else:
        dist.destroy_process_group()


def make_group(n_shards: int, device) -> ShardGroup:
    """The group of ``n_shards`` ranks this process belongs to (nbodyax's
    ``make_mesh``): ``ValueError`` when the shard count is not the world
    size, or (``maybe_init_distributed``) when there are more ranks on
    this host than cards."""
    group = maybe_init_distributed(device)
    size = 1 if group is None else group.size
    if group is None or n_shards != size:
        raise ValueError(
            f"shards={n_shards} needs {n_shards} processes, one a shard "
            f"(python -m torch.distributed.run --nproc-per-node "
            f"{n_shards} ...); this run has {size}")
    return group


def pad_to_shards(state: SimState, n_shards: int) -> SimState:
    """Pad the capacity to a multiple of ``n_shards`` with dead slots
    (mass 0)."""
    n = state.capacity
    pad = -(-n // n_shards) * n_shards - n
    if pad == 0:
        return state

    def pad1(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return SimState(pad1(state.pos), pad1(state.vel), pad1(state.mass),
                    pad1(state.radius), state.step, state.sim_time)


def shard_state(state: SimState, group: ShardGroup) -> SimState:
    """This rank's rows of a global state whose capacity the group size
    divides, on the group's device (step and sim_time replicated)."""
    n = state.capacity
    if n % group.size:
        raise ValueError(f"capacity {n} is not a multiple of the "
                         f"{group.size} shards (pad_to_shards first)")
    m = n // group.size
    rows = slice(group.rank * m, (group.rank + 1) * m)
    return SimState(*(t[rows].to(group.device).contiguous()
                      for t in state[:4]),
                    state.step, state.sim_time.to(group.device))
