"""The bh step across shards: every rank evaluates a slice of the cells.

Counterpart of ``nbodyax/sharding/bh.py``. The bodies stay placed as for
the exact ring (rank r owns rows [r n / P, (r + 1) n / P)). Each step
all-gathers pos, vel, mass and radius; every rank builds the same grids,
slot grid, moments and FMM tables from the gathered arrays and evaluates
only its contiguous 1/P of the finest cells and its 1/P of the completion
list (``barneshut.bh_cellrange_accumulators``). Each body's accumulators
then come whole from one rank, so the merge is a sum once every lane is
rebased to identity 0: the force, gained mass and radius, died as 0/1,
``parent - index`` split into two exact float lanes (hi 4096 + lo), and
dv ride one ``reduce_scatter_sum`` that hands each rank its own rows. The
sum adds one nonzero term a body, so it is exact in any order. best_mass,
which no commit reads, comes back as -inf. Collisions, the lockstep dt and
the integrators are the ring step's (``ring.integrate_sharded``).
"""

from __future__ import annotations

from typing import Callable

import torch

from nbodyax_torch.physics.barneshut import (bh_cellrange_accumulators,
                                             resolve_near_kernel)
from nbodyax_torch.physics.pairwise import PairAccumulators
from nbodyax_torch.physics.step import PhysicsParams
from nbodyax_torch.sharding.mesh import ShardGroup
from nbodyax_torch.sharding.ring import integrate_sharded
from nbodyax_torch.state import SimState

__all__ = ["make_sharded_bh_step", "sharded_bh_accumulators"]

_ID_SPLIT = 4096      # parent - index = hi * 4096 + lo, both exact in f32


def _lanes(acc: PairAccumulators, n: int) -> torch.Tensor:
    """The identity-0 lanes of full-length accumulators, f32[n, 2 dim + 6]:
    force, gained mass, gained radius, died, parent offset hi and lo,
    dv."""
    dev = acc.force.device
    off = acc.parent.to(torch.int64) - torch.arange(n, device=dev)
    hi = torch.div(off, _ID_SPLIT, rounding_mode="floor")
    return torch.cat([acc.force, acc.gained_mass[:, None],
                      acc.gained_radius[:, None],
                      acc.died.to(torch.float32)[:, None],
                      hi.to(torch.float32)[:, None],
                      (off - hi * _ID_SPLIT).to(torch.float32)[:, None],
                      acc.dv], 1)


def _from_lanes(lanes: torch.Tensor, first: int, dim: int
                ) -> PairAccumulators:
    """Accumulators of the rows from global id ``first`` from their summed
    lanes."""
    n = lanes.shape[0]
    idx = first + torch.arange(n, device=lanes.device)
    off = (lanes[:, dim + 3].to(torch.int64) * _ID_SPLIT
           + lanes[:, dim + 4].to(torch.int64))
    return PairAccumulators(
        force=lanes[:, :dim], gained_mass=lanes[:, dim],
        gained_radius=lanes[:, dim + 1], died=lanes[:, dim + 2] > 0.5,
        best_mass=torch.full((n,), -torch.inf, dtype=torch.float32,
                             device=lanes.device),
        parent=(idx + off).to(torch.int32), dv=lanes[:, dim + 5:])


def sharded_bh_accumulators(pos, vel, mass, radius, *, group: ShardGroup,
                            **kw) -> PairAccumulators:
    """This rank's rows of the bh accumulators of the whole body set:
    gather, evaluate this rank's cell range, sum the rebased lanes by one
    reduce_scatter. ``kw`` are ``bh_accumulators``'s knobs."""
    g = group.all_gather
    gp = g(pos)
    n = gp.shape[0]
    acc = bh_cellrange_accumulators(gp, g(vel), g(mass), g(radius),
                                    group.rank, group.size, **kw)
    mine = group.reduce_scatter_sum(_lanes(acc, n))
    return _from_lanes(mine, group.rank * pos.shape[0], pos.shape[-1])


def make_sharded_bh_step(cfg, p: PhysicsParams,
                         group: ShardGroup) -> Callable[[SimState], SimState]:
    """The ``forceModel=bh`` step on this rank's rows of a sharded state;
    ``cfg``'s bh knobs must be resolved (``driver.resolve_bh_config``)."""
    resolve_near_kernel(cfg.bh_pallas, cfg.bh_near, group.device)

    def accum(pos, vel, mass, radius):
        return sharded_bh_accumulators(
            pos, vel, mass, radius, group=group, eps=p.eps,
            growth_rate=p.growth_rate, mode=p.collision_mode,
            levels=cfg.bh_levels, ring=cfg.bh_ring,
            neighbor_k=cfg.bh_neighbor_k, order=cfg.bh_order,
            far=cfg.bh_far, near=cfg.bh_near, comp_cap=cfg.bh_comp_cap,
            near_kernel=cfg.bh_pallas, n_giants=cfg.bh_giants)
    return integrate_sharded(p, group, accum)
