"""Collision resolution modes.

Counterpart of ``nbodyax/physics/collisions.py``: turns the pair
accumulators into committed state updates.

- ``reference``: every body that overlaps a lighter-or-equal body gains its
  mass and ``r_j * growthRate`` radius; every body overlapped by a strictly
  heavier one dies (mass 0). Equal masses absorb each other (quirk Q1), so
  neither mass nor momentum is conserved: that is the reference's rule.
- ``momentum``: losers donate to the strongest overlapping winner; merge
  trees are resolved to their roots by pointer doubling, and each root takes
  the tree's mass, momentum-weighted velocity, centre of mass and an
  area-conserving radius. On a card the tree sums add in a fixed order,
  so a run repeats bit for bit.
- ``elastic``: no merging; the summed pair impulse, scaled by (1+e)/2.
- ``none``: nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from nbodyax_torch.physics.pairwise import PairAccumulators

__all__ = ["resolve_collisions"]


def _pointer_double(parent: torch.Tensor, iters: int) -> torch.Tensor:
    """Resolve parent pointers to their roots: ``p <- p[p]``, ``iters``
    times. Every parent is strictly stronger than its child, so the pointer
    graph is a forest and ceil(log2 N) rounds reach every root."""
    p = parent.long()
    for _ in range(iters):
        p = p[p]
    return p


def resolve_collisions(pos, vel, mass, radius, acc: PairAccumulators, *,
                       mode: str, restitution: float = 1.0):
    """Apply collision outcomes; returns (pos, vel, mass, radius).

    ``vel`` is the velocity before the kick: merges resolve from the
    step-start state, as in the reference.
    """
    if mode == "none":
        return pos, vel, mass, radius
    zero = torch.zeros((), dtype=torch.float32, device=mass.device)

    if mode == "reference":
        new_mass = torch.where(acc.died, zero, mass + acc.gained_mass)
        new_mass = torch.where(mass > 0, new_mass, zero)
        # the radius is committed even for dying bodies, as the reference
        # does; dead slots are masked everywhere
        new_radius = radius + acc.gained_radius
        return pos, vel, new_mass, new_radius

    if mode == "momentum":
        n = pos.shape[0]
        iters = max(1, (n - 1).bit_length())
        idx = torch.arange(n, device=pos.device)
        alive = mass > 0
        root = torch.where(alive, _pointer_double(acc.parent, iters), idx)

        def tree_sum(x):
            if x.is_cuda:
                # index_add_ adds by CUDA atomics, in an order that changes
                # from run to run; index_put_ with accumulate sorts the ids
                # and adds each root's terms in a fixed order
                return torch.zeros_like(x).index_put_((root,), x,
                                                      accumulate=True)
            return torch.zeros_like(x).index_add_(0, root, x)

        msum = tree_sum(mass)
        psum = tree_sum(mass[:, None] * vel)
        xsum = tree_sum(mass[:, None] * pos)
        r2sum = tree_sum(radius * radius)
        is_root = (root == idx) & alive
        safe_m = torch.where(msum > 0, msum, torch.ones_like(msum))
        new_mass = torch.where(is_root, msum, zero)
        new_vel = torch.where(is_root[:, None], psum / safe_m[:, None], vel)
        new_pos = torch.where(is_root[:, None], xsum / safe_m[:, None], pos)
        new_radius = torch.where(is_root, torch.sqrt(r2sum), radius)
        return new_pos, new_vel, new_mass, new_radius

    if mode == "elastic":
        fac = np.float32(0.5 * (1.0 + float(restitution)))
        dv = acc.dv if fac == np.float32(1.0) else float(fac) * acc.dv
        return pos, vel + dv, mass, radius

    raise ValueError(f"unknown collision mode {mode!r}")
