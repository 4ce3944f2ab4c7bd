"""The exact step across shards: j tiles passed around a ring of ranks.

Counterpart of ``nbodyax/sharding/ring.py``. Each rank keeps its own i
bodies and their accumulators, and the j tile (pos, mass and radius, and
vel in elastic mode, the one mode whose pair rule reads the partner's
velocity) goes around the ring: at hop h rank r holds the tile of rank
(r + h) mod P, whose rows start at global id ((r + h) mod P) n / P. The
next hop's shift (send to r - 1, receive from r + 1, one
``batch_isend_irecv``) is posted before the current tile's pass, so the
transfer runs beside the pair math, and the tiles' accumulators fold in
hop order (``combine_accumulators``).

Collisions: reference, elastic and none resolve on each rank's own rows.
Momentum-mode merge trees cross ranks, so the parents and the state are
all-gathered, resolved on every rank alike and sliced back (pointer
doubling is O(n log n), small beside the O(n^2 / P) pairs). Adaptive dt is
the minimum over ranks (``step_dt(..., group)``). euler, leapfrog (the
ring twice a step) and yoshida4 (four times) run as in ``physics/step.py``.

Reverse mode: the shifts and gathers are differentiable (``mesh.py``), so
each hop's B1 call (``tile_accumulators_raw``) gets its backward, B2 with
the hop's global offsets, and the tile's gradient goes back round the ring
to its owner. A momentum merge's best-mass cotangent reaches only the hop
whose candidate won the fold (``combine_accumulators``), which routes it to
that parent's mass. Adaptive dt under shards has no gradient.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from nbodyax_torch.physics.collisions import resolve_collisions
from nbodyax_torch.physics.kernels import (body_features, decode_raw,
                                           tile_accumulators_raw)
from nbodyax_torch.physics.pairwise import (PairAccumulators,
                                            combine_accumulators,
                                            empty_accumulators,
                                            pair_accumulators_chunk)
from nbodyax_torch.physics.step import (PhysicsParams, finish_euler,
                                        finish_leapfrog, half_kick_drift,
                                        step_dt, yoshida4_tail)
from nbodyax_torch.sharding.mesh import ShardGroup
from nbodyax_torch.state import SimState

__all__ = ["make_local_accum_fn", "ring_accumulators",
           "resolve_collisions_sharded", "make_sharded_step",
           "integrate_sharded"]


def make_local_accum_fn(backend: str, p: PhysicsParams):
    """(pi, vi, mi, ri, i_off, pj, vj, mj, rj, j_off) -> the accumulators
    of the i rows against one j tile, with the global ids of the two
    tiles' first rows. ``auto`` / ``pallas``: B1 (``tile_accumulators_raw``,
    its plain version on the CPU); ``jnp``: the chunked torch oracle."""
    if backend in ("auto", "pallas"):
        def accum(pi, vi, mi, ri, i_off, pj, vj, mj, rj, j_off):
            dim = pi.shape[-1]
            raw, par = tile_accumulators_raw(
                body_features(pi, vi, mi, ri), body_features(pj, vj, mj, rj),
                i_off, j_off, mode=p.collision_mode, eps=p.eps,
                growth_rate=p.growth_rate, dim=dim)
            return decode_raw(raw, par, i_off, mi, p.collision_mode, dim=dim)
        return accum
    if backend != "jnp":
        raise ValueError(f"unknown backend {backend!r}")
    eps2 = float(torch.tensor(p.eps, dtype=torch.float32) ** 2)
    growth = float(torch.tensor(p.growth_rate, dtype=torch.float32))

    def accum(pi, vi, mi, ri, i_off, pj, vj, mj, rj, j_off):
        dev = pi.device
        ni, nj = pi.shape[0], pj.shape[0]
        ii = i_off + torch.arange(ni, dtype=torch.int32, device=dev)
        jj = j_off + torch.arange(nj, dtype=torch.int32, device=dev)
        c = max(8, min(ni, (1 << 22) // max(nj, 1)))
        parts = [pair_accumulators_chunk(
            pi[s:s + c], vi[s:s + c], mi[s:s + c], ri[s:s + c], ii[s:s + c],
            pj, vj, mj, rj, jj, eps2=eps2, growth_rate=growth,
            mode=p.collision_mode) for s in range(0, ni, c)]
        return PairAccumulators(*(torch.cat(xs) for xs in zip(*parts)))
    return accum


def ring_accumulators(pos, vel, mass, radius, *, group: ShardGroup,
                      accum_fn: Callable,
                      need_vel: bool = True) -> PairAccumulators:
    """This rank's rows [n/P] folded against all n bodies, tile by tile
    around the ring. ``need_vel=False`` leaves vel out of the tile (zeros
    stand in for the partners' velocities)."""
    n_local = pos.shape[0]
    i_off = group.rank * n_local
    acc = empty_accumulators(i_off + torch.arange(
        n_local, dtype=torch.int32, device=pos.device), dim=pos.shape[-1])
    tile = [pos, vel, mass, radius] if need_vel else [pos, mass, radius]
    zero_vel = None if need_vel else torch.zeros_like(vel)
    for hop in range(group.size):
        shift = group.shift(tile) if hop + 1 < group.size else None
        if need_vel:
            pj, vj, mj, rj = tile
        else:
            (pj, mj, rj), vj = tile, zero_vel
        j_off = (group.rank + hop) % group.size * n_local
        acc = combine_accumulators(acc, accum_fn(
            pos, vel, mass, radius, i_off, pj, vj, mj, rj, j_off))
        if shift is not None:
            tile = shift.wait()
    return acc


def resolve_collisions_sharded(pos, vel, mass, radius, acc, mode: str,
                               group: ShardGroup, restitution: float = 1.0):
    """``resolve_collisions`` on this rank's rows. Momentum mode gathers
    the state and the parents (the only channel its commit reads),
    resolves the whole set and keeps this rank's slice."""
    if mode != "momentum":
        return resolve_collisions(pos, vel, mass, radius, acc, mode=mode,
                                  restitution=restitution)
    g = group.all_gather
    n_local = pos.shape[0]
    acc_g = empty_accumulators(g(acc.parent), dim=pos.shape[-1])
    out = resolve_collisions(g(pos), g(vel), g(mass), g(radius), acc_g,
                             mode="momentum")
    rows = slice(group.rank * n_local, (group.rank + 1) * n_local)
    return tuple(x[rows] for x in out)


def integrate_sharded(p: PhysicsParams, group: ShardGroup, accum: Callable):
    """The sharded step around ``accum(pos, vel, mass, radius)``, this
    rank's accumulators: collisions (``resolve_collisions_sharded``), the
    lockstep dt and the integrator's tail, as ``physics/step.py``'s."""
    if p.integrator not in ("euler", "leapfrog", "yoshida4"):
        raise ValueError(f"unknown integrator {p.integrator!r}")

    def step(state: SimState) -> SimState:
        pos, vel, mass, radius = state[:4]
        acc = accum(pos, vel, mass, radius)
        pos2, vel2, mass2, radius2 = resolve_collisions_sharded(
            pos, vel, mass, radius, acc, p.collision_mode, group,
            restitution=p.restitution)
        dt = step_dt(vel2, mass2, radius2, acc.force, p, group=group)
        if p.integrator == "euler":
            out = finish_euler(pos2, vel2, mass2, radius2, radius, acc.force,
                               p, dt)
        elif p.integrator == "yoshida4":
            out = yoshida4_tail(pos2, vel2, mass2, radius2, acc.force, accum,
                                p, dt)
        else:
            v_half, new_pos = half_kick_drift(pos2, vel2, acc.force, p, dt)
            acc2 = accum(new_pos, v_half, mass2, radius2)
            out = finish_leapfrog(pos2, new_pos, v_half, mass2, radius2,
                                  acc2.force, p, dt)
        return SimState(*out, state.step + 1, state.sim_time + dt)

    return step


def make_sharded_step(cfg, p: PhysicsParams,
                      group: ShardGroup) -> Callable[[SimState], SimState]:
    """The exact step on this rank's rows of a sharded state: the pair
    accumulators from the ring (``cfg.backend`` picks B1 or the oracle),
    everything else as the single-device step."""
    if cfg.backend == "pallas" and group.device.type != "cuda":
        raise ValueError(f"backend=pallas is the CUDA kernel; device "
                         f"{group.device} has none (use auto or jnp)")
    ring = partial(ring_accumulators, group=group,
                   accum_fn=make_local_accum_fn(cfg.backend, p),
                   need_vel=p.collision_mode == "elastic")
    return integrate_sharded(p, group, ring)
