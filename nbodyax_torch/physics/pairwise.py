"""Dense all-pairs accumulators: the port's executable spec and CPU path.

Counterpart of ``nbodyax/physics/pairwise.py``, with the same per-pair
semantics (the reference's ``ComputeForces``):

- overlap test ``d^2 <= (r_i + r_j)^2``, with ``d^2`` summed axis by axis
  from the subtract-first ``p_j - p_i`` so it rounds like the CPU oracle;
- overlapping pairs are left out of the force sum (except in elastic mode);
- reference merge rule: on overlap, ``m_i >= m_j`` gains ``m_j`` and
  ``r_j * growthRate``, ``m_i < m_j`` dies (quirk Q1: equal masses
  double-absorb);
- force kernel ``m_j (p_j - p_i) / (d^2 + eps^2)^{3/2}`` (eps = 0 is the
  reference's bare kernel, quirk Q4).

Every reduction is associative over the j set, so accumulators from
disjoint j sets combine exactly (``combine_accumulators``). The pass is
chunked over i so the pair temporaries stay near 2^22 elements. Everything
here is device-generic: it runs on the CPU in the tests and is the plain
version the CUDA kernel is compared with on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["PairAccumulators", "pair_accumulators", "pair_accumulators_chunk",
           "combine_accumulators", "empty_accumulators"]

_I32_MIN = torch.iinfo(torch.int32).min


class PairAccumulators(NamedTuple):
    """Per-body reductions over a set of partner bodies.

    force:         f32[C,D] un-normalized gravity sum (before G)
    gained_mass:   f32[C]   reference mode: absorbed mass
    gained_radius: f32[C]   reference mode: absorbed radius (growth applied)
    died:          bool[C]  reference mode: a heavier body overlaps i
    best_mass:     f32[C]   momentum mode: mass of the strongest overlapping
                            body that beats i (-inf when none)
    parent:        i32[C]   momentum mode: global id of that body, else i
    dv:            f32[C,D] elastic mode: summed impulse velocity change
    """

    force: torch.Tensor
    gained_mass: torch.Tensor
    gained_radius: torch.Tensor
    died: torch.Tensor
    best_mass: torch.Tensor
    parent: torch.Tensor
    dv: torch.Tensor


def empty_accumulators(ii: torch.Tensor, dim: int = 2) -> PairAccumulators:
    """Identity element of the accumulator monoid for i bodies ``ii``."""
    c, dev = ii.shape[0], ii.device
    zd = torch.zeros((c, dim), dtype=torch.float32, device=dev)
    z1 = torch.zeros((c,), dtype=torch.float32, device=dev)
    return PairAccumulators(
        force=zd, gained_mass=z1, gained_radius=z1,
        died=torch.zeros((c,), dtype=torch.bool, device=dev),
        best_mass=torch.full((c,), -torch.inf, dtype=torch.float32,
                             device=dev),
        parent=ii.to(torch.int32), dv=zd)


def combine_accumulators(a: PairAccumulators,
                         b: PairAccumulators) -> PairAccumulators:
    """Fold partial accumulators from two disjoint j sets (associative).
    best_mass is the winner's, the larger value or on a tie the lower
    parent id (``torch.maximum``'s value): the winner takes the whole of
    its cotangent, as in one pass over both sets, where ``torch.maximum``
    (and ``jnp.maximum``) would split a tie's half and half."""
    b_wins = (b.best_mass > a.best_mass) | (
        (b.best_mass == a.best_mass) & (b.parent < a.parent))
    return PairAccumulators(
        force=a.force + b.force,
        gained_mass=a.gained_mass + b.gained_mass,
        gained_radius=a.gained_radius + b.gained_radius,
        died=a.died | b.died,
        best_mass=torch.where(b_wins, b.best_mass, a.best_mass),
        parent=torch.where(b_wins, b.parent, a.parent),
        dv=a.dv + b.dv)


def _axis_sum(w: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """sum_j w[c, j] * dp[c, j, :] without a matrix product (no TF32)."""
    return torch.stack([(w * dp[..., k]).sum(1) for k in range(dp.shape[-1])],
                       dim=-1)


def squared_distance(dp: torch.Tensor) -> torch.Tensor:
    """dx*dx + dy*dy (+ dz*dz), each product rounded, summed left to right:
    the rounding the overlap test is pinned to (no fused multiply-add)."""
    d2 = dp[..., 0] * dp[..., 0]
    for k in range(1, dp.shape[-1]):
        d2 = d2 + dp[..., k] * dp[..., k]
    return d2


def pair_accumulators_chunk(pi, vi, mi, ri, ii, pos, vel, mass, radius, jj, *,
                            eps2: float, growth_rate: float,
                            mode: str, pair_mask=None,
                            with_force: bool = True) -> PairAccumulators:
    """Accumulators for an i chunk [C] against a j set [M].

    ``ii`` / ``jj`` are global body ids (int32); the self pair is skipped by
    id equality. ``eps2`` and ``growth_rate`` are float32 values.
    ``pair_mask`` (bool [C, M]) restricts the pass to a pair subset: it is
    ANDed into the validity gate, so masked pairs add nothing to any
    channel. ``with_force=False`` skips the gravity sum (force stays 0).
    The bh giant pass uses both for its collision-only pairs.
    """
    alive_j = (mass > 0)[None, :]
    alive_i = (mi > 0)[:, None]
    jdx = jj[None, :]

    dp = pos[None, :, :] - pi[:, None, :]              # p_j - p_i [C,M,D]
    d2 = squared_distance(dp)
    rsum = ri[:, None] + radius[None, :]
    overlap = d2 <= rsum * rsum
    valid = alive_i & alive_j & (ii[:, None] != jdx)
    if pair_mask is not None:
        valid &= pair_mask
    overlap &= valid

    out = empty_accumulators(ii, dim=pi.shape[-1])
    if with_force:
        fmask = valid if mode == "elastic" else valid & ~overlap
        d2_eff = d2 + eps2
        safe = fmask & (d2_eff > 0)
        inv = torch.rsqrt(torch.where(safe, d2_eff, torch.ones_like(d2_eff)))
        w = torch.where(safe, mass[None, :] * (inv * inv * inv),
                        torch.zeros_like(inv))
        out = out._replace(force=_axis_sum(w, dp))

    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    if mode == "reference":
        heavier = mi[:, None] >= mass[None, :]          # >= : quirk Q1
        merge = overlap & heavier
        out = out._replace(
            gained_mass=torch.where(merge, mass[None, :], zero).sum(1),
            gained_radius=torch.where(
                merge, radius[None, :] * growth_rate, zero).sum(1),
            died=(overlap & ~heavier).any(1))
    elif mode == "momentum":
        # j beats i if heavier, or equal mass and lower global id
        beats = (mass[None, :] > mi[:, None]) | (
            (mass[None, :] == mi[:, None]) & (jdx < ii[:, None]))
        cand = overlap & beats
        key = torch.where(cand, mass[None, :],
                          torch.full_like(d2, -torch.inf))
        kmax = key.max(1, keepdim=True).values
        is_best = cand & (key == kmax)
        order = torch.where(is_best, -jdx, torch.full_like(jdx, _I32_MIN))
        best_local = order.argmax(1)
        any_cand = cand.any(1)
        out = out._replace(
            best_mass=torch.where(any_cand, kmax[:, 0],
                                  torch.full_like(kmax[:, 0], -torch.inf)),
            parent=torch.where(any_cand, jj[best_local], ii).to(torch.int32))
    elif mode == "elastic":
        rel = vel[None, :, :] - vi[:, None, :]          # v_j - v_i
        vdotp = (rel[..., 0] * dp[..., 0])
        for k in range(1, dp.shape[-1]):
            vdotp = vdotp + rel[..., k] * dp[..., k]
        approaching = overlap & (vdotp < 0) & (d2 > 0)
        msum = mi[:, None] + mass[None, :]
        msum = torch.where(msum > 0, msum, torch.ones_like(msum))
        coef = torch.where(
            approaching,
            2.0 * mass[None, :] / msum * vdotp
            / torch.where(d2 > 0, d2, torch.ones_like(d2)),
            zero)
        out = out._replace(dv=_axis_sum(coef, dp))
    elif mode != "none":
        raise ValueError(f"unknown collision mode {mode!r}")
    return out


def pair_accumulators(pos, vel, mass, radius, *, eps: float = 0.0,
                      growth_rate: float = 0.1, mode: str = "reference",
                      chunk: Optional[int] = None) -> PairAccumulators:
    """All-pairs accumulators, chunked over i bodies.

    ``chunk`` bounds the [chunk, N] pair temporaries; by default chunk * N
    is about 2^22 elements.
    """
    n = pos.shape[0]
    if chunk is None:
        chunk = max(8, min(n, (1 << 22) // max(n, 1)))
    eps32 = torch.tensor(eps, dtype=torch.float32)
    eps2 = float(eps32 * eps32)
    growth = float(torch.tensor(growth_rate, dtype=torch.float32))
    jj = torch.arange(n, dtype=torch.int32, device=pos.device)
    parts = [pair_accumulators_chunk(
        pos[s:s + chunk], vel[s:s + chunk], mass[s:s + chunk],
        radius[s:s + chunk], jj[s:s + chunk], pos, vel, mass, radius, jj,
        eps2=eps2, growth_rate=growth, mode=mode)
        for s in range(0, n, chunk)]
    if len(parts) == 1:
        return parts[0]
    return PairAccumulators(*(torch.cat(xs, 0) for xs in zip(*parts)))
