"""Grid geometry and per-pair rules shared by the ``forceModel=bh`` modules.

Counterparts of the helpers at the top of ``nbodyax/physics/barneshut.py``:
the adaptive bounding box (``_extent``), cell indices (``_cells``,
``_flatten_cells``, ``_cell_sizes``), the moment channel order, sum-pooling,
the exact two-lane f32 id packing (``_pack_id`` / ``_unpack_id``), the
gathered per-pair rules of the near field (``_gathered_pair_accum``) and the
cell-sorted partner structure (``_partner_structure``).

Flat cell ids are row-major with x fastest, as in nbodyax. Everything here
is device-generic torch and queues no host read: the extent stays a pair of
0-d tensors on the state's device.
"""

from __future__ import annotations

import torch

from nbodyax_torch.physics.pairwise import (PairAccumulators,
                                            empty_accumulators,
                                            squared_distance)

__all__ = ["_extent", "_cells", "_flatten_cells", "_cell_sizes",
           "_moment_pairs", "_pool", "_pack_id", "_unpack_id",
           "_gathered_pair_accum", "_partner_structure"]

_I32_MIN = torch.iinfo(torch.int32).min


def _extent(pos, alive):
    """Bounding box of the live bodies: (mins, spans), each a tuple of 0-d
    f32 tensors, one a dimension. The span is floored at 1e-3 and widened
    by 1.0001 so the top edge falls inside the last cell."""
    big = 3e38
    mins, spans = [], []
    for d in range(pos.shape[-1]):
        lo = torch.where(alive, pos[:, d], big).min()
        hi = torch.where(alive, pos[:, d], -big).max()
        mins.append(lo)
        spans.append(torch.clamp(hi - lo, min=1e-3) * 1.0001)
    return tuple(mins), tuple(spans)


def _cells(pos, ext, g: int):
    """Per-axis cell indices at grid side g: a tuple of int64[N]."""
    mins, spans = ext
    return tuple(
        (torch.clamp((pos[:, d] - mins[d]) / spans[d], 0.0, 1.0 - 1e-7)
         * g).to(torch.int64)
        for d in range(pos.shape[-1]))


def _flatten_cells(cs, g: int):
    """Row-major flat cell id from per-axis indices, x fastest: cells
    adjacent in x are adjacent ids."""
    flat = cs[-1]
    for c in reversed(cs[:-1]):
        flat = flat * g + c
    return flat


def _cell_sizes(ext, g: int):
    mins, spans = ext
    return mins, tuple(s / g for s in spans)


def _moment_pairs(dim: int):
    """Index pairs (a <= b) of the symmetric second moment, in channel
    order."""
    return [(a, b) for a in range(dim) for b in range(a, dim)]


def _pool(a, s: int, dim: int):
    """Sum-pool 2^dim children into parents on a flat grid of side s."""
    shape = [s // 2, 2] * dim
    return a.reshape(shape).sum(dim=tuple(range(1, 2 * dim, 2))).reshape(-1)


def _pack_id(ids):
    """Split int ids over two exactly representable f32 lanes:
    hi = id >> 12 (< 2^19 for any int32 id), lo = id & 0xFFF."""
    ids = ids.to(torch.int64)
    return (ids >> 12).to(torch.float32), (ids & 0xFFF).to(torch.float32)


def _unpack_id(hi, lo):
    return hi.to(torch.int64) * 4096 + lo.to(torch.int64)


def _gathered_pair_accum(pi, vi, mi, ri, ii, pj, vj, mj, rj, jj, *,
                         eps2, growth_rate, mode: str) -> PairAccumulators:
    """Exact per-pair rules over per-body partner lists (nbodyax's
    ``_gathered_pair_accum``): i arrays are [C], j arrays [C, M]. Padded or
    masked partners carry mass 0 and drop out of every channel."""
    dim = pi.shape[-1]
    valid = (mi > 0)[:, None] & (mj > 0) & (ii[:, None] != jj)
    dp = pj - pi[:, None, :]
    d2 = squared_distance(dp)
    rsum = ri[:, None] + rj
    overlap = (d2 <= rsum * rsum) & valid

    fmask = valid if mode == "elastic" else (valid & ~overlap)
    d2e = d2 + eps2
    safe = fmask & (d2e > 0)
    inv = torch.rsqrt(torch.where(safe, d2e, torch.ones_like(d2e)))
    zero = torch.zeros((), dtype=torch.float32, device=pi.device)
    w = torch.where(safe, mj * (inv * inv * inv), zero)
    force = torch.stack([(w * dp[..., d]).sum(1) for d in range(dim)], 1)

    out = empty_accumulators(ii, dim=dim)._replace(force=force)
    if mode == "reference":
        heavier = mi[:, None] >= mj
        merge = overlap & heavier
        out = out._replace(
            gained_mass=torch.where(merge, mj, zero).sum(1),
            gained_radius=torch.where(merge, rj * growth_rate, zero).sum(1),
            died=(overlap & ~heavier).any(1))
    elif mode == "momentum":
        beats = (mj > mi[:, None]) | ((mj == mi[:, None]) & (jj < ii[:, None]))
        cand = overlap & beats
        key = torch.where(cand, mj, torch.full_like(mj, -torch.inf))
        bm = key.max(1).values
        is_best = cand & (key == bm[:, None])
        order = torch.where(is_best, -jj, torch.full_like(jj, _I32_MIN))
        best = torch.gather(jj, 1, order.argmax(1, keepdim=True))[:, 0]
        any_cand = cand.any(1)
        out = out._replace(
            best_mass=torch.where(any_cand, bm, torch.full_like(bm, -torch.inf)),
            parent=torch.where(any_cand, best, ii).to(torch.int32))
    elif mode == "elastic":
        vdotp = (vj[..., 0] - vi[:, None, 0]) * dp[..., 0]
        for d in range(1, dim):
            vdotp = vdotp + (vj[..., d] - vi[:, None, d]) * dp[..., d]
        approaching = overlap & (vdotp < 0) & (d2 > 0)
        msum = mi[:, None] + mj
        one = torch.ones((), dtype=torch.float32, device=pi.device)
        coef = torch.where(approaching,
                           2.0 * mj / torch.where(msum > 0, msum, one)
                           * vdotp / torch.where(d2 > 0, d2, one), zero)
        out = out._replace(dv=torch.stack(
            [(coef * dp[..., d]).sum(1) for d in range(dim)], 1))
    elif mode != "none":
        raise ValueError(f"unknown collision mode {mode!r}")
    return out


def _partner_structure(pos, vel, mass, radius, ext, g: int, need_vel: bool):
    """Cell-sorted partner structure of the near-field passes:
    ``(order, s_cell, starts, ends, sf)``.

    - ``order``: sorted position -> body index (int64), dead bodies last in
      an out-of-grid bucket ``ncells``; the sort is stable, so ties keep id
      order, which fixes slot occupancy and the f32 sum order;
    - ``s_cell``: flat cell id of each sorted position;
    - ``starts`` / ``ends``: each cell's [start, end) range in sorted order,
      found by binary search in ``s_cell`` (no histogram, no host read);
    - ``sf``: f32[N + 1, L] feature rows in sorted order: pos, (vel in
      elastic mode), mass, radius, id hi, id lo, and one zero row at N that
      padded gathers read (mass 0: inert in every channel).
    """
    dim = pos.shape[-1]
    n = pos.shape[0]
    ncells = g ** dim
    dev = pos.device
    alive = mass > 0
    cell = torch.where(alive, _flatten_cells(_cells(pos, ext, g), g),
                       torch.full((n,), ncells, dtype=torch.int64,
                                  device=dev))
    s_cell, order = torch.sort(cell, stable=True)
    ids = torch.arange(ncells, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(s_cell, ids)
    ends = torch.searchsorted(s_cell, ids, right=True)
    id_hi, id_lo = _pack_id(torch.arange(n, device=dev))
    lanes = [pos[:, d] for d in range(dim)]
    if need_vel:
        lanes += [vel[:, d] for d in range(dim)]
    lanes += [mass, radius, id_hi, id_lo]
    feats = torch.stack(lanes, 1)[order]
    sf = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    return order, s_cell, starts, ends, sf
