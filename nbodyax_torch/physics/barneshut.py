"""Hierarchical gravity, ``forceModel=bh``: FMM far field plus the exact
grid-neighbour near field, single device, in 2-D (a quadtree of cells) and
3-D (an octree, at most 7 levels).

Counterpart of ``nbodyax/physics/barneshut.py``; see its module docstring
for the model and its documented approximations. The pieces:

- ``bh_grid``: extent, cells, id packing, the per-pair rules and the
  cell-sorted partner structure;
- ``slotpack_kernel``: the slot grid and the finest moments (B4, B5);
- ``near_kernel``: the slots near field (B3);
- ``fmm``: moment grids, the FMM, the annulus and ``bhFar=direct``;
- ``annulus_kernel``: the annulus at the cells' slots, the CUDA kernel on a
  card (``fmm``'s plain version on the CPU);
- here: the knob heuristics, the per-body and per-cell near passes with
  their completion pass, the slot unsort, the giant-collision pass,
  ``bh_accumulators`` and the diagnostics the driver reads.

The step reads nothing back to the host, so a CUDA graph can hold it. As
in nbodyax, the crowded-cell bodies go into a list of static length
(``_completion_list``, nbodyax's ``_completion_slice``) whose fill entries
``n`` write a discarded row n, and the completion passes run under tiers
(``_Tiers``, nbodyax's ``_tiered``): nothing, the first ``_COMP_TIER``
entries, or the whole list. The giant pass takes a static top-B list with
the entries that do not qualify masked to mass 0, under tiers of
``_GIANT_TIER`` and B entries. Each tier is a ``graph_if.run_if`` branch:
a CUDA-graph IF node under a capture, the predicate's value elsewhere.
One tier decision a step serves every completion pass.

``near_kernel="auto"`` (the ``bhPallas`` knob) runs B3 and B5 (or B4)
through their wrappers: the kernels on a CUDA tensor, their plain versions
on a CPU tensor; ``"on"`` demands a CUDA tensor; ``"off"`` runs the plain
torch engines on any device. The annulus kernel follows the same knob on
either near engine: on a CUDA tensor unless ``"off"``.

The sharded step's hooks are nbodyax's: ``bh_cellrange_accumulators(shard,
nshards)`` evaluates one contiguous 1/nshards slice of the finest cells
(``cell_range``, host ints) and 1/nshards of the completion list
(``comp_range``) on the whole body set, so each body's accumulators come
from exactly one shard and the others hold the identity
(``sharding/bh.py`` sums them).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from nbodyax_torch.physics.bh_grid import (_cell_sizes, _cells, _extent,
                                           _flatten_cells,
                                           _gathered_pair_accum,
                                           _partner_structure, _unpack_id)
from nbodyax_torch.physics.annulus_kernel import annulus_cells
from nbodyax_torch.physics.fmm import (_annulus_force_bodies,
                                       _annulus_force_cells, _cell_slice,
                                       _far_force,
                                       _far_force_cells, _fmm_local_table,
                                       _l2p, _l2p_slots, _level_grids)
from nbodyax_torch.physics.graph_if import run_if
from nbodyax_torch.physics.near_kernel import (_lanes, slots_near,
                                               slots_near_reference)
from nbodyax_torch.physics.pairwise import (PairAccumulators,
                                            combine_accumulators,
                                            empty_accumulators,
                                            pair_accumulators_chunk)
from nbodyax_torch.physics.slotpack_kernel import (build_slot_grid_reference,
                                                   pack_slots)

__all__ = ["bh_accumulators", "bh_cellrange_accumulators", "auto_levels",
           "auto_neighbor_k", "pick_levels",
           "overflow_count", "bh_health", "slot_cap", "needed_neighbor_k",
           "giant_collision_accumulators", "resolve_near_kernel"]


def auto_levels(n: int, target_occupancy: int = 0, max_levels: int = 10,
                dim: int = 2) -> int:
    """Finest level for an average occupancy near the target (16 in 2-D,
    32 in 3-D): grid side 2^levels, 2^(dim*levels) cells."""
    if dim == 3:
        max_levels = min(max_levels, 7)
    if not target_occupancy:
        target_occupancy = 32 if dim == 3 else 16
    cells = max(4, n // max(1, target_occupancy))
    return max(2, min(max_levels, math.ceil(math.log(cells, 2 ** dim))))


def auto_neighbor_k(n: int, levels: int, ring: int = 1, dim: int = 2,
                    near: str = "rows") -> int:
    """Near-field partner cap matched to the grid: per window ROW for
    ``rows`` (~1.33x the mean row population, floor 64), per CELL for
    ``slots`` (~2.5x the mean occupancy, floor 40); multiples of 8."""
    occ = max(1, -(-n // (1 << (dim * levels))))
    if near == "slots":
        return int(max(40, 8 * -(-(occ * 5 // 2) // 8)))
    want = (2 * ring + 1) * occ * 4 // 3
    return int(max(64, 8 * -(-want // 8)))


_SLOTS_PREFERRED_N = 1_500_000   # rows/slots crossover of the plain engines
_CI_CAP = 32                      # floor of the per-cell i-slot budget
_COMP_TIER = 1024                 # the completion list's small tier
_GIANT_TIER = 64                  # the giant list's small tier


def slot_cap(n: int, ncells: int) -> int:
    """Per-cell i-slot budget: 2x the mean occupancy, a multiple of 8,
    at least 32 and at most 1024."""
    occ = -(-n // max(1, ncells))
    return int(min(1024, max(_CI_CAP, 8 * -(-2 * occ // 8))))


def _completion_cap(n: int, cap: int = 0) -> int:
    """Budget of crowded-cell bodies the per-body completion pass takes:
    ``bhCompCap`` when set, else ~n/16."""
    if cap:
        return min(n, cap)
    return min(n, max(1024, n // 16))


def resolve_near_kernel(near_kernel: str, near: str, device) -> bool:
    """The ``bhPallas`` knob: whether the slots engine goes through the
    kernel wrappers (B3, B4/B5). ``auto`` does on a CUDA device (on the
    CPU the wrappers would run their plain versions, which equal the plain
    engine); ``on`` always, and it is an error without a card; ``off``
    never."""
    if near_kernel not in ("auto", "on", "off"):
        raise ValueError(f"unknown bhPallas value {near_kernel!r}")
    if near != "slots" or near_kernel == "off":
        return False
    if torch.device(device).type == "cuda":
        return True
    if near_kernel == "on":
        raise ValueError(f"bhPallas=on needs the CUDA kernels; device "
                         f"{device} has none (use auto or off)")
    return False


def _over_slots(s_cell, starts, ncells: int, cap: int):
    """Sorted positions past their cell's first ``cap`` slots (the
    crowded-cell bodies the completion pass finishes)."""
    n = s_cell.shape[0]
    srank = (torch.arange(n, device=s_cell.device)
             - starts[torch.clamp(s_cell, 0, ncells - 1)])
    return (srank >= cap) & (s_cell < ncells)


def _channels(mode: str) -> tuple:
    """The accumulator fields a collision mode fills (the rest keep the
    identity, and may share its storage)."""
    return ("force",) + {"reference": ("gained_mass", "gained_radius",
                                       "died"),
                         "momentum": ("best_mass", "parent"),
                         "elastic": ("dv",)}.get(mode, ())


def _completion_list(over, n: int, comp_cap: int, comp_range=None):
    """nbodyax's ``_completion_slice``: the sorted positions of the
    crowded bodies in order, in a list of the static length
    ``_completion_cap``, the rest filled with ``n``. Bodies past the budget
    are dropped (``bh_health`` counts them). ``comp_range`` (base, length,
    total): the slice [base, base + length) of a list of length total."""
    if comp_range is None:
        return torch.nonzero_static(over, size=_completion_cap(n, comp_cap),
                                    fill_value=n)[:, 0]
    base, length, total = comp_range
    return torch.nonzero_static(over, size=total,
                                fill_value=n)[base:base + length, 0]


def _completion_rows(order, psx, n: int):
    """(body index, row written) of completion-list entries ``psx``: a
    fill entry ``n`` reads a real body and writes the discarded row n
    (nbodyax's ``osidx``)."""
    gi = order[torch.clamp(psx, max=n - 1)]
    return gi, torch.where(psx < n, gi, n)


class _Tiers:
    """nbodyax's ``_tiered`` over one completion list ``ps``: ``run(body)``
    calls ``body(psx)`` on nothing when ``ps`` holds no real entry, on its
    first ``_COMP_TIER`` entries when the real ones fit in them (they are
    a prefix), else on the whole list. The decision stays on the device,
    and every completion pass of a step shares it."""

    def __init__(self, ps, n: int):
        self.ps = ps
        real = (ps < n).sum()
        small = min(_COMP_TIER, ps.shape[0])
        self.tiers = [(small, (real > 0) & (real <= small))]
        if ps.shape[0] > small:
            self.tiers.append((ps.shape[0], real > small))

    def run(self, body) -> None:
        for size, pred in self.tiers:
            run_if(pred, lambda size=size: body(self.ps[:size]))


def _near_field(i_pos, i_vel, i_mass, i_radius, i_ids, pos, vel, mass,
                radius, ext, levels: int, ring: int, eps2, growth_rate,
                mode: str, k: int, chunk: int,
                _structure=None) -> PairAccumulators:
    """Exact accumulators of the i bodies against their (2 ring + 1)^dim
    finest-cell neighbours: one gathered window of up to ``k`` partners a
    neighbour ROW (its cells are contiguous in sorted order). Returns
    accumulators in i order."""
    dim = pos.shape[-1]
    n = pos.shape[0]
    g = 1 << levels
    need_vel = mode == "elastic"
    if _structure is None:
        _structure = _partner_structure(pos, vel, mass, radius, ext, g,
                                        need_vel)
    _, _, starts, ends, sf = _structure
    rest = 2 * dim if need_vel else dim
    ics = _cells(i_pos, ext, g)
    ks = torch.arange(k, device=pos.device)[None, :]
    i_ids = i_ids.to(torch.int64)
    parts = []
    for s in range(0, i_pos.shape[0], chunk):
        sl = slice(s, s + chunk)
        pi, vi, mi, ri, ii = (i_pos[sl], i_vel[sl], i_mass[sl],
                              i_radius[sl], i_ids[sl])
        ccs = [a[sl] for a in ics]
        acc = empty_accumulators(ii, dim=dim)
        left = torch.clamp(ccs[0] - ring, min=0)
        right = torch.clamp(ccs[0] + ring, max=g - 1)
        for off in itertools.product(range(-ring, ring + 1), repeat=dim - 1):
            nds = [ccs[1 + a] + off[a] for a in range(dim - 1)]
            ok_row = torch.ones_like(left, dtype=torch.bool)
            for nd in nds:
                ok_row = ok_row & (nd >= 0) & (nd < g)
            ndc = tuple(torch.clamp(nd, 0, g - 1) for nd in nds)
            st = starts[_flatten_cells((left,) + ndc, g)]
            cnt = torch.clamp(ends[_flatten_cells((right,) + ndc, g)] - st,
                              max=k)
            ok = ok_row[:, None] & (ks < cnt[:, None])
            fj = sf[torch.where(ok, st[:, None] + ks, n)]
            pj = fj[..., 0:dim]
            vj = fj[..., dim:2 * dim] if need_vel else torch.zeros_like(pj)
            jj = torch.where(ok, _unpack_id(fj[..., rest + 2],
                                            fj[..., rest + 3]), -1)
            acc = combine_accumulators(acc, _gathered_pair_accum(
                pi, vi, mi, ri, ii, pj, vj, fj[..., rest], fj[..., rest + 1],
                jj, eps2=eps2, growth_rate=growth_rate, mode=mode))
        parts.append(acc)
    return PairAccumulators(*(torch.cat(xs) for xs in zip(*parts)))


def _slot_unsort_idx(pos, mass, ext, g: int, order, starts, s_cell,
                     ncells: int, ci_cap: int, nslots: int, cell_range=None):
    """Body -> slot map for gathering per-slot results back into body
    order (slot = (cell - first cell of ``cell_range``) * ci_cap + rank):
    (valid, idx), idx = ``nslots`` (a pad row) where the body has no slot
    or its cell lies outside the range."""
    n = pos.shape[0]
    srank = (torch.arange(n, device=pos.device)
             - starts[torch.clamp(s_cell, 0, ncells - 1)])
    rank_b = torch.empty_like(srank)
    rank_b[order] = srank
    alive = mass > 0
    cellb = torch.where(alive, _flatten_cells(_cells(pos, ext, g), g),
                        torch.full_like(rank_b, ncells))
    c0, nc = _cell_slice(ncells, cell_range)
    rel = cellb - c0
    valid = alive & (rank_b >= 0) & (rank_b < ci_cap) & (rel >= 0) & (rel < nc)
    return valid, torch.where(valid, rel * ci_cap + rank_b,
                              torch.full_like(rank_b, nslots))


def _rows_engine(structure, ncells: int, g: int, ring: int, k: int,
                 ci_cap: int, chunk: int, dim: int, eps2, growth_rate,
                 mode: str, cell_range=None):
    """The per-cell ``rows`` engine: the first ci_cap bodies of each cell
    of ``cell_range`` (every cell for None) against up to ``k`` partners
    of each window row, gathered once a cell. Returns the packed channels
    [cells * ci_cap, 8] (``near_kernel`` layout)."""
    _, _, starts, ends, sf = structure
    n = sf.shape[0] - 1
    dev = sf.device
    need_vel = mode == "elastic"
    rest = 2 * dim if need_vel else dim
    L = sf.shape[1]
    c_first, nc = _cell_slice(ncells, cell_range)
    cc = max(1, min(nc, (2 * chunk) // ci_cap))
    cc = 1 << (cc.bit_length() - 1)
    B = cc * ci_cap
    ks = torch.arange(k, device=dev)[None, :]
    slots_i = torch.arange(ci_cap, device=dev)[None, :]
    out = []
    for base in range(c_first, c_first + nc, cc):
        cid = base + torch.arange(cc, device=dev)
        coords, rem = [], cid
        for _ in range(dim):
            coords.append(rem % g)
            rem = rem // g
        st_c = starts[cid]
        isl = st_c[:, None] + slots_i
        i_ok = isl < torch.minimum(ends[cid], st_c + ci_cap)[:, None]
        fi = sf[torch.where(i_ok, isl, n)].reshape(B, L)
        pi = fi[:, 0:dim]
        vi = fi[:, dim:2 * dim] if need_vel else torch.zeros_like(pi)
        mi, ri = fi[:, rest], fi[:, rest + 1]
        ii = _unpack_id(fi[:, rest + 2], fi[:, rest + 3])
        acc = empty_accumulators(ii, dim=dim)
        left = torch.clamp(coords[0] - ring, min=0)
        right = torch.clamp(coords[0] + ring, max=g - 1)
        for off in itertools.product(range(-ring, ring + 1), repeat=dim - 1):
            ok_row = torch.ones((cc,), dtype=torch.bool, device=dev)
            for a, o in enumerate(off):
                nd = coords[1 + a] + o
                ok_row = ok_row & (nd >= 0) & (nd < g)
            ndc = tuple(torch.clamp(coords[1 + a] + off[a], 0, g - 1)
                        for a in range(dim - 1))
            st = starts[_flatten_cells((left,) + ndc, g)]
            cnt = torch.clamp(ends[_flatten_cells((right,) + ndc, g)] - st,
                              max=k)
            ok = ok_row[:, None] & (ks < cnt[:, None])      # [cc, k]
            fj = sf[torch.where(ok, st[:, None] + ks, n)]   # [cc, k, L]
            fjE = fj[:, None].expand(cc, ci_cap, k, L).reshape(B, k, L)
            okE = ok[:, None].expand(cc, ci_cap, k).reshape(B, k)
            pj = fjE[..., 0:dim]
            vj = fjE[..., dim:2 * dim] if need_vel else torch.zeros_like(pj)
            acc = combine_accumulators(acc, _gathered_pair_accum(
                pi, vi, mi, ri, ii, pj, vj, fjE[..., rest] * okE,
                fjE[..., rest + 1],
                _unpack_id(fjE[..., rest + 2], fjE[..., rest + 3]),
                eps2=eps2, growth_rate=growth_rate, mode=mode))
        out.append(_lanes(acc, mode, dim))
    return torch.cat(out)


def _near_field_cells(pos, vel, mass, radius, ext, levels: int, ring: int,
                      eps2, growth_rate, mode: str, k: int,
                      ci_cap: int = _CI_CAP, chunk: int = 8192,
                      _structure=None, near: str = "rows",
                      comp_cap: int = 0, kernel: bool = False, _fslot=None,
                      far_slot_lanes=None, _completion=None,
                      cell_range=None, comp_range=None) -> PairAccumulators:
    """Near field of the FULL body set by per-CELL passes (nbodyax's
    ``_near_field_cells``): each cell's first ``ci_cap`` bodies through
    the ``rows`` engine (gathered row windows, ``k`` a row) or the
    ``slots`` engine (slices of the slot grid, S = max(k, ci_cap) a cell;
    B3 when ``kernel``), unsorted into body order; the rest of a crowded
    cell through the per-body completion pass (``_near_field``, windows of
    (2 ring + 1) S a row for slots, ``k`` for rows), up to the completion
    budget, under the tiers of ``_Tiers``. ``far_slot_lanes`` ([nslots,
    dim], per-slot far forces) rides the same unsort. ``_completion``: the
    caller's ``_Tiers``, so a step lists the crowded bodies once.
    ``cell_range`` (first cell, count) restricts the per-cell pass, and
    ``comp_range`` (``_completion_list``) the completion pass, to one
    shard's slices; the slot grid stays global, and every other body keeps
    the identity."""
    eps2 = float(np.float32(eps2))
    growth_rate = float(np.float32(growth_rate))
    use_slots = near == "slots"
    dim = pos.shape[-1]
    n = pos.shape[0]
    g = 1 << levels
    ncells = g ** dim
    structure = (_structure if _structure is not None else
                 _partner_structure(pos, vel, mass, radius, ext, g,
                                    mode == "elastic"))
    order, s_cell, starts, ends, sf = structure
    S = max(k, ci_cap)
    c_first, nc = _cell_slice(ncells, cell_range)
    nslots = nc * ci_cap
    kw = dict(mode=mode, eps2=eps2, growth=growth_rate, g=g, ring=ring,
              ci=ci_cap)
    if use_slots:
        fslot = _fslot if _fslot is not None else build_slot_grid_reference(
            sf, starts, ends, n, ncells, S)
        if cell_range is not None:
            kw.update(cell_base=c_first, ncells_eval=nc)
        raw = (slots_near if kernel else slots_near_reference)(
            fslot, dim=dim, **kw)
        packed = raw.reshape(nslots, -1)
    else:
        packed = _rows_engine(structure, ncells, g, ring, k, ci_cap, chunk,
                              dim, eps2, growth_rate, mode, cell_range)
    nlane = {"reference": dim + 3, "momentum": dim + 3,
             "elastic": 2 * dim}.get(mode, dim)
    packed = packed[:, :nlane]
    if far_slot_lanes is not None:
        packed = torch.cat([packed, far_slot_lanes], 1)
    packed = torch.cat([packed, packed.new_zeros((1, packed.shape[1]))])

    valid, slot_idx = _slot_unsort_idx(pos, mass, ext, g, order, starts,
                                       s_cell, ncells, ci_cap, nslots,
                                       cell_range)
    # one more row, n: the completion's fill entries write it, and it goes
    valid = F.pad(valid, (0, 1))
    slot_idx = F.pad(slot_idx, (0, 1), value=nslots)
    row = packed[slot_idx]
    ids = torch.arange(n + 1, dtype=torch.int32, device=pos.device)
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    force = row[:, 0:dim]
    if far_slot_lanes is not None:
        force = force + row[:, -dim:]
    out = empty_accumulators(ids, dim=dim)._replace(
        force=torch.where(valid[:, None], force, zero))
    if mode == "reference":
        out = out._replace(
            gained_mass=torch.where(valid, row[:, dim], zero),
            gained_radius=torch.where(valid, row[:, dim + 1], zero),
            died=valid & (row[:, dim + 2] > 0.5))
    elif mode == "momentum":
        out = out._replace(
            best_mass=torch.where(valid, row[:, dim], -torch.inf),
            parent=torch.where(valid, _unpack_id(row[:, dim + 1],
                                                 row[:, dim + 2]),
                               ids).to(torch.int32))
    elif mode == "elastic":
        out = out._replace(dv=torch.where(valid[:, None],
                                          row[:, dim:2 * dim], zero))

    if _completion is None:
        _completion = _Tiers(_completion_list(
            _over_slots(s_cell, starts, ncells, ci_cap), n, comp_cap,
            comp_range), n)
    row_k = (2 * ring + 1) * S if use_slots else k

    def complete(psx):
        gi, osidx = _completion_rows(order, psx, n)
        oacc = _near_field(pos[gi], vel[gi], mass[gi], radius[gi], gi, pos,
                           vel, mass, radius, ext, levels, ring, eps2,
                           growth_rate, mode, row_k, min(psx.shape[0], chunk),
                           _structure=structure)
        for name in _channels(mode):
            o = getattr(out, name)
            o.index_put_((osidx,), getattr(oacc, name).to(o.dtype))

    _completion.run(complete)
    return PairAccumulators(*(o[:n] for o in out))


def _giant_key(mass, radius, ext, levels: int, ring: int):
    """Radius of each live body beyond half a ring of the finest cell (the
    giant-pass candidates), -1 elsewhere."""
    _, csz = _cell_sizes(ext, 1 << levels)
    cell_min = csz[0]
    for s in csz[1:]:
        cell_min = torch.minimum(cell_min, s)
    thr = 0.5 * ring * cell_min
    return torch.where((mass > 0) & (radius > thr), radius, -1.0)


def giant_collision_accumulators(pos, vel, mass, radius, *, ext, levels: int,
                                 ring: int, growth_rate, mode: str,
                                 n_giants: int, chunk: int = 16384,
                                 cell_range=None) -> PairAccumulators:
    """Exact COLLISION channels (no gravity) for the ``n_giants``
    largest-radius live bodies among those with radius > ring * cell / 2,
    against every body, over the pairs the near window does NOT cover
    (finest-cell Chebyshev distance > ring): pass 1 gives every body its
    channels from the giants, pass 2 each giant its channels from the
    non-giant bodies. Returns full-length accumulators (identity rows for
    untouched bodies). See ``_giant_pass`` for the list and its tiers.
    ``cell_range`` (first cell, count) keeps only the rows of bodies whose
    finest cell lies in it: the giant set stays global, so a body in the
    range is still eaten by a giant outside it, whose own row belongs to
    its cell's shard."""
    ids = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    out = PairAccumulators(*(t.clone() for t in empty_accumulators(
        ids, dim=pos.shape[-1])))
    _giant_pass(pos, vel, mass, radius, ext=ext, levels=levels, ring=ring,
                growth_rate=growth_rate, mode=mode, n_giants=n_giants,
                chunk=chunk, into=out, cell_range=cell_range)
    return out


def _giant_pass(pos, vel, mass, radius, *, ext, levels: int, ring: int,
                growth_rate, mode: str, n_giants: int, chunk: int,
                into: PairAccumulators, cell_range=None) -> None:
    """Combine the giant-collision channels into ``into``, in place.

    The giant list is nbodyax's: the top ``B = min(n, max(8, n_giants))``
    keys in ``lax.top_k`` order (largest radius first, ties to the lower
    index, from a stable sort), the entries that do not qualify masked to
    mass 0, which adds nothing. Unlike nbodyax, B is clamped to n, so
    n < 8 works. The pass runs under tiers on the number of qualifying
    bodies: nothing when none qualifies, the first ``_GIANT_TIER`` entries
    when they fit, else all B, so a run with a handful of giants does not
    test every body against B of them."""
    n = pos.shape[0]
    key = _giant_key(mass, radius, ext, levels, ring)
    qualified = (key > 0).sum()
    B = min(n, max(8, n_giants))
    lo = 0
    for t in [t for t in (_GIANT_TIER,) if t < B] + [B]:
        pred = (qualified > lo) & (qualified <= t) if t < B else (
            qualified > lo)
        run_if(pred, lambda t=t: _giant_tier(
            pos, vel, mass, radius, key, t, ext=ext, levels=levels,
            ring=ring, growth_rate=growth_rate, mode=mode, chunk=chunk,
            into=into, cell_range=cell_range))
        lo = t


def _giant_list(key, count: int):
    """The top ``count`` entries of ``key`` in ``lax.top_k`` order (largest
    first, ties to the lower index) and the mask of those that qualify
    (key > 0)."""
    topi = torch.sort(-key, stable=True).indices[:count]
    return topi, key[topi] > 0


def _giant_tier(pos, vel, mass, radius, key, count: int, *, ext,
                levels: int, ring: int, growth_rate, mode: str, chunk: int,
                into: PairAccumulators, cell_range=None) -> None:
    """One tier of ``_giant_pass``: the top ``count`` list. Under a
    ``cell_range`` only the rows of its bodies are written: pass 1 masks
    the other rows' pairs, pass 2 the giants outside it."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    dev = pos.device
    g = 1 << levels
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    topi, gmask = _giant_list(key, count)
    pg, vg, rg = pos[topi], vel[topi], radius[topi]
    mg = torch.where(gmask, mass[topi], 0.0)   # masked: dead, no pairs
    gids = topi.to(torch.int32)
    cells = torch.stack(_cells(pos, ext, g), -1)
    gcells = cells[topi]
    is_giant = torch.zeros((n + 1,), dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(gmask, topi, n), True)[:n]
    owned = None
    if cell_range is not None:
        flat = _flatten_cells(tuple(cells[:, d] for d in range(dim)), g)
        owned = (flat >= cell_range[0]) & (flat < cell_range[0]
                                           + cell_range[1])
        gmask = gmask & owned[topi]
    safe = torch.where(gmask, topi, n)         # masked rows go to row n
    gr = float(np.float32(growth_rate))
    c = max(8, min(n, chunk))
    # pass 1's rows are independent: chunks of about 2^22 pairs
    c1 = max(c, min(n, (1 << 22) // count))

    def uncovered(ci, cj):
        return (ci[:, None, :] - cj[None, :, :]).abs().amax(-1) > ring

    def pass1_mask(s):
        pm = uncovered(cells[s:s + c1], gcells)
        return pm if owned is None else pm & owned[s:s + c1, None]

    kw = dict(eps2=0.0, growth_rate=gr, mode=mode, with_force=False)
    acc1 = [pair_accumulators_chunk(
        pos[s:s + c1], vel[s:s + c1], mass[s:s + c1], radius[s:s + c1],
        ids[s:s + c1], pg, vg, mg, rg, gids, pair_mask=pass1_mask(s), **kw)
        for s in range(0, n, c1)]
    acc1 = PairAccumulators(*(torch.cat(xs) for xs in zip(*acc1)))
    # pass 2's giants: the ones whose rows this call writes
    mg2 = mg if owned is None else torch.where(gmask, mg, 0.0)
    acc2 = None
    for s in range(0, n, c):
        pm = uncovered(gcells, cells[s:s + c]) & ~is_giant[s:s + c][None, :]
        part = pair_accumulators_chunk(
            pg, vg, mg2, rg, gids, pos[s:s + c], vel[s:s + c], mass[s:s + c],
            radius[s:s + c], ids[s:s + c], pair_mask=pm, **kw)
        acc2 = part if acc2 is None else combine_accumulators(acc2, part)
    full2 = empty_accumulators(
        torch.arange(n + 1, dtype=torch.int32, device=dev), dim=dim)
    full2 = PairAccumulators(*(f.index_put((safe,), v)[:n]
                               for f, v in zip(full2, acc2)))
    new = combine_accumulators(into, combine_accumulators(acc1, full2))
    for o, v in zip(into, new):
        o.copy_(v)


def _bh_cells_eval(pos, vel, mass, radius, *, eps2, growth_rate, mode: str,
                   levels: int, ring: int, neighbor_k: int, order: int,
                   chunk: int, ci_cap: int = 0, far: str = "fmm",
                   near: str = "rows", comp_cap: int = 0,
                   kernel: bool = False, annulus_kernel: bool = False,
                   n_giants: int = 0, shard: int = 0,
                   nshards: int = 1) -> PairAccumulators:
    """Near + far per-cell evaluation over the full body set, or with
    ``nshards`` > 1 over shard ``shard``'s contiguous 1/nshards slice of
    the finest cells and its 1/nshards of the completion list: each body's
    accumulators then come whole from the one shard that owns its cell (or
    its completion entry), and every other body keeps the identity.
    ``kernel`` routes the slots engine through B3 and B5 (B4 when no
    moments are wanted), ``annulus_kernel`` the annulus through its
    kernel."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    alive = mass > 0
    ext = _extent(pos, alive)
    g = 1 << levels
    ncells = g ** dim
    cell_range = comp_range = None
    if nshards > 1:
        if ncells % nshards:
            raise ValueError(
                f"shards ({nshards}) must divide the finest grid's {ncells} "
                f"cells: use a power-of-two shard count or raise bhLevels")
        comp_len = -(-_completion_cap(n, comp_cap) // nshards)
        cell_range = (shard * (ncells // nshards), ncells // nshards)
        comp_range = (shard * comp_len, comp_len, comp_len * nshards)
    c0, nc = _cell_slice(ncells, cell_range)
    structure = _partner_structure(pos, vel, mass, radius, ext, g,
                                   mode == "elastic")
    order_idx, s_cell, starts, ends, sf = structure
    c = min(chunk, n)
    cap = ci_cap or slot_cap(n, ncells)
    over = _over_slots(s_cell, starts, ncells, cap)
    tiers = _Tiers(_completion_list(over, n, comp_cap, comp_range), n)

    S_full = max(neighbor_k, cap)
    fslot = finest_mom = None
    if near == "slots":
        if kernel and (far == "fmm" or order >= 2):
            fslot, finest_mom = pack_slots(sf, starts, ends, S_full,
                                           moments=(pos, mass, ext, levels))
        elif kernel:
            fslot = pack_slots(sf, starts, ends, S_full)
        else:
            fslot = build_slot_grid_reference(sf, starts, ends, n, ncells,
                                              S_full)

    far_slot_lanes = None
    if far == "fmm":
        # hybrid FMM: expansions at ring + 1, the ring < |delta| <= ring + 1
        # finest shell at exact targets (always quadrupole)
        grids = _level_grids(pos, mass, ext, levels, order=2,
                             finest=finest_mom)
        packed_finest = torch.stack(grids[levels], 1)
        local_tab = _fmm_local_table(pos, mass, ext, levels, ring + 1, eps2,
                                     order, grids=grids)
        annulus = annulus_cells if annulus_kernel else _annulus_force_cells
        aslots, _ = annulus(packed_finest, ext, levels, ring, ring + 1, eps2,
                            2, structure, cap, fslot=fslot,
                            cell_range=cell_range)
        if near == "slots":
            l2p_sl = _l2p_slots(local_tab[c0:c0 + nc],
                                fslot[c0:c0 + nc, :cap, 0:dim], ext, levels,
                                dim, cell0=c0)
            far_slot_lanes = l2p_sl.reshape(nc * cap, dim) + aslots

    near_acc = _near_field_cells(
        pos, vel, mass, radius, ext, levels, ring, eps2, growth_rate, mode,
        neighbor_k, ci_cap=cap, chunk=c, _structure=structure, near=near,
        comp_cap=comp_cap, kernel=kernel, _fslot=fslot,
        far_slot_lanes=far_slot_lanes, _completion=tiers,
        cell_range=cell_range)

    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    if far == "fmm":
        if far_slot_lanes is not None:
            far_v = torch.zeros((n + 1, dim), dtype=torch.float32,
                                device=pos.device)
        else:
            far_all = _l2p(local_tab, pos, ext, levels, dim)
            over_body = torch.zeros((n,), dtype=torch.bool, device=pos.device)
            over_body[order_idx] = over
            keep = alive & ~over_body
            if cell_range is not None:
                # dead bodies sit in bucket ncells, outside every range
                cell = torch.where(alive, _flatten_cells(_cells(pos, ext, g),
                                                         g), ncells)
                keep = keep & (cell >= c0) & (cell < c0 + nc)
            a_valid, a_idx = _slot_unsort_idx(pos, mass, ext, g, order_idx,
                                              starts, s_cell, ncells, cap,
                                              aslots.shape[0], cell_range)
            a_pad = torch.cat([aslots, aslots.new_zeros((1, dim))])
            far_v = F.pad(torch.where(a_valid[:, None], a_pad[a_idx], zero)
                          + torch.where(keep[:, None], far_all, zero),
                          (0, 0, 0, 1))

        def complete(psx):
            # crowded-cell bodies take their whole far field here
            gi, osidx = _completion_rows(order_idx, psx, n)
            far_v.index_put_((osidx,), _annulus_force_bodies(
                pos[gi], packed_finest, ext, levels, ring, ring + 1, eps2, 2)
                + _l2p(local_tab, pos[gi], ext, levels, dim))
    else:
        d_grids = _level_grids(pos, mass, ext, levels, order,
                               finest=finest_mom if order >= 2 else None)
        fslots, fsidx = _far_force_cells(pos, mass, ext, levels, ring, eps2,
                                         order, structure, cap,
                                         grids=d_grids, fslot=fslot,
                                         cell_range=cell_range)
        far_v = torch.zeros((n + 1, dim), dtype=torch.float32,
                            device=pos.device)
        far_v[fsidx] = fslots

        def complete(psx):
            gi, osidx = _completion_rows(order_idx, psx, n)
            far_v.index_put_((osidx,), _far_force(
                pos[gi], pos, mass, ext, levels, ring, eps2, order,
                grids=d_grids))

    tiers.run(complete)
    ids = torch.arange(n, dtype=torch.int32, device=pos.device)
    far_acc = empty_accumulators(ids, dim=dim)._replace(
        force=torch.where(alive[:, None], far_v[:n], zero))
    out = combine_accumulators(near_acc, far_acc)
    if n_giants and mode != "none":
        _giant_pass(pos, vel, mass, radius, ext=ext, levels=levels,
                    ring=ring, growth_rate=growth_rate, mode=mode,
                    n_giants=n_giants, chunk=max(chunk, 4096), into=out,
                    cell_range=cell_range)
    return out


def bh_accumulators(pos, vel, mass, radius, *, eps: float = 0.0,
                    growth_rate: float = 0.1, mode: str = "reference",
                    levels: int = 0, ring: int = 1, neighbor_k: int = 64,
                    order: int = 2, chunk: int = 8192, ci_cap: int = 0,
                    far: str = "fmm", near: str = "rows", comp_cap: int = 0,
                    near_kernel: str = "auto", n_giants: int = 1024,
                    shard: int = 0, nshards: int = 1) -> PairAccumulators:
    """Drop-in accum_fn (the interface of ``pair_accumulators``):
    approximate far-field force, exact near-field force and collision
    channels, and exact any-distance collisions for the ``n_giants``
    largest-radius bodies (0 disables). ``near_kernel`` is the
    ``bhPallas`` knob (``resolve_near_kernel``; the annulus kernel on a
    CUDA tensor unless ``"off"``); ``shard`` and ``nshards``
    are ``bh_cellrange_accumulators``'s. Forward-only, as nbodyax's bh
    step (nbodyax/autodiff.py): under autograd it raises
    ``NotImplementedError`` (its kernels have no backward, so a gradient
    would lack the near field's part)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (pos, vel, mass, radius)):
        raise NotImplementedError(
            "forceModel=bh is forward-only: differentiate the exact "
            "step (forceModel=exact)")
    if far not in ("fmm", "direct"):
        raise ValueError(f"unknown bhFar value {far!r}")
    if near not in ("rows", "slots"):
        raise ValueError(f"bhNear must be resolved to rows or slots, got "
                         f"{near!r}")
    dim = pos.shape[-1]
    n = pos.shape[0]
    levels = levels or auto_levels(n, dim=dim)
    neighbor_k = neighbor_k or auto_neighbor_k(n, levels, ring, dim, near)
    eps32 = np.float32(eps)
    return _bh_cells_eval(
        pos, vel, mass, radius, eps2=float(eps32 * eps32),
        growth_rate=float(np.float32(growth_rate)), mode=mode, levels=levels,
        ring=ring, neighbor_k=neighbor_k, order=order, chunk=chunk,
        ci_cap=ci_cap, far=far, near=near, comp_cap=comp_cap,
        kernel=resolve_near_kernel(near_kernel, near, pos.device),
        annulus_kernel=(near_kernel != "off"
                        and torch.device(pos.device).type == "cuda"),
        n_giants=n_giants, shard=shard, nshards=nshards)


def bh_cellrange_accumulators(pos, vel, mass, radius, shard: int,
                              nshards: int, **kw) -> PairAccumulators:
    """One cell-range shard's part of the global accumulators: full-length
    accumulators that hold real values only for the bodies whose finest
    cell lies in shard ``shard``'s contiguous 1/nshards slice of the cells
    (or whose completion entry lies in its slice of that list), and the
    identity elsewhere. Every shard calls it on the same all-gathered state
    with its own index; the slices are disjoint, so the shards' parts sum
    once every lane is rebased to identity 0 (``sharding/bh.py``). ``kw``
    are ``bh_accumulators``'s knobs. Raises ``ValueError`` when nshards
    does not divide the cells."""
    return bh_accumulators(pos, vel, mass, radius, shard=shard,
                           nshards=nshards, **kw)


# ---------------------------------------------------------------------------
# Diagnostics (barneshut.py:2392-2518) and the knob probe (148-260)
# ---------------------------------------------------------------------------

def _occupancy(pos, mass, levels: int, ring: int, near: str,
               comp_cap: int = 0):
    """(occupancy of each cap unit: a cell for slots, a (2 ring + 1)-cell
    window row for rows; bodies past the per-cell slot_cap; bodies past
    the completion budget as well)."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    g = 1 << levels
    alive = mass > 0
    ext = _extent(pos, alive)
    cell = torch.where(alive, _flatten_cells(_cells(pos, ext, g), g),
                       torch.full((n,), g ** dim, dtype=torch.int64,
                                  device=pos.device))
    occ = torch.zeros((g ** dim + 1,), dtype=torch.int64,
                      device=pos.device).scatter_add_(
        0, cell, torch.ones_like(cell))
    if near == "slots":
        unit = occ[:-1]
    else:
        occp = F.pad(occ[:-1].reshape((g,) * dim), (ring, ring))
        unit = sum(occp[..., d:d + g] for d in range(2 * ring + 1))
    i_over = torch.clamp(occ[:-1] - slot_cap(n, g ** dim), min=0).sum()
    dropped = torch.clamp(i_over - _completion_cap(n, comp_cap), min=0)
    return unit, i_over, dropped


def _overflow_terms(pos, mass, *, levels: int, neighbor_k: int, ring: int,
                    near: str, comp_cap: int = 0):
    """(partner-cap overflow, completion-budget overflow) as 0-d tensors."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    levels = levels or auto_levels(n, dim=dim)
    neighbor_k = neighbor_k or auto_neighbor_k(n, levels, ring, dim, near)
    unit, _, dropped = _occupancy(pos, mass, levels, ring, near, comp_cap)
    if near == "slots":
        neighbor_k = max(neighbor_k, slot_cap(n, (1 << levels) ** dim))
    return torch.clamp(unit - neighbor_k, min=0).sum(), dropped


def overflow_count(pos, mass, *, levels: int = 0, neighbor_k: int = 0,
                   ring: int = 1, near: str = "rows", comp_cap: int = 0):
    """Live bodies invisible to some part of the near field (partner-cap
    overflow plus completion-budget overflow); 0 means the near field is
    exact for this state. A 0-d int64 tensor on the state's device."""
    k_over, dropped = _overflow_terms(pos, mass, levels=levels,
                                      neighbor_k=neighbor_k, ring=ring,
                                      near=near, comp_cap=comp_cap)
    return k_over + dropped


def needed_neighbor_k(pos, mass, *, levels: int, ring: int = 1,
                      near: str = "rows", comp_cap: int = 0):
    """int64[3]: smallest partner cap with zero overflow, completion-
    budget drop, completion-pass population."""
    unit, i_over, dropped = _occupancy(pos, mass, levels, ring, near,
                                       comp_cap)
    return torch.stack([unit.max(), dropped, i_over])


def bh_health(pos, mass, radius, *, levels: int, neighbor_k: int = 0,
              ring: int = 1, near: str = "rows", comp_cap: int = 0,
              n_giants: int = 0):
    """f32[7] health vector the driver reads at each log point: partner-
    cap overflow, completion-budget overflow, max live radius, min extent
    span, minimal exact partner cap, completion-pass population, giant-list
    excess."""
    alive = mass > 0
    k_over, dropped = _overflow_terms(pos, mass, levels=levels,
                                      neighbor_k=neighbor_k, ring=ring,
                                      near=near, comp_cap=comp_cap)
    unit, i_over, _ = _occupancy(pos, mass, levels, ring, near, comp_cap)
    rmax = torch.where(alive, radius, 0.0).max()
    _, spans = _extent(pos, alive)
    span_min = spans[0]
    for s in spans[1:]:
        span_min = torch.minimum(span_min, s)
    thr = 0.5 * ring * span_min / (1 << levels)
    giant_excess = torch.clamp((alive & (radius > thr)).sum() - n_giants,
                               min=0)
    return torch.stack([x.to(torch.float32) for x in (
        k_over, dropped, rmax, span_min, unit.max(), i_over, giant_excess)])


def pick_levels(pos, mass, *, neighbor_k: int = 0, ring: int = 1,
                max_levels: int = 10, tolerance: float = 0.01,
                near: str = "auto", levels: int = 0,
                prefer_slots=None) -> tuple:
    """Density-aware (levels, near, k, comp_cap) from a state, as nbodyax's
    ``pick_levels``: the engine whose overflow fits ``tolerance`` at the
    uniform-density level (slots first when ``prefer_slots``), refinement
    while it does not, then a count-aware exact partner cap and a
    completion budget sized to the measured population. ``prefer_slots``
    defaults to "n >= 1.5M, or the kernel engine is on" (a CUDA state:
    ``bhPallas=auto`` there runs B3). Every probe is a host read."""
    n = pos.shape[0]
    dim = pos.shape[-1]
    lv = levels or auto_levels(n, max_levels=max_levels, dim=dim)
    cap = lv if levels else (min(max_levels, 7) if dim == 3 else max_levels)
    probed = {}

    def ov_at(lv, eng):
        if (lv, eng) not in probed:
            k = neighbor_k or auto_neighbor_k(n, lv, ring, dim, eng)
            probed[lv, eng] = int(overflow_count(
                pos, mass, levels=lv, neighbor_k=k, ring=ring, near=eng))
        return probed[lv, eng]

    def exact_k(lv, eng):
        k_auto = auto_neighbor_k(n, lv, ring, dim, eng)
        k_need, dropped, i_over = needed_neighbor_k(
            pos, mass, levels=lv, ring=ring, near=eng).tolist()
        return max(k_auto, 8 * -(-k_need // 8)), dropped, k_auto, i_over

    if prefer_slots is None:
        prefer_slots = n >= _SLOTS_PREFERRED_N or pos.device.type == "cuda"
    if near == "auto":
        for eng in (("slots", "rows") if prefer_slots else ("rows", "slots")):
            if ov_at(lv, eng) <= n * tolerance:
                near = eng
                break
        else:
            near = "slots"
    while lv < cap and ov_at(lv, near) > n * tolerance:
        lv += 1
    if neighbor_k:
        return lv, near, neighbor_k, 0
    while True:
        k, dropped, k_auto, i_over = exact_k(lv, near)
        if lv >= cap or (k <= min(1024, 4 * k_auto) and dropped == 0):
            break
        lv += 1
    comp = 0
    pad = min(n, 1024 * -(-(i_over + i_over // 8) // 1024))
    if dropped or _COMP_TIER < pad < _completion_cap(n):
        comp = pad
    return lv, near, min(1024, k), comp
