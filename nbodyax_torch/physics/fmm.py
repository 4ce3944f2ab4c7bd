"""Far field of ``forceModel=bh``: per-level moment grids, the uniform-grid
FMM with its exact-target annulus, and the gathered direct engine.

Counterpart of the far-field half of ``nbodyax/physics/barneshut.py``:
``_level_grids``, ``_far_window_force``, the FMM (``_fmm_offsets`` ...
``_fmm_local_table``), the annulus (``_annulus_offsets``,
``_annulus_force_cells``, ``_annulus_force_bodies``) and ``bhFar=direct``
(``_far_force``, ``_far_force_cells``). None of this ran in a Pallas
kernel; it is plain torch on any device. The bh step reaches
``_annulus_force_cells`` through ``annulus_kernel.annulus_cells`` (a CUDA
kernel on a card, this plain version on the CPU), and directly under
``bhPallas=off``.

Precision: the M2L convolution (``conv2d``, or ``conv3d`` for an octree)
runs in full fp32 (nbodyax asks XLA for ``Precision.HIGHEST``). cuDNN's
float32 convolutions default to TF32, which keeps about three decimal
digits and gave a 7.2% far-force error on the TPU, so ``_m2l_level_conv``
turns TF32 off around its call (``_no_tf32``: cuDNN's switch and the
matrix-product one, which a convolution lowered to a product would read).
The moment grids and expansions are sums and products of float32 tensors,
never matrix products.

Cell-chunked passes of nbodyax (``lax.map`` over cell blocks) become one
pass over all cells, looping over the static window offsets instead: each
iteration is a handful of whole-grid elementwise ops, so a step launches
tens of kernels a level, not thousands. The annulus batches every shell
offset at once and is cut into cell chunks only where its
[cells, slots, offsets] temporaries would pass ``_ANNULUS_ELEMS``
elements: the 98 offsets of a 3-D shell, against 16 in 2-D.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from nbodyax_torch.physics.bh_grid import (_cell_sizes, _cells,
                                           _flatten_cells, _moment_pairs,
                                           _pool, _unpack_id)
from nbodyax_torch.physics.slotpack_kernel import finest_moments_reference

__all__ = ["_level_grids", "_far_window_force", "_fmm_offsets",
           "_m2l_weights", "_m2l_level_conv", "_l2l", "_l2p", "_l2p_slots",
           "_fmm_local_table", "_annulus_offsets", "_annulus_force_cells",
           "_annulus_force_bodies", "_far_force", "_far_force_cells"]


_CONSTS = {}
# most elements of one [cells, slots, shell offsets] temporary of the
# annulus (128 MiB of float32); the 2-D million-body step fits in one pass
_ANNULUS_ELEMS = 1 << 25


@contextlib.contextmanager
def _no_tf32():
    """Full-fp32 convolutions inside: cuDNN's TF32 off, and the
    matrix-product TF32 switch off too for the time of the call."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _const(key, device, make):
    """A constant tensor (or tuple of them) copied to ``device`` once:
    ``make()`` builds it on the host. A host-to-device copy of pageable
    memory in the step would wait for the stream each time."""
    key = key + (str(device),)
    if key not in _CONSTS:
        val = make()
        _CONSTS[key] = (tuple(v.to(device) for v in val)
                        if isinstance(val, tuple) else val.to(device))
    return _CONSTS[key]


def _iota_axes(ncells: int, s: int, dim: int, device):
    """Per-axis coordinates of the flat cells of a grid of side s."""
    iota = torch.arange(ncells, device=device)
    return [(iota // (s ** d)) % s for d in range(dim)]


def _level_grids(pos, mass, ext, levels: int, order: int = 1, finest=None):
    """Per-level cell aggregates {level: tuple of f32[s^dim] channels}.

    order=1: (M, S_0..S_{D-1}) about the origin. order=2: moments about
    each cell's centre, pooled with parallel-axis shifts (r' = r - delta):
    S_a' = S_a - M d_a, S_ab' = S_ab - d_a S_b - d_b S_a + M d_a d_b.
    ``finest`` (order 2): precomputed [ncells, NM] finest moments (the
    slot-pack kernel's second output) in place of the scatter."""
    dim = pos.shape[-1]
    g = 1 << levels
    ncells = g ** dim
    if order < 2:
        chans = [mass] + [mass * pos[:, d] for d in range(dim)]
        flat = _flatten_cells(_cells(pos, ext, g), g)
        big = torch.zeros((ncells, len(chans)), dtype=torch.float32,
                          device=pos.device).index_add_(
            0, flat, torch.stack(chans, 1))
        grids = {levels: tuple(big[:, i] for i in range(len(chans)))}
        for lv in range(levels - 1, 1, -1):
            s = 1 << (lv + 1)
            grids[lv] = tuple(_pool(a, s, dim) for a in grids[lv + 1])
        return grids

    pairs = _moment_pairs(dim)
    if finest is None:
        finest = finest_moments_reference(pos, mass, ext, levels)
    grids = {levels: tuple(finest[:, i] for i in range(finest.shape[1]))}
    for lv in range(levels - 1, 1, -1):
        s = 1 << (lv + 1)                    # child grid side
        M = grids[lv + 1][0]
        S1 = list(grids[lv + 1][1:1 + dim])
        S2 = list(grids[lv + 1][1 + dim:])
        _, ccsz = _cell_sizes(ext, s)
        par = [c & 1 for c in _iota_axes(s ** dim, s, dim, pos.device)]
        delta = [torch.where(par[d] == 0, 0.5 * ccsz[d], -0.5 * ccsz[d])
                 for d in range(dim)]
        S2n = [S2[k] - delta[a] * S1[b] - delta[b] * S1[a]
               + M * delta[a] * delta[b] for k, (a, b) in enumerate(pairs)]
        S1n = [S1[d] - M * delta[d] for d in range(dim)]
        grids[lv] = tuple(_pool(a, s, dim) for a in [M] + S1n + S2n)
    return grids


def _far_window_force(pxs, ws, use, cellrow, ext, g: int, eps2, order: int):
    """Monopole (+ quadrupole) force of interaction-list cells on targets,
    broadcast-generic as in nbodyax: ``pxs`` per-axis target coordinates,
    ``ws`` per-axis cell indices, ``use`` the membership mask, ``cellrow``
    the cell aggregates with a trailing channel axis. Returns per-axis
    force arrays; the caller reduces over the window axis.

    order 2 adds F_quad = 1/2 [-3 r^-5 (2 Q d + d tr Q) + 15 r^-7 (d^T Q d) d]
    with d = COM - p and central moments Q (channels masked before any
    product, and scaled by r^-5 before contracting, to stay finite in
    f32 at field scale)."""
    dim = len(pxs)
    zero = torch.zeros((), dtype=torch.float32, device=cellrow.device)
    one = torch.ones((), dtype=torch.float32, device=cellrow.device)
    M = torch.where(use, cellrow[..., 0], zero)
    has = M > 0
    Minv = 1.0 / torch.where(has, M, one)
    if order >= 2:
        mins, csz = _cell_sizes(ext, g)
        com = [mins[d] + (ws[d].to(torch.float32) + 0.5) * csz[d]
               + cellrow[..., 1 + d] * Minv for d in range(dim)]
    else:
        com = [cellrow[..., 1 + d] * Minv for d in range(dim)]
    dv = [torch.where(has, com[d] - pxs[d], zero) for d in range(dim)]
    d2 = dv[0] * dv[0]
    for c2 in dv[1:]:
        d2 = d2 + c2 * c2
    d2 = d2 + eps2
    inv = torch.rsqrt(torch.where(has, d2, one))
    inv2 = inv * inv
    inv3 = inv2 * inv
    wgt = torch.where(has, M * inv3, zero)
    f = [wgt * dv[d] for d in range(dim)]
    if order >= 2:
        s1 = [torch.where(use, cellrow[..., 1 + d], zero) for d in range(dim)]
        rb = [s1[d] * Minv for d in range(dim)]
        q = {}
        for k, (a, b) in enumerate(_moment_pairs(dim)):
            q[a, b] = (torch.where(use, cellrow[..., 1 + dim + k], zero)
                       - rb[a] * s1[b])
            q[b, a] = q[a, b]
        inv5 = inv3 * inv2
        u = [sum(q[a, b] * dv[b] for b in range(dim)) * inv5
             for a in range(dim)]
        trq5 = sum(q[a, a] for a in range(dim)) * inv5
        dqd7 = sum(dv[a] * u[a] for a in range(dim)) * inv2
        coef = torch.where(has, one, zero)
        f = [f[a] + coef * (-1.5 * (2.0 * u[a] + dv[a] * trq5)
                            + 7.5 * dqd7 * dv[a]) for a in range(dim)]
    return f


# ---------------------------------------------------------------------------
# The uniform-grid FMM (nbodyax/physics/barneshut.py:1342-1776)
# ---------------------------------------------------------------------------

def _fmm_offsets(ring: int, dim: int):
    """Interaction-list offsets: per-axis range [-(2r+1), 2r+1] minus the
    near block |delta| <= ring on every axis."""
    w = 2 * ring + 1
    return [d for d in itertools.product(range(-w, w + 1), repeat=dim)
            if not all(abs(x) <= ring for x in d)]


def _sym_tuples(dim: int, rank: int):
    return list(itertools.combinations_with_replacement(range(dim), rank))


def _fmm_layout(dim: int, degree: int):
    """Local-expansion channel map: fully symmetric blocks of rank
    1..degree+1. Returns (n_loc, {sorted index tuple: channel})."""
    idx, off = {}, 0
    for rank in range(1, degree + 2):
        for t in _sym_tuples(dim, rank):
            idx[t] = off
            off += 1
    return off, idx


def _pairings(idx):
    """Partitions of an index tuple into unordered pairs plus singles."""
    if not idx:
        yield (), ()
        return
    first, rest = idx[0], idx[1:]
    for pairs, singles in _pairings(rest):
        yield pairs, (first,) + singles
    for i in range(len(rest)):
        for pairs, singles in _pairings(rest[:i] + rest[i + 1:]):
            yield ((first, rest[i]),) + pairs, singles


_DFACT = [1, 3, 15, 105, 945, 10395, 135135]    # (2t+1)!!


def _deriv_entry(idx, ut, inv_pows, memo):
    """d^r K_i / du_j1..du_jr of K(u) = u / (|u|^2 + eps^2)^{3/2} by the
    pairing expansion, with ut = u * inv so every factor is O(1)."""
    key = tuple(sorted(idx))
    if key in memo:
        return memo[key]
    r = len(idx) - 1
    total = None
    for pairs, singles in _pairings(key):
        if any(a != b for a, b in pairs):
            continue
        t = r - len(pairs)
        term = float((-1.0) ** t * _DFACT[t])
        for s in singles:
            term = term * ut[s]
        total = term if total is None else total + term
    total = (0.0 if total is None else total) * inv_pows[r + 2]
    memo[key] = total
    return total


def _m2l_weights(deltas, csz, eps2, dim: int, order: int, degree: int):
    """W[..., noff, n_src, n_loc]: per-offset matrices taking a cell's
    source moments to its local-expansion contribution (every Taylor term
    of total order <= degree, source orders <= 2). ``deltas`` is a static
    [noff, dim] int array; ``csz`` a tuple of per-axis cell sizes, each a
    0-d tensor or a [nlev] tensor (then W gets a leading level axis)."""
    src = [((), 1.0)] + [((a,), 1.0) for a in range(dim)]
    if order >= 2:
        for a, b in _moment_pairs(dim):
            src.append(((a, b), (1.0 if a == b else 2.0) / 2.0))
    n_src = 1 + dim + len(_moment_pairs(dim))
    n_loc, lidx = _fmm_layout(dim, degree)
    dev = csz[0].device
    deltas = tuple(map(tuple, deltas))
    dl = _const(("deltas", deltas), dev,
                lambda: torch.tensor(deltas, dtype=torch.float32))
    u = torch.stack([dl[:, d] * csz[d][..., None] for d in range(dim)], -1)
    inv = torch.rsqrt((u * u).sum(-1) + eps2)
    ut = [u[..., d] * inv for d in range(dim)]
    inv_pows = {p: inv ** p for p in range(2, degree + 4)}
    memo = {}
    zero = torch.zeros_like(inv)
    W = [[zero for _ in range(n_loc)] for _ in range(n_src)]
    for I, ch in lidx.items():
        rho = len(I)
        sign = (-1.0) ** (rho - 1)
        for si, (A, wA) in enumerate(src):
            if (rho - 1) + len(A) > degree:
                continue
            W[si][ch] = W[si][ch] + (sign * wA) * _deriv_entry(
                I + A, ut, inv_pows, memo)
    return torch.stack([torch.stack(r, -1) for r in W], -2)


def _conv_kernel_index(ring: int, dim: int):
    """Static scatter lists that fold the per-offset weights into the
    parent-grid convolution kernel: (flat kernel offset, source parity,
    target parity, offset index) per allowed (delta, target parity)."""
    w = 2 * ring + 1
    ks = 2 * ring + 1
    kf, rf, pf, oi = [], [], [], []
    for i, d in enumerate(_fmm_offsets(ring, dim)):
        for p in itertools.product((0, 1), repeat=dim):
            if any((d[k] == -w and p[k] == 0) or (d[k] == w and p[k] == 1)
                   for k in range(dim)):
                continue
            q = [(d[k] + p[k]) >> 1 for k in range(dim)]
            r = [(d[k] + p[k]) & 1 for k in range(dim)]
            kf.append(sum((q[k] + ring) * ks ** k for k in range(dim)))
            rf.append(sum(r[k] << k for k in range(dim)))
            pf.append(sum(p[k] << k for k in range(dim)))
            oi.append(i)
    return torch.tensor([kf, rf, pf, oi])


def _m2l_level_conv(packed, s: int, ext, eps2, ring: int, dim: int,
                    order: int, degree: int, W=None):
    """One level's M2L as one convolution over the PARENT grid: each
    child's parity is folded into a channel, so the whole interaction list
    is a (2 ring + 1)^dim stencil with 2^dim n_src input and 2^dim n_loc
    output channels. ``packed`` is the level's [s^dim, n_src] source grid;
    returns [s^dim, n_loc]. Runs in true fp32 (TF32 off). ``W`` may pass
    the level's precomputed ``_m2l_weights``. 2-D (``conv2d``, 4 parity
    classes) or 3-D (``conv3d``, 8)."""
    if dim not in (2, 3):
        raise ValueError(f"the M2L convolution runs in 2 or 3 dimensions, "
                         f"got dim={dim}")
    nch = packed.shape[1]
    sp = s // 2
    ks = 2 * ring + 1
    if W is None:
        _, csz = _cell_sizes(ext, s)
        W = _m2l_weights(_fmm_offsets(ring, dim), csz, eps2, dim, order,
                         degree)
    n_loc = W.shape[-1]
    kf, rf, pf, oi = _const(("conv", ring, dim), packed.device,
                            lambda: _conv_kernel_index(ring, dim))
    kflat = torch.zeros((ks ** dim, 1 << dim, 1 << dim, nch, n_loc),
                        dtype=torch.float32, device=packed.device)
    kflat[kf, rf, pf] = W[oi]
    npar = 1 << dim
    sdims = tuple(range(dim))
    # [(kz,) ky, kx, r (in), p (out), nch, n_loc] -> conv weight
    # [out = (p, n_loc), in = (r, nch), (kz,) ky, kx]
    ker = kflat.reshape((ks,) * dim + (npar, npar, nch, n_loc)).permute(
        dim + 1, dim + 3, dim, dim + 2, *sdims)
    ker = ker.reshape((npar * n_loc, npar * nch) + (ks,) * dim)
    # fold children into parent channels, r = px + 2 py (+ 4 pz): the grid
    # as [(zp, pz,) yp, py, xp, px, ch] -> [(pz,) py, px, ch, (zp,) yp, xp]
    spat = packed.reshape((sp, 2) * dim + (nch,))
    folded = spat.permute(*(2 * a + 1 for a in sdims), 2 * dim,
                          *(2 * a for a in sdims))
    folded = folded.reshape((1, npar * nch) + (sp,) * dim)
    conv = F.conv3d if dim == 3 else F.conv2d
    with _no_tf32():
        out = conv(folded, ker, padding=ring)[0]   # [p*n_loc, (zp,) yp, xp]
    # [(pz,) py, px, loc, (zp,) yp, xp] -> [(zp, pz,) yp, py, xp, px, loc]
    out = out.reshape((2,) * dim + (n_loc,) + (sp,) * dim)
    perm = sum(((dim + 1 + a, a) for a in sdims), ()) + (dim,)
    return out.permute(*perm).reshape(s ** dim, n_loc)


def _shift_table(dim: int, degree: int, top_rank: int, device):
    """The Taylor shift of nbodyax's ``_shifted_block`` as constant tables:
    (exponents int64[M, dim], C f32[M, n_loc, n_out]) such that shifting an
    expansion ``up`` by y gives out[i] = sum_{m, j} up[j] C[m, j, i] y^e_m
    for the blocks of rank 1..``top_rank`` (``n_out`` columns in
    ``_sym_tuples`` order). One contraction then replaces a few hundred
    small elementwise ops."""
    def make():
        n_loc, lidx = _fmm_layout(dim, degree)
        expos = [tuple(K.count(d) for d in range(dim))
                 for m in range(degree + 1)
                 for K in itertools.combinations_with_replacement(
                     range(dim), m)]
        cols = [I for rank in range(1, top_rank + 1)
                for I in _sym_tuples(dim, rank)]
        C = np.zeros((len(expos), n_loc, len(cols)), np.float64)
        for ci, I in enumerate(cols):
            for m in range(0, degree + 2 - len(I)):
                for K in itertools.combinations_with_replacement(range(dim),
                                                                 m):
                    perms = math.factorial(m)
                    for v in set(K):
                        perms //= math.factorial(K.count(v))
                    e = expos.index(tuple(K.count(d) for d in range(dim)))
                    C[e, lidx[tuple(sorted(I + K))], ci] += (
                        perms / math.factorial(m))
        return (torch.tensor(expos, dtype=torch.int64),
                torch.tensor(C, dtype=torch.float32))
    return _const(("shift", dim, degree, top_rank), device, make)


def _monomials(y, expos, degree: int):
    """y^e for every exponent row: y [..., dim] -> [..., M]."""
    pw = [torch.ones_like(y), y]
    for _ in range(2, degree + 1):
        pw.append(pw[-1] * y)
    pw = torch.stack(pw, -2)                         # [..., degree+1, dim]
    out = None
    for d in range(y.shape[-1]):
        f = pw[..., expos[:, d], d]
        out = f if out is None else out * f
    return out


def _l2l(local, sp: int, dim: int, ext, degree: int):
    """Shift parent expansions (side sp) to their 2^dim children (side
    2 sp): child centre offset delta = (parity - 1/2) * child cell size,
    one shift matrix for each of the 2^dim parity classes."""
    expos, C = _shift_table(dim, degree, degree + 1, local.device)
    nl = local.shape[1]
    npar = 1 << dim
    _, ccsz = _cell_sizes(ext, 2 * sp)
    # delta of the parity classes p = px + 2 py (+ 4 pz)
    half = torch.stack([0.5 * ccsz[d] for d in range(dim)])
    sign = _const(("l2l_sign", dim), local.device, lambda: torch.tensor(
        [[1.0 if (p >> d) & 1 else -1.0 for d in range(dim)]
         for p in range(npar)]))
    mono = _monomials(sign * half, expos, degree)            # [npar, M]
    T = (mono[:, :, None, None] * C[None]).sum(1)            # [npar, nl, nl]
    # parents [(zp, 1,) yp, 1, xp, 1, nl, 1] x classes [(pz,) py, px, nl, nl]
    out = (local.reshape((sp, 1) * dim + (nl, 1))
           * T.reshape((1, 2) * dim + (nl, nl))).sum(-2)
    return out.reshape(npar * sp ** dim, nl)


def _l2p_table(local, dim: int, degree: int):
    """Per-cell L2P coefficients [ncells, M, dim]: the force at offset y is
    sum_m table[m] * y^e_m."""
    expos, C = _shift_table(dim, degree, 1, local.device)
    return expos, (local[:, None, :, None] * C[None]).sum(2)


def _l2p(local, pos, ext, levels: int, dim: int, degree: int = 3):
    """Each body's finest-cell expansion at its offset from the centre."""
    g = 1 << levels
    cs = _cells(pos, ext, g)
    mins, csz = _cell_sizes(ext, g)
    y = torch.stack([pos[:, d] - (mins[d] + (cs[d].to(torch.float32) + 0.5)
                                  * csz[d]) for d in range(dim)], -1)
    expos, tab = _l2p_table(local, dim, degree)
    mono = _monomials(y, expos, degree)                        # [N, M]
    return (mono[:, :, None] * tab[_flatten_cells(cs, g)]).sum(1)


def _l2p_slots(local, pslot, ext, levels: int, dim: int, degree: int = 3,
               cell0: int = 0):
    """L2P at each cell's slot positions ``pslot`` [nc, ci, dim] (cell-
    major, so no gather) with the expansions ``local`` [nc, n_loc] of the
    cells cell0 .. cell0 + nc - 1; returns [nc, ci, dim]. Pad slots give
    junk that the unsort never reads."""
    g = 1 << levels
    nc = pslot.shape[0]
    mins, csz = _cell_sizes(ext, g)
    axes = [a[cell0:cell0 + nc] for a in _iota_axes(cell0 + nc, g, dim,
                                                    pslot.device)]
    y = torch.stack([pslot[..., d] - (mins[d] + (axes[d][:, None].to(
        torch.float32) + 0.5) * csz[d]) for d in range(dim)], -1)
    expos, tab = _l2p_table(local, dim, degree)
    mono = _monomials(y, expos, degree)                        # [nc, ci, M]
    return (mono[..., None] * tab[:, None]).sum(2)


def _fmm_local_table(pos, mass, ext, levels: int, ring: int, eps2, order: int,
                     degree: int = 3, grids=None):
    """The finest-level local-expansion table [ncells, n_loc]: M2L at every
    level (interaction lists at ``ring``), chained down by L2L. The M2L
    weights of all levels come from one batched ``_m2l_weights`` call."""
    dim = pos.shape[-1]
    if grids is None:
        grids = _level_grids(pos, mass, ext, levels, order=2)
    lvls = list(range(2, levels + 1))
    _, spans = ext
    csz = tuple(torch.stack([spans[d] / (1 << lv) for lv in lvls])
                for d in range(dim))
    W_all = _m2l_weights(_fmm_offsets(ring, dim), csz, eps2, dim, order,
                         degree)
    local = None
    for k, lv in enumerate(lvls):
        s = 1 << lv
        if local is not None:
            local = _l2l(local, s // 2, dim, ext, degree)
        packed = torch.stack(grids[lv], 1)
        contrib = _m2l_level_conv(packed, s, ext, eps2, ring, dim, order,
                                  degree, W=W_all[k])
        local = contrib if local is None else local + contrib
    return local


# ---------------------------------------------------------------------------
# The exact-target annulus (nbodyax/physics/barneshut.py:1780-1927)
# ---------------------------------------------------------------------------

def _annulus_offsets(w_near: int, w_far: int, dim: int):
    """Finest-level shell offsets w_near < |delta|_inf <= w_far."""
    return [d for d in itertools.product(range(-w_far, w_far + 1),
                                         repeat=dim)
            if not all(abs(x) <= w_near for x in d)]


def _cell_slice(ncells: int, cell_range):
    """(first cell, count) of a cell range, the whole grid for None."""
    return (0, ncells) if cell_range is None else cell_range


def _slot_side(structure, ci: int, fslot=None, cell_range=None):
    """The i side of the per-cell passes: the first ci sorted bodies of
    each cell of ``cell_range`` (every cell for None) as [cells, ci, L]
    rows (the shared slot grid when given, else a gather), with their
    scatter ids (``n`` where the slot is empty)."""
    _, _, starts, ends, sf = structure
    n = sf.shape[0] - 1
    c0, nc = _cell_slice(starts.shape[0], cell_range)
    starts, ends = starts[c0:c0 + nc], ends[c0:c0 + nc]
    isl = starts[:, None] + torch.arange(ci, device=sf.device)
    i_ok = isl < torch.minimum(ends, starts + ci)[:, None]
    fi = (fslot[c0:c0 + nc, :ci] if fslot is not None
          else sf[torch.where(i_ok, isl, n)])
    ii = _unpack_id(fi[..., -2], fi[..., -1])
    return fi, torch.where(i_ok, ii, n).reshape(-1)


def _annulus_force_cells(packed, ext, levels: int, w_near: int, w_far: int,
                         eps2, order: int, structure, ci_cap: int,
                         fslot=None, cell_range=None):
    """Exact-target force from the finest-level annulus cells at the
    first ``ci_cap`` slots of every cell of ``cell_range`` (first cell,
    count; every cell for None): (force [cells * ci_cap, dim], scatter
    ids). Sources are flat-shifted slices of the padded whole grid, one an
    offset; out-of-grid wraps are masked from the cell coordinates. The
    cells go through in chunks whose [cells, slots, offsets] temporaries
    hold at most ``_ANNULUS_ELEMS`` elements; a cell's result does not
    depend on the chunking."""
    dim = len(ext[0])
    g = 1 << levels
    ncells = g ** dim
    c_first, nc = _cell_slice(ncells, cell_range)
    maxk = sum(w_far * g ** d for d in range(dim))
    Gp = F.pad(packed, (0, 0, maxk, maxk))
    fi, sidx = _slot_side(structure, ci_cap, fslot, cell_range)
    offs = _const(("annulus", w_near, w_far, dim), packed.device,
                  lambda: torch.tensor(_annulus_offsets(w_near, w_far,
                                                        dim)))  # [K, dim]
    kk = sum(offs[:, d] * g ** d for d in range(dim))
    coords = _iota_axes(ncells, g, dim, packed.device)
    cc = max(1, min(nc, _ANNULUS_ELEMS // (ci_cap * offs.shape[0])))
    cc = 1 << (cc.bit_length() - 1)
    out = []
    for c0 in range(c_first, c_first + nc, cc):
        c1 = min(c0 + cc, c_first + nc)
        cells = torch.arange(c0, c1, device=packed.device)
        rows = Gp[maxk + cells[:, None] + kk[None, :]]        # [cc, K, ch]
        ws = [coords[d][c0:c1, None] + offs[None, :, d] for d in range(dim)]
        okc = torch.ones_like(ws[0], dtype=torch.bool)
        for d in range(dim):
            okc = okc & (ws[d] >= 0) & (ws[d] < g)
        # targets [cc, ci, 1] against the K shell cells [cc, 1, K]
        fo = _far_window_force(
            [fi[c0 - c_first:c1 - c_first, :, d:d + 1] for d in range(dim)],
            [w[:, None, :] for w in ws], okc[:, None, :], rows[:, None],
            ext, g, eps2, order)
        out.append(torch.stack([f.sum(-1) for f in fo], -1))
    force = out[0] if len(out) == 1 else torch.cat(out)
    return force.reshape(nc * ci_cap, dim), sidx


def _annulus_force_bodies(i_pos, packed, ext, levels: int, w_near: int,
                          w_far: int, eps2, order: int):
    """Per-body annulus force for a small subset (the completion list)."""
    dim = i_pos.shape[-1]
    g = 1 << levels
    ncells = g ** dim
    cs = _cells(i_pos, ext, g)
    flat = _flatten_cells(cs, g)
    pxs = [i_pos[:, d] for d in range(dim)]
    force = [torch.zeros_like(pxs[0]) for _ in range(dim)]
    for off in _annulus_offsets(w_near, w_far, dim):
        ws = [cs[d] + off[d] for d in range(dim)]
        okc = torch.ones_like(flat, dtype=torch.bool)
        for d in range(dim):
            okc = okc & (ws[d] >= 0) & (ws[d] < g)
        kk = sum(off[d] * g ** d for d in range(dim))
        row = packed[torch.clamp(flat + kk, 0, ncells - 1)]
        fo = _far_window_force(pxs, ws, okc, row, ext, g, eps2, order)
        force = [a + b for a, b in zip(force, fo)]
    return torch.stack(force, -1)


# ---------------------------------------------------------------------------
# bhFar=direct: gathered interaction-list windows (barneshut.py:468-547,
# 1237-1339)
# ---------------------------------------------------------------------------

_DENSE_FAR_CELLS = {2: 256, 3: 512}


def _level_window(cs, lv: int, ring: int, dim: int, packed, device):
    """One level's interaction list for targets in cells ``cs`` (per-axis
    [T] index tensors): (ws, use, cellrow) with a trailing window axis.
    Coarse levels take every cell (membership computed in place), finer
    ones the (4 ring + 2)^dim window around the parent."""
    g = 1 << lv
    ncl = g ** dim
    if ncl <= _DENSE_FAR_CELLS[dim]:
        ws = [w[None, :] for w in _iota_axes(ncl, g, dim, device)]
        near = parent_ok = True
        for d in range(dim):
            cd = cs[d][:, None]
            near = near & ((ws[d] - cd).abs() <= ring)
            parent_ok = parent_ok & (((ws[d] >> 1) - (cd >> 1)).abs()
                                     <= ring)
        return ws, parent_ok & ~near, packed[None, :, :]
    win = 4 * ring + 2
    grid = torch.meshgrid(*[torch.arange(win, device=device)] * dim,
                          indexing="ij")
    offs = [grid[d].reshape(-1) for d in range(dim)]
    ws = [(((cs[d] >> 1) - ring) << 1)[:, None] + offs[d][None, :]
          for d in range(dim)]
    near = inb = True
    for d in range(dim):
        near = near & ((ws[d] - cs[d][:, None]).abs() <= ring)
        inb = inb & (ws[d] >= 0) & (ws[d] < g)
    flat = torch.clamp(_flatten_cells(ws, g), 0, ncl - 1)
    return ws, inb & ~near, packed[flat]


def _far_force(i_pos, pos, mass, ext, levels: int, ring: int, eps2, order=1,
               grids=None):
    """Far-field force for the i bodies (any subset) from grids of the full
    partner set, by gathered interaction-list windows per level."""
    dim = pos.shape[-1]
    if grids is None:
        grids = _level_grids(pos, mass, ext, levels, order)
    force = torch.zeros((i_pos.shape[0], dim), dtype=torch.float32,
                        device=pos.device)
    for lv in range(2, levels + 1):
        cs = _cells(i_pos, ext, 1 << lv)
        ws, use, cellrow = _level_window(cs, lv, ring, dim,
                                         torch.stack(grids[lv], 1),
                                         pos.device)
        f = _far_window_force([i_pos[:, d:d + 1] for d in range(dim)], ws,
                              use, cellrow, ext, 1 << lv, eps2, order)
        force = force + torch.stack([fa.sum(-1) for fa in f], -1)
    return force


def _far_force_cells(pos, mass, ext, levels: int, ring: int, eps2,
                     order: int, structure, ci_cap: int, grids=None,
                     fslot=None, cell_range=None):
    """Far field of the first ``ci_cap`` sorted bodies of every cell of
    ``cell_range`` (first cell, count; every cell for None) by per-CELL
    window gathers (all bodies of a finest cell share every level's
    window). Returns (force [cells * ci_cap, dim], scatter ids)."""
    dim = pos.shape[-1]
    g_f = 1 << levels
    ncells = g_f ** dim
    c_first, nc = _cell_slice(ncells, cell_range)
    if grids is None:
        grids = _level_grids(pos, mass, ext, levels, order)
    fi, sidx = _slot_side(structure, ci_cap, fslot, cell_range)
    fcoords = [a[c_first:c_first + nc]
               for a in _iota_axes(ncells, g_f, dim, pos.device)]
    packed = {lv: torch.stack(grids[lv], 1) for lv in range(2, levels + 1)}
    # cell chunks bound the [cells, ci, window] temporaries near 2^22
    win = max(_DENSE_FAR_CELLS[dim], (4 * ring + 2) ** dim)
    cc = max(1, (1 << 22) // (ci_cap * win))
    out = []
    for c0 in range(0, nc, cc):
        pxs = [fi[c0:c0 + cc, :, d:d + 1] for d in range(dim)]
        force = torch.zeros((pxs[0].shape[0], ci_cap, dim),
                            dtype=torch.float32, device=pos.device)
        for lv in range(2, levels + 1):
            cs = [fc[c0:c0 + cc] >> (levels - lv) for fc in fcoords]
            ws, use, cellrow = _level_window(cs, lv, ring, dim, packed[lv],
                                             pos.device)
            f = _far_window_force(pxs, [w[:, None] for w in ws],
                                  use[:, None], cellrow[:, None], ext,
                                  1 << lv, eps2, order)
            force = force + torch.stack([fa.sum(-1) for fa in f], -1)
        out.append(force)
    return torch.cat(out).reshape(nc * ci_cap, dim), sidx
