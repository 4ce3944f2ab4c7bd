"""The bh near-field kernel (B3): wrapper and plain version.

Counterpart of ``nbodyax/physics/near_pallas.py``. The TPU kernel there
(``_near_kernel``) becomes the CUDA kernel in
``nbodyax_torch/csrc/near_kernel.cu``, built by ``physics/_build.py``.

Both engines take the slot grid ``fslot`` f32[ncells, S, L] of a grid of
side g in ``dim`` = 2 or 3 dimensions (each finest cell's first S
cell-sorted bodies, zero rows past its count; a row is pos, [vel in
elastic mode], mass, radius, id hi, id lo, so L = dim + 4 or 2 dim + 4)
and evaluate every cell's first ``ci`` slots against the S slots of each
cell of its (2 ring + 1)^dim window, with the per-pair rules of
``_gathered_pair_accum``. They return f32[ncells, ci, 8], slot-major
(``NUM_CH`` channels): the dim force channels, then reference gained mass
/ gained radius / died (0 or 1), momentum best mass (-inf when none) /
parent id hi / parent id lo, or elastic dv; unused channels are 0. That is
the packed-lane order of the slot unsort in
``barneshut._near_field_cells``. The rows do not encode the dimension, so
every entry point takes ``dim`` (default 2).

- ``slots_near`` launches the kernel on a CUDA tensor and runs
  ``slots_near_reference`` on a CPU tensor; ``slots_near.launches`` counts
  kernel launches. ``near_plan`` is its one host-side choice: the staging
  capacity of live partners a warp and the shared memory that takes.
- ``slots_near_reference`` is the port of the jnp slots engine of
  ``_near_field_cells`` (its ``one_chunk``, barneshut.py:1004-1084),
  evaluated over the same slot grid.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from nbodyax_torch.physics.bh_grid import (_gathered_pair_accum, _pack_id,
                                           _unpack_id)
from nbodyax_torch.physics.pairwise import (combine_accumulators,
                                            empty_accumulators)

__all__ = ["slots_near", "slots_near_reference", "near_plan", "NUM_CH",
           "MODES"]

NUM_CH = 8
MODES = ("reference", "momentum", "elastic", "none")
_PAIRS_PER_CHUNK = 1 << 22
NEAR_WARPS = 4          # cells a block (csrc/near_kernel.cu kWarps)
NEAR_MAX_CAP = 256      # most live partners a warp stages before it computes
SHARED_LIMIT = 48 * 1024   # static-launch limit: no opt-in needed


def near_plan(S: int, ring: int, L: int, dim: int = 2):
    """B3's staging buffer: (capacity, shared bytes a block). A warp stages
    up to ``capacity`` live partners of its window: the window's
    (2 ring + 1)^dim S slots rounded up to 32 and at most NEAR_MAX_CAP, so
    a small window is staged whole and any S or ring takes a fixed amount
    of shared memory. In 2-D a partner is a float4 (x, y, m, r) and an int
    id, plus a float2 velocity when L = 8 (elastic): 5 or 7 words. In 3-D
    it is a float4 (x, y, z, m), the radius and the id, plus three
    velocity words when L = 10: 6 or 9 words. Each warp adds 32 ints of
    compacted i lanes (the kernel's warp_words). The largest block, 3-D
    elastic at the full capacity, takes 4 x (256 x 9 + 32) words = 37,376
    bytes, under the 48 KB a block may take without opting in."""
    win = (2 * ring + 1) ** dim * S
    cap = min(NEAR_MAX_CAP, -(-win // 32) * 32)
    vel = L == 2 * dim + 4
    per = (9 if vel else 6) if dim == 3 else (7 if vel else 5)
    return cap, NEAR_WARPS * (cap * per + 32) * 4


def _check(fslot, mode, ci, g, dim):
    if mode not in MODES:
        raise ValueError(f"unknown collision mode {mode!r}")
    if dim not in (2, 3):
        raise ValueError(f"the near field runs in 2 or 3 dimensions, got "
                         f"dim={dim}")
    if fslot.dim() != 3:
        raise ValueError(f"fslot must be f32[g^dim, S, L], got "
                         f"{tuple(fslot.shape)}")
    ncells, S, L = fslot.shape
    if fslot.dtype != torch.float32 or ncells != g ** dim:
        raise ValueError(f"fslot must be f32[{g ** dim}, S, L], got "
                         f"{fslot.dtype} {tuple(fslot.shape)}")
    want_l = (2 * dim if mode == "elastic" else dim) + 4
    if L != want_l or not 0 < ci <= S:
        raise ValueError(f"fslot rows must be {want_l} wide and ci in "
                         f"[1, S={S}], got L={L}, ci={ci}")


def slots_near(fslot, *, mode: str, eps2: float, growth: float, g: int,
               ring: int, ci: int, dim: int = 2):
    """Near-field channels f32[ncells, ci, 8] of the slot grid ``fslot``
    of a ``dim``-dimensional grid: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check(fslot, mode, ci, g, dim)
    if fslot.device.type == "cpu":
        return slots_near_reference(fslot, mode=mode, eps2=eps2,
                                    growth=growth, g=g, ring=ring, ci=ci,
                                    dim=dim)
    if fslot.device.type != "cuda":
        raise ValueError(f"no near kernel for device {fslot.device}")
    from nbodyax_torch.physics._build import load_library
    lib = load_library()
    fslot = fslot.contiguous()
    ncells, S, L = fslot.shape
    # the kernel loads a row of 8 by 16 bytes, of 6 or 10 by 8, of 7 by 4
    if fslot.data_ptr() % (16 if L == 8 else 8 if L % 2 == 0 else 4):
        fslot = fslot.clone()
    cap, _ = near_plan(S, ring, L, dim)
    out = torch.empty((ncells, ci, NUM_CH), dtype=torch.float32,
                      device=fslot.device)
    with torch.cuda.device(fslot.device):
        stream = torch.cuda.current_stream(fslot.device).cuda_stream
        err = lib.nbodyax_slots_near(fslot.data_ptr(), g, ring, S, ci, L,
                                     cap, MODES.index(mode), dim,
                                     float(np.float32(eps2)),
                                     float(np.float32(growth)),
                                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"near kernel launch failed: CUDA error {err}")
    slots_near.launches += 1
    return out


slots_near.launches = 0


def _lanes(acc, mode: str, dim: int):
    """The packed channels of a slot's accumulators, padded to NUM_CH."""
    lanes = [acc.force[:, d] for d in range(dim)]
    if mode == "reference":
        lanes += [acc.gained_mass, acc.gained_radius,
                  acc.died.to(torch.float32)]
    elif mode == "momentum":
        lanes += [acc.best_mass, *_pack_id(acc.parent)]
    elif mode == "elastic":
        lanes += [acc.dv[:, d] for d in range(dim)]
    zero = torch.zeros_like(lanes[0])
    return torch.stack(lanes + [zero] * (NUM_CH - len(lanes)), 1)


def slots_near_reference(fslot, *, mode: str, eps2: float, growth: float,
                         g: int, ring: int, ci: int, dim: int = 2):
    """Plain PyTorch version of the near kernel, dimension-generic.

    Window rows are contiguous slices of the flat slot grid padded by the
    window's reach in zero cells; out-of-grid window cells (the flat
    layout's x-wrap and rows past the edge) are masked by zeroing the
    partner mass. Chunked over cells so a chunk holds about
    ``_PAIRS_PER_CHUNK`` pairs."""
    _check(fslot, mode, ci, g, dim)
    ncells, S, L = fslot.shape
    dev = fslot.device
    need_vel = mode == "elastic"
    rest = 2 * dim if need_vel else dim
    win = 2 * ring + 1
    padc = ring * sum(g ** d for d in range(dim))
    flat = F.pad(fslot.reshape(ncells * S, L), (0, 0, padc * S, padc * S))
    cc = max(1, min(ncells, _PAIRS_PER_CHUNK // (ci * win * S)))
    cc = 1 << (cc.bit_length() - 1)          # a power of two divides ncells
    B = cc * ci
    eps2 = float(np.float32(eps2))
    growth = float(np.float32(growth))
    out = []
    for base in range(0, ncells, cc):
        cid = base + torch.arange(cc, device=dev)
        coords, rem = [], cid
        for _ in range(dim):                  # x fastest
            coords.append(rem % g)
            rem = rem // g
        fi = fslot[base:base + cc, :ci].reshape(B, L)
        pi = fi[:, 0:dim]
        vi = fi[:, dim:2 * dim] if need_vel else torch.zeros_like(pi)
        mi, ri = fi[:, rest], fi[:, rest + 1]
        ii = _unpack_id(fi[:, rest + 2], fi[:, rest + 3])
        acc = empty_accumulators(ii, dim=dim)
        for off in itertools.product(range(-ring, ring + 1), repeat=dim - 1):
            ok_row = torch.ones((cc,), dtype=torch.bool, device=dev)
            for a, o in enumerate(off):
                nd = coords[1 + a] + o
                ok_row = ok_row & (nd >= 0) & (nd < g)
            koff = sum(off[a] * g ** (1 + a) for a in range(dim - 1))
            s0 = (base + koff - ring + padc) * S
            blk = flat[s0:s0 + (cc + 2 * ring) * S].reshape(
                cc + 2 * ring, S, L)
            parts = [blk[dx + ring:dx + ring + cc]
                     for dx in range(-ring, ring + 1)]
            oks = [ok_row & (coords[0] + dx >= 0) & (coords[0] + dx < g)
                   for dx in range(-ring, ring + 1)]
            fj = torch.stack(parts, 1).reshape(cc, win * S, L)
            ok = torch.stack(oks, 1)                         # [cc, win]
            fjE = fj[:, None].expand(cc, ci, win * S, L).reshape(
                B, win * S, L)
            okE = ok[:, None, :, None].expand(cc, ci, win, S).reshape(
                B, win * S)
            pj = fjE[..., 0:dim]
            vj = fjE[..., dim:2 * dim] if need_vel else torch.zeros_like(pj)
            mj = fjE[..., rest] * okE
            rj = fjE[..., rest + 1]
            jj = _unpack_id(fjE[..., rest + 2], fjE[..., rest + 3])
            acc = combine_accumulators(acc, _gathered_pair_accum(
                pi, vi, mi, ri, ii, pj, vj, mj, rj, jj, eps2=eps2,
                growth_rate=growth, mode=mode))
        out.append(_lanes(acc, mode, dim).reshape(cc, ci, NUM_CH))
    return torch.cat(out)
