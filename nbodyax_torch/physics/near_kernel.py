"""The bh near-field kernel (B3): wrapper and plain version.

Counterpart of ``nbodyax/physics/near_pallas.py``. The TPU kernel there
(``_near_kernel``) becomes the CUDA kernel in
``nbodyax_torch/csrc/near_kernel.cu``, built by ``physics/_build.py``.

Both engines take the slot grid ``fslot`` f32[ncells, S, L] (each finest
cell's first S cell-sorted bodies, zero rows past its count; a row is pos,
[vel in elastic mode], mass, radius, id hi, id lo) and evaluate every
cell's first ``ci`` slots against the S slots of each cell of its
(2 ring + 1)^2 window, with the per-pair rules of ``_gathered_pair_accum``.
They return f32[ncells, ci, 8], slot-major (``NUM_CH`` channels): force x,
y, then reference gained mass / gained radius / died (0 or 1), momentum
best mass (-inf when none) / parent id hi / parent id lo, or elastic dv x,
y; unused channels are 0. That is the packed-lane order of the slot unsort
in ``barneshut._near_field_cells``.

- ``slots_near`` launches the kernel on a CUDA tensor and runs
  ``slots_near_reference`` on a CPU tensor; ``slots_near.launches`` counts
  kernel launches.
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

__all__ = ["slots_near", "slots_near_reference", "NUM_CH", "MODES"]

NUM_CH = 8
MODES = ("reference", "momentum", "elastic", "none")
_PAIRS_PER_CHUNK = 1 << 22


def _check(fslot, mode, ci, g, dim):
    if mode not in MODES:
        raise ValueError(f"unknown collision mode {mode!r}")
    ncells, S, L = fslot.shape
    if fslot.dtype != torch.float32 or ncells != g ** dim:
        raise ValueError(f"fslot must be f32[{g ** dim}, S, L], got "
                         f"{fslot.dtype} {tuple(fslot.shape)}")
    want_l = (2 * dim if mode == "elastic" else dim) + 4
    if L != want_l or not 0 < ci <= S:
        raise ValueError(f"fslot rows must be {want_l} wide and ci in "
                         f"[1, S={S}], got L={L}, ci={ci}")


def slots_near(fslot, *, mode: str, eps2: float, growth: float, g: int,
               ring: int, ci: int):
    """Near-field channels f32[ncells, ci, 8] of the 2-D slot grid
    ``fslot``: the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    _check(fslot, mode, ci, g, 2)
    if fslot.device.type == "cpu":
        return slots_near_reference(fslot, mode=mode, eps2=eps2,
                                    growth=growth, g=g, ring=ring, ci=ci)
    if fslot.device.type != "cuda":
        raise ValueError(f"no near kernel for device {fslot.device}")
    from nbodyax_torch.physics._build import load_library
    lib = load_library()
    fslot = fslot.contiguous()
    ncells, S, L = fslot.shape
    out = torch.empty((ncells, ci, NUM_CH), dtype=torch.float32,
                      device=fslot.device)
    with torch.cuda.device(fslot.device):
        stream = torch.cuda.current_stream(fslot.device).cuda_stream
        err = lib.nbodyax_slots_near(fslot.data_ptr(), g, ring, S, ci, L,
                                     MODES.index(mode), float(np.float32(eps2)),
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
