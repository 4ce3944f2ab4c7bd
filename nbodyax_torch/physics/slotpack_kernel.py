"""The bh slot-grid pack (B4) and its finest-moment variant (B5): wrapper
and plain versions.

Counterpart of ``nbodyax/physics/slotpack_pallas.py``. The TPU kernels there
(``_pack_kernel``, ``_pack_mom_kernel``) become one CUDA source,
``nbodyax_torch/csrc/slotpack_kernel.cu``, built by ``physics/_build.py``.
The port keeps the slot grid in ``_build_slot_grid``'s own layout
``[ncells, S, L]``, so the kernel's rows equal that gather bit for bit (no
transpose, no 128-lane padding), and it handles every occupancy: the TPU
kernel's static capacity and its runtime fallback have no counterpart.

- ``pack_slots(sf, starts, ends, S, moments=None)`` launches B4 (rows) or,
  with ``moments=(pos, mass, ext, levels)``, B5 (rows and the f32[ncells, 6]
  order-2 moments of a 2-D grid) on a CUDA tensor, and the plain versions on
  a CPU tensor. ``pack_slots.launches`` and ``pack_slots.moment_launches``
  count the kernel launches.
- ``build_slot_grid_reference`` is the port of ``_build_slot_grid`` (one
  gather), ``finest_moments_reference`` the port of
  ``_finest_moments_scatter`` (one ``index_add_``). The tests and
  ``chip_smoke.py`` hold the kernels to them.
"""

from __future__ import annotations

import torch

from nbodyax_torch.physics.bh_grid import (_cell_sizes, _cells,
                                           _flatten_cells, _moment_pairs)

__all__ = ["pack_slots", "build_slot_grid_reference",
           "finest_moments_reference"]


def build_slot_grid_reference(sf, starts, ends, n: int, ncells: int, S: int):
    """The slot grid f32[ncells, S, L]: each cell's first S sorted rows,
    the zero pad row ``sf[n]`` past its count (``_build_slot_grid``)."""
    pslots = starts[:, None] + torch.arange(S, device=sf.device)
    p_ok = pslots < torch.minimum(ends, starts + S)[:, None]
    return sf[torch.where(p_ok, pslots, n)]


def finest_moments_reference(pos, mass, ext, levels: int):
    """Order-2 finest-level moments about each body's own cell centre,
    f32[ncells, 1 + dim + dim(dim+1)/2], by one row scatter-add
    (``_finest_moments_scatter``). The float32 terms are summed in float64
    and rounded once: on the card ``index_add_`` sums in the order its
    atomics land, and a float32 sum over a crowded cell then moves by up to
    6e-6 of the channel scale from run to run (measured on the H100 at
    28,000 bodies a cell), three times the gate the kernel is held to."""
    dim = pos.shape[-1]
    g = 1 << levels
    cs = _cells(pos, ext, g)
    flat = _flatten_cells(cs, g)
    mins, csz = _cell_sizes(ext, g)
    r = [pos[:, d] - (mins[d] + (cs[d].to(torch.float32) + 0.5) * csz[d])
         for d in range(dim)]
    chans = ([mass] + [mass * r[d] for d in range(dim)]
             + [mass * r[a] * r[b] for a, b in _moment_pairs(dim)])
    out = torch.zeros((g ** dim, len(chans)), dtype=torch.float64,
                      device=pos.device)
    return out.index_add_(0, flat, torch.stack(chans, 1).double()).float()


def pack_slots(sf, starts, ends, S: int, moments=None):
    """Slot grid ``[ncells, S, L]`` of the sorted pack ``sf[n + 1, L]``
    (and, with ``moments=(pos, mass, ext, levels)``, the finest moments).
    A CUDA tensor goes to the kernel, a CPU tensor to the plain versions."""
    n, ncells = sf.shape[0] - 1, starts.shape[0]
    if sf.device.type == "cpu":
        rows = build_slot_grid_reference(sf, starts, ends, n, ncells, S)
        if moments is None:
            return rows
        return rows, finest_moments_reference(*moments)
    if sf.device.type != "cuda":
        raise ValueError(f"no slot-pack kernel for device {sf.device}")
    return _launch(sf, starts, ends, S, moments)


pack_slots.launches = 0
pack_slots.moment_launches = 0


def _launch(sf, starts, ends, S: int, moments):
    from nbodyax_torch.physics._build import load_library
    lib = load_library()
    ncells, L = starts.shape[0], sf.shape[1]
    if sf.dtype != torch.float32 or sf.dim() != 2 or L > 8:
        raise ValueError(f"sf must be f32[n + 1, L <= 8], got {sf.dtype} "
                         f"{tuple(sf.shape)}")
    if not 0 < S <= 1024:
        raise ValueError(f"S must be in [1, 1024], got {S}")
    sf = sf.contiguous()
    starts = starts.to(torch.int64).contiguous()
    ends = ends.to(torch.int64).contiguous()
    rows = torch.empty((ncells, S, L), dtype=torch.float32, device=sf.device)
    with torch.cuda.device(sf.device):
        stream = torch.cuda.current_stream(sf.device).cuda_stream
        if moments is None:
            err = lib.nbodyax_slot_pack(sf.data_ptr(), L, starts.data_ptr(),
                                        ends.data_ptr(), ncells, S,
                                        rows.data_ptr(), stream)
            mom = None
        else:
            pos, _, ext, levels = moments
            if pos.shape[-1] != 2:
                raise NotImplementedError(
                    "the slot-pack moment kernel is 2-D only")
            g = 1 << levels
            if g * g != ncells:
                raise ValueError(f"levels={levels} does not match the "
                                 f"{ncells} cells of starts")
            mins, csz = _cell_sizes(ext, g)
            geom = torch.stack([mins[0], mins[1], csz[0], csz[1]]).to(
                device=sf.device, dtype=torch.float32).contiguous()
            mom = torch.empty((ncells, 6), dtype=torch.float32,
                              device=sf.device)
            err = lib.nbodyax_slot_pack_moments(
                sf.data_ptr(), L, starts.data_ptr(), ends.data_ptr(), ncells,
                S, g, geom.data_ptr(), rows.data_ptr(), mom.data_ptr(),
                stream)
    if err != 0:
        raise RuntimeError(f"slot-pack kernel launch failed: CUDA error {err}")
    if mom is None:
        pack_slots.launches += 1
        return rows
    pack_slots.moment_launches += 1
    return rows, mom
