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
  with ``moments=(pos, mass, ext, levels)``, B5 (rows and the order-2
  moments f32[ncells, 6] of a 2-D grid or f32[ncells, 10] of a 3-D one, by
  the width of ``pos``) on a CUDA tensor, and the plain versions on a CPU
  tensor. Rows are ``dim + 4`` wide, or ``2 dim + 4`` in elastic mode: 6
  and 8 in 2-D, 7 and 10 in 3-D (``ROW_WIDTHS``); any other width is
  refused. ``pack_slots.launches`` and ``pack_slots.moment_launches`` count
  the kernel launches.
- ``moment_plan`` is the wrapper's one host-side choice: the chunks of
  B5's first pass, which reduces the cells of more than MOMENT_CHUNK
  bodies in pieces, and the scratch its partials take.
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
           "finest_moments_reference", "moment_plan", "MOMENT_CHUNK",
           "ROW_WIDTHS", "num_moments"]

MOMENT_CHUNK = 256      # sorted bodies a warp of B5's chunk pass (kChunk)
# row widths of the sorted pack, by dimension: dim + 4, and 2 dim + 4 with
# velocities (elastic mode)
ROW_WIDTHS = {2: (6, 8), 3: (7, 10)}


def num_moments(dim: int) -> int:
    """Order-2 moments of a cell: m, m r_a, m r_a r_b (a <= b)."""
    return 1 + dim + dim * (dim + 1) // 2


def moment_plan(n: int, dim: int = 2):
    """B5's chunk pass over the n sorted bodies: (chunks, scratch floats).
    Each chunk of MOMENT_CHUNK bodies writes two partials of
    ``num_moments(dim)`` floats, 6 in 2-D and 10 in 3-D (the cells of more
    than MOMENT_CHUNK bodies that it meets)."""
    chunks = -(-n // MOMENT_CHUNK)
    return chunks, chunks * 2 * num_moments(dim)


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


def _check(sf, starts, S: int, moments):
    """Raise on a pack the kernels do not take: rows other than f32 of a
    2-D or 3-D width, S out of range, and with moments a ``pos`` whose
    dimension does not fit the rows or the cell count."""
    if sf.dtype != torch.float32 or sf.dim() != 2:
        raise ValueError(f"sf must be f32[n + 1, L], got {sf.dtype} "
                         f"{tuple(sf.shape)}")
    L, ncells = sf.shape[1], starts.shape[0]
    if not any(L in w for w in ROW_WIDTHS.values()):
        raise ValueError(f"sf rows must be 6 or 8 (2-D) or 7 or 10 (3-D) "
                         f"wide, got L={L}")
    if not 0 < S <= 1024:
        raise ValueError(f"S must be in [1, 1024], got {S}")
    if moments is None:
        return
    pos, _, _, levels = moments
    dim = pos.shape[-1]
    if dim not in ROW_WIDTHS or L not in ROW_WIDTHS[dim]:
        raise ValueError(f"no slot-pack moment kernel for {dim}-D positions "
                         f"with rows of {L}")
    if (1 << levels) ** dim != ncells:
        raise ValueError(f"levels={levels} in {dim}-D does not match the "
                         f"{ncells} cells of starts")


def pack_slots(sf, starts, ends, S: int, moments=None):
    """Slot grid ``[ncells, S, L]`` of the sorted pack ``sf[n + 1, L]``
    (and, with ``moments=(pos, mass, ext, levels)``, the finest moments).
    A CUDA tensor goes to the kernel, a CPU tensor to the plain versions."""
    _check(sf, starts, S, moments)
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
    sf = sf.contiguous()
    if L % 2 == 0 and sf.data_ptr() % 8:   # 8-byte loads of even rows
        sf = sf.clone()
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
            dim = pos.shape[-1]
            g = 1 << levels
            mins, csz = _cell_sizes(ext, g)
            geom = torch.stack([*mins, *csz]).to(
                device=sf.device, dtype=torch.float32).contiguous()
            mom = torch.empty((ncells, num_moments(dim)),
                              dtype=torch.float32, device=sf.device)
            chunks, scratch = moment_plan(sf.shape[0] - 1, dim)
            part = torch.empty((scratch,), dtype=torch.float32,
                               device=sf.device)
            err = lib.nbodyax_slot_pack_moments(
                sf.data_ptr(), L, starts.data_ptr(), ends.data_ptr(), ncells,
                S, g, dim, geom.data_ptr(), chunks, part.data_ptr(),
                rows.data_ptr(), mom.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"slot-pack kernel launch failed: CUDA error {err}")
    if mom is None:
        pack_slots.launches += 1
        return rows
    pack_slots.moment_launches += 1
    return rows, mom
