"""The bh far field's exact-target annulus as one CUDA kernel: wrapper and
plan.

No TPU kernel stands behind it: nbodyax computes the annulus in jnp, and
the port's plain version, ``fmm._annulus_force_cells``, builds [cells,
slots, shell cells] temporaries and runs the order-2 formula of
``fmm._far_window_force`` over them as whole-tensor ops. The kernel,
``nbodyax_torch/csrc/annulus_kernel.cu`` (built by ``physics/_build.py``),
stages each cell's shell once in shared memory and sums every slot's force
in registers; each shell cell's term is the plain version's float32
arithmetic, and only the order of the sum over shell cells differs.

- ``annulus_cells`` takes ``_annulus_force_cells``'s arguments and returns
  what it returns: (force f32[cells * ci_cap, dim], scatter ids int64) for
  the cells of ``cell_range`` (every cell for None), the slots read from
  the slot grid ``fslot`` or, without it, from the cell-sorted pack. On a
  CUDA tensor it launches the kernel (a slot past its cell's count gets
  force 0 and id n, which no consumer reads); on a CPU tensor it runs the
  plain version. ``annulus_cells.launches`` counts kernel launches.
- ``annulus_plan`` is the wrapper's one host-side choice: the cells a
  block takes, within the shared memory a block may hold (the kernel lays
  it out and its launch refuses a block that passes the limit).
"""

from __future__ import annotations

import numpy as np
import torch

from nbodyax_torch.physics.bh_grid import _cell_sizes
from nbodyax_torch.physics.fmm import _annulus_force_cells, _cell_slice
from nbodyax_torch.physics.slotpack_kernel import ROW_WIDTHS, num_moments

__all__ = ["annulus_cells", "annulus_plan", "shell_cells", "SHARED_LIMIT"]

MAX_CELLS = 8                # cells a block at most
SHARED_LIMIT = 48 * 1024     # static-launch limit: no opt-in needed


def shell_cells(w_near: int, w_far: int, dim: int) -> int:
    """Offsets of the shell w_near < |delta|_inf <= w_far
    (``fmm._annulus_offsets``): 16 and 98 at ring 1 in 2-D and 3-D."""
    return (2 * w_far + 1) ** dim - (2 * w_near + 1) ** dim


def annulus_plan(ci: int, w_near: int, w_far: int, dim: int) -> int:
    """The cells a block takes: 256 / ci, so a block's 128 threads meet
    about one live slot each under the auto slot budget (twice the mean
    occupancy), at most MAX_CELLS, and fewer where their shells would pass
    SHARED_LIMIT. A cell takes 8 floats a staged shell cell in 2-D and 12
    in 3-D, and 16 bytes of counts; the 3-D shell at ring 3 (386 cells)
    leaves room for 2. Raises ValueError where one cell does not fit."""
    shell = shell_cells(w_near, w_far, dim)
    per = shell * (32 if dim == 2 else 48) + 16
    cpb = min(MAX_CELLS, max(1, 256 // ci), SHARED_LIMIT // per)
    if cpb < 1:
        raise ValueError(f"the annulus of {shell} shell cells in {dim}-D "
                         f"takes {per} bytes of shared memory a cell, over "
                         f"{SHARED_LIMIT}")
    return cpb


def _check(packed, ext, levels, w_near, w_far, order, structure, ci_cap,
           fslot, cell_range):
    """Refuse what the kernel does not take, on any device; returns the
    cells a block."""
    dim = len(ext[0])
    if dim not in ROW_WIDTHS:
        raise ValueError(f"the annulus runs in 2 or 3 dimensions, got "
                         f"dim={dim}")
    ncells = (1 << levels) ** dim
    nm = num_moments(dim)
    if (packed.dtype != torch.float32
            or tuple(packed.shape) != (ncells, nm)):
        raise ValueError(f"packed must be f32[{ncells}, {nm}], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if order != 2:
        raise ValueError(f"the annulus kernel is order 2, got order={order}")
    if not 0 <= w_near < w_far:
        raise ValueError(f"the shell needs 0 <= w_near < w_far, got "
                         f"{w_near}, {w_far}")
    if not 32 <= ci_cap <= 1024:
        raise ValueError(f"ci_cap must be in [32, 1024], got {ci_cap}")
    _, _, starts, ends, sf = structure
    if (sf.dtype != torch.float32 or sf.dim() != 2
            or sf.shape[1] not in ROW_WIDTHS[dim]):
        raise ValueError(f"sf must be f32[n + 1, L] with L in "
                         f"{ROW_WIDTHS[dim]} ({dim}-D), got {sf.dtype} "
                         f"{tuple(sf.shape)}")
    if tuple(starts.shape) != (ncells,) or tuple(ends.shape) != (ncells,):
        raise ValueError(f"starts and ends must hold the {ncells} cells, "
                         f"got {tuple(starts.shape)} and {tuple(ends.shape)}")
    if fslot is not None and (
            fslot.dtype != torch.float32 or fslot.dim() != 3
            or fslot.shape[0] != ncells or fslot.shape[1] < ci_cap
            or fslot.shape[2] != sf.shape[1]):
        raise ValueError(f"fslot must be f32[{ncells}, S >= {ci_cap}, "
                         f"{sf.shape[1]}], got {fslot.dtype} "
                         f"{tuple(fslot.shape)}")
    c0, nc = _cell_slice(ncells, cell_range)
    if c0 < 0 or nc < 0 or c0 + nc > ncells:
        raise ValueError(f"the cell range [{c0}, {c0 + nc}) leaves the grid "
                         f"of {ncells} cells")
    return annulus_plan(ci_cap, w_near, w_far, dim)


def annulus_cells(packed, ext, levels: int, w_near: int, w_far: int, eps2,
                  order: int, structure, ci_cap: int, fslot=None,
                  cell_range=None):
    """The annulus force at the first ``ci_cap`` slots of every cell of
    ``cell_range``: (force [cells * ci_cap, dim], scatter ids), as
    ``fmm._annulus_force_cells``. The CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    cpb = _check(packed, ext, levels, w_near, w_far, order, structure,
                 ci_cap, fslot, cell_range)
    if packed.device.type == "cpu":
        return _annulus_force_cells(packed, ext, levels, w_near, w_far, eps2,
                                    order, structure, ci_cap, fslot=fslot,
                                    cell_range=cell_range)
    if packed.device.type != "cuda":
        raise ValueError(f"no annulus kernel for device {packed.device}")
    _, _, starts, ends, sf = structure
    rows = sf if fslot is None else fslot
    if not rows.is_contiguous():
        raise ValueError("the slot rows must be contiguous")
    from nbodyax_torch.physics._build import load_library
    lib = load_library()
    dim = len(ext[0])
    g = 1 << levels
    c0, nc = _cell_slice(g ** dim, cell_range)
    mins, csz = _cell_sizes(ext, g)
    geom = torch.stack([*mins, *csz]).to(device=packed.device,
                                         dtype=torch.float32)
    packed = packed.contiguous()
    starts = starts.to(torch.int64).contiguous()
    ends = ends.to(torch.int64).contiguous()
    force = torch.empty((nc * ci_cap, dim), dtype=torch.float32,
                        device=packed.device)
    ids = torch.empty((nc * ci_cap,), dtype=torch.int64, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = lib.nbodyax_annulus_cells(
            packed.data_ptr(), geom.data_ptr(), rows.data_ptr(),
            sf.shape[1], 0 if fslot is None else fslot.shape[1],
            starts.data_ptr(), ends.data_ptr(), g, dim, w_near, w_far, ci_cap,
            sf.shape[0] - 1, c0, nc, cpb, float(np.float32(eps2)),
            force.data_ptr(), ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"annulus kernel launch failed: CUDA error {err}")
    annulus_cells.launches += 1
    return force, ids


annulus_cells.launches = 0
