"""The bh annulus wrapper (``physics/annulus_kernel.py``) on the CPU: it
runs the plain version there, bit for bit, and refuses on any device what
the CUDA kernel does not take. The kernel itself is held to the plain
version on the card (tests/test_torch_kernels.py)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch.physics import fmm  # noqa: E402
from nbodyax_torch.physics.annulus_kernel import (  # noqa: E402
    SHARED_LIMIT, annulus_cells, annulus_plan, shell_cells)
from nbodyax_torch.physics.bh_grid import (_extent,  # noqa: E402
                                           _partner_structure)
from nbodyax_torch.physics.slotpack_kernel import (  # noqa: E402
    build_slot_grid_reference)

LEVELS = {2: 4, 3: 3}
CI = 32


def annulus_case(dim, n=3000, seed=5):
    """A uniform state with a crowded corner, its partner structure, the
    finest moment grid and the slot grid (S = 48), on the CPU."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1e4, 1e4, (n, dim)).astype(np.float32)
    pos[: n // 5] = rng.uniform(9e3, 1e4, (n // 5, dim))
    mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
    mass[3] = 0.0
    t = [torch.from_numpy(x) for x in (pos, np.zeros_like(pos), mass,
                                       np.full(n, 50.0, np.float32))]
    levels = LEVELS[dim]
    g = 1 << levels
    ext = _extent(t[0], t[2] > 0)
    st = _partner_structure(*t, ext, g, False)
    grids = fmm._level_grids(t[0], t[2], ext, levels, order=2)
    packed = torch.stack(grids[levels], 1)
    fslot = build_slot_grid_reference(st[4], st[2], st[3], n, g ** dim, 48)
    return packed, ext, levels, st, fslot


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("source", ["fslot", "rows"])
@pytest.mark.parametrize("sliced", [False, True])
def test_cpu_wrapper_is_the_plain_version(dim, source, sliced):
    packed, ext, levels, st, fslot = annulus_case(dim)
    ncells = (1 << levels) ** dim
    cr = (ncells // 4, ncells // 2) if sliced else None
    args = (packed, ext, levels, 1, 2, 25.0, 2, st, CI)
    kw = dict(fslot=fslot if source == "fslot" else None, cell_range=cr)
    before = annulus_cells.launches
    force, ids = annulus_cells(*args, **kw)
    want, want_ids = fmm._annulus_force_cells(*args, **kw)
    assert torch.equal(force, want) and torch.equal(ids, want_ids)
    assert annulus_cells.launches == before       # no kernel on the CPU


def _bad(case):
    """The wrapper's arguments for a bad ``case``, on the 2-D state."""
    packed, ext, levels, st, fslot = annulus_case(2, n=600)
    kw = dict(packed=packed, ext=ext, levels=levels, w_near=1, w_far=2,
              eps2=0.0, order=2, structure=st, ci_cap=CI, fslot=fslot,
              cell_range=None)
    ncells = packed.shape[0]
    if case == "dtype":
        kw["packed"] = packed.double()
    elif case == "dimension":
        kw["ext"] = tuple(tuple(e) + tuple(e) for e in ext)   # 4-D
    elif case == "moment width":
        kw["packed"] = packed[:, :5]
    elif case == "row width":
        sf = st[4]
        kw["structure"] = st[:4] + (torch.cat([sf, sf[:, :1]], 1),)
        kw["fslot"] = None
    elif case == "ci_cap small":
        kw["ci_cap"] = 16
    elif case == "ci_cap large":
        kw["ci_cap"] = 2048
    elif case == "fslot short":
        kw["fslot"] = fslot[:, :CI - 1]
    elif case == "order":
        kw["order"] = 1
    elif case == "shell":
        kw["w_near"] = 2
    elif case == "cell range":
        kw["cell_range"] = (ncells // 2, ncells // 2 + 1)
    return kw


@pytest.mark.parametrize("case", [
    "dtype", "dimension", "moment width", "row width", "ci_cap small",
    "ci_cap large", "fslot short", "order", "shell", "cell range"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        annulus_cells(**_bad(case))


def test_plan_fits_every_ring_and_slot_budget():
    """The bh paths' plans, and every ring the knobs allow (1-3) at every
    slot budget within 48 KB, the shell count that of
    ``fmm._annulus_offsets``; a shell past 48 KB a cell is refused."""
    assert annulus_plan(32, 1, 2, 2) == 8      # bh-million
    assert annulus_plan(64, 1, 2, 3) == 4      # bh3d-million
    assert annulus_plan(32, 3, 4, 3) == 2      # 386 shell cells
    for dim, ring in itertools.product((2, 3), (1, 2, 3)):
        assert shell_cells(ring, ring + 1, dim) == len(
            fmm._annulus_offsets(ring, ring + 1, dim))
        for ci in range(32, 1025, 8):
            cpb = annulus_plan(ci, ring, ring + 1, dim)
            shared = cpb * (shell_cells(ring, ring + 1, dim) * (
                32 if dim == 2 else 48) + 16)
            assert 1 <= cpb <= 8 and shared <= SHARED_LIMIT
            assert cpb == 1 or cpb * ci <= 256
    with pytest.raises(ValueError):
        annulus_plan(32, 6, 7, 3)        # 1,178 shell cells, 56,560 bytes
