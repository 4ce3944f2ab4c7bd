"""The host-side choices of the bh kernels' wrappers, and their plain
versions against nbodyax on the edge cases the redesigned kernels have to
get right, on the CPU.

- ``near_kernel.near_plan``: B3's staging capacity and shared memory, within
  the 48 KB a block may take without opting in, for S in {40, 48, 1024},
  ring in {1, 2} and L in {6, 8}.
- ``slotpack_kernel.moment_plan``: B5's chunk count and scratch size.
- ``slots_near_reference`` against nbodyax's per-pair rules
  (``_gathered_pair_accum``, which its Pallas near kernel is held to) on a
  hand-built slot grid: cells of 0 to 40 live slots, a dead body between
  live ones (as i and as partner; nbodyax's kernel never sees one, since
  its caller sorts dead bodies out of the grid), ring 2 at the corners,
  ids past 2^24; and a momentum tie.
- ``pack_slots`` (its plain versions) against nbodyax's
  ``_build_slot_grid`` and ``_finest_moments_scatter`` where B5's chunks
  of 256 bodies meet cell edges, cross cells, and meet a 2,000-body cell
  (nbodyax sums its moments in float32, which at 70,000 bodies a cell,
  the card test's size, drifts past the gate).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch.physics import bh_grid  # noqa: E402
from nbodyax_torch.physics.near_kernel import (  # noqa: E402
    NEAR_MAX_CAP, NEAR_WARPS, SHARED_LIMIT, near_plan, slots_near,
    slots_near_reference)
from nbodyax_torch.physics.slotpack_kernel import (  # noqa: E402
    MOMENT_CHUNK, moment_plan, pack_slots)
from test_torch_kernels import (  # noqa: E402
    CHUNK_COUNTS, LIVE_COUNTS, chunk_counts_state, manual_slot_grid,
    tie_slot_grid)

MODES = ["reference", "momentum", "elastic", "none"]
NEAR_GATE = 2e-5    # of the channel's largest value (test_barneshut.py:385)


@pytest.mark.parametrize("L", [6, 8])
@pytest.mark.parametrize("ring", [1, 2])
@pytest.mark.parametrize("S", [40, 48, 1024])
def test_near_plan_fits_shared_memory(S, ring, L):
    cap, nbytes = near_plan(S, ring, L)
    assert cap == NEAR_MAX_CAP          # every such window exceeds it
    assert nbytes <= SHARED_LIMIT
    assert nbytes == NEAR_WARPS * (cap * (7 if L == 8 else 5) + 32) * 4
    assert nbytes % (16 * NEAR_WARPS) == 0   # each warp's float4s aligned


@pytest.mark.parametrize("S,ring,want", [(1, 1, 32), (4, 1, 64),
                                         (15, 1, 160), (25, 1, 256),
                                         (10, 2, 256), (2, 2, 64)])
def test_near_plan_small_windows(S, ring, want):
    """A window smaller than the largest capacity is staged whole:
    (2 ring + 1)^2 S rounded up to 32."""
    assert near_plan(S, ring, 6)[0] == want


@pytest.mark.parametrize("n,chunks", [(0, 0), (1, 1), (MOMENT_CHUNK - 1, 1),
                                      (MOMENT_CHUNK, 1), (1 << 20, 4096)])
def test_moment_plan(n, chunks):
    assert moment_plan(n) == (chunks, chunks * 12)


def nbodyax_slots_near(fslot, mode, eps2, g, ring, ci):
    """nbodyax's per-pair rules (``_gathered_pair_accum``, the oracle its
    own Pallas near kernel is held to) over each cell's first ci slots
    against every slot of its window, clipped to the grid. A cell row at a
    time; returns the accumulators of every slot, [g * g * ci]."""
    ncells, S, L = fslot.shape
    rest = 4 if mode == "elastic" else 2
    grid = fslot.numpy().reshape(g, g, S, L)
    parts = []
    for cy in range(g):
        fi, fj = [], []
        for cx in range(g):
            fi.append(grid[cy, cx, :ci])
            win = np.zeros((2 * ring + 1, 2 * ring + 1, S, L), np.float32)
            for dy in range(-ring, ring + 1):
                for dx in range(-ring, ring + 1):
                    y, x = cy + dy, cx + dx
                    if 0 <= y < g and 0 <= x < g:
                        win[dy + ring, dx + ring] = grid[y, x]
            fj.append(np.broadcast_to(win.reshape(-1, L), (ci, win[..., 0].size,
                                                           L)))
        fi = np.concatenate(fi)
        fj = np.concatenate(fj)

        def lanes(f):
            ids = (f[..., rest + 2].astype(np.int64) * 4096
                   + f[..., rest + 3].astype(np.int64)).astype(np.int32)
            vel = f[..., 2:4] if mode == "elastic" else np.zeros_like(
                f[..., 0:2])
            return (jnp.asarray(f[..., 0:2]), jnp.asarray(vel),
                    jnp.asarray(f[..., rest]), jnp.asarray(f[..., rest + 1]),
                    jnp.asarray(ids))
        parts.append(jbh._gathered_pair_accum(
            *lanes(fi), *lanes(fj), eps2=jnp.float32(eps2),
            growth_rate=jnp.float32(0.1), mode=mode))
    return type(parts[0])(*(np.concatenate([np.asarray(x) for x in xs])
                            for xs in zip(*parts)))


def assert_near_matches_nbodyax(got, want, mode):
    """Every slot, live or not: float channels within NEAR_GATE of the
    channel's largest value, died and the parent id exact."""
    got = got.reshape(-1, 8)
    chans = {"reference": [("gained_mass", 2), ("gained_radius", 3)],
             "momentum": [("best_mass", 2)], "elastic": [("dv", 2)],
             "none": []}[mode]
    for name, c in [("force", 0)] + chans:
        w = np.asarray(getattr(want, name), np.float32).reshape(len(got), -1)
        k = got[:, c:c + w.shape[1]].numpy()
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(k), fin, err_msg=name)
        w, k = np.where(fin, w, 0.0), np.where(fin, k, 0.0)
        err = np.abs(k - w).max()
        assert err <= NEAR_GATE * max(np.abs(w).max(), 1e-30), name
    if mode == "reference":
        np.testing.assert_array_equal(got[:, 4].numpy() > 0.5, want.died)
    if mode == "momentum":
        parent = bh_grid._unpack_id(got[:, 3], got[:, 4]).numpy()
        np.testing.assert_array_equal(parent, want.parent)


@pytest.mark.parametrize("ring", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_slots_near_reference_matches_nbodyax_edge_cases(mode, ring):
    """Cells of 0-40 live slots with a dead body mid-cell (live slots not a
    prefix), every cell of the 8 x 8 grid within ring 2 of a corner or an
    edge, ids from 2^25, eps 0 and 10; the CPU wrapper is the plain
    version."""
    fslot = manual_slot_grid(8, 48, LIVE_COUNTS, 21, mode == "elastic",
                             id_base=(1 << 25) + 3)
    for eps in (0.0, 10.0):
        kw = dict(mode=mode, eps2=eps * eps, growth=0.1, g=8, ring=ring,
                  ci=40)
        got = slots_near_reference(fslot, **kw)
        assert torch.equal(slots_near(fslot, **kw), got)
        want = nbodyax_slots_near(fslot, mode, eps * eps, 8, ring, 40)
        assert_near_matches_nbodyax(got, want, mode)


def test_slots_near_reference_momentum_tie():
    fslot = tie_slot_grid(8)
    got = slots_near_reference(fslot, mode="momentum", eps2=0.0, growth=0.1,
                               g=2, ring=1, ci=8)
    want = nbodyax_slots_near(fslot, "momentum", 0.0, 2, 1, 8)
    assert_near_matches_nbodyax(got, want, "momentum")
    assert [int(x) for x in got[0, :2, 4]] == [5, 5]


@pytest.mark.parametrize("case", ["chunk_edges", "crowded_cell"])
def test_pack_slots_plain_matches_nbodyax_at_chunk_edges(case):
    """The plain versions behind ``pack_slots`` on a CPU tensor against
    nbodyax: rows bitwise, moments within 2e-6 of max(per-channel scale,
    1)."""
    if case == "chunk_edges":
        levels, counts = 2, CHUNK_COUNTS
    else:
        levels, counts = 5, [0] * 1024
        counts[517], counts[300] = 2000, 300
        counts[0] = counts[-1] = 1
    arrays = chunk_counts_state(counts, levels, 31)
    pos, vel, mass, radius = arrays
    g, n, S = 1 << levels, pos.shape[0], 40
    je = jbh._extent(jnp.asarray(pos), jnp.asarray(mass) > 0)
    te = bh_grid._extent(torch.from_numpy(pos), torch.from_numpy(mass) > 0)
    js = jbh._partner_structure(*map(jnp.asarray, arrays), je, g, False)
    ts = bh_grid._partner_structure(*map(torch.from_numpy, arrays), te, g,
                                    False)
    assert (ts[3] - ts[2]).tolist() == counts
    rows, mom = pack_slots(ts[4], ts[2], ts[3], S,
                           moments=(torch.from_numpy(pos),
                                    torch.from_numpy(mass), te, levels))
    want = np.asarray(jbh._build_slot_grid(js[4], js[2], js[3], n, g * g, S))
    np.testing.assert_array_equal(rows.numpy(), want)
    jm = np.asarray(jbh._finest_moments_scatter(jnp.asarray(pos),
                                                jnp.asarray(mass), je,
                                                levels))
    scale = np.maximum(np.abs(jm).max(axis=0), 1.0)
    assert (np.abs(mom.numpy() - jm).max(axis=0) <= 2e-6 * scale).all()
