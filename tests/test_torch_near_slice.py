"""B3's cell-slice form, the sharded bh step's (``cell_base`` /
``ncells_eval``), against nbodyax on the CPU.

``slots_near_reference`` over a slice of the cells of a random slot grid
(empty, partly filled and full cells; no dead bodies, which nbodyax's
callers sort out of the grid) against nbodyax's
``slots_near_raw(..., cell_base, ncells_eval, interpret=True)``: force
within 2e-5 of the largest |force| (B3's gate), the other float channels
to 2e-5 of their largest magnitude, flags (nbodyax's died count > 0) and
ids exact, on every slot that holds a live body (the Pallas kernel leaves
the other slots' channels unspecified; the port writes their "none"
values). In 2-D at ring 1 and 2 and in 3-D at ring 1, on slices 1 and 3
of four. In 3-D at ring 2 nbodyax's kernel takes about nine minutes to
compile in interpret mode on a CPU, so there the slice is held bit for
bit to the rows of the whole-grid plain version, which
``tests/test_torch_bh_3d_near.py`` holds to nbodyax. Every case also
checks that the slices tile the whole grid bit for bit, and the wrapper
refuses a slice that leaves the grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.physics.near_pallas import NUM_CH, slots_near_raw  # noqa: E402
from nbodyax_torch.physics.near_kernel import (slots_near,  # noqa: E402
                                               slots_near_reference)

MODES = ("reference", "momentum", "elastic", "none")
# (dim, g, S, ci, ring, nbodyax's interpret-mode kernel as the reference)
CASES = [(2, 8, 16, 8, 1, True), (2, 8, 16, 8, 2, True),
         (3, 4, 16, 8, 1, True), (3, 4, 16, 8, 2, False)]
SHARDS = 4


def slot_grid(dim, g, S, mode, seed):
    """f32[g^dim, S, L]: each cell holds 0..S live bodies inside it, with
    global ids; velocities in elastic mode."""
    rng = np.random.RandomState(seed)
    ncells = g ** dim
    rest = 2 * dim if mode == "elastic" else dim
    f = np.zeros((ncells, S, rest + 4), np.float32)
    counts = rng.randint(0, S + 1, ncells)
    counts[0] = S                                  # a full cell
    for c in range(ncells):
        k = counts[c]
        corner = np.array([(c // g ** d) % g for d in range(dim)])
        f[c, :k, :dim] = (corner[None] + rng.rand(k, dim)) * 10.0
        if mode == "elastic":
            f[c, :k, dim:2 * dim] = rng.randn(k, dim)
        f[c, :k, rest] = rng.uniform(1, 100, k)
        f[c, :k, rest + 1] = rng.uniform(0.5, 4, k)
        ids = c * S + np.arange(k)
        f[c, :k, rest + 2] = ids // 4096
        f[c, :k, rest + 3] = ids % 4096
    return f


def nbodyax_slice(f, mode, g, ring, dim, ci, base, ne):
    """nbodyax's kernel over cells [base, base + ne), as [ne, ci, 8]."""
    ncells, S, L = f.shape
    padc = ring * sum(g ** d for d in range(dim))
    jrows = np.pad(f.transpose(0, 2, 1), ((padc, padc),
                                          (0, -(-L // 8) * 8 - L),
                                          (0, -(-S // 128) * 128 - S)))
    raw = slots_near_raw(jnp.asarray(jrows), mode=mode, eps2=1.0, growth=0.1,
                         g=g, ring=ring, dim=dim, S=S, ci=ci, L=L,
                         cell_base=base, ncells_eval=ne, interpret=True)
    return np.asarray(raw).reshape(ne, NUM_CH, ci).transpose(0, 2, 1)


def assert_channels_match(got, want, live, mode, dim):
    got, want = got[live], want[live]
    if mode == "reference":
        # nbodyax counts the heavier overlapping partners; the port flags
        # any (the step reads count > 0)
        want[:, dim + 2] = want[:, dim + 2] > 0
    for ch in range(NUM_CH):
        a, b = got[:, ch], want[:, ch]
        exact = (mode == "reference" and ch == dim + 2) or (
            mode == "momentum" and ch > dim)
        if mode == "momentum" and ch == dim:
            exact = True                   # best mass: a partner's, or -inf
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=f"channel {ch}")
        else:
            scale = max(np.abs(b).max(), 1e-30)
            assert np.abs(a - b).max() <= 2e-5 * scale, ch


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}d-ring{c[4]}" for c in CASES])
def test_slice_matches_nbodyax(case, mode):
    dim, g, S, ci, ring, oracle = case
    f = slot_grid(dim, g, S, mode, seed=ring + 10 * dim)
    t = torch.from_numpy(f)
    kw = dict(mode=mode, eps2=1.0, growth=0.1, g=g, ring=ring, ci=ci,
              dim=dim)
    full = slots_near_reference(t, **kw)
    ne = g ** dim // SHARDS
    rest = 2 * dim if mode == "elastic" else dim
    parts = []
    for shard in range(SHARDS):
        got = slots_near(t, cell_base=shard * ne, ncells_eval=ne, **kw)
        assert got.shape == (ne, ci, NUM_CH)
        parts.append(got)
        if oracle and shard in (1, SHARDS - 1):
            live = f[shard * ne:(shard + 1) * ne, :ci, rest] > 0
            assert live.any()
            want = nbodyax_slice(f, mode, g, ring, dim, ci, shard * ne, ne)
            assert_channels_match(got.numpy(), want, live, mode, dim)
    assert torch.equal(torch.cat(parts), full)


def test_slice_past_the_grid_is_refused():
    t = torch.from_numpy(slot_grid(2, 4, 8, "reference", 0))
    kw = dict(mode="reference", eps2=1.0, growth=0.1, g=4, ring=1, ci=8)
    for base, ne in ((12, 8), (-1, 4), (16, 1)):
        with pytest.raises(ValueError, match="leaves the grid"):
            slots_near(t, cell_base=base, ncells_eval=ne, **kw)
    assert slots_near(t, cell_base=12, ncells_eval=4, **kw).shape[0] == 4
