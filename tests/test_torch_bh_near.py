"""nbodyax_torch's bh near field against nbodyax on the CPU.

``_near_field_cells`` (slots and rows engines, every collision mode) is held
to nbodyax's jnp engines (``pallas_near=False``; nbodyax's own tests hold
its Pallas kernel to them) on a state with a crowded cell (the completion
pass), a dead body and grid edges, at the gates of
tests/test_barneshut.py:376-388: float channels within 2e-5 of the
channel's largest value, ``died`` and ``parent`` exact. The slots engine
here is B3's plain version (``slots_near_reference``), which the CUDA
kernel is held to on the card. The giant pass is in
test_torch_bh_giants.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax.physics import barneshut as jbh  # noqa: E402
from nbodyax_torch.physics import barneshut as tbh  # noqa: E402
from nbodyax_torch.physics import bh_grid  # noqa: E402
from nbodyax_torch.physics.near_kernel import (  # noqa: E402
    slots_near, slots_near_reference)
from nbodyax_torch.physics.slotpack_kernel import \
    build_slot_grid_reference  # noqa: E402

MODES = ["reference", "momentum", "elastic", "none"]
FLOATS = {"reference": ["force", "gained_mass", "gained_radius"],
          "momentum": ["force", "best_mass"], "elastic": ["force", "dv"],
          "none": ["force"]}


def crowded_state(n=2048, seed=5):
    """test_barneshut.py:360-367's state: 200 bodies crowd the centre
    cell, body 7 is dead, the rest reach the grid edges."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
    pos[-200:] = rng.uniform(-20, 20, (200, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(1, 12, n).astype(np.float32)
    return pos, vel, mass, radius


def assert_accumulators_close(got, want, mode, gate=2e-5):
    for name in FLOATS[mode]:
        x = np.asarray(getattr(want, name))
        y = getattr(got, name).numpy()
        fin = np.isfinite(x)
        np.testing.assert_array_equal(np.isfinite(y), fin, err_msg=name)
        err = np.abs(np.where(fin, y, 0.0) - np.where(fin, x, 0.0)).max()
        scale = max(1e-30, np.abs(np.where(fin, x, 0.0)).max())
        assert err <= gate * scale, (name, err / scale)
    np.testing.assert_array_equal(got.died.numpy(), np.asarray(want.died))
    np.testing.assert_array_equal(got.parent.numpy(),
                                  np.asarray(want.parent))


def near_both(arrays, mode, near, eps, levels=4, ring=1, k=40, ci=32):
    pos, vel, mass, radius = arrays
    je = jbh._extent(jnp.asarray(pos), jnp.asarray(mass) > 0)
    te = bh_grid._extent(torch.from_numpy(pos), torch.from_numpy(mass) > 0)
    eps2 = np.float32(eps) * np.float32(eps)
    want = jbh._near_field_cells(pos, vel, mass, radius, je, levels, ring,
                                 jnp.float32(eps2), jnp.float32(0.1), mode,
                                 k, ci_cap=ci, near=near, pallas_near=False)
    got = tbh._near_field_cells(*map(torch.from_numpy, arrays), te, levels,
                                ring, float(eps2), 0.1, mode, k, ci_cap=ci,
                                near=near)
    return got, want


@pytest.mark.parametrize("near", ["slots", "rows"])
@pytest.mark.parametrize("mode", MODES)
def test_near_field_cells_matches_nbodyax(mode, near):
    arrays = crowded_state()
    got, want = near_both(arrays, mode, near, eps=50.0)
    assert_accumulators_close(got, want, mode)


@pytest.mark.parametrize("mode", ["reference", "momentum", "elastic"])
def test_near_field_unsoftened_and_ring2(mode):
    """eps = 0 (the guarded rsqrt, B3's non-eps_pos path) at ring 1, and
    the 5-cell windows of ring 2, on the slots engine."""
    arrays = crowded_state(1024, 8)
    got, want = near_both(arrays, mode, "slots", eps=0.0)
    assert_accumulators_close(got, want, mode)
    got, want = near_both(arrays, mode, "slots", eps=10.0, ring=2, levels=3)
    assert_accumulators_close(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
def test_slots_near_wrapper_runs_the_plain_version_on_cpu(mode):
    """On a CPU tensor the B3 wrapper is its plain version, bit for bit,
    and counts no launch; malformed grids are refused."""
    pos, vel, mass, radius = crowded_state(1024, 3)
    te = bh_grid._extent(torch.from_numpy(pos), torch.from_numpy(mass) > 0)
    st = bh_grid._partner_structure(
        *map(torch.from_numpy, (pos, vel, mass, radius)), te, 8,
        mode == "elastic")
    fslot = build_slot_grid_reference(st[4], st[2], st[3], 1024, 64, 40)
    kw = dict(mode=mode, eps2=25.0, growth=0.1, g=8, ring=1, ci=32)
    before = slots_near.launches
    a = slots_near(fslot, **kw)
    b = slots_near_reference(fslot, **kw)
    assert a.shape == (64, 32, 8) and torch.equal(a, b)
    assert slots_near.launches == before
    with pytest.raises(ValueError):
        slots_near(fslot[:, :, :5], **kw)
    with pytest.raises(ValueError):
        slots_near(fslot, **dict(kw, ci=41))

