"""nbodyax_torch's bh near field in 3-D against nbodyax on the CPU.

``_near_field_cells`` at ``dim = 3`` (slots and rows engines, every
collision mode) is held to nbodyax's jnp engines (``pallas_near=False``;
nbodyax's own tests hold its Pallas kernel to them) on a state with a
crowded cell (the completion pass), a dead body and grid faces, at the
gates of tests/test_barneshut.py:376-388: float channels within 2e-5 of the
channel's largest value, ``died`` and ``parent`` exact; the momentum cases
run at eps = 0 and the none cases with the 5 x 5 x 5 windows of ring 2. The slots engine here is B3's plain
version (``slots_near_reference`` at ``dim = 3``), which the CUDA kernel is
held to on the card.
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
from test_torch_bh_near import MODES, assert_accumulators_close  # noqa: E402
from test_torch_bh_stages import both_ext  # noqa: E402


def crowded_state_3d(n=1024, seed=5):
    """tests/test_barneshut.py:360-367's state in 3-D: 150 bodies crowd the
    centre cell (past the slot budget, so the completion pass runs), body 7
    is dead, the rest reach the grid edges; radii 20-60 overlap often."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1000, 1000, (n, 3)).astype(np.float32)
    pos[-150:] = rng.uniform(-40, 40, (150, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(20, 60, n).astype(np.float32)
    return pos, vel, mass, radius


def near_both(arrays, mode, near, eps, levels=2, ring=1, k=40, ci=32):
    pos, vel, mass, radius = arrays
    je, te = both_ext(pos, mass)
    eps2 = np.float32(eps) * np.float32(eps)
    want = jbh._near_field_cells(pos, vel, mass, radius, je, levels, ring,
                                 jnp.float32(eps2), jnp.float32(0.1), mode,
                                 k, ci_cap=ci, near=near, pallas_near=False)
    got = tbh._near_field_cells(*map(torch.from_numpy, arrays), te, levels,
                                ring, float(eps2), 0.1, mode, k, ci_cap=ci,
                                near=near)
    return got, want


# ring and softening of each mode's two cases: the 5 x 5 x 5 windows of
# ring 2 (clipped by the 4 x 4 x 4 grid on every side) ride on the none
# mode, eps = 0 (the guarded rsqrt) on the momentum mode
SETTINGS = {"reference": (1, 50.0), "momentum": (1, 0.0),
            "elastic": (1, 50.0), "none": (2, 10.0)}


@pytest.mark.parametrize("near", ["slots", "rows"])
@pytest.mark.parametrize("mode", MODES)
def test_near_field_cells_3d_matches_nbodyax(mode, near):
    """Both engines over a 4 x 4 x 4 grid with a crowded centre (150 bodies
    against a slot budget of 32: the completion pass), a dead body and
    every cell on the grid's edge."""
    ring, eps = SETTINGS[mode]
    got, want = near_both(crowded_state_3d(), mode, near, eps=eps, ring=ring)
    assert_accumulators_close(got, want, mode)
    if mode == "reference":
        assert np.asarray(want.died).any()
    if mode == "momentum":
        assert (np.asarray(want.parent) != np.arange(1024)).any()


def test_near_field_3d_ring2_elastic():
    """Ring 2 with rows of 10 floats on the slots engine."""
    got, want = near_both(crowded_state_3d(), "elastic", "slots", eps=10.0,
                          ring=2)
    assert_accumulators_close(got, want, "elastic")


@pytest.mark.parametrize("mode", MODES)
def test_slots_near_wrapper_3d_runs_the_plain_version_on_cpu(mode):
    """On a CPU tensor the B3 wrapper at dim = 3 is its plain version, bit
    for bit, with the force in channels 0-2 and the mode's channels at 3-5,
    and counts no launch."""
    pos, vel, mass, radius = crowded_state_3d(400, 3)
    te = bh_grid._extent(torch.from_numpy(pos), torch.from_numpy(mass) > 0)
    st = bh_grid._partner_structure(
        *map(torch.from_numpy, (pos, vel, mass, radius)), te, 2,
        mode == "elastic")
    fslot = build_slot_grid_reference(st[4], st[2], st[3], 400, 8, 48)
    kw = dict(mode=mode, eps2=25.0, growth=0.1, g=2, ring=1, ci=32, dim=3)
    before = slots_near.launches
    a = slots_near(fslot, **kw)
    b = slots_near_reference(fslot, **kw)
    assert a.shape == (8, 32, 8) and torch.equal(a, b)
    assert slots_near.launches == before
    assert a[..., 2].abs().max() > 0            # a z force
    used = {"reference": 6, "momentum": 6, "elastic": 6, "none": 3}[mode]
    assert not a[..., used:].any()
    if mode != "none":
        assert a[..., 3:6].abs().max() > 0
