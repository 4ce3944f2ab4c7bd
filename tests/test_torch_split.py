"""The partner-split choice of the all-pairs kernels (B1 forward, B2
backward), a pure function of the call's shape and the card's block slots,
so it runs on the CPU. The kernels themselves are held to their plain
versions in tests/test_torch_kernels.py, on the card."""

import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch.physics.kernels import (  # noqa: E402
    MIN_SPLIT_PARTNERS, choose_splits)

SLOTS = 132 * 6        # an H100's 132 SMs at six resident blocks


@pytest.mark.parametrize("row_blocks,partners", [
    (0, 16384), (32, 0), (0, 0), (-1, 5)])
def test_empty_calls_take_one_split(row_blocks, partners):
    assert choose_splits(row_blocks, partners, SLOTS) == 1


@pytest.mark.parametrize("row_blocks", [SLOTS, SLOTS + 1, 10 * SLOTS])
def test_rows_that_fill_the_card_take_one_split(row_blocks):
    assert choose_splits(row_blocks, 1 << 20, SLOTS) == 1


@pytest.mark.parametrize("partners", [1, 130, MIN_SPLIT_PARTNERS - 1])
def test_few_partners_take_one_split(partners):
    """Nj = 1 or 130 against many rows, or any call under one tile."""
    assert choose_splits(1, partners, SLOTS) == 1


@pytest.mark.parametrize("row_blocks,partners", [
    (1, 16384), (1, 1 << 24), (2, 16384), (32, 16384), (64, 16384),
    (256, 131072), (5, 5077), (SLOTS // 2, 1 << 20)])
def test_splits_fill_one_wave_and_keep_a_tile(row_blocks, partners):
    s = choose_splits(row_blocks, partners, SLOTS)
    assert s >= 1
    assert s * row_blocks <= max(SLOTS, row_blocks)
    assert s == 1 or partners // s >= MIN_SPLIT_PARTNERS
    # one more split would overfill the wave or cut a split under a tile
    assert ((s + 1) * row_blocks > SLOTS
            or partners // (s + 1) < MIN_SPLIT_PARTNERS)


def test_default_scene_shapes():
    """N = 16,384: 32 forward row blocks of 512 rows split 24 ways; one row
    against N partners is capped by the tile rule; the backward's 128 row
    blocks (two sides of 256 rows) split 6 ways."""
    assert choose_splits(32, 16384, SLOTS) == 24
    assert choose_splits(1, 16384, SLOTS) == 16384 // MIN_SPLIT_PARTNERS
    assert choose_splits(128, 16384, SLOTS) == 6
