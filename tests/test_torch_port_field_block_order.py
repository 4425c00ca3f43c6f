"""The order contract of K6b (`map_tpu_torch/ops/field_gather.py`), on the CPU.

K6b sums each tile row in float32, from 0.0, in the order of (pair, b), a
tile's pairs in pos order; its plain version, which the CPU takes, adds in
that order too, so the two give the same bits on the card. Here the plain
version is held, bit for bit, to a float32 running sum in (pair, b) order on
the hit patterns that decide the order: rows hit by several pairs (ids in a
field's tile but outside its window), one hot row, a tile whose pairs all
carry -1, and a ragged last tile; on ill-conditioned gradients (mixed
+-1e4..2e4 and 1e-3), where another order gives other bits. And it is held
to map_tpu's Pallas kernel in interpret mode, within 1e-6, on dyadic
gradients whose sums are exact in any order (map_tpu sums by one-hot
matmuls in another order). K6b's work list, built once per plan, is held to
cover every (tile, row) once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import map_tpu.ops.pallas_field_gather as jax_pfg
from map_tpu_torch.ops import field_gather

W = 16
TILE = field_gather.TILE


def _case(kind: str, rng: np.random.Generator):
    """-> (small, r, phys (Fs, b) int32)."""
    if kind == "multi_pair":
        # fields 0 and 1 share tile 0, field 2 spans tiles 0-1: ids of field 0
        # on field 1's rows and of field 2 on fields 0-1's rows still count
        small, r, b = ((0, 10, 14), (1, 14, 40), (2, 40, 700)), 1024, 160
        phys = np.stack([rng.integers(plo, pe, b) for _, plo, pe in small])
        phys[0, ::3] = rng.integers(14, 40, phys[0, ::3].shape)
        phys[2, ::5] = rng.integers(10, 40, phys[2, ::5].shape)
        phys[1, ::7] = -1
    elif kind == "hot_row":  # a 4-id field, most of the batch on one row
        small, r, b = ((0, 10, 14), (1, 14, 600)), 1024, 256
        phys = np.stack([rng.integers(plo, pe, b) for _, plo, pe in small])
        phys[0, rng.random(b) < 0.9] = 12
    elif kind == "empty_tile":  # tile 1's only pair carries -1 throughout
        small, r, b = ((0, 10, 30), (1, 600, 700), (2, 1100, 1200)), 1536, 128
        phys = np.stack([rng.integers(plo, pe, b) for _, plo, pe in small])
        phys[1] = -1
    else:  # ragged_last_tile: an unpadded table, the last tile runs past r
        small, r, b = ((0, 20, 30), (1, 30, 1100), (2, 1290, 1300)), 1300, 200
        phys = np.stack([rng.integers(plo, pe, b) for _, plo, pe in small])
        phys[0, ::7] = -1
    return small, r, phys.astype(np.int32)


KINDS = ["multi_pair", "hot_row", "empty_tile", "ragged_last_tile"]


def _ill_conditioned(shape, rng: np.random.Generator) -> np.ndarray:
    big = rng.random(shape) < 0.5
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    mag = np.where(big, 1e4 * (1 + rng.random(shape)), 1e-3 * rng.random(shape))
    return (sign * mag).astype(np.float32)


def _running_sum(g: np.ndarray, phys: np.ndarray, small, r, reverse=False) -> np.ndarray:
    """The (U, TILE, W) stack summed in float32 from 0.0 in order of (pair, b),
    a tile's pairs in pos order (or the reverse of that order)."""
    fs, b = phys.shape
    utiles, pairs = field_gather.plan_pairs(small, r)
    out = np.zeros((len(utiles), TILE, W), np.float32)
    order = [(pos, s, row0, bb) for pos, s, row0 in sorted(pairs, key=lambda p: (p[1], p[0]))
             for bb in range(b)]
    for pos, s, row0, bb in (order[::-1] if reverse else order):
        rel = int(phys[pos, bb]) - row0
        if phys[pos, bb] >= 0 and 0 <= rel < TILE:
            out[s, rel] = out[s, rel] + g[bb, pos * W:(pos + 1) * W]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_sums_each_row_in_pair_b_order(kind, dtype):
    rng = np.random.default_rng(5)
    small, r, phys = _case(kind, rng)
    g = torch.from_numpy(_ill_conditioned((phys.shape[1], len(small) * W), rng)).to(dtype)
    before = field_gather.scatter_launches
    got = field_gather.field_block_scatter(g, torch.from_numpy(phys), small, r).numpy()
    assert field_gather.scatter_launches == before  # the CPU route launches nothing
    want = _running_sum(g.float().numpy(), phys, small, r)
    assert np.array_equal(got, want)
    if kind == "empty_tile":
        utiles, _ = field_gather.plan_pairs(small, r)
        assert not got[utiles.index(1)].any()
    if kind == "hot_row" and dtype == torch.float32:
        # the order matters on these values: the reversed order gives other bits
        assert not np.array_equal(_running_sum(g.numpy(), phys, small, r, reverse=True), want)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_add_leaves_other_rows_and_adds_the_tiles(kind):
    rng = np.random.default_rng(6)
    small, r, phys = _case(kind, rng)
    g = torch.from_numpy(_ill_conditioned((phys.shape[1], len(small) * W), rng))
    base = torch.from_numpy(rng.normal(size=(r, W)).astype(np.float32))
    added = field_gather.field_block_scatter_add(base.clone(), g, torch.from_numpy(phys), small)
    utiles, _ = field_gather.plan_pairs(small, r)
    stack = torch.from_numpy(_running_sum(g.numpy(), phys, small, r))
    assert torch.equal(added, base + field_gather.assemble_dense(stack, utiles, r))
    outside = torch.ones(r, dtype=torch.bool)
    for t in utiles:
        outside[t * TILE:(t + 1) * TILE] = False
    assert torch.equal(added[outside], base[outside])


@pytest.mark.parametrize("kind", ["multi_pair", "hot_row", "empty_tile"])
def test_plain_matches_map_tpu_pallas(kind):
    rng = np.random.default_rng(8)
    small, r, phys = _case(kind, rng)
    # multiples of 2**-8 below 8 in size: every partial sum is exact
    g = (np.round(rng.normal(size=(phys.shape[1], len(small) * W)) * 256) / 256).astype(
        np.float32)
    ref = np.asarray(jax_pfg.field_block_scatter(jnp.asarray(g), jnp.asarray(phys), small, r,
                                                 interpret=True))
    got = field_gather.field_block_scatter(torch.from_numpy(g), torch.from_numpy(phys),
                                           small, r).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# the canonical layout: bench.py's 5-core-Avazu field sizes, 21 small fields
CANONICAL_SIZES = [7, 7, 24, 26, 4100, 7600, 26, 8500, 560, 36, 8200, 5, 4, 2600, 8, 450,
                   70, 170, 60, 30, 26]


def _canonical():
    lo = np.cumsum([10] + CANONICAL_SIZES[:-1])
    small = tuple((pos, int(a), int(a + s)) for pos, (a, s) in
                  enumerate(zip(lo, CANONICAL_SIZES)))
    return small, int(lo[-1] + CANONICAL_SIZES[-1])


@pytest.mark.parametrize("b", [1, 256, 4096])
@pytest.mark.parametrize("kind", KINDS + ["canonical"])
def test_work_list_covers_every_tile_row_once_and_keeps_pairs_in_pos_order(kind, b):
    if kind == "canonical":
        small, r = _canonical()
    else:
        small, r, _ = _case(kind, np.random.default_rng(0))
    utiles, pairs = field_gather.plan_pairs(small, r)
    plan = field_gather._scatter_plan(small, r, b, torch.device("cpu"))
    covered, slots, tile_pairs = [], [], {}
    for slot, row0, first, packed in plan.work.tolist():
        count, q, slices = packed & 0xFFF, (packed >> 12) & 0xFF, 1 << (packed >> 20)
        assert row0 == utiles[slot] * TILE
        assert field_gather.MIN_SLICES <= slices <= field_gather.MAX_SLICES
        covered += [(slot, row) for row in range(q, TILE, slices)]
        slots.append(slot)
        tile_pairs[slot] = plan.pair_pos[first:first + count].tolist()
    # block q of a tile's n sums rows q, q + n, ...: every (tile, row) once
    assert sorted(covered) == [(s, row) for s in range(len(utiles)) for row in range(TILE)]
    for s in range(len(utiles)):
        assert tile_pairs[s] == sorted(p for p, ps, _ in pairs if ps == s)
    assert plan.most_pairs == max(len(v) for v in tile_pairs.values())
    # a tile's blocks are consecutive, the tiles in work order
    assert list(dict.fromkeys(slots)) == list(field_gather.work_order(small, r))
    for s in set(slots):
        at = [i for i, x in enumerate(slots) if x == s]
        assert at == list(range(at[0], at[0] + len(at)))
    if kind == "canonical":
        # the 4- and 5-id fields' tile and the four tiny fields' tile go first,
        # and at b = 4096 they take the most blocks
        assert [utiles[s] for s in dict.fromkeys(slots)][:2] == [56, 0]
        if b == 4096:
            assert slots.count(slots[0]) == field_gather.MAX_SLICES
