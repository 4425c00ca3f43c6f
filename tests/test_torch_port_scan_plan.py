"""K8's launch plan and association (`map_tpu_torch/ops/scan.py`), on the CPU.

K8 scans (n, W) in one cooperative launch: `plan` fixes the tile rows, the
tiles, the grid (at most one block an SM), the rounds, the segments a tile
is summed in and the runs its carry is summed in; the association follows
from the plan alone, so every call gives the same bits on one card.
`block_cumsum_order` computes that association in PyTorch ops, and the card
tests hold the kernel to it bit for bit. Here the plan is held to what the
kernel (`csrc/block_cumsum.cu`) needs: every row in one tile and one
segment, every tile in one round and one run, shared memory within the
H100's opt-in, 16-byte-aligned tiles; and the association to a float64
scan and to map_tpu's Pallas `block_cumsum` (interpret mode) within
TOL_SCAN (1e-6 of the largest prefix of |x|), the same bits twice, and
exact where every partial sum is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu.ops import pallas_scan
from map_tpu_torch.ops import scan

TOL_SCAN = 1e-6
SMEM_OPTIN = 232_448

# (n, w, SMs): n = 1, n not a multiple of a tile, the MFP folds' shapes
# (the per-position fold's spans 4 rounds on 132 SMs), widths 1, 33 and 128,
# and few SMs, so that a small n spans several rounds
SHAPES = [(1, 1, 132), (1, 33, 132), (1, 128, 132), (1000, 33, 132), (1001, 1, 132),
          (2400, 33, 132), (28_672, 33, 132), (745_472, 33, 132), (5000, 128, 132),
          (60_000, 1, 132), (50_000, 33, 4), (9_999, 128, 3), (70_001, 1, 2),
          (3_000_000, 33, 132), (400_001, 128, 132)]


def _tol(x: torch.Tensor) -> float:
    return TOL_SCAN * float(x.double().abs().cumsum(0).max())


@pytest.mark.parametrize("n,w,sms", SHAPES)
def test_plan_covers_every_row_once(n, w, sms):
    p = scan.plan(n, w, sms)
    assert p.tile_rows % scan.ROW_ALIGN == 0
    assert p.tiles * p.tile_rows >= n > (p.tiles - 1) * p.tile_rows
    assert 1 <= p.grid <= min(sms, p.tiles)
    assert p.grid * p.rounds >= p.tiles > p.grid * (p.rounds - 1)
    assert p.segs * w <= scan.THREADS and p.segs * p.seg_rows >= p.tile_rows
    assert p.part_tiles * p.segs >= p.grid
    assert p.smem == scan.smem_bytes(p.tile_rows, w, p.segs) <= SMEM_OPTIN
    assert p.tile_rows * w * 4 <= scan.TILE_BYTES
    # block b of round r takes tile r * grid + b; thread (s, c) of it takes
    # rows [s * seg_rows, (s + 1) * seg_rows) of its tile, column c
    b, r, s = np.meshgrid(np.arange(p.grid), np.arange(p.rounds), np.arange(p.segs),
                          indexing="ij")
    tile = r * p.grid + b
    lo = tile * p.tile_rows + s * p.seg_rows
    hi = np.minimum(np.minimum(lo + p.seg_rows, (tile + 1) * p.tile_rows), n)
    keep = (tile < p.tiles) & (hi > lo)
    hits = np.zeros(n + 1, np.int64)
    np.add.at(hits, lo[keep], 1)
    np.add.at(hits, hi[keep], -1)
    assert (np.cumsum(hits)[:n] == 1).all()
    # a round's tiles in runs of part_tiles, one a thread: each tile in one run
    for rr in range(p.rounds):
        count = min(p.grid, p.tiles - rr * p.grid)
        assert -(-count // p.part_tiles) <= p.segs


def test_plan_balances_the_rounds_of_the_per_position_fold():
    p = scan.plan(745_472, 33)
    assert (p.rounds, p.grid, p.tiles) == (4, 132, 528)
    assert p.tile_rows * 33 * 4 <= scan.TILE_BYTES


def test_plan_keeps_small_tiles_at_least_min_tile_bytes():
    p = scan.plan(2400, 33)
    assert p.tile_rows * 33 * 4 >= scan.MIN_TILE_BYTES and p.rounds == 1


@pytest.mark.parametrize("n,w", [(0, 4), (10, 0), (10, 129)])
def test_plan_refuses_what_the_kernel_does_not_take(n, w):
    with pytest.raises(ValueError):
        scan.plan(n, w)


@pytest.mark.parametrize("n,w,sms", [s for s in SHAPES if s[0] * s[1] <= 2_000_000])
def test_order_is_fixed_and_within_tol_of_float64(n, w, sms):
    g = torch.Generator().manual_seed(n + w)
    x = torch.randn(n, w, generator=g) * 1e-3
    p = scan.plan(n, w, sms)
    got = scan.block_cumsum_order(x, p)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert torch.equal(got, scan.block_cumsum_order(x, p))
    tol = _tol(x)
    assert float((got.double() - x.double().cumsum(0)).abs().max()) <= tol
    assert float((got - scan.block_cumsum_plain(x)).abs().max()) <= 2 * tol


@pytest.mark.parametrize("n,w,sms", [(1, 1, 132), (4097, 33, 132), (50_000, 33, 4),
                                     (9_999, 128, 3)])
def test_order_is_exact_where_every_partial_sum_is(n, w, sms):
    # small integers: every partial sum is exact in float32 under any
    # association, so the emulation must equal the exact scan: each row
    # added once, in its own place
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-8, 9, (n, w)).astype(np.float32))
    got = scan.block_cumsum_order(x, scan.plan(n, w, sms))
    assert torch.equal(got, x.double().cumsum(0).float())


def test_order_is_not_the_plain_running_sum():
    # ill-conditioned values (+-1e4 beside 1e-3): the plan's association
    # gives other bits than a running sum, so the emulation pins it
    rng = np.random.default_rng(3)
    n, w = 20_000, 33
    big = rng.random((n, w)) < 0.5
    x = torch.from_numpy(np.where(big, 1e4 * rng.standard_normal((n, w)),
                                  1e-3 * rng.standard_normal((n, w))).astype(np.float32))
    got = scan.block_cumsum_order(x, scan.plan(n, w))
    assert not torch.equal(got, scan.block_cumsum_plain(x))
    assert float((got.double() - x.double().cumsum(0)).abs().max()) <= _tol(x)


def test_order_matches_map_tpu_pallas_block_cumsum():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2048, 128)) * 1e-3).astype(np.float32)
    ref = np.array(pallas_scan.block_cumsum(jnp.asarray(x), interpret=True))
    xt = torch.from_numpy(x)
    got = scan.block_cumsum_order(xt, scan.plan(2048, 128))
    tol = _tol(xt)
    assert float(np.abs(got.numpy().astype(np.float64) - ref).max()) <= 2 * tol
    assert float((torch.from_numpy(ref).double() - xt.double().cumsum(0)).abs().max()) <= tol


def test_cpu_route_is_the_plain_version():
    x = torch.randn(300, 7, generator=torch.Generator().manual_seed(1))
    before = scan.launches
    assert torch.equal(scan.block_cumsum(x), scan.block_cumsum_plain(x))
    assert scan.launches == before  # the CPU route launches nothing
