"""Inclusive prefix sum over axis 0 (K8). Counterpart:
`map_tpu/ops/pallas_scan.py:block_cumsum`, built for the MFP decoder's fold
(`map_tpu/ops/dedup_scatter.py:_fold_stream2`); here it is the fold's scan
(`ops/dedup_scatter.py:sort_and_fold`), on the path of every MFP mode.

Kernel: `map_tpu_torch/csrc/block_cumsum.cu` (CUDA C++, sm_90a; a reduction
Triton would serve, written in CUDA to keep the one nvcc + ctypes build of
`kernels/build.py`).
- Replaces `pallas_scan.py:block_cumsum`, a sequential grid of 512-row
  blocks carrying the running sum in scratch, (n, 128) with n % 512 == 0.
  This one takes any n and any width up to 128.
- Bound on the H100: device-memory bytes, n * W * 4 read and written once;
  0.059 ms for the per-position fold's (745,472, 33) stream at 3.35 TB/s.
- Design: one cooperative launch of at most one block an SM, all resident
  at once, working in rounds. In a round each block holds one tile of rows
  in shared memory (brought by cp.async, 16-byte pieces where x and out are
  aligned), sums its columns, publishes the sums, crosses a grid barrier,
  computes its tile's carry from the round's tile sums in a fixed order,
  scans the tile in place and writes it out in 16-byte stores. x is read
  from device memory once and the scan written once. The plan (`plan`:
  tile rows, rounds, grid, segments, carry runs) is a pure function of the
  shape and the SM count, so the association, and every bit of the result,
  is the same on every call on one card; `block_cumsum_order` computes that
  association in PyTorch ops. No decoupled look-back: its association
  would depend on timing.

The plain version is what the fold did before K8: one `torch.cumsum` per
column, each column a contiguous 1-D tensor (PyTorch scans the columns of an
(n, W) tensor over dim 0 with one thread each, 261 ms for the fold's stream
on the H100). It sums in another order than the kernel: the two agree to
the rounding of the running prefix, not bit for bit.

CUDA tensors go to the kernel, CPU tensors to `block_cumsum_plain`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from map_tpu_torch.kernels import build

MAX_WIDTH = 128

# The kernel's geometry (block_cumsum.cu): threads a block; the most and
# the least bytes of x a tile holds (the most: one block an SM, and as few
# rounds as that allows; the least: a small input takes few blocks, which
# cross the barrier sooner); tile rows a multiple of 4, so that every tile
# starts 16-byte aligned at any W
THREADS = 512
TILE_BYTES = 200 * 1024
MIN_TILE_BYTES = 16 * 1024
ROW_ALIGN = 4
# The H100's SM count, for a plan made without a card (the CPU tests)
H100_SMS = 132

# Launches of the K8 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0


class Plan(NamedTuple):
    tile_rows: int   # rows a tile (the last tile may hold fewer)
    tiles: int
    grid: int        # blocks, all resident at once; block b takes tile r * grid + b
    rounds: int      # in round r
    segs: int        # thread (s, c) sums rows [s * seg_rows, (s + 1) * seg_rows)
    seg_rows: int    # of its tile's column c, in order
    part_tiles: int  # the carry: a round's tiles in runs of part_tiles, one a thread
    smem: int        # dynamic shared memory a block, bytes
    vector: bool     # 16-byte pieces (x and out 16-byte aligned), else 4-byte


def smem_bytes(tile_rows: int, w: int, segs: int) -> int:
    """block_cumsum.cu's shared memory: the tile, the segments' sums, the
    carry runs' sums, then the carry-in, the carry and the base of w each."""
    return 4 * (tile_rows * w + 2 * segs * w + 3 * w)


@functools.lru_cache(maxsize=256)
def plan(n: int, w: int, sm_count: int = H100_SMS, aligned: bool = True) -> Plan:
    """K8's launch for x (n, w): as few rounds as tiles of at most
    TILE_BYTES allow, their tiles as even as ROW_ALIGN allows, at most one
    block an SM and no tile under MIN_TILE_BYTES where the rows allow."""
    if n < 1 or not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"block_cumsum: ({n}, {w}) is outside n >= 1, 1 <= W <= {MAX_WIDTH}")
    if sm_count < 1:
        raise ValueError(f"block_cumsum: sm_count = {sm_count}")
    segs = THREADS // w
    max_rows = TILE_BYTES // (4 * w) // ROW_ALIGN * ROW_ALIGN
    min_rows = min(max_rows, -(-MIN_TILE_BYTES // (4 * w * ROW_ALIGN)) * ROW_ALIGN)
    rounds = -(-n // (sm_count * max_rows))
    rows = -(-n // (rounds * sm_count * ROW_ALIGN)) * ROW_ALIGN
    tile_rows = min(max_rows, max(min_rows, rows))
    tiles = -(-n // tile_rows)
    grid = min(tiles, sm_count)
    return Plan(tile_rows=tile_rows, tiles=tiles, grid=grid, rounds=-(-tiles // grid),
                segs=segs, seg_rows=-(-tile_rows // segs), part_tiles=-(-grid // segs),
                smem=smem_bytes(tile_rows, w, segs), vector=aligned)


def block_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([col.contiguous().cumsum(0) for col in x.t()], dim=1)


def block_cumsum_order(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """The kernel's association under plan `p`, in PyTorch ops on x's
    device, one float32 add at a time: the same bits as the kernel.
    1. segment s of a tile, column c: the in-order sum of its rows from 0;
       the tile's sum: segment 0's, then each next segment's added;
    2. round r's tiles r * grid + j in runs of part_tiles: each run summed
       in order from 0 (j's in-run prefix: the sum before j's own); then
       from the round's base, each run's sum added in order: tile j's carry
       is the base so far plus its in-run prefix; the base after the last
       run is the next round's;
    3. segment s's base: the carry plus segments 0..s-1 in order; row i's
       value: that base plus the segment's own in-order prefix through i."""
    n, w = x.shape
    x = x.float()
    span = p.segs * p.seg_rows
    rows = torch.arange(p.tiles * span, device=x.device).view(p.tiles, p.segs, p.seg_rows)
    tile_row = rows % span
    global_row = (rows // span) * p.tile_rows + tile_row
    valid = (tile_row < p.tile_rows) & (global_row < n)
    vals = x[global_row.clamp(max=n - 1)] * valid[..., None]  # (tiles, segs, seg_rows, w)
    valid = valid[..., None]
    seg = torch.zeros(p.tiles, p.segs, w, device=x.device)
    for i in range(p.seg_rows):
        seg = torch.where(valid[:, :, i], seg + vals[:, :, i], seg)
    total = seg[:, 0]
    for k in range(1, p.segs):
        total = total + seg[:, k]

    carry = torch.empty(p.tiles, w, device=x.device)
    base = torch.zeros(w, device=x.device)
    for r in range(p.rounds):
        first = r * p.grid
        count = min(p.grid, p.tiles - first)
        runs = -(-count // p.part_tiles)
        run_sum = torch.zeros(runs, w, device=x.device)
        in_run = torch.empty(runs * p.part_tiles, w, device=x.device)
        for j in range(p.part_tiles):
            idx = torch.arange(runs, device=x.device) * p.part_tiles + j
            live = (idx < count)[:, None]
            in_run[idx] = run_sum
            run_sum = torch.where(live, run_sum + total[first + idx.clamp(max=count - 1)],
                                  run_sum)
        for q in range(runs):
            lo, hi = q * p.part_tiles, min((q + 1) * p.part_tiles, count)
            carry[first + lo:first + hi] = base + in_run[lo:hi]
            base = base + run_sum[q]

    out = torch.empty_like(vals)
    seg_base = carry
    for s in range(p.segs):
        local = torch.zeros(p.tiles, w, device=x.device)
        for i in range(p.seg_rows):
            local = torch.where(valid[:, s, i], local + vals[:, s, i], local)
            out[:, s, i] = seg_base + local
        seg_base = seg_base + seg[:, s]
    keep = valid.reshape(-1)
    res = torch.empty(n, w, device=x.device)
    res[global_row.reshape(-1)[keep]] = out.reshape(-1, w)[keep]
    return res


def block_cumsum(x: torch.Tensor, p: Optional[Plan] = None) -> torch.Tensor:
    """x (n, W) float32, W <= 128 -> (n, W) float32, out[r] = x[0] + ... + x[r].
    p: the launch plan; by default `plan` for x's shape on x's card."""
    if x.dim() != 2 or not 1 <= x.shape[1] <= MAX_WIDTH:
        raise ValueError(f"block_cumsum: x must be (n, W) with 1 <= W <= {MAX_WIDTH}, "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return block_cumsum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"block_cumsum: x on {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("block_cumsum: x must be a contiguous float32 tensor, got "
                         f"{x.dtype}")
    global launches
    n, w = x.shape
    out = torch.empty_like(x)
    if n == 0:
        return out
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if p is None:
        p = plan(n, w, build.sm_count(index), x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    agg = torch.empty(p.tiles * w, dtype=torch.float32, device=x.device)
    lib = build.library()
    status = lib.map_tpu_block_cumsum(
        x.data_ptr(), out.data_ptr(), agg.data_ptr(), n, w, p.tile_rows, p.tiles, p.grid,
        p.rounds, p.segs, p.seg_rows, p.part_tiles, p.smem, int(p.vector),
        build.current_stream(index))
    build.check_status(status, "block_cumsum")
    launches += 1
    return out
