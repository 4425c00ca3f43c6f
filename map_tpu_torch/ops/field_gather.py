"""Field-block embedding gather and scatter (K6a, K6b): every small field of
the hybrid lookup in one launch per direction. Counterpart:
`map_tpu/ops/pallas_field_gather.py` (`plan_pairs` :47-60,
`field_block_gather` :82-146, `field_block_scatter` :150-214,
`assemble_dense` :224-237).

Kernel: `map_tpu_torch/csrc/field_block.cu` (CUDA C++, sm_90a).
- Replaces `pallas_field_gather.py:field_block_gather` and
  `:field_block_scatter`, which build a (512, B) one-hot in VMEM and run
  three bf16 MXU passes a (field, tile) pair, for want of fast scattered
  writes on the TPU.
- Bound on the H100: device-memory bytes. K6b reads the small fields' g rows
  and ids once and writes (or adds) the touched tiles once: about 5 MB,
  1.6 us, at the training shape (4096 rows, 21 small fields, 65 tiles).
  Beside it stands K6b's order floor, its longest row's chain of in-order
  adds.
- K6b's order contract: each tile row is summed in float32 from 0.0 in the
  order of (pair, b), a tile's pairs in pos order, never split or
  reordered: the same bits every run, and a small field's row equals the
  flat K3 route's bit for bit (K3 sums a row's segment of the stably sorted
  ids in the order of b too).
- K6b's design: a tile's rows are spread over 4 to 16 blocks (block q of n
  takes rows q, q + n, ...; `tile_slices`), so a tiny field's hot rows land
  on different blocks, and the grid takes the heavy tiles first
  (`work_order`). A block reads its tile's ids in (pair, b) order, keeps the
  hits on its rows by a stable compaction, copies their g rows into shared
  memory as it finds them, sorts them by row with a stable counting sort,
  and walks each row's hits in order, one column a thread.
- K6a's design: a block takes a range of b (`gather_plan`), reads the
  range's ids along b (each beside its field's window) into shared memory,
  and writes the range's output rows, one contiguous span, with 8 row loads
  a thread in flight: a transpose through shared memory.

The plan is map_tpu's: `small` is a tuple of (pos, plo, pe), pos the field's
position among the small fields and [plo, pe) its row window; the 512-row
tiles the windows touch are listed once (`plan_pairs`), with a (pos, slot,
row0) pair for each tile of each field. The port's table is not padded to a
tile multiple (V = 1,013,519 at the canonical configuration), so the last
tile may run past R: the plan allows it and the kernels bound-check it. An
id counts for a field when it lies in one of the field's tiles, as in
map_tpu's kernels; the hybrid backward passes -1 for every id outside the
field's block.

Every function takes g or the table in float32 (K6b also bf16, summed in
float32) and W a multiple of 4 on the card. `field_block_scatter` returns the
compact (U, 512, W) tile stack, as map_tpu's does;
`field_block_scatter_add` adds the tiles onto a dense (R, W) float32
gradient in place, which is what the hybrid backward uses.

CUDA tensors go to the kernels, CPU tensors to the plain versions
(`*_plain`). The plain scatter sums each row in the kernel's order: its
entries, stably sorted by row, are added a rank at a time (the k-th entry
of every row in one `index_add_` over distinct rows), so on the card too it
gives the kernel's bits.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from map_tpu_torch.kernels import build

TILE = 512
# K6b's blocks a tile (field_block.cu's rows a thread take 4 at least; its
# row bytes, 16 at most) and the hits a block is sized for
MIN_SLICES, MAX_SLICES, HITS_PER_BLOCK = 4, 16, 1024

# K6a: threads a block (field_block.cu's kThreads), the most rows of b a
# block takes, the blocks an SM its plan aims at, and the shared memory for
# a block's ids
GATHER_THREADS, GATHER_MAX_B, GATHER_BLOCKS_PER_SM = 256, 32, 4
GATHER_SMEM = 48 * 1024

# Launches of K6a and K6b; a wrapper adds one where it launches, nowhere else.
gather_launches = 0
scatter_launches = 0

Plan = Tuple[Tuple[int, int, int], ...]


@functools.lru_cache(maxsize=256)
def plan_pairs(small: Plan, r: int):
    """-> (utiles, pairs): the sorted unique tile indices the windows touch,
    and (pos, slot, row0) for each tile of each field, in field order. A
    tile may run past r (the last one of an unpadded table)."""
    utiles = sorted({t for _, plo, pe in small
                     for t in range(plo // TILE, (pe - 1) // TILE + 1)})
    slot = {t: i for i, t in enumerate(utiles)}
    pairs = [(pos, slot[t], t * TILE) for pos, plo, pe in small
             for t in range(plo // TILE, (pe - 1) // TILE + 1)]
    if any(plo < 0 or pe <= plo or pe > r for _, plo, pe in small):
        raise ValueError(f"field windows {small} do not lie in a table of {r} rows")
    return tuple(utiles), tuple(pairs)


def tile_windows(small: Plan, r: int) -> Tuple[Tuple[int, int], ...]:
    """Each field's rows [lo, hi) covered by its tiles, in pos order."""
    wins = {pos: ((plo // TILE) * TILE, min(((pe - 1) // TILE + 1) * TILE, r))
            for pos, plo, pe in small}
    return tuple(wins[pos] for pos in range(len(small)))


def work_order(small: Plan, r: int) -> Tuple[int, ...]:
    """Every slot of `plan_pairs(small, r)[0]` once, the heavy tiles first,
    as K6b's grid takes them. A tile's blocks read pairs x B ids, and walk
    rows of up to about B / (its smallest field's ids) hits in order; the
    weight below counts a chained add as 14 id reads, a guess at the
    kernel's costs. It orders the launch only, never a sum."""
    utiles, pairs = plan_pairs(small, r)
    size = {pos: pe - plo for pos, plo, pe in small}
    sizes = [[] for _ in utiles]
    for pos, s, _ in pairs:
        sizes[s].append(size[pos])
    return tuple(sorted(range(len(utiles)),
                        key=lambda s: (-(len(sizes[s]) + 14.0 / min(sizes[s])), s)))


def tile_slices(small: Plan, r: int, b: int) -> Tuple[int, ...]:
    """K6b's blocks for each slot: 4 to 16, a power of two, so that a block
    expects about HITS_PER_BLOCK hits of b rows of ids spread evenly over
    each field's window. It sizes the launch only, never a sum."""
    utiles, pairs = plan_pairs(small, r)
    window = {pos: (plo, pe) for pos, plo, pe in small}
    hits = [0.0] * len(utiles)
    for pos, s, row0 in pairs:
        plo, pe = window[pos]
        hits[s] += b * (min(pe, row0 + TILE) - max(plo, row0)) / (pe - plo)
    return tuple(min(MAX_SLICES, max(MIN_SLICES, 1 << max(0, math.ceil(
        math.log2(max(h, 1.0) / HITS_PER_BLOCK))))) for h in hits)


class ScatterPlan(NamedTuple):
    work: torch.Tensor      # (blocks, 4) int32, a record a block (field_block.cu)
    pair_pos: torch.Tensor  # (P,) int32: each tile's pairs' field positions, in pos order
    most_pairs: int         # the most pairs a tile has


@functools.lru_cache(maxsize=64)
def _scatter_plan(small: Plan, r: int, b: int, device: torch.device) -> ScatterPlan:
    """K6b's work list on `device`, built once per plan and batch size: a
    record a block, the heavy tiles' blocks first (`work_order`), block q of
    a tile's n (`tile_slices`) summing rows q, q + n, ...: (slot, the tile's
    first row, its first pair, pairs | q << 12 | log2 n << 20)."""
    utiles, pairs = plan_pairs(small, r)
    by_slot = sorted(pairs, key=lambda p: (p[1], p[0]))
    first = [0] * (len(utiles) + 1)
    for _, s, _ in by_slot:
        first[s + 1] += 1
    for s in range(len(utiles)):
        first[s + 1] += first[s]
    slices = tile_slices(small, r, b)
    work = [(s, utiles[s] * TILE, first[s],
             (first[s + 1] - first[s]) | q << 12 | (slices[s].bit_length() - 1) << 20)
            for s in work_order(small, r) for q in range(slices[s])]
    return ScatterPlan(torch.tensor(work, dtype=torch.int32, device=device),
                       torch.tensor([p[0] for p in by_slot], dtype=torch.int32, device=device),
                       max(first[s + 1] - first[s] for s in range(len(utiles))))


@functools.lru_cache(maxsize=256)
def gather_plan(b: int, fs: int, w: int, sms: int) -> int:
    """K6a's rows of b a block: the largest power of two up to GATHER_MAX_B
    that still gives GATHER_BLOCKS_PER_SM blocks an SM (1 at least), whose
    ids, T * fs ints, fit GATHER_SMEM. Block x takes rows [x * T, (x + 1) *
    T) of b."""
    if fs * 4 > GATHER_SMEM or fs * w >= 2 ** 31:
        raise ValueError(f"field_block_gather: {fs} fields of width {w} exceed a block")
    t = GATHER_MAX_B
    while t > 1 and (-(-b // t) < sms * GATHER_BLOCKS_PER_SM or t * fs * 4 > GATHER_SMEM
                     or t * fs * w >= 2 ** 31):
        t //= 2
    return t


@functools.lru_cache(maxsize=64)
def _gather_windows(small: Plan, r: int, device: torch.device):
    """K6a's window bounds, (Fs,) int32 x 2 on `device`, built once."""
    wins = tile_windows(small, r)
    return (torch.tensor([lo for lo, _ in wins], dtype=torch.int32, device=device),
            torch.tensor([hi for _, hi in wins], dtype=torch.int32, device=device))


def _valid(phys_small: torch.Tensor, small: Plan, r: int) -> torch.Tensor:
    """(Fs, B) bool: the id lies in one of its field's tiles."""
    wins = torch.tensor(tile_windows(small, r), dtype=torch.int64,
                        device=phys_small.device)
    p = phys_small.long()
    return (p >= 0) & (p >= wins[:, :1]) & (p < wins[:, 1:])


def field_block_gather_plain(table: torch.Tensor, phys_small: torch.Tensor,
                             small: Plan, r: int) -> torch.Tensor:
    fs, b = phys_small.shape
    valid = _valid(phys_small, small, r)
    rows = table[phys_small.long().clamp(min=0)].float()           # (Fs, B, W)
    rows = torch.where(valid[..., None], rows, torch.zeros((), device=table.device))
    return rows.transpose(0, 1).reshape(b, -1)


def stack_rows(phys_small: torch.Tensor, small: Plan, r: int) -> torch.Tensor:
    """(Fs, B) row of each id in the (U * TILE) tile stack, -1 = skip."""
    utiles, _ = plan_pairs(small, r)
    slot_of = torch.full(((r - 1) // TILE + 1,), -1, dtype=torch.int64,
                         device=phys_small.device)
    slot_of[torch.tensor(utiles, dtype=torch.int64, device=phys_small.device)] = (
        torch.arange(len(utiles), device=phys_small.device))
    p = phys_small.long().clamp(min=0)
    rows = slot_of[p // TILE] * TILE + p % TILE
    return torch.where(_valid(phys_small, small, r), rows, -1)


def _ordered_add(out: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> None:
    """out[rows[i]] += vals[i], each row's entries added in order of i: the
    k-th entry of every row in one index_add_ over distinct rows."""
    if rows.numel() == 0:
        return
    rows_sorted, perm = torch.sort(rows, stable=True)
    first = torch.searchsorted(rows_sorted, rows_sorted)
    rank = torch.arange(rows.numel(), device=rows.device) - first
    for k in range(int(rank.max()) + 1):
        at = rank == k
        out.index_add_(0, rows_sorted[at], vals[perm[at]])


def field_block_scatter_plain(g_small: torch.Tensor, phys_small: torch.Tensor,
                              small: Plan, r: int) -> torch.Tensor:
    fs, b = phys_small.shape
    w = g_small.shape[1] // fs
    utiles, _ = plan_pairs(small, r)
    rows = stack_rows(phys_small, small, r).reshape(-1)          # (pos, b) order
    vals = g_small.float().reshape(b, fs, w).transpose(0, 1).reshape(fs * b, w)
    keep = rows >= 0
    out = torch.zeros(len(utiles) * TILE, w, dtype=torch.float32, device=g_small.device)
    _ordered_add(out, rows[keep], vals[keep])
    return out.reshape(len(utiles), TILE, w)


def _tile_rows(utiles: Sequence[int], r: int, device: torch.device) -> torch.Tensor:
    """Row of the dense table for each row of the tile stack, -1 past r."""
    rows = (torch.tensor(utiles, dtype=torch.int64, device=device)[:, None] * TILE
            + torch.arange(TILE, device=device)).reshape(-1)
    return torch.where(rows < r, rows, -1)


def assemble_dense(stack: torch.Tensor, utiles: Sequence[int], r: int) -> torch.Tensor:
    """Compact (U, TILE, W) tiles -> dense (r, W), zeros elsewhere."""
    w = stack.shape[2]
    rows = _tile_rows(utiles, r, stack.device)
    keep = rows >= 0
    dense = torch.zeros(r, w, dtype=torch.float32, device=stack.device)
    dense[rows[keep]] = stack.reshape(-1, w)[keep]
    return dense


def field_block_scatter_add_plain(dense: torch.Tensor, g_small: torch.Tensor,
                                  phys_small: torch.Tensor, small: Plan) -> torch.Tensor:
    r, w = dense.shape
    utiles, _ = plan_pairs(small, r)
    stack = field_block_scatter_plain(g_small, phys_small, small, r)
    rows = _tile_rows(utiles, r, dense.device)
    keep = rows >= 0
    dense[rows[keep]] += stack.reshape(-1, w)[keep]
    return dense


def _check(name: str, device: torch.device, phys_small: torch.Tensor, w: int,
           *tensors: torch.Tensor) -> None:
    if device.type != "cuda" or any(t.device != device for t in (phys_small, *tensors)):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}, "
                         f"ids on {phys_small.device}")
    if phys_small.dtype != torch.int32 or phys_small.dim() != 2:
        raise ValueError(f"{name}: ids must be (Fs, B) int32, got {phys_small.dtype} "
                         f"{tuple(phys_small.shape)}")
    if w % 4:
        raise ValueError(f"{name}: the row width {w} must be a multiple of 4")
    for t in (phys_small, *tensors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")


def _scatter(out: torch.Tensor, g_small: torch.Tensor, phys_small: torch.Tensor,
             small: Plan, r: int, add: bool) -> None:
    global scatter_launches
    fs, b = phys_small.shape
    w = out.shape[-1]
    _check("field_block_scatter", g_small.device, phys_small, w, g_small, out)
    if g_small.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"field_block_scatter: g must be float32 or bfloat16, "
                         f"got {g_small.dtype}")
    if tuple(g_small.shape) != (b, fs * w) or len(small) != fs:
        raise ValueError(f"field_block_scatter: g {tuple(g_small.shape)} does not fit "
                         f"ids {tuple(phys_small.shape)}, width {w}, {len(small)} fields")
    if g_small.numel() >= 2 ** 31:
        raise ValueError(f"field_block_scatter: g of {g_small.numel()} elements exceeds "
                         "int32 offsets")
    plan = _scatter_plan(small, r, b, g_small.device)
    most = plan.most_pairs
    if most > TILE:
        raise ValueError(f"field_block_scatter: {most} pairs on one tile; windows that "
                         f"do not overlap give at most {TILE}")
    if most * b >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"field_block_scatter: {most} pairs of a tile x {b} rows "
                         "exceed int32 positions")
    status = build.library().map_tpu_field_block_scatter(
        g_small.data_ptr(), phys_small.data_ptr(), plan.work.data_ptr(),
        plan.pair_pos.data_ptr(), out.data_ptr(), b, fs, w, r, plan.work.shape[0],
        int(g_small.dtype == torch.bfloat16), int(add),
        build.current_stream(g_small.device.index))
    build.check_status(status, "field_block_scatter")
    scatter_launches += 1


def field_block_scatter(g_small: torch.Tensor, phys_small: torch.Tensor,
                        small: Plan, r: int) -> torch.Tensor:
    """g_small (B, Fs * W), phys_small (Fs, B) int32 rows (-1 = skip) ->
    the (U, TILE, W) float32 summed tiles of `plan_pairs(small, r)[0]`."""
    if g_small.device.type == "cpu":
        return field_block_scatter_plain(g_small, phys_small, small, r)
    fs = phys_small.shape[0]
    utiles, _ = plan_pairs(small, r)
    out = torch.empty(len(utiles), TILE, g_small.shape[1] // max(fs, 1),
                      dtype=torch.float32, device=g_small.device)
    _scatter(out, g_small, phys_small, small, r, add=False)
    return out


def field_block_scatter_add(dense: torch.Tensor, g_small: torch.Tensor,
                            phys_small: torch.Tensor, small: Plan) -> torch.Tensor:
    """dense (R, W) float32 += the tiles of field_block_scatter, in place;
    returns dense."""
    if dense.device.type == "cpu":
        return field_block_scatter_add_plain(dense, g_small, phys_small, small)
    if dense.dtype != torch.float32 or dense.dim() != 2:
        raise ValueError(f"field_block_scatter_add: dense must be (R, W) float32, "
                         f"got {dense.dtype} {tuple(dense.shape)}")
    _scatter(dense, g_small, phys_small, small, dense.shape[0], add=True)
    return dense


def field_block_gather(table: torch.Tensor, phys_small: torch.Tensor,
                       small: Plan, r: int) -> torch.Tensor:
    """table (R, W) float32, phys_small (Fs, B) int32 rows (-1 = skip) ->
    (B, Fs * W): field pos's row at columns [pos * W, (pos + 1) * W), zeros
    for -1 and for rows outside the field's tiles."""
    if table.device.type == "cpu":
        return field_block_gather_plain(table, phys_small, small, r)
    global gather_launches
    fs, b = phys_small.shape
    w = table.shape[1]
    _check("field_block_gather", table.device, phys_small, w, table)
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != r:
        raise ValueError(f"field_block_gather: table must be ({r}, W) float32, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if len(small) != fs:
        raise ValueError(f"field_block_gather: {fs} id rows for {len(small)} fields")
    win_lo, win_hi = _gather_windows(small, r, table.device)
    out = torch.empty(b, fs * w, dtype=torch.float32, device=table.device)
    status = build.library().map_tpu_field_block_gather(
        table.data_ptr(), phys_small.data_ptr(), win_lo.data_ptr(), win_hi.data_ptr(),
        out.data_ptr(), b, fs, w, gather_plan(b, fs, w, build.sm_count(table.device.index)),
        build.current_stream(table.device.index))
    build.check_status(status, "field_block_gather")
    gather_launches += 1
    return out
