"""Row-sharded table lookups over the model axis. Counterpart:
`map_tpu/parallel/embedding.py:36-249` (`sharded_embedding_lookup`,
`sharded_rows_gather`, `sharded_rows_scatter_add`,
`hotcold_embedding_lookup`), whose shard_map bodies become
`torch.autograd.Function`s here.

A table parameter sharded by `parallel/sharding.shard_tables` carries its
`Shard` (rows [lo, lo + rows) of V); the ids are global and every rank of a
model group holds the same ids (its data block), so a lookup is:

- `sharded_embedding_lookup` ('psum'): local = ids - lo; the ids this shard
  does not own are clamped to row 0 (K4 does not bound-check), gathered by
  K4 in float32, zeroed, and the partials summed over the model group; the
  output is then cast to `out_dtype` (round to nearest even, as K4's fused
  cast). Backward: the output gradient is the same on every shard; the
  shard's positions go through K3 into its block, the others are DROPPED
  into `SPARE` rows past the block (by id mod SPARE, so no one segment of
  K3's sorted stream grows long), which are cut off. Each owned row sums its
  gradients in index order, as the unsharded K3 does, so the block's
  gradient is the unsharded gradient's rows, bit for bit. The sum over the
  data axis is the train step's (one flat all_reduce of every gradient).
- `sharded_rows_gather` / `sharded_rows_scatter_add`: the NCE decoder's row
  gather and the scatter of its folded stream (`ops/dedup_scatter.py`); the
  stream is sorted and duplicate-free, so the rows this shard owns form one
  contiguous segment and the scatter is K5 on the stream with its ids
  offset by -lo (ids below the block go negative and fall in no tile of K5,
  ids past it are sentinels).
- `hotcold_embedding_lookup` ('hotcold'): the hot rows' cache (H, W)
  assembled by a masked gather + all_reduce and served locally; the cold
  ids sorted (hot ones sent to V, past every shard), each shard gathering
  the window of C = ceil(n * capacity_frac / 8S) * 8 sorted ids from its
  segment's start (positions scattered back into (n, W), all_reduced); when
  any shard's segment is longer than C (the count all_reduced, so every
  shard agrees) the call takes the full masked gather instead, so the
  result is exact either way. Eagerly the choice reads the count on the
  host; under a CUDA graph capture both are computed and one is selected on
  the device, so a captured lookup does more gather and scatter work than
  'psum' (K3 over n + H + C ids), where map_tpu's lax.cond runs one
  branch. Backward: the hot positions' gradient summed into the cache's
  rows (K3), the cache's rows and the cold positions' gradient into the
  block (one K3 launch, unowned dropped into SPARE rows). `stats` (the
  module's `hotcold_stats`, device tensors summed over calls) counts the
  lookups, the all_reduced overflow, this shard's segment lengths and the
  cold ids; `with_stats` returns one call's counters, map_tpu's
  (total_overflow, seg_counts over the group, num_cold, capacity).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from map_tpu_torch.parallel.mesh import Group
from map_tpu_torch.parallel.sharding import Shard, shard_of

# rows past a block that take the gradients of the ids it does not own
SPARE = 64

# device tensors summed over hotcold lookups (reset by assigning {})
hotcold_stats: Dict[str, torch.Tensor] = {}


def _shard(table: torch.Tensor) -> Shard:
    s = shard_of(table)
    if s is None:
        raise ValueError("a sharded lookup needs a table block from shard_tables")
    return s


def _owned(ids: torch.Tensor, lo: int, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local ids, owned mask)."""
    local = ids - lo
    return local, (local >= 0) & (local < rows)


def masked_gather(table: torch.Tensor, ids: torch.Tensor, shard: Shard) -> torch.Tensor:
    """float32 (..., W): the rows of `ids` this shard owns, zeros elsewhere
    (K4 on the clamped local ids)."""
    from map_tpu_torch.ops.embedding import _gather

    local, own = _owned(ids, shard.lo, shard.rows)
    rows = _gather(table, torch.where(own, local, 0).to(torch.int32), None)
    return torch.where(own[..., None], rows, 0.0)


def local_ids(ids: torch.Tensor, shard: Shard) -> torch.Tensor:
    """int32 ids into the block plus SPARE rows: owned ids at their local
    row, the others at rows + id mod SPARE."""
    local, own = _owned(ids, shard.lo, shard.rows)
    return torch.where(own, local, shard.rows + torch.remainder(ids, SPARE)).to(torch.int32)


def local_scatter(ids: torch.Tensor, grads: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(rows, W) float32: K3 of the owned positions' gradients into the
    block (in index order), the others dropped."""
    from map_tpu_torch.ops.scatter import scatter_add

    out = scatter_add(local_ids(ids, shard).contiguous(), grads.contiguous(),
                      shard.rows + SPARE)
    return out[:shard.rows]


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, group, out_dtype):
        shard = _shard(table)
        ctx.save_for_backward(ids)
        ctx.shard = shard
        out = group.all_reduce_(masked_gather(table, ids, shard))
        return out if out_dtype in (None, torch.float32) else out.to(out_dtype)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return local_scatter(ids, grad, ctx.shard), None, None, None


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor, group: Group,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """table: this rank's block (V rows over the model group); ids (...) int
    in [0, V), the same on every rank of `group` -> (..., W), the full rows."""
    return _ShardedLookup.apply(table, ids, group, out_dtype)


def sharded_rows_gather(tables, ids: torch.Tensor, group: Group) -> torch.Tensor:
    """float32 (..., W) rows of a sharded table at `ids` (the same on every
    rank of the group), or of several tables of one row split, side by
    side in one exchange (the decoder's emb and bias); not differentiable
    (the decoder pairs it with `sharded_rows_scatter_add`)."""
    tables = (tables,) if isinstance(tables, torch.Tensor) else tuple(tables)
    rows = [masked_gather(t, ids, _shard(t)) for t in tables]
    return group.all_reduce_(rows[0] if len(rows) == 1 else torch.cat(rows, -1))


def sharded_rows_scatter_add(uids: torch.Tensor, vals: torch.Tensor, shard: Shard,
                             widths=None, matmul: str = "highest"):
    """The block's rows of the dense gradient of a sorted, duplicate-free
    stream (`ops/dedup_scatter.sort_and_fold`'s uids, sentinels >= V after
    the ids): K5 on the stream offset by -lo -> one (rows, w) tensor per
    width, as `scatter_unique_sorted` gives them."""
    from map_tpu_torch.ops.scatter_unique import scatter_unique_sorted

    return scatter_unique_sorted((uids - shard.lo).to(torch.int32), vals, shard.rows,
                                 widths, matmul)


def capacity(n: int, capacity_frac: float, num_shards: int) -> int:
    """map_tpu's C = min(n, max(8, ceil(n * frac / (8 S)) * 8))."""
    return min(n, max(8, -(-int(n * capacity_frac) // (8 * num_shards)) * 8))


def _add_stat(key: str, value: torch.Tensor) -> None:
    prev = hotcold_stats.get(key)
    if prev is None:
        hotcold_stats[key] = value.detach().clone()
    else:
        prev.add_(value)  # in place, so a graph replay adds too


class _HotCold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, hot, group, capacity_frac, out_dtype, stats):
        shard = _shard(table)
        lo, rows, total = shard
        dev = table.device
        fids = ids.reshape(-1).to(torch.int32)
        n, h = fids.numel(), hot.numel()
        cap = capacity(n, capacity_frac, group.size)
        # (1) the hot cache, replicated over the group
        cache = group.all_reduce_(masked_gather(table, hot, shard))
        hpos = torch.searchsorted(hot, fids).clamp_max(h - 1)
        is_hot = hot[hpos] == fids
        # (2) the cold ids, sorted; this shard's segment [start, stop)
        cold = torch.where(is_hot, total, fids)
        sorted_ids, pos = torch.sort(cold, stable=True)
        bounds = (torch.arange(2, device=dev, dtype=torch.int32) * rows + lo)
        start, stop = torch.searchsorted(sorted_ids, bounds).unbind()
        seg = stop - start
        overflow = group.all_reduce_(torch.clamp_min(seg - cap, 0))
        at = start + torch.arange(cap, device=dev)
        j = at.clamp_max(n - 1)
        seg_ids, seg_pos = sorted_ids[j], pos[j]
        valid = (at < n) & (seg_ids >= lo) & (seg_ids < lo + rows)

        def compact():
            got = masked_gather(table, torch.where(valid, seg_ids, total), shard)
            out = torch.zeros(n + 1, got.shape[1], dtype=got.dtype, device=dev)
            return out.index_add_(0, torch.where(valid, seg_pos, n), got)[:n]

        def full():
            return masked_gather(table, cold, shard)

        capturing = table.is_cuda and torch.cuda.is_current_stream_capturing()
        if capturing:
            use_full = overflow > 0
            partial = torch.where(use_full, full(), compact())
        else:
            use_full = bool(overflow.item() > 0)
            partial = full() if use_full else compact()
        cold_out = group.all_reduce_(partial)
        out = torch.where(is_hot[:, None], cache[hpos], cold_out)
        ctx.shard, ctx.h, ctx.n = shard, h, n
        ctx.use_full = None if capturing else use_full  # None: selected on the device
        ctx.save_for_backward(hot, hpos, is_hot, cold, seg_ids, seg_pos, valid,
                              use_full if capturing else overflow)
        if stats is not None:
            num_cold = (~is_hot).sum()
            stats.update(total_overflow=overflow, seg_count=seg, num_cold=num_cold,
                         capacity=cap, n=n,
                         seg_counts=group.all_reduce_(
                             (torch.arange(group.size, device=dev) == group.index) * seg))
        for key, value in (("lookups", torch.ones((), dtype=torch.int64, device=dev)),
                           ("overflow", overflow), ("seg_count", seg),
                           ("num_cold", (~is_hot).sum())):
            _add_stat(key, value)
        out = out.reshape(*ids.shape, out.shape[-1])
        return out if out_dtype in (None, torch.float32) else out.to(out_dtype)

    @staticmethod
    def backward(ctx, grad):
        from map_tpu_torch.ops.scatter import scatter_add

        hot, hpos, is_hot, cold, seg_ids, seg_pos, valid, use_full = ctx.saved_tensors
        shard = ctx.shard
        g = grad.reshape(ctx.n, -1).float()
        g_hot = torch.where(is_hot[:, None], g, 0.0)
        cache_grad = scatter_add(hpos.to(torch.int32).contiguous(), g_hot.contiguous(), ctx.h)
        full_ids, full_g = local_ids(cold, shard), g
        seg_l = local_ids(torch.where(valid, seg_ids, shard.total), shard)
        seg_g = torch.where(valid[:, None], g[seg_pos], 0.0)
        if ctx.use_full is not None:
            cold_ids, cold_g = (full_ids, full_g) if ctx.use_full else (seg_l, seg_g)
        else:  # captured: both, selected on the device (no host read)
            cold_ids = torch.cat([torch.where(use_full, full_ids, shard.rows),
                                  torch.where(use_full, shard.rows, seg_l)])
            cold_g = torch.cat([full_g, seg_g])
        ids_all = torch.cat([local_ids(hot, shard), cold_ids]).contiguous()
        g_all = torch.cat([cache_grad, cold_g]).contiguous()
        out = scatter_add(ids_all, g_all, shard.rows + SPARE)
        return out[:shard.rows], None, None, None, None, None, None


def hotcold_embedding_lookup(table: torch.Tensor, ids: torch.Tensor, group: Group,
                             hot: torch.Tensor, capacity_frac: float = 1.5,
                             with_stats: bool = False,
                             out_dtype: Optional[torch.dtype] = None):
    """table: this rank's block; ids (...) int in [0, V), the same on every
    rank of `group`; hot: ascending (H,) int32 ids on the table's device.
    -> (..., W), or (out, stats) with `with_stats`."""
    stats: Optional[dict] = {} if with_stats else None
    out = _HotCold.apply(table, ids, hot, group, capacity_frac, out_dtype, stats)
    return (out, stats) if with_stats else out
