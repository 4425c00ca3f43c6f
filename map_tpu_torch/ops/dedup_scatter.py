"""The NCE decoder's row gathers, with a duplicate-folding backward.
Counterpart: `map_tpu/ops/dedup_scatter.py`: `decoder_gather` with unpacked
tables and `use_pallas_scatter=True` (`_sort_ids`, `_fold_stream`,
`_dg_bwd`), the path map_tpu takes under `nce_grad='dedup_pallas'`; and the
backwards of the shared-noise modes, the target rows' (`_dst_bwd`) and the
noise rows' (`_nr_bwd`).

Forward: rows = emb[ids] through K4 (`ops/embedding.py`) and bias[ids] by
plain indexing; both exact row gathers (map_tpu's unique-once gather and
expand give the same values). The ids are the per-position candidates
(B, M, 1 + k), the targets (B, M) of a shared-noise mode, or its noise ids
(k,) or (F * k,).

Backward (`sort_and_fold`, then K5 or the optimizer): one stable sort of
the flat ids; the (n, E + 1) gradient [d_rows | d_bias] put in sorted order
with one row gather and scanned with one K8 launch (`ops/scan.py`); each
distinct id's sum taken as the difference of the scan at its segment's end
and at the previous segment's end, map_tpu's `_fold_stream` arithmetic; the
folded values compacted to the front of the stream, the sentinel V behind
them. Then, dense: one K5 launch (`ops/scatter_unique.py`) writes the
(V, E) emb and (V, 1) bias gradients. With a `StreamHandoff`
(`ops/sparse_adamw.py`, the sparse table update of the shared modes): the
emb stream goes to the handoff for K7 and no emb gradient is returned; the
bias keeps its dense gradient through K5, as map_tpu's does
(`dedup_scatter.py:497-499`, `:651-654`).

Under a table mesh (row blocks of emb and bias, `parallel/sharding`; map_tpu
`dedup_scatter.py:356-392`, `:435-462`): the forward's rows are
`parallel/embedding.sharded_rows_gather`'s (a masked K4 gather of emb and
one of bias, summed over the model group in one all_reduce); the backward's sort, K8 fold and
compaction run as above on the candidate stream, which is the same on
every rank of the model group (its data block), and only the scatter is the
shard's: K5 on the folded stream offset to its block
(`sharded_rows_scatter_add`). The data axis sums the blocks' gradients in
the train step, as every gradient. The sparse table update is off there.

Capacity: map_tpu compacts into a static 131,072 slots and, under a
`lax.cond`, scatters the raw stream when a batch has more distinct ids. In
eager PyTorch that choice needs the count on the host, a sync in the middle
of the backward. The port sizes the compacted stream to the whole id
stream, so every distinct id fits, K5 runs every step and nothing waits on
the host; the result is map_tpu's wherever map_tpu takes its folded tier.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from map_tpu_torch.ops.embedding import embedding_lookup
from map_tpu_torch.ops.scan import block_cumsum
from map_tpu_torch.ops.scatter_unique import scatter_unique_sorted
from map_tpu_torch.ops.sparse_adamw import Stream, StreamHandoff
from map_tpu_torch.parallel.embedding import sharded_rows_gather, sharded_rows_scatter_add
from map_tpu_torch.parallel.sharding import shard_of


def sort_and_fold(flat_ids: torch.Tensor, grads: torch.Tensor, vocab_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flat_ids (n,) int, grads (n, W) float32 -> (uids (n,) int32, vals
    (n, W) float32, num_unique 0-d int64), all on the ids' device: for
    j < num_unique, uids[j] is the j-th smallest distinct id and vals[j] the
    sum of its gradient rows; uids = vocab_size and vals = 0 beyond."""
    n = flat_ids.numel()
    dev = flat_ids.device
    sids, order = torch.sort(flat_ids.int(), stable=True)
    change = sids[1:] != sids[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), change])
    last = torch.cat([change, torch.ones(1, dtype=torch.bool, device=dev)])
    seg = torch.cumsum(first, 0) - 1  # segment of each sorted position
    num_unique = seg[-1] + 1
    # end_pos[j]: the last sorted position of segment j, n - 1 past the last
    # segment. A segment's end writes its segment's slot, every other
    # position a spare slot of its own, so no two writes meet.
    pos = torch.arange(n, device=dev)
    end_pos = torch.full((2 * n,), n - 1, dtype=torch.long, device=dev)
    end_pos.scatter_(0, torch.where(last, seg, n + pos), pos)
    end_pos = end_pos[:n]
    uids = torch.where(pos < num_unique, sids[end_pos], vocab_size)
    ends = block_cumsum(grads.index_select(0, order))[end_pos]
    # sum of a segment = prefix at its end - prefix at the previous end; 0
    # past the last segment, whose end is the last position
    vals = ends - torch.cat([ends.new_zeros(1, ends.shape[1]), ends[:-1]])
    return uids, vals, num_unique


def _rows(emb: torch.Tensor, bias: torch.Tensor, ids: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows (..., E), bias (...)) of `ids`, from whole tables or row blocks."""
    if shard_of(emb) is None:
        return embedding_lookup(emb, ids), bias[ids][..., 0]
    both = sharded_rows_gather((emb, bias), ids, _model_group())
    return both[..., :-1], both[..., -1]


def _model_group():
    from map_tpu_torch.parallel import context

    mesh = context.table_mesh()
    if mesh is None:
        raise RuntimeError("a row-sharded decoder is read with no table mesh active")
    return mesh.model_group


class _DecoderGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, bias, ids, handoff, stream):
        ctx.save_for_backward(ids)
        ctx.shard = shard_of(emb)
        ctx.vocab_size = emb.shape[0] if ctx.shard is None else ctx.shard.total
        if ctx.shard is not None and handoff is not None:
            raise ValueError("the sparse table update is off under a table mesh")
        ctx.handoff, ctx.stream = handoff, stream
        return _rows(emb, bias, ids)

    @staticmethod
    def backward(ctx, g_rows, g_bias):
        (ids,) = ctx.saved_tensors
        e = g_rows.shape[-1]
        g = torch.cat([g_rows.reshape(-1, e).float(),
                       g_bias.reshape(-1, 1).float()], dim=1)
        uids, vals, _ = sort_and_fold(ids.reshape(-1), g, ctx.vocab_size)
        if ctx.shard is not None:
            d_emb, d_bias = sharded_rows_scatter_add(uids, vals, ctx.shard, widths=(e, 1))
            return d_emb, d_bias, None, None, None
        if ctx.handoff is None:
            d_emb, d_bias = scatter_unique_sorted(uids, vals, ctx.vocab_size,
                                                  widths=(e, 1))
            return d_emb, d_bias, None, None, None
        ctx.handoff.put(ctx.stream, Stream(uids, vals[:, :e].contiguous()))
        (d_bias,) = scatter_unique_sorted(uids, vals[:, e:].contiguous(),
                                          ctx.vocab_size)
        return None, d_bias, None, None, None


def decoder_gather(emb: torch.Tensor, bias: torch.Tensor, ids: torch.Tensor,
                   handoff: Optional[StreamHandoff] = None, stream: str = "target"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """emb (V, E) float32, bias (V, 1) float32, ids (...) int32 in [0, V)
    -> (rows (..., E), bias (...)); differentiable in emb and bias. With a
    `handoff`, the backward deposits the emb gradient there as the `stream`
    ("target" or "noise") instead of returning it."""
    if torch.is_grad_enabled() and (emb.requires_grad or bias.requires_grad):
        return _DecoderGather.apply(emb, bias, ids, handoff, stream)
    return _rows(emb, bias, ids)
