"""The NCE decoder's candidate gather, with a duplicate-folding backward.
Counterpart: `map_tpu/ops/dedup_scatter.py` `decoder_gather` with unpacked
tables and `use_pallas_scatter=True` (`_sort_ids`, `_fold_stream`,
`_dg_bwd`), the path map_tpu takes under `nce_grad='dedup_pallas'`.

Forward: rows = emb[ids] through K4 (`ops/embedding.py`) and bias[ids] by
plain indexing; both exact row gathers (map_tpu's unique-once gather and
expand give the same values).

Backward (`sort_and_fold`, then K5): one stable sort of the flat candidate
ids; the (n, E + 1) gradient [d_rows | d_bias] put in sorted order and
folded into one value per distinct id as float32 prefix-sum differences at
the segment ends, map_tpu's `_fold_stream` arithmetic; the folded values
compacted to the front of the stream, the sentinel V behind them; then one
K5 launch (`ops/scatter_unique.py`) writes the dense (V, E) emb and (V, 1)
bias gradients.

Capacity: map_tpu compacts into a static 131,072 slots and, under a
`lax.cond`, scatters the raw stream when a batch has more distinct ids. In
eager PyTorch that choice needs the count on the host, a sync in the middle
of the backward. The port sizes the compacted stream to the whole candidate
stream (n = B * M * (1 + k)), so every distinct id fits, K5 runs every step
and nothing waits on the host; the result is map_tpu's wherever map_tpu
takes its folded tier.
"""

from __future__ import annotations

from typing import Tuple

import torch

from map_tpu_torch.ops.embedding import embedding_lookup
from map_tpu_torch.ops.scatter_unique import scatter_unique_sorted


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
    # the gradient in sorted order, a row per column: PyTorch scans a
    # contiguous 1-D tensor with one device-wide scan, but the columns of an
    # (n, W) tensor with one thread each (260 ms for the MFP step's stream)
    cols = grads.t()[:, order]
    ends = torch.stack([c.cumsum(0) for c in cols])[:, end_pos]
    # sum of a segment = prefix at its end - prefix at the previous end; 0
    # past the last segment, whose end is the last position
    vals = ends - torch.cat([ends.new_zeros(ends.shape[0], 1), ends[:, :-1]], 1)
    return uids, vals.t().contiguous(), num_unique


class _DecoderGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, bias, ids):
        ctx.save_for_backward(ids)
        ctx.vocab_size = emb.shape[0]
        return embedding_lookup(emb, ids), bias[ids][..., 0]

    @staticmethod
    def backward(ctx, g_rows, g_bias):
        (ids,) = ctx.saved_tensors
        e = g_rows.shape[-1]
        g = torch.cat([g_rows.reshape(-1, e).float(),
                       g_bias.reshape(-1, 1).float()], dim=1)
        uids, vals, _ = sort_and_fold(ids.reshape(-1), g, ctx.vocab_size)
        d_emb, d_bias = scatter_unique_sorted(uids, vals, ctx.vocab_size,
                                              widths=(e, 1))
        return d_emb, d_bias, None


def decoder_gather(emb: torch.Tensor, bias: torch.Tensor, ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """emb (V, E) float32, bias (V, 1) float32, ids (...) int32 in [0, V)
    -> (rows (..., E), bias (...)); differentiable in emb and bias."""
    if torch.is_grad_enabled() and (emb.requires_grad or bias.requires_grad):
        return _DecoderGather.apply(emb, bias, ids)
    return embedding_lookup(emb, ids), bias[ids][..., 0]
