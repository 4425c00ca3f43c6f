"""The `full` MFP loss over a row-sharded decoder. Counterpart: map_tpu's
`full_scores` and `full_ce_loss` (`map_tpu/objectives/nce.py:257-260,
284`) with the decoder's `emb` and `bias` row-sharded over the model axis,
whose vocabulary axis GSPMD splits; here an autograd Function over the
model group.

Each rank holds rows [lo, lo + rows) of V (`parallel/sharding`) and the
same (B, M, E) encodings (its data block); it scores its block,
(B, M, rows) = inputs @ emb.T + bias, and
- the normalizer: the max all_reduced over the group, then the sum of
  exp(score - max), so log-sum-exp = log(sum) + max;
- the target's logit: the rank that owns the target reads it, the others
  give 0, summed over the group; the loss is log-sum-exp - logit;
- the accuracy: the target scores highest where the lowest global id at
  the global max is the target (`jnp.argmax` and `torch.argmax` break ties
  toward the lowest id): the max, then the min of the ids at it,
  all_reduced;
- backward: softmax - one-hot on the block gives the block's dense `emb`
  and `bias` gradients (summed over the data axis by the step's gradient
  all_reduce, then K1 on the block); the input gradient, each rank's
  block's part, is summed over the model group.

The scores stay on the rank: (B, M, V / M) float32, kept for the backward,
which turns them into the softmax in place. No host read, so a CUDA graph
can capture it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from map_tpu_torch.parallel.mesh import Group
from map_tpu_torch.parallel.sharding import shard_of


def _block_scores(inputs: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor
                  ) -> torch.Tensor:
    """(B, M, E) x this rank's (rows, E) and (rows, 1) -> (B, M, rows), in
    the promoted dtype, as the unsharded `full_scores` computes them."""
    dt = torch.promote_types(inputs.dtype, emb.dtype)
    return torch.einsum("bme,ve->bmv", inputs.to(dt), emb.to(dt)) + bias[:, 0]


class _ShardedFullCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, emb, bias, target, group):
        shard = shard_of(emb)
        if shard is None:
            raise ValueError("sharded_full_ce needs the decoder's row blocks")
        scores = _block_scores(inputs, emb, bias)
        local_max, local_arg = scores.max(-1)
        top = group.all_reduce_(local_max.clone(), "max")
        local = target.long() - shard.lo
        own = (local >= 0) & (local < shard.rows)
        local = torch.where(own, local, 0)
        logit = torch.gather(scores, -1, local[..., None])[..., 0]
        logit = group.all_reduce_(torch.where(own, logit, 0.0), "sum")
        best = torch.where(local_max == top, local_arg + shard.lo, shard.total)
        best = group.all_reduce_(best, "min")
        probs = scores.sub_(top[..., None]).exp_()  # the scores' buffer, in place
        total = group.all_reduce_(probs.sum(-1), "sum")
        loss = torch.log(total) + top - logit
        hit = (best == target.long()).float()
        ctx.mark_non_differentiable(hit)
        ctx.group, ctx.dtypes = group, (inputs.dtype, bias.dtype)
        ctx.save_for_backward(inputs, emb, probs, total, local, own)
        return loss, hit

    @staticmethod
    def backward(ctx, grad_loss, _grad_hit):
        inputs, emb, probs, total, local, own = ctx.saved_tensors
        # softmax - one-hot, times the loss's gradient (in place: a Function
        # whose backward runs once)
        g = probs.div_(total[..., None])
        g.scatter_add_(-1, local[..., None], -own.to(g.dtype)[..., None])
        g.mul_(grad_loss.to(g.dtype)[..., None])
        x = inputs.to(g.dtype)
        d_emb = torch.einsum("bmv,bme->ve", g, x)
        d_bias = g.sum((0, 1))[:, None]
        d_in = ctx.group.all_reduce_(torch.einsum("bmv,ve->bme", g, emb.to(g.dtype)), "sum")
        in_dtype, bias_dtype = ctx.dtypes
        return d_in.to(in_dtype), d_emb.to(emb.dtype), d_bias.to(bias_dtype), None, None


def sharded_full_ce(inputs: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                    target: torch.Tensor, group: Group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs (B, M, E), the same on every rank of `group`; emb (rows, E)
    and bias (rows, 1), this rank's row blocks of the decoder; target
    (B, M) global ids -> (the cross-entropy over all V ids (B, M), whether
    the target scores highest (B, M) float, ties to the lowest id)."""
    return _ShardedFullCE.apply(inputs, emb, bias, target, group)


def gathered_full_scores(inputs: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor,
                         group: Group) -> torch.Tensor:
    """The whole (B, M, V) scores from every rank's block (a collective over
    `group`; not differentiable: the loss goes through `sharded_full_ce`)."""
    shard = shard_of(emb)
    per = -(-shard.total // group.size)
    with torch.no_grad():
        block = _block_scores(inputs, emb, bias)
        padded = torch.nn.functional.pad(block, (0, per - shard.rows))
        parts = group.all_gather(padded)  # (size, B, M, per)
    return torch.cat(list(parts.unbind(0)), -1)[..., :shard.total]
