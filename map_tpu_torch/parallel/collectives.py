"""The collectives of a data-parallel step, over the data group.

- `all_reduce_sum`: a differentiable sum over the group. Each rank's loss
  is its part of the global loss, so the gradient of a summed value is the
  sum of every rank's gradient: the backward all_reduces too (FGCNN's
  BatchNorm statistics, `nn/layers.BatchNorm`).
- `global_count`: a batch's weight summed over the group, the denominator
  of the global loss (map_tpu `objectives/supervised.py:16-21` normalises
  over the global batch; a mean of per-rank means is wrong when the padded
  last batch leaves ranks unequal real rows).
- `reduce_sums`: the named metrics of a step summed over the group, in one
  collective.
- `all_reduce_flat_`: a list of tensors summed over the group as one flat
  buffer, in list order (the dense gradients before K1).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

from map_tpu_torch.parallel.mesh import Group


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(grad.clone()), None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def global_count(weight: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """sum(weight) over the data group (over this rank without one)."""
    total = weight.sum()
    return total if group is None else group.all_reduce_(total)


def reduce_sums(metrics: Dict[str, torch.Tensor], keys: Iterable[str],
                group: Optional[Group]) -> Dict[str, torch.Tensor]:
    """`metrics` with the tensors named in `keys` summed over the group."""
    keys = [k for k in keys if k in metrics]
    if group is None or not keys:
        return metrics
    parts = [metrics[k].detach().float().reshape(-1) for k in keys]
    flat = group.all_reduce_(torch.cat(parts))
    out = dict(metrics)
    for k, piece in zip(keys, flat.split([p.numel() for p in parts])):
        out[k] = piece.reshape(metrics[k].shape).to(metrics[k].dtype)
    return out


# every tensor starts on a 16-float boundary of the flat buffer, so its
# view is 64-byte aligned for the kernels' vector loads
_ALIGN = 16


def all_reduce_flat_(tensors: List[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """float32 tensors -> the same, summed over the group: one buffer, one
    collective; returns views of the buffer, in order."""
    sizes = [t.numel() for t in tensors]
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += -(-n // _ALIGN) * _ALIGN
    flat = torch.zeros(at, dtype=torch.float32, device=tensors[0].device)
    for t, o, n in zip(tensors, offsets, sizes):
        flat[o:o + n].copy_(t.reshape(-1))
    group.all_reduce_(flat)
    return [flat[o:o + n].view(t.shape) for t, o, n in zip(tensors, offsets, sizes)]
