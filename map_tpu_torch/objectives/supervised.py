"""Supervised binary-CTR objective. Counterparts:
`map_tpu/objectives/nce.py:38 bce_with_logits` and
`map_tpu/objectives/supervised.py:15 bce_loss`.

The weighted mean of BCEWithLogits in float32: padding rows of a batch carry
weight 0 and contribute nothing (the loader pads the last batch).
"""

from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise max(x, 0) - x*y + log(1 + exp(-|x|))."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             weight: torch.Tensor, count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,) or (B, 1); labels (B,); weight (B,) in {0, 1}; `count`
    the global batch's weight sum under data parallelism (default: this
    batch's), the loss's denominator."""
    per_ex = bce_with_logits(logits.reshape(-1).float(), labels.reshape(-1).float())
    denom = torch.clamp(weight.sum() if count is None else count, min=1.0)
    return (per_ex * weight).sum() / denom
