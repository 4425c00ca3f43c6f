"""Supervised train and eval steps. Counterpart:
`map_tpu/train/train_step.py:207-263 make_supervised_steps` (the exact,
non-streaming eval step).

A step takes one host batch from `data/loader.Batcher`, copies it to the
device, and returns device tensors: nothing is read back, so the host runs
ahead of the card until a logging window or an eval pass reads the values.

train step: forward in train mode, the weighted BCE (`objectives`),
backward (K3 for the table, the cross-net chain from K2's residuals), then
one `AdamW.step` (K1 for every parameter); returns {loss, probs}.
eval step: forward in eval mode under `torch.inference_mode`; returns
{loss, logits, probs}.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from map_tpu_torch.objectives.supervised import bce_loss
from map_tpu_torch.train.optimizer import AdamW

Batch = Dict[str, np.ndarray]
Step = Callable[[Batch], Dict[str, torch.Tensor]]


def to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_supervised_steps(model: torch.nn.Module, optimizer: AdamW,
                          device: torch.device) -> Tuple[Step, Step]:
    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        b = to_device(batch, device)
        model.train()
        logits = model(b["input_ids"]).reshape(-1)
        loss = bce_loss(logits, b["labels"], b["weight"])
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "probs": torch.sigmoid(logits.detach().float())}

    @torch.inference_mode()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        b = to_device(batch, device)
        model.eval()
        logits = model(b["input_ids"]).reshape(-1).float()
        loss = bce_loss(logits, b["labels"], b["weight"])
        return {"loss": loss, "logits": logits, "probs": torch.sigmoid(logits)}

    return train_step, eval_step
