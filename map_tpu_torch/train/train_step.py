"""Supervised and MFP train and eval steps. Counterpart:
`map_tpu/train/train_step.py:207-263 make_supervised_steps` (the exact,
non-streaming eval step) and `:270-531 make_mfp_steps` (the per-position
path, `nce` and `sampled` losses).

A step takes one host batch from `data/loader.Batcher`, copies it to the
device, and returns device tensors: nothing is read back, so the host runs
ahead of the card until a logging window or an eval pass reads the values.

supervised train step: forward in train mode, the weighted BCE
(`objectives`), backward (K3 for the table, the cross-net chain from K2's
residuals), then one `AdamW.step` (K1 for every parameter); returns
{loss, probs}. eval step: forward in eval mode under
`torch.inference_mode`; returns {loss, logits, probs}.

MFP train step: masked positions and noise drawn on the device from the
step's generator (or handed in as `draws`), the corruption, the candidate
logits through the MFP head (K4 for the candidate rows, K5 for their
gradient), the per-position loss weighted by the example weights over
max(sum w, 1) * mask_num, backward and one `AdamW.step`; returns {loss,
count = sum w * mask_num, acc_count}. The eval step does the same forward
under `torch.inference_mode` with the generator it is given.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from map_tpu_torch.config import Config
from map_tpu_torch.objectives import alias, corruption
from map_tpu_torch.objectives.nce import (
    mfp_accuracy_count,
    nce_loss,
    sampled_softmax_loss,
)
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


class MFPDraws(NamedTuple):
    """One step's random draws: masked positions (B, M), noise ids
    (B, M, k) int32 and their log-probabilities (B, M, k) float32."""

    masked_index: torch.Tensor
    noise: torch.Tensor
    noise_logq: torch.Tensor


class NoiseTables(NamedTuple):
    """The noise distribution on the device: the fused (V, 4) alias table
    (`objectives/alias.build_fused_alias`), log q (V,) float32 and
    norm_term = log V."""

    fused: torch.Tensor
    logprob: torch.Tensor
    norm_term: float


def draw_mfp(generator: torch.Generator, tables: NoiseTables, batch_size: int,
             num_fields: int, mask_num: int, k: int, sampling_method: str
             ) -> MFPDraws:
    masked_index = corruption.sample_masked_index(
        generator, batch_size, num_fields, mask_num, sampling_method,
        tables.fused.device)
    noise, noise_logq = alias.alias_draw_logq(generator, tables.fused,
                                              (batch_size, mask_num, k))
    return MFPDraws(masked_index, noise, noise_logq)


def make_mfp_steps(model: torch.nn.Module, optimizer: AdamW, config: Config,
                   mask_ratio: float, sampling_method: str, tables: NoiseTables,
                   generator: torch.Generator, device: torch.device):
    """-> (train_step(batch, draws=None), eval_step(batch, generator))."""
    mask_num = corruption.mask_num_of(config.num_fields, mask_ratio)
    k = int(config.pt_neg_num)
    loss_type = config.nce_loss_type
    if loss_type not in ("nce", "sampled"):
        raise NotImplementedError(f"nce_loss_type={loss_type} (ROADMAP.md)")

    def forward(b, draws: MFPDraws):
        corrupted, labels = corruption.mfp_corrupt(b["input_ids"], draws.masked_index)
        candidates = torch.cat([labels[..., None], draws.noise.to(labels.dtype)], -1)
        cand_logq = torch.cat([tables.logprob[labels][..., None], draws.noise_logq], -1)
        logits = model.mfp_candidate_logits(corrupted, draws.masked_index, candidates)
        if loss_type == "nce":
            per_pos = nce_loss(logits, cand_logq, tables.norm_term, k)
        else:
            per_pos = sampled_softmax_loss(logits, cand_logq, tables.norm_term)
        w = b["weight"]
        loss = (per_pos * w[:, None]).sum() / (torch.clamp_min(w.sum(), 1.0) * mask_num)
        return loss, {"loss": loss.detach(), "count": w.sum() * mask_num,
                      "acc_count": mfp_accuracy_count(logits.detach(), w)}

    def draw(gen, b) -> MFPDraws:
        return draw_mfp(gen, tables, b["input_ids"].shape[0], config.num_fields,
                        mask_num, k, sampling_method)

    def train_step(batch: Batch, draws: Optional[MFPDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        b = to_device(batch, device)
        if draws is None:
            draws = draw(generator, b)
        else:
            draws = MFPDraws(*(t.to(device) for t in draws))
        model.train()
        loss, metrics = forward(b, draws)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return metrics

    @torch.inference_mode()
    def eval_step(batch: Batch, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        b = to_device(batch, device)
        model.eval()
        return forward(b, draw(gen, b))[1]

    return train_step, eval_step
