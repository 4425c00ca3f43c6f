"""The MFP decoder and its losses. Counterpart: `map_tpu/objectives/nce.py`
(`bce_with_logits` :38, `IndexLinearDecoder` :43-183 with unpacked storage,
`nce_loss` :263, `sampled_softmax_loss` :277, `mfp_accuracy_count` :290).

`IndexLinearDecoder` holds the reference's `mfp_criterion` (the torch names
of `code/nce/index_linear.py`): `emb.weight` (V, proj), uniform in
+-1/sqrt(proj), and `bias.weight` (V, 1), initialised to the noise
log-prior + norm_term. It scores candidate ids per masked position,
logits = <inputs, emb[ids]> + bias[ids], through `ops/dedup_scatter.py`
(K4 forward, K5 backward). As in map_tpu, the float32 parameters promote the
products to float32 whatever the compute dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from map_tpu_torch.ops.dedup_scatter import decoder_gather


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise max(x, 0) - x * y + log(1 + exp(-|x|))."""
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


class _Table(nn.Module):
    """A bare `weight` parameter, so the state_dict keys read `emb.weight`
    and `bias.weight` as the reference's nn.Embedding tables do."""

    def __init__(self, rows: int, cols: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(rows, cols))


class IndexLinearDecoder(nn.Module):
    def __init__(self, input_size: int, proj_size: int):
        super().__init__()
        self.input_size = input_size
        self.proj_size = proj_size
        self.emb = _Table(input_size, proj_size)
        self.bias = _Table(input_size, 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         logprob_noise: np.ndarray, norm_term: float) -> None:
        bound = 1.0 / math.sqrt(self.proj_size)
        self.emb.weight.uniform_(-bound, bound, generator=generator)
        prior = np.asarray(logprob_noise, np.float32) + norm_term  # float32
        self.bias.weight.copy_(torch.from_numpy(prior).reshape(-1, 1))

    def forward(self, inputs: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """inputs (B, M, E), indices (B, M, C) int32 -> logits (B, M, C)."""
        rows, b = decoder_gather(self.emb.weight, self.bias.weight, indices)
        dt = torch.promote_types(inputs.dtype, rows.dtype)
        return torch.einsum("bme,bmce->bmc", inputs.to(dt), rows.to(dt)) + b


def nce_loss(model_logits: torch.Tensor, noise_logprobs: torch.Tensor,
             norm_term: float, noise_ratio: int) -> torch.Tensor:
    """'nce': (B, M, 1+k) raw scores and noise log-probs, slot 0 the target
    -> (B, M) sum over the candidates of the BCE terms."""
    logit_true = (model_logits - norm_term) - noise_logprobs - math.log(noise_ratio)
    labels = torch.zeros_like(logit_true)
    labels[:, :, 0] = 1.0
    return bce_with_logits(logit_true, labels).sum(dim=2)


def sampled_softmax_loss(model_logits: torch.Tensor, noise_logprobs: torch.Tensor,
                         norm_term: float) -> torch.Tensor:
    """'sampled': cross-entropy of class 0 on the q-corrected logits -> (B, M)."""
    logits = (model_logits - norm_term) - noise_logprobs
    return -torch.log_softmax(logits, dim=-1)[:, :, 0]


def mfp_accuracy_count(candidate_logits: torch.Tensor,
                       position_weight: torch.Tensor) -> torch.Tensor:
    """Count of real positions where the target outranks every noise."""
    hit = (torch.argmax(candidate_logits, dim=2) == 0).float()
    return torch.sum(hit * position_weight[:, None])
