"""The MFP decoder and its losses. Counterpart: `map_tpu/objectives/nce.py`
(`bce_with_logits` :38, `IndexLinearDecoder` :43-260 with unpacked storage,
`nce_loss` :263, `sampled_softmax_loss` :277, `full_ce_loss` :284,
`mfp_accuracy_count` :290).

`IndexLinearDecoder` holds the reference's `mfp_criterion` (the torch names
of `code/nce/index_linear.py`): `emb.weight` (V, proj), uniform in
+-1/sqrt(proj), and `bias.weight` (V, 1), initialised to the noise
log-prior + norm_term (per id, in per-field mode). It scores
- candidate ids per masked position (per-position noise),
  logits = <inputs, emb[ids]> + bias[ids];
- the targets against one noise set shared by the batch
  (`shared_noise_logits`), or one set per field (`per_field_shared_noise_logits`);
- the whole vocabulary (`full_scores`, the `full` loss: `full_loss`, under
  a table mesh over the row blocks, `parallel/vocab_ce.py`).
Row lookups go through `ops/dedup_scatter.py` (K4 forward; fold, then K5 or,
with a `handoff` set, the sparse table update K7). As in map_tpu, the
float32 parameters promote the products to float32 whatever the compute
dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from map_tpu_torch.ops.dedup_scatter import _model_group, decoder_gather
from map_tpu_torch.ops.sparse_adamw import StreamHandoff
from map_tpu_torch.parallel.sharding import shard_of
from map_tpu_torch.parallel.vocab_ce import gathered_full_scores, sharded_full_ce


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
        # set by the Trainer when the sparse table update engages
        # (`ops/sparse_adamw.engages`): the shared modes' backward then hands
        # the emb streams to the optimizer
        self.handoff: Optional[StreamHandoff] = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         logprob_noise: np.ndarray, norm_term) -> None:
        """norm_term: a float (log V) or, in per-field mode, a (V,) array."""
        bound = 1.0 / math.sqrt(self.proj_size)
        self.emb.weight.uniform_(-bound, bound, generator=generator)
        prior = np.asarray(logprob_noise, np.float32) + norm_term  # float32
        self.bias.weight.copy_(torch.from_numpy(prior).reshape(-1, 1))

    def _rows(self, ids: torch.Tensor, stream: str):
        return decoder_gather(self.emb.weight, self.bias.weight, ids, self.handoff,
                              stream)

    @staticmethod
    def _dtype(inputs: torch.Tensor, rows: torch.Tensor) -> torch.dtype:
        return torch.promote_types(inputs.dtype, rows.dtype)

    def forward(self, inputs: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """inputs (B, M, E), indices (B, M, C) int32 -> logits (B, M, C)."""
        rows, b = decoder_gather(self.emb.weight, self.bias.weight, indices)
        dt = self._dtype(inputs, rows)
        return torch.einsum("bme,bmce->bmc", inputs.to(dt), rows.to(dt)) + b

    def target_scores(self, inputs: torch.Tensor, target_idx: torch.Tensor
                      ) -> torch.Tensor:
        """(B, M, E) x (B, M) -> (B, M) = <inputs, emb[t]> + bias[t]."""
        rows, b = self._rows(target_idx, "target")
        dt = self._dtype(inputs, rows)
        return torch.einsum("bme,bme->bm", inputs.to(dt), rows.to(dt)) + b

    def shared_noise_logits(self, inputs: torch.Tensor, target_idx: torch.Tensor,
                            noise_idx: torch.Tensor) -> torch.Tensor:
        """One noise set shared by the batch (the reference's per_word=False,
        `index_linear.py:108-143`): inputs (B, M, E), target_idx (B, M),
        noise_idx (k,) -> (B, M, 1 + k); the noise side one (B*M, E) x (E, k)
        product."""
        target = self.target_scores(inputs, target_idx)
        rows, b = self._rows(noise_idx, "noise")
        dt = self._dtype(inputs, rows)
        noise = torch.einsum("bme,ke->bmk", inputs.to(dt), rows.to(dt)) + b
        return torch.cat([target[..., None], noise], dim=-1)

    def per_field_shared_noise_logits(self, inputs: torch.Tensor,
                                      target_idx: torch.Tensor, fields: torch.Tensor,
                                      noise_f: torch.Tensor) -> torch.Tensor:
        """One noise set per field: inputs (B, M, E), target_idx (B, M),
        fields (B, M) the masked field of each position, noise_f (F, k)
        -> (B, M, 1 + k). All fields' sets are scored in one
        (B*M, E) x (E, F*k) product, as map_tpu does; each position then
        keeps its own field's k scores by an exact gather (map_tpu's one-hot
        contraction gives the same values)."""
        target = self.target_scores(inputs, target_idx)
        f, k = noise_f.shape
        rows, b = self._rows(noise_f.reshape(-1), "noise")
        dt = self._dtype(inputs, rows)
        scores = torch.einsum("bme,ne->bmn", inputs.to(dt), rows.to(dt)) + b
        cols = fields.long()[..., None] * k + torch.arange(k, device=fields.device)
        return torch.cat([target[..., None], torch.gather(scores, 2, cols)], dim=-1)

    def full_scores(self, inputs: torch.Tensor) -> torch.Tensor:
        """Scores over the whole vocabulary (`index_linear.py:145-151`):
        (B, M, E) -> (B, M, V). Under a table mesh every rank scores its row
        block and the blocks are gathered over the model group (not
        differentiable: the loss goes through `full_loss`)."""
        emb = self.emb.weight
        if shard_of(emb) is not None:
            return gathered_full_scores(inputs, emb, self.bias.weight, _model_group())
        dt = self._dtype(inputs, emb)
        return (torch.einsum("bme,ve->bmv", inputs.to(dt), emb.to(dt))
                + self.bias.weight[:, 0])

    def full_loss(self, inputs: torch.Tensor, target: torch.Tensor):
        """The `full` loss: (B, M, E), (B, M) target ids -> (the exact
        cross-entropy over V (B, M), whether the target scores highest
        (B, M) float, ties to the lowest id, as argmax breaks them). Under a
        table mesh `parallel/vocab_ce.sharded_full_ce` over the row blocks."""
        emb = self.emb.weight
        if shard_of(emb) is not None:
            return sharded_full_ce(inputs, emb, self.bias.weight, target, _model_group())
        scores = self.full_scores(inputs)
        hit = (torch.argmax(scores.detach(), dim=-1) == target.long()).float()
        return full_ce_loss(scores, target), hit


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


def full_ce_loss(full_scores: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """'full': exact cross-entropy over V. full_scores (B, M, V), target
    (B, M) -> (B, M)."""
    logp = torch.log_softmax(full_scores, dim=-1)
    return -torch.gather(logp, -1, target.long()[..., None])[..., 0]


def mfp_accuracy_count(candidate_logits: torch.Tensor,
                       position_weight: torch.Tensor) -> torch.Tensor:
    """Count of real positions where the target outranks every noise."""
    hit = (torch.argmax(candidate_logits, dim=2) == 0).float()
    return torch.sum(hit * position_weight[:, None])
