"""CTRModel protocol: backbone -> final_vec -> supervised, MFP or RFD head.

Counterpart: `map_tpu/models/base.py` `CTRModel` (`create_pretraining_predictor`
:34-47, `_select_masked` :50, `mfp_candidate_logits` :62,
`mfp_shared_noise_logits` :76, `mfp_per_field_shared_logits` :90,
`mfp_full_scores` :107, `rfd_field_logits` :120-123, `__call__` :132).
The MFP head, built instead of the supervised one when `config.mfp`, is the
reference's (`code/models.py:114-126`): `feat_encoder` (Linear final_dim ->
num_fields * proj_size) and `mfp_criterion` (`objectives/nce.py`
IndexLinearDecoder). The RFD head, built when `config.rfd`, is the
reference's `pred_rfd` (`code/models.py:118-123`): Linear final_dim ->
num_fields * proj_size, ReLU, Linear -> num_fields, whose state_dict names
`pred_rfd.0.*` and `pred_rfd.2.*` are those map_tpu exchanges for its
`pred_rfd_hidden` and `pred_rfd_out` (`interop/torch_import.py:287-288`).
Both Linears compute in float32 (map_tpu's TorchDense with dtype=None
promotes a bf16 final_vec).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from map_tpu_torch.config import Config
from map_tpu_torch.nn.layers import TorchDense, reset_children
from map_tpu_torch.objectives.alias import noise_log_prior, per_field_log_prior
from map_tpu_torch.objectives.nce import IndexLinearDecoder


PRETRAINING_HEADS = ("feat_encoder", "mfp_criterion", "pred_rfd")


class SelectMasked(torch.autograd.Function):
    """enc (B, F, P), masked_index (B, M) -> enc[b, masked_index[b, m]]
    (B, M, P). The forward is `torch.gather`. Its backward would add the M
    slots' gradients into (B, F, P) by atomics, and with `randint` positions
    a row can name one field three or more times, so the sum's order (and
    its last bits) would change from run to run on the card. This backward
    adds slot by slot, m = 0, 1, ..., M - 1: within one slot every row
    names one field, so no two adds of a launch meet, and a repeated
    field's gradient is the same sum in the same order on every run
    (map_tpu's one-hot einsum, `map_tpu/models/base.py:52-59`, is a fixed-
    order product as well)."""

    @staticmethod
    def forward(ctx, enc: torch.Tensor, masked_index: torch.Tensor) -> torch.Tensor:
        idx = masked_index.long()[..., None].expand(-1, -1, enc.shape[-1])
        ctx.save_for_backward(idx)
        ctx.num_fields = enc.shape[1]
        return torch.gather(enc, 1, idx)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        b, m, p = grad.shape
        out = grad.new_zeros(b, ctx.num_fields, p)
        for j in range(m):
            out.scatter_add_(1, idx[:, j:j + 1], grad[:, j:j + 1])
        return out, None


class CTRModel(nn.Module):
    """Subclasses build their modules in __init__ and implement backbone()
    and supervised_logits(); they end __init__ with `finish`, which builds
    the pretraining head for a pretraining config. reset_parameters draws
    every parameter from the generator, module by module in the order they
    were registered, the pretraining head last."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config

    def finish(self, final_dim: int, head: Optional[str] = None) -> None:
        """The MFP or RFD head on the backbone's final_dim for a pretraining
        config, else the supervised head `head` (if named): a TorchDense
        from final_dim to one logit."""
        if self.config.mfp or self.config.rfd:
            self.create_pretraining_predictor(final_dim)
        elif head is not None:
            setattr(self, head, TorchDense(final_dim, 1))

    def create_pretraining_predictor(self, final_dim: int) -> None:
        c = self.config
        if c.rfd:
            self.pred_rfd = nn.Sequential(
                TorchDense(final_dim, c.num_fields * c.proj_size), nn.ReLU(),
                TorchDense(c.num_fields * c.proj_size, c.num_fields))
            return
        self.feat_encoder = TorchDense(final_dim, c.num_fields * c.proj_size)
        self.mfp_criterion = IndexLinearDecoder(c.input_size, c.proj_size)

    def reset_pretraining_predictor(self, generator: torch.Generator) -> None:
        """The decoder bias starts at log q + norm_term, q the noise
        distribution of `config.feat_count`: the global unigram and log V,
        or with `config.pt_per_field_noise` each id's unigram within its field
        and log of its field's size (map_tpu's trainer sets
        `config.logprob_noise` and `config.norm_term` so, `trainer.py:89-109`,
        and the decoder's init reads them, `objectives/nce.py:63-65`)."""
        c = self.config
        if c.rfd:
            self.pred_rfd[0].reset_parameters(generator)
            self.pred_rfd[2].reset_parameters(generator)
            return
        if c.feat_count is None:
            raise ValueError("the MFP head needs config.feat_count, the train "
                             "split's unigram counts")
        if c.pt_per_field_noise:
            if c.idx_low is None or c.idx_high is None:
                raise ValueError("per-field noise needs config.idx_low / idx_high, "
                                 "the fields' id ranges")
            logprob, norm_term = per_field_log_prior(c.feat_count, c.idx_low,
                                                     c.idx_high)
        else:
            _, logprob, norm_term = noise_log_prior(c.feat_count)
        self.feat_encoder.reset_parameters(generator)
        self.mfp_criterion.reset_parameters(generator, logprob, norm_term)

    @staticmethod
    def _select_masked(enc: torch.Tensor, masked_index: torch.Tensor) -> torch.Tensor:
        """(B, F, P) x (B, M) -> (B, M, P), an exact gather (map_tpu's one-hot
        einsum gives the same values) whose backward sums in a fixed order
        (`SelectMasked`)."""
        return SelectMasked.apply(enc, masked_index)

    def _masked_encoding(self, input_ids: torch.Tensor,
                         masked_index: torch.Tensor) -> torch.Tensor:
        """(B, F) corrupted ids, (B, M) masked positions -> (B, M, proj)."""
        c = self.config
        final_vec = self.backbone(input_ids)
        enc = self.feat_encoder(final_vec).reshape(final_vec.shape[0], c.num_fields,
                                                   c.proj_size)
        return self._select_masked(enc, masked_index)

    def mfp_candidate_logits(self, input_ids: torch.Tensor,
                             masked_index: torch.Tensor,
                             candidates: torch.Tensor) -> torch.Tensor:
        """(B, F) corrupted ids, (B, M) masked positions, (B, M, 1+k)
        [target || noise] ids -> raw decoder logits (B, M, 1+k)."""
        return self.mfp_criterion(self._masked_encoding(input_ids, masked_index),
                                  candidates)

    def mfp_shared_noise_logits(self, input_ids: torch.Tensor,
                                masked_index: torch.Tensor, target_idx: torch.Tensor,
                                noise_idx: torch.Tensor) -> torch.Tensor:
        """One noise set (k,) shared by the batch -> (B, M, 1+k)."""
        return self.mfp_criterion.shared_noise_logits(
            self._masked_encoding(input_ids, masked_index), target_idx, noise_idx)

    def mfp_per_field_shared_logits(self, input_ids: torch.Tensor,
                                    masked_index: torch.Tensor,
                                    target_idx: torch.Tensor,
                                    noise_f: torch.Tensor) -> torch.Tensor:
        """One noise set per field, noise_f (F, k); the masked position is
        the field, so it selects each position's set -> (B, M, 1+k)."""
        return self.mfp_criterion.per_field_shared_noise_logits(
            self._masked_encoding(input_ids, masked_index), target_idx,
            masked_index, noise_f)

    def mfp_full_scores(self, input_ids: torch.Tensor,
                        masked_index: torch.Tensor) -> torch.Tensor:
        """Scores over the whole vocabulary for the `full` loss -> (B, M, V)."""
        return self.mfp_criterion.full_scores(
            self._masked_encoding(input_ids, masked_index))

    def mfp_full_loss(self, input_ids: torch.Tensor, masked_index: torch.Tensor,
                      target_idx: torch.Tensor):
        """The `full` loss (B, M) and the target-scores-highest hits (B, M)."""
        return self.mfp_criterion.full_loss(
            self._masked_encoding(input_ids, masked_index), target_idx)

    def rfd_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, F) corrupted ids -> (B, F) float32 'was replaced' logits."""
        return self.pred_rfd(self.backbone(input_ids))

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator, skip=PRETRAINING_HEADS)
        if self.config.mfp or self.config.rfd:
            self.reset_pretraining_predictor(generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.config.rfd:
            return self.rfd_logits(input_ids)
        return self.supervised_logits(input_ids)
