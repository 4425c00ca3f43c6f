"""CTRModel protocol: backbone -> final_vec -> supervised head or MFP head.

Counterpart: `map_tpu/models/base.py` `CTRModel` (`create_pretraining_predictor`
:34-47, `_select_masked` :50, `mfp_candidate_logits` :62, `__call__` :132).
The MFP head, built instead of the supervised one when `config.mfp`, is the
reference's (`code/models.py:114-126`): `feat_encoder` (Linear final_dim ->
num_fields * proj_size) and `mfp_criterion` (`objectives/nce.py`
IndexLinearDecoder). The RFD head comes with its slice (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from map_tpu_torch.config import Config
from map_tpu_torch.nn.layers import TorchDense
from map_tpu_torch.objectives.alias import noise_log_prior
from map_tpu_torch.objectives.nce import IndexLinearDecoder


class CTRModel(nn.Module):
    """Subclasses build their modules in __init__ and implement backbone(),
    supervised_logits() and reset_parameters(generator)."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config

    def create_pretraining_predictor(self, final_dim: int) -> None:
        c = self.config
        self.feat_encoder = TorchDense(final_dim, c.num_fields * c.proj_size)
        self.mfp_criterion = IndexLinearDecoder(c.input_size, c.proj_size)

    def reset_pretraining_predictor(self, generator: torch.Generator) -> None:
        """The decoder bias starts at log q + log V, q the noise
        distribution of `config.feat_count`."""
        c = self.config
        if c.feat_count is None:
            raise ValueError("the MFP head needs config.feat_count, the train "
                             "split's unigram counts")
        _, logprob, norm_term = noise_log_prior(c.feat_count)
        self.feat_encoder.reset_parameters(generator)
        self.mfp_criterion.reset_parameters(generator, logprob, norm_term)

    @staticmethod
    def _select_masked(enc: torch.Tensor, masked_index: torch.Tensor) -> torch.Tensor:
        """(B, F, P) x (B, M) -> (B, M, P), an exact gather (map_tpu's one-hot
        einsum gives the same values)."""
        idx = masked_index.long()[..., None].expand(-1, -1, enc.shape[-1])
        return torch.gather(enc, 1, idx)

    def mfp_candidate_logits(self, input_ids: torch.Tensor,
                             masked_index: torch.Tensor,
                             candidates: torch.Tensor) -> torch.Tensor:
        """(B, F) corrupted ids, (B, M) masked positions, (B, M, 1+k)
        [target || noise] ids -> raw decoder logits (B, M, 1+k)."""
        c = self.config
        final_vec = self.backbone(input_ids)
        enc = self.feat_encoder(final_vec).reshape(final_vec.shape[0], c.num_fields,
                                                   c.proj_size)
        return self.mfp_criterion(self._select_masked(enc, masked_index), candidates)

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.supervised_logits(input_ids)
