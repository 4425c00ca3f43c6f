"""CTRModel protocol: backbone -> final_vec -> supervised head.

Counterpart: `map_tpu/models/base.py` `CTRModel`. The port has the supervised
head only; the MFP / RFD pretraining heads come with their slices
(ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from map_tpu_torch.config import Config


class CTRModel(nn.Module):
    """Subclasses build their modules in __init__ and implement backbone(),
    supervised_logits() and reset_parameters(generator)."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.supervised_logits(input_ids)
