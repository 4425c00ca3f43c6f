"""Model registry. Counterpart: `map_tpu/models/__init__.py`; the port
registers dcnv2 only so far."""

from __future__ import annotations

from typing import Optional

import torch

from map_tpu_torch.config import Config
from map_tpu_torch.models.base import CTRModel
from map_tpu_torch.models.zoo import DCNV2

MODEL_REGISTRY = {"dcnv2": DCNV2}


def from_config(config: Config,
                generator: Optional[torch.Generator] = None) -> CTRModel:
    """Build the model on the CPU and initialise it from `generator` (a CPU
    generator; None = seed 0). Move it to its device afterwards."""
    name = config.model_name.lower()
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {config.model_name!r} is not ported yet (map_tpu_torch has "
            f"{sorted(MODEL_REGISTRY)}); ROADMAP.md queues the rest of the zoo")
    with torch.device("meta"):  # no allocation or draw until the init below
        model = MODEL_REGISTRY[name](config)
    model.to_empty(device="cpu")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.eval()
