"""Model registry. Counterpart: `map_tpu/models/__init__.py`; the port
registers all of map_tpu's models but fgcnn and fignn, which ROADMAP.md
queues."""

from __future__ import annotations

from typing import Optional

import torch

from map_tpu_torch.config import Config, validate_model_config
from map_tpu_torch.models.base import CTRModel
from map_tpu_torch.models.zoo import (
    DCNV2,
    DNN,
    FM,
    LR,
    AutoInt,
    DeepFM,
    Transformer,
    XDeepFM,
)

MODEL_REGISTRY = {
    "lr": LR,
    "fm": FM,
    "dnn": DNN,
    "deepfm": DeepFM,
    "xdeepfm": XDeepFM,
    "dcnv2": DCNV2,
    "autoint": AutoInt,
    "trans": Transformer,
}


def from_config(config: Config,
                generator: Optional[torch.Generator] = None) -> CTRModel:
    """Build the model on the CPU and initialise it from `generator` (a CPU
    generator; None = seed 0). Move it to its device afterwards."""
    name = config.model_name.lower()
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {config.model_name!r} is not ported yet (map_tpu_torch has "
            f"{sorted(MODEL_REGISTRY)}); ROADMAP.md queues fignn, then fgcnn")
    validate_model_config(config)
    with torch.device("meta"):  # no allocation or draw until the init below
        model = MODEL_REGISTRY[name](config)
    model.to_empty(device="cpu")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.eval()
