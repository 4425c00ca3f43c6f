"""Model registry. Counterpart: `map_tpu/models/__init__.py`; the port
registers all ten of map_tpu's models under map_tpu's names."""

from __future__ import annotations

from typing import Optional

import torch

from map_tpu_torch.config import Config, validate_model_config
from map_tpu_torch.models.base import CTRModel
from map_tpu_torch.models.zoo import (
    DCNV2,
    DNN,
    FGCNN,
    FM,
    LR,
    FiGNN,
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
    "fgcnn": FGCNN,
    "fignn": FiGNN,
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
            f"model {config.model_name!r} is not one of map_tpu's "
            f"{sorted(MODEL_REGISTRY)}")
    validate_model_config(config)
    with torch.device("meta"):  # no allocation or draw until the init below
        model = MODEL_REGISTRY[name](config)
    model.to_empty(device="cpu")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model.reset_parameters(generator)
    return model.eval()
