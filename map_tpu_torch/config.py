"""The model fields of map_tpu's `config.json` that the port reads.

Counterpart: `map_tpu/config.py` `Config` / `Config.load`. map_tpu's Config is
a free-form bag; the port keeps a dataclass of the fields its modules read and
carries every other key along in `extra`, unread. Defaults are what map_tpu's
model code assumes when a key is absent (`getattr(config, key, default)` in
`map_tpu/models/zoo.py`), so a config.json without `compute_dtype` runs in
float32 in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Config:
    model_name: str = "dcnv2"
    input_size: int = 0
    num_fields: int = 0
    embed_size: int = 32
    hidden_size: int = 128
    num_hidden_layers: int = 1
    hidden_act: str = "relu"
    num_cross_layers: int = 1
    embed_norm: bool = False
    layer_norm_eps: float = 1e-12
    embed_dropout_rate: float = 0.0
    hidden_dropout_rate: float = 0.0
    compute_dtype: str = "float32"
    packed_tables: bool = False
    idx_low: Optional[List[int]] = None
    idx_high: Optional[List[int]] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        known = {k: v for k, v in d.items() if k in names}
        if known.get("compute_dtype") is None:
            known.pop("compute_dtype", None)
        return cls(**known, extra={k: v for k, v in d.items() if k not in names})

    @classmethod
    def load(cls, load_directory: str) -> "Config":
        with open(os.path.join(load_directory, "config.json"), "r",
                  encoding="utf-8") as f:
            return cls.from_dict(json.load(f))
