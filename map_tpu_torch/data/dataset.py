"""Preprocessed CTR artifacts, loaded into host RAM.

The port's copy of the in-RAM path of `map_tpu/data/dataset.py` and the
readers of `map_tpu/data/artifacts.py` it uses: `{name}-meta.json`
(field_names, feat_map, field_map with the `<rsv>` field first), `split.pkl`
({train,valid,test}_index arrays) and `{name}.h5` (feat_ids, labels). The
>RAM memmap mode is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict

import numpy as np


class CTRDataset:
    """`X[split]` int32 (N, F) field-blocked ids and `Y[split]` float32 (N,)
    labels for the train / valid / test splits."""

    split_names = ("train", "valid", "test")

    def __init__(self, data_dir: str, dataset_name: str):
        import h5py

        with open(os.path.join(data_dir, f"{dataset_name}-meta.json"), "r") as f:
            meta = json.load(f)
        self.feat_map = meta["feat_map"]
        self.field_map = meta["field_map"]
        # split.pkl is written by the repo's own preprocessing
        with open(os.path.join(data_dir, "split.pkl"), "rb") as f:
            split_index = pickle.load(f)
        with h5py.File(os.path.join(data_dir, f"{dataset_name}.h5"), "r") as f:
            feat_ids = np.ascontiguousarray(f["feat_ids"][:].astype(np.int32))
            labels = np.ascontiguousarray(f["labels"][:].astype(np.float32))
        self.X: Dict[str, np.ndarray] = {}
        self.Y: Dict[str, np.ndarray] = {}
        for s in self.split_names:
            idx = np.asarray(split_index[f"{s}_index"])
            self.X[s] = feat_ids[idx]
            self.Y[s] = labels[idx]

    @property
    def num_fields(self) -> int:
        return len(self.field_map) - 1  # minus the reserved <rsv> field

    @property
    def input_size(self) -> int:
        return len(self.feat_map)
