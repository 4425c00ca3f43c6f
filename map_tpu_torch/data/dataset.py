"""Preprocessed CTR artifacts, loaded into host RAM.

The port's copy of the in-RAM path of `map_tpu/data/dataset.py`, reading
`{name}-meta.json`, `split.pkl` and `{name}.h5` through `data/artifacts.py`.
The >RAM memmap mode is not ported yet (ROADMAP.md).

Pretraining statistics, as map_tpu derives them (`dataset.py:101-124`):
`feat_count`, the unigram of the train split (a float32 bincount over the
vocabulary), cached in `{data_dir}/feat-count.npy` (map_tpu's file and
format, so either package reuses the other's cache) and loaded only for a
pretraining run; `idx_low` / `idx_high`, each field's id range over all rows;
`field_blocked_ok`, whether those ranges are the blocks the hybrid lookup
(`ops/hybrid_gather.py`) slices: at or above the 10 reserved ids, ascending
and disjoint in field order (map_tpu `dataset.py:126-143`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from map_tpu_torch.data import artifacts
from map_tpu_torch.data.artifacts import NUM_RESERVED, compute_feat_count


def field_blocked_ok(idx_low: np.ndarray, idx_high: np.ndarray) -> bool:
    """True when every field's block starts at or above the reserved ids and
    the blocks ascend without overlap in field order."""
    idx_low, idx_high = np.asarray(idx_low), np.asarray(idx_high)
    return bool(idx_low.min() >= NUM_RESERVED
                and np.all(idx_low[1:] >= idx_high[:-1]))


class CTRDataset:
    """`X[split]` int32 (N, F) field-blocked ids and `Y[split]` float32 (N,)
    labels for the train / valid / test splits; `feat_count` (None unless
    `pretrain`), `idx_low` and `idx_high` (F,) int32, `field_blocked_ok`."""

    split_names = ("train", "valid", "test")

    def __init__(self, data_dir: str, dataset_name: str, pretrain: bool = False):
        _, self.feat_map, self.field_map = artifacts.read_meta(data_dir, dataset_name)
        split_index = artifacts.read_split(data_dir, self.split_names)
        feat_ids, labels = artifacts.read_ctr_h5(data_dir, dataset_name)
        feat_ids = np.ascontiguousarray(feat_ids.astype(np.int32))
        labels = np.ascontiguousarray(labels.astype(np.float32))
        self.X: Dict[str, np.ndarray] = {s: feat_ids[split_index[s]] for s in self.split_names}
        self.Y: Dict[str, np.ndarray] = {s: labels[split_index[s]] for s in self.split_names}
        # over all rows: valid / test ids may be unseen in train
        self.idx_low = feat_ids.min(axis=0).astype(np.int32)
        self.idx_high = (feat_ids.max(axis=0) + 1).astype(np.int32)
        self.field_blocked_ok = field_blocked_ok(self.idx_low, self.idx_high)
        self.feat_count: Optional[np.ndarray] = None
        if pretrain:
            path = artifacts.feat_count_path(data_dir)
            if os.path.exists(path):
                self.feat_count = np.load(path)
            else:
                self.feat_count = compute_feat_count(self.X["train"], self.input_size)
                np.save(path, self.feat_count)

    @property
    def num_fields(self) -> int:
        return len(self.field_map) - 1  # minus the reserved <rsv> field

    @property
    def input_size(self) -> int:
        return len(self.feat_map)
