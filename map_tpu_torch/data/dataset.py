"""Preprocessed CTR artifacts, loaded into host RAM.

The port's copy of the in-RAM path of `map_tpu/data/dataset.py` and the
readers of `map_tpu/data/artifacts.py` it uses: `{name}-meta.json`
(field_names, feat_map, field_map with the `<rsv>` field first), `split.pkl`
({train,valid,test}_index arrays) and `{name}.h5` (feat_ids, labels). The
>RAM memmap mode is not ported yet (ROADMAP.md).

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

import json
import os
import pickle
from typing import Dict, Optional

import numpy as np

NUM_RESERVED = 10  # ids 0-9: <pad>, <cls>, <sep>, <mask>, ... (map_tpu dataset.py)


def feat_count_path(data_dir: str) -> str:
    return os.path.join(data_dir, "feat-count.npy")


def field_blocked_ok(idx_low: np.ndarray, idx_high: np.ndarray) -> bool:
    """True when every field's block starts at or above the reserved ids and
    the blocks ascend without overlap in field order."""
    idx_low, idx_high = np.asarray(idx_low), np.asarray(idx_high)
    return bool(idx_low.min() >= NUM_RESERVED
                and np.all(idx_low[1:] >= idx_high[:-1]))


def compute_feat_count(train_feat_ids: np.ndarray, vocab_size: int) -> np.ndarray:
    """Global per-feature frequency over the train split (map_tpu
    `artifacts.py:225`)."""
    return np.bincount(train_feat_ids.ravel(), minlength=vocab_size).astype(np.float32)


class CTRDataset:
    """`X[split]` int32 (N, F) field-blocked ids and `Y[split]` float32 (N,)
    labels for the train / valid / test splits; `feat_count` (None unless
    `pretrain`), `idx_low` and `idx_high` (F,) int32, `field_blocked_ok`."""

    split_names = ("train", "valid", "test")

    def __init__(self, data_dir: str, dataset_name: str, pretrain: bool = False):
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
        # over all rows: valid / test ids may be unseen in train
        self.idx_low = feat_ids.min(axis=0).astype(np.int32)
        self.idx_high = (feat_ids.max(axis=0) + 1).astype(np.int32)
        self.field_blocked_ok = field_blocked_ok(self.idx_low, self.idx_high)
        self.feat_count: Optional[np.ndarray] = None
        if pretrain:
            path = feat_count_path(data_dir)
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
