"""Preprocessed CTR artifacts, in host RAM or memory-mapped.

The port's copy of `map_tpu/data/dataset.py`, reading `{name}-meta.json`,
`split.pkl` and `{name}.h5` through `data/artifacts.py`.

The >RAM mode (map_tpu `dataset.py:43-62`, `:74-98`): when the in-RAM
path's peak, (max(stored itemsize, 4) + 4) bytes an element of the h5's
matrix (the stored matrix beside its int32 copy, then the int32 matrix
beside the split copies), exceeds the host budget, the splits are
converted once, in chunks, into per-split memmap files
(`artifacts.materialize_split_memmaps`, map_tpu's files), and `X[split]` /
`Y[split]` are read-only memmaps of them, which every process maps through
the shared page cache. `host_data_budget_mb`: -1 always in RAM, 0 auto (60 %
of the physical RAM), > 0 a budget in MB. The batches, `feat_count` and
the fields' ranges are the in-RAM path's, bit for bit. Without an h5 (a
split's files written from rows in memory, `artifacts.write_split_memmaps`)
the matrix is the splits' memmaps and the fields' ranges are theirs.

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


def split_field_ranges(xs, chunk_rows: int = 1 << 20):
    """Each field's (min, max + 1) int32 over the rows of the matrices
    `xs`, read in chunks."""
    lo = hi = None
    for x in xs:
        for i in range(0, len(x), chunk_rows):
            c = np.asarray(x[i:i + chunk_rows])
            clo, chi = c.min(axis=0), c.max(axis=0)
            lo, hi = (clo, chi) if lo is None else (np.minimum(lo, clo), np.maximum(hi, chi))
    return lo.astype(np.int32), (hi + 1).astype(np.int32)


def field_blocked_ok(idx_low: np.ndarray, idx_high: np.ndarray) -> bool:
    """True when every field's block starts at or above the reserved ids and
    the blocks ascend without overlap in field order."""
    idx_low, idx_high = np.asarray(idx_low), np.asarray(idx_high)
    return bool(idx_low.min() >= NUM_RESERVED
                and np.all(idx_low[1:] >= idx_high[:-1]))


def over_host_budget(rows: int, num_fields: int, itemsize: int, budget_mb: int) -> bool:
    """True when the in-RAM path's peak, (max(itemsize, 4) + 4) bytes an
    element, exceeds the budget (-1: never; 0: 60 % of physical RAM)."""
    budget_mb = int(budget_mb or 0)
    if budget_mb < 0:
        return False
    need = (max(itemsize, 4) + 4) * rows * num_fields
    if budget_mb == 0:
        try:
            budget = int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") * 0.6)
        except (ValueError, OSError):
            return False
    else:
        budget = budget_mb << 20
    return need > budget


class CTRDataset:
    """`X[split]` int32 (N, F) field-blocked ids and `Y[split]` float32 (N,)
    labels for the train / valid / test splits (memmaps when
    `memory_mapped`); `feat_count` (None unless `pretrain`), `idx_low` and
    `idx_high` (F,) int32, `field_blocked_ok`."""

    split_names = ("train", "valid", "test")

    def __init__(self, data_dir: str, dataset_name: str, pretrain: bool = False,
                 host_data_budget_mb: int = 0, chunk_rows: int = 1 << 20):
        self.data_dir, self.dataset_name = data_dir, dataset_name
        _, self.feat_map, self.field_map = artifacts.read_meta(data_dir, dataset_name)
        split_index = artifacts.read_split(data_dir, self.split_names)
        h5 = os.path.exists(os.path.join(data_dir, f"{dataset_name}.h5"))
        if h5:
            rows, nf, itemsize = artifacts.h5_matrix_info(data_dir, dataset_name)
        else:  # the split files alone
            rows, nf, itemsize = sum(len(v) for v in split_index.values()), self.num_fields, 4
        self.memory_mapped = over_host_budget(rows, nf, itemsize, host_data_budget_mb)
        if self.memory_mapped:
            ranges = artifacts.materialize_split_memmaps(
                data_dir, dataset_name, split_index, chunk_rows)
            self.X: Dict[str, np.ndarray] = {}
            self.Y: Dict[str, np.ndarray] = {}
            for s in self.split_names:
                self.X[s], self.Y[s] = artifacts.open_split_memmaps(
                    data_dir, dataset_name, s, nf)
            if ranges is None:
                ranges = (artifacts.h5_field_ranges(data_dir, dataset_name, chunk_rows)
                          if h5 else split_field_ranges(self.X.values(), chunk_rows))
            self.idx_low, self.idx_high = ranges
        else:
            feat_ids, labels = artifacts.read_ctr_h5(data_dir, dataset_name)
            feat_ids = np.ascontiguousarray(feat_ids.astype(np.int32))
            labels = np.ascontiguousarray(labels.astype(np.float32))
            self.X = {s: feat_ids[split_index[s]] for s in self.split_names}
            self.Y = {s: labels[split_index[s]] for s in self.split_names}
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
