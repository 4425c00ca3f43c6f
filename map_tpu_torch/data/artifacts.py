"""The on-disk artifacts of the preprocessing, read and written. The port's
copy of `map_tpu/data/artifacts.py`: `write_meta` (:37), `read_meta`,
`write_ctr_h5` (:50), `H5Writer` (:56), `read_ctr_h5`, `write_split` (:88),
`read_split`, `feat_count_path` and `compute_feat_count` (:225). The
memmap mode (`materialize_split_memmaps`) is not ported yet (ROADMAP.md).

- `{name}-meta.json`: `field_names`, `feat_map` (feature string -> id),
  `field_map` (field name -> index, the `<rsv>` field first);
- `{name}.h5`: datasets `feat_ids` (N, num_fields) and `labels` (N,);
- `split.pkl`: a pickled dict of `train_index` / `valid_index` /
  `test_index` integer arrays;
- `feat-count.npy`: the train split's unigram, cached for pretraining.

The ids 0-9 are reserved (`<pad>`, `<cls>`, `<sep>`, `<mask>` = 3,
`<unused0..5>`); each field's ids follow in one block, its `<oov>` last.

`h5py` is imported inside the `.h5` functions only, so that this module,
`data/synth.py` and `validate.py` import on a host without it.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

RESERVED_TOKENS = ["<pad>", "<cls>", "<sep>", "<mask>"] + [f"<unused{i}>" for i in range(6)]
MASK_ID = 3
NUM_RESERVED = len(RESERVED_TOKENS)  # == 10
RSV_FIELD = "<rsv>"


def write_meta(data_dir: str, name: str, field_names: List[str],
               feat_map: Dict[str, int], field_map: Dict[str, int]) -> None:
    meta = {"field_names": field_names, "feat_map": feat_map, "field_map": field_map}
    with open(os.path.join(data_dir, f"{name}-meta.json"), "w") as f:
        json.dump(meta, f)


def read_meta(data_dir: str, name: str) -> Tuple[List[str], Dict[str, int], Dict[str, int]]:
    with open(os.path.join(data_dir, f"{name}-meta.json"), "r") as f:
        meta = json.load(f)
    return meta["field_names"], meta["feat_map"], meta["field_map"]


def write_ctr_h5(data_dir: str, name: str, feat_ids: np.ndarray, labels: np.ndarray) -> None:
    import h5py

    with h5py.File(os.path.join(data_dir, f"{name}.h5"), "w") as f:
        f.create_dataset("feat_ids", data=feat_ids)
        f.create_dataset("labels", data=labels)


class H5Writer:
    """The `{name}.h5` contract in appended chunks (resizable datasets):
    write_ctr_h5 for data larger than RAM."""

    def __init__(self, data_dir: str, name: str, num_fields: int):
        import h5py

        self._f = h5py.File(os.path.join(data_dir, f"{name}.h5"), "w")
        self._x = self._f.create_dataset(
            "feat_ids", shape=(0, num_fields), maxshape=(None, num_fields),
            dtype=np.int32, chunks=(1 << 16, num_fields))
        self._y = self._f.create_dataset(
            "labels", shape=(0,), maxshape=(None,), dtype=np.int64, chunks=(1 << 18,))

    def append(self, feat_ids: np.ndarray, labels: np.ndarray) -> None:
        n0, n = self._x.shape[0], len(labels)
        self._x.resize(n0 + n, axis=0)
        self._y.resize(n0 + n, axis=0)
        self._x[n0:] = feat_ids
        self._y[n0:] = labels

    def close(self) -> int:
        n = self._x.shape[0]
        self._f.close()
        return n


def read_ctr_h5(data_dir: str, name: str) -> Tuple[np.ndarray, np.ndarray]:
    import h5py

    with h5py.File(os.path.join(data_dir, f"{name}.h5"), "r") as f:
        return f["feat_ids"][:], f["labels"][:]


def write_split(data_dir: str, splits: Dict[str, np.ndarray]) -> None:
    payload = {f"{k}_index": np.asarray(v) for k, v in splits.items()}
    with open(os.path.join(data_dir, "split.pkl"), "wb") as f:
        pickle.dump(payload, f)


def read_split(data_dir: str, split_names=("train", "valid", "test")) -> Dict[str, np.ndarray]:
    with open(os.path.join(data_dir, "split.pkl"), "rb") as f:
        split_index = pickle.load(f)
    return {s: np.asarray(split_index[f"{s}_index"]) for s in split_names}


def feat_count_path(data_dir: str) -> str:
    return os.path.join(data_dir, "feat-count.npy")


def compute_feat_count(train_feat_ids: np.ndarray, vocab_size: int) -> np.ndarray:
    """Global per-feature frequency over the train split."""
    return np.bincount(train_feat_ids.ravel(), minlength=vocab_size).astype(np.float32)
