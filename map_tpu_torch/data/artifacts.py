"""The on-disk artifacts of the preprocessing, read and written. The port's
copy of `map_tpu/data/artifacts.py`: `write_meta` (:37), `read_meta`,
`write_ctr_h5` (:50), `H5Writer` (:56), `read_ctr_h5`, `write_split` (:88),
`read_split`, `feat_count_path` and `compute_feat_count` (:225); and the
>RAM memmap mode's `h5_dims` (:104), `h5_matrix_info` (:111), `_mmap_paths`
(:121), `materialize_split_memmaps` (:126; here an h5 reader and a writer
core, `write_split_memmaps`, that takes (x, y) row chunks in file order and
takes the fields' ranges in the same pass), `open_split_memmaps` (:198) and
`h5_field_ranges` (:208).

- `{name}-meta.json`: `field_names`, `feat_map` (feature string -> id),
  `field_map` (field name -> index, the `<rsv>` field first);
- `{name}.h5`: datasets `feat_ids` (N, num_fields) and `labels` (N,);
- `split.pkl`: a pickled dict of `train_index` / `valid_index` /
  `test_index` integer arrays;
- `feat-count.npy`: the train split's unigram, cached for pretraining;
- `{name}-{split}-X.i32.mmap` (int32 (n, num_fields), row-major) and
  `{name}-{split}-Y.f32.mmap` (float32 (n,)): a split's rows in its index
  order, raw bytes; `{name}-mmap.done` marks them whole, `{name}-mmap.lock`
  is held by the one process that writes them.

The ids 0-9 are reserved (`<pad>`, `<cls>`, `<sep>`, `<mask>` = 3,
`<unused0..5>`); each field's ids follow in one block, its `<oov>` last.

`h5py` is imported inside the `.h5` functions only, so that this module,
`data/synth.py` and `validate.py` import on a host without it.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Tuple

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


# ---- the >RAM memmap mode (map_tpu `artifacts.py:104-222`) ----------------

def h5_dims(data_dir: str, name: str) -> Tuple[int, int]:
    """(rows, fields) from the h5's header, nothing loaded."""
    import h5py

    with h5py.File(os.path.join(data_dir, f"{name}.h5"), "r") as f:
        return tuple(f["feat_ids"].shape)


def h5_matrix_info(data_dir: str, name: str) -> Tuple[int, int, int]:
    """(rows, fields, stored itemsize) from the h5's header: an int64 h5
    holds 8 bytes an element beside the in-RAM path's int32 copy."""
    import h5py

    with h5py.File(os.path.join(data_dir, f"{name}.h5"), "r") as f:
        fx = f["feat_ids"]
        return fx.shape[0], fx.shape[1], int(fx.dtype.itemsize)


def _mmap_paths(data_dir: str, name: str, split: str) -> Tuple[str, str]:
    base = os.path.join(data_dir, f"{name}-{split}")
    return base + "-X.i32.mmap", base + "-Y.f32.mmap"


def _h5_chunks(data_dir: str, name: str, chunk_rows: int):
    """(total rows, fields, an iterator of the h5's (x, y) row chunks in
    file order), read sequentially; the file stays open while iterated."""
    import h5py

    f = h5py.File(os.path.join(data_dir, f"{name}.h5"), "r")
    fx, fy = f["feat_ids"], f["labels"]
    total, nf = fx.shape

    def chunks():
        try:
            for i in range(0, total, chunk_rows):
                yield fx[i:i + chunk_rows], fy[i:i + chunk_rows]
        finally:
            f.close()

    return total, nf, chunks()


def write_split_memmaps(data_dir: str, name: str, splits: Dict[str, np.ndarray],
                        total: int, num_fields: int, chunks) -> Tuple[np.ndarray, np.ndarray]:
    """The writer core of `materialize_split_memmaps`: `chunks`, the (x, y)
    rows of the whole matrix in file order, scattered into each split's
    `{name}-{split}-X.i32.mmap` / `-Y.f32.mmap` (written as `.tmp`, then
    renamed), with each field's (min, max + 1) taken in the same pass ->
    (idx_low, idx_high) int32. Peak host memory is a chunk and the inverse
    maps (h5 row -> split, position), whatever the matrix's size."""
    split_names = list(splits)
    split_of = np.full(total, -1, np.int8)
    pos_of = np.empty(total, np.int64)
    mms = {}
    for si, split in enumerate(split_names):
        idx = np.asarray(splits[split], np.int64)
        split_of[idx] = si
        pos_of[idx] = np.arange(len(idx))
        xp, yp = _mmap_paths(data_dir, name, split)
        mms[si] = (np.memmap(xp + ".tmp", np.int32, "w+", shape=(len(idx), num_fields)),
                   np.memmap(yp + ".tmp", np.float32, "w+", shape=(len(idx),)))
    lo = hi = None
    i = 0
    for cx, cy in chunks:
        n = len(cy)
        so, po = split_of[i:i + n], pos_of[i:i + n]
        for si, (xm, ym) in mms.items():
            m = so == si
            xm[po[m]] = cx[m]
            ym[po[m]] = cy[m]
        clo, chi = cx.min(axis=0), cx.max(axis=0)
        lo, hi = (clo, chi) if lo is None else (np.minimum(lo, clo), np.maximum(hi, chi))
        i += n
    if i != total:
        raise ValueError(f"the chunks hold {i} rows, the matrix {total}")
    for si, split in enumerate(split_names):
        xm, ym = mms.pop(si)
        xm.flush()
        ym.flush()
        del xm, ym
        xp, yp = _mmap_paths(data_dir, name, split)
        os.replace(xp + ".tmp", xp)
        os.replace(yp + ".tmp", yp)
    return lo.astype(np.int32), (hi + 1).astype(np.int32)


def materialize_split_memmaps(data_dir: str, name: str, splits: Dict[str, np.ndarray],
                              chunk_rows: int = 1 << 20, source=None
                              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The one-time conversion of the h5 and the split indices into row-major
    per-split memmap files (map_tpu `artifacts.py:126`, its files letter for
    letter, so either package reuses the other's). The h5 is streamed in
    `chunk_rows` chunks and scattered into the splits (reading a shuffled
    split's rows from the h5 would be millions of tiny hyperslabs).

    `source`, (total, fields, chunks) as `_h5_chunks` gives it, replaces the
    h5 (rows already in memory; `chip_smoke.py` writes its data so).

    Safe under N processes: the one that creates `{name}-mmap.lock`
    (O_EXCL) writes, the others wait for `{name}-mmap.done`. Returns the
    fields' (idx_low, idx_high) when this call wrote the files, else None."""
    import time

    done = os.path.join(data_dir, f"{name}-mmap.done")
    if os.path.exists(done):
        return None
    lock = os.path.join(data_dir, f"{name}-mmap.lock")
    try:
        os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        while not os.path.exists(done):  # another process is writing
            time.sleep(0.5)
        return None
    try:
        total, nf, chunks = source or _h5_chunks(data_dir, name, chunk_rows)
        ranges = write_split_memmaps(data_dir, name, splits, total, nf, chunks)
        with open(done, "w") as f:
            f.write("ok")
    finally:
        os.remove(lock)
    return ranges


def open_split_memmaps(data_dir: str, name: str, split: str, num_fields: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Read-only memmaps of a materialized split: processes map the same
    file and share the page cache."""
    xp, yp = _mmap_paths(data_dir, name, split)
    x = np.memmap(xp, np.int32, "r").reshape(-1, num_fields)
    y = np.memmap(yp, np.float32, "r")
    return x, y


def h5_field_ranges(data_dir: str, name: str, chunk_rows: int = 1 << 20
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Each field's (min, max + 1) over every h5 row, in chunks."""
    lo = hi = None
    for c, _ in _h5_chunks(data_dir, name, chunk_rows)[2]:
        clo, chi = c.min(axis=0), c.max(axis=0)
        lo, hi = (clo, chi) if lo is None else (np.minimum(lo, clo), np.maximum(hi, chi))
    return lo.astype(np.int32), (hi + 1).astype(np.int32)
