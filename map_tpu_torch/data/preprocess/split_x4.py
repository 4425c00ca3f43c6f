"""The Criteo / Avazu x4 split: StratifiedKFold(10, shuffle, seed 2018),
fold 0 the test split, fold 1 the valid split, folds 2-9 the train split,
written as `split.pkl`. Counterpart: `map_tpu/data/preprocess/split_x4.py`
(the reference's `data_preprocess/split_criteo_x4.py:15,29-37`).

The reference pins sklearn 0.19.1, whose StratifiedKFold assigned folds
differently from sklearn 0.22 on; `stratified_kfold_legacy` is that
release's algorithm, as map_tpu vendors it (one RandomState shared by the
classes' KFold shuffles, taken in ascending class order; each class's
KFold over max(count, 10) samples, its folds clipped to the class), so its
folds are the pinned ones under any numpy. `make_split(legacy=False)` runs
the installed sklearn's (imported when called).

    python -m map_tpu_torch.data.preprocess.split_x4 --labels <h5|txt> --out data/criteo

A host job: h5py is imported when it reads an h5.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from map_tpu_torch.data import artifacts

RANDOM_SEED = 2018


def _kfold_slices(n_samples: int, n_splits: int, rng: np.random.RandomState):
    """KFold(shuffle=True)'s test folds: one shuffle of arange, then
    contiguous slices, the remainder over the first folds."""
    indices = np.arange(n_samples)
    rng.shuffle(indices)
    fold_sizes = np.full(n_splits, n_samples // n_splits, dtype=np.int64)
    fold_sizes[: n_samples % n_splits] += 1
    stops = np.cumsum(fold_sizes)
    return [indices[lo:hi] for lo, hi in zip(np.r_[0, stops[:-1]], stops)]


def stratified_kfold_legacy(y: np.ndarray, n_splits: int = 10,
                            seed: int = RANDOM_SEED) -> np.ndarray:
    """sklearn 0.19.1's StratifiedKFold(shuffle=True): each sample's fold."""
    rng = np.random.RandomState(seed)
    y = np.asarray(y)
    unique_y, y_inversed = np.unique(y, return_inverse=True)
    y_counts = np.bincount(y_inversed)
    per_cls = [_kfold_slices(max(int(c), n_splits), n_splits, rng) for c in y_counts]
    test_folds = np.zeros(y.shape[0], dtype=np.int64)
    for fold_idx in range(n_splits):
        for cls_idx in range(len(unique_y)):
            mask = y_inversed == cls_idx
            test_split = per_cls[cls_idx][fold_idx]
            test_split = test_split[test_split < int(y_counts[cls_idx])]
            cls_test_folds = test_folds[mask]
            cls_test_folds[test_split] = fold_idx
            test_folds[mask] = cls_test_folds
    return test_folds


# the digest map_tpu pins (tests/test_preprocess.py::test_legacy_split_deterministic_pin)
LEGACY_PIN = "d68945aee9fcc1a88709b05ffd24d1d0"


def make_split(labels: np.ndarray, seed: int = RANDOM_SEED, legacy: bool = True):
    if legacy:
        test_folds = stratified_kfold_legacy(labels, 10, seed)
        fold_indexes = [np.flatnonzero(test_folds == k) for k in range(10)]
    else:
        from sklearn.model_selection import StratifiedKFold

        folds = StratifiedKFold(n_splits=10, shuffle=True, random_state=seed
                                ).split(np.zeros_like(labels), labels)
        fold_indexes = [valid_id for _, valid_id in folds]
    return {"test": fold_indexes[0], "valid": fold_indexes[1],
            "train": np.concatenate(fold_indexes[2:])}


def run(labels_path: str, out_dir: str, name: str = "criteo") -> None:
    if labels_path.endswith(".h5"):
        import h5py

        with h5py.File(labels_path, "r") as f:
            labels = f["labels"][:]
    else:
        labels = np.loadtxt(labels_path, dtype=np.int64)
    splits = make_split(np.asarray(labels).astype(np.int64))
    os.makedirs(out_dir, exist_ok=True)
    artifacts.write_split(out_dir, splits)
    print(f"split written: { {k: len(v) for k, v in splits.items()} }")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--labels", required=True, help=".h5 with labels or a text file")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    run(a.labels, a.out)


if __name__ == "__main__":
    main()
