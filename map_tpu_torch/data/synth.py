"""Synthetic CTR data, in memory or in the artifact format. The port's copy
of `map_tpu/data/synth.py`: `generate` (:23), `AVAZU_LIKE_VOCABS` (:89)
and `generate_realistic` (:99), with the same numpy draws in the same order
from the same seed, so the arrays are map_tpu's bit for bit.

Both generators lay the ids out as the preprocessing does: 10 reserved ids,
then each field's block of ids followed by its `<oov>` id (which no row
holds). `generate` draws each field's value from a Zipf law on its own and
the label from a planted logistic model; `generate_realistic` ("synthazu",
the same-data validation set, `validation/gen_data.py`: 400,000 rows, seed
7) draws a latent z per row, each field's value from a cluster chosen by a
softmax on U_f z plus a Zipf rank inside it (so the fields predict one
another and pretraining has signal), and the label from per-id weights
plus a read-out of z, its intercept bisected to a positive rate of 0.17.

- `generate_arrays` / `generate_realistic_arrays` -> `SynthArrays`: the
  rows (feat_ids in map_tpu's dtype: int32 for `generate`, int64 for
  `generate_realistic`), the int64 labels and the split permutation.
- `in_memory(arrays, pretrain)` -> `InMemoryDataset`, the attributes of
  `data/dataset.CTRDataset` (`X[split]` int32, `Y[split]` float32 in the
  order CTRDataset reads the files back in, `idx_low` / `idx_high` over all
  rows, `field_blocked_ok`, `input_size`, `num_fields`, and `feat_count`
  of the train split when `pretrain`). No file and no feat_map dict.
- `generate(data_dir, ...)` / `generate_realistic(data_dir, ...)` write
  `{name}-meta.json`, `{name}.h5` and `split.pkl` through
  `data/artifacts.py` (h5py needed there only), as map_tpu's do.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from map_tpu_torch.data import artifacts
from map_tpu_torch.data.artifacts import compute_feat_count
from map_tpu_torch.data.dataset import field_blocked_ok

# map_tpu's Avazu-like per-field vocabulary mix: 24 fields, 13 of them of
# 60 ids or fewer, 101,178 ids with the reserved ones and each <oov>
AVAZU_LIKE_VOCABS = [8, 8, 25, 300, 24, 5000, 500, 2000, 30000, 50000,
                     10000, 400, 6, 5, 2000, 8, 400, 30, 200, 60, 40, 60,
                     30, 40]


class SynthArrays(NamedTuple):
    vocab_sizes: List[int]  # each field's ids, its <oov> not counted
    field_lo: np.ndarray  # (F,) int64, each field's first id
    feat_ids: np.ndarray  # (N, F)
    labels: np.ndarray  # (N,) int64
    splits: Dict[str, np.ndarray]  # train / valid / test row indices

    @property
    def field_names(self) -> List[str]:
        return [f"f{i}" for i in range(len(self.vocab_sizes))]

    @property
    def vocab_size(self) -> int:
        return artifacts.NUM_RESERVED + sum(v + 1 for v in self.vocab_sizes)


def _field_lo(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Each field's first id: the blocks follow the reserved ids, each
    field's ids then its <oov>."""
    return np.cumsum([artifacts.NUM_RESERVED] + [v + 1 for v in vocab_sizes[:-1]]
                     ).astype(np.int64)


def _split(rng: np.random.Generator, num_rows: int, splits) -> Dict[str, np.ndarray]:
    perm = rng.permutation(num_rows)
    n_train = int(splits[0] * num_rows)
    n_valid = int(splits[1] * num_rows)
    return {"train": perm[:n_train], "valid": perm[n_train:n_train + n_valid],
            "test": perm[n_train + n_valid:]}


def generate_arrays(num_rows: int = 20000, num_fields: int = 12,
                    vocab_per_field: int = 50, seed: int = 0, zipf_a: float = 1.3,
                    splits=(0.8, 0.1, 0.1)) -> SynthArrays:
    """map_tpu's `generate`: independent Zipfian fields, a planted logistic
    label with one pairwise term."""
    rng = np.random.default_rng(seed)
    vocab_sizes = [int(vocab_per_field)] * num_fields
    field_lo = _field_lo(vocab_sizes)
    vocab_size = artifacts.NUM_RESERVED + num_fields * (vocab_per_field + 1)

    ranks = np.arange(1, vocab_per_field + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    local = np.stack(
        [rng.choice(vocab_per_field, size=num_rows, p=probs) for _ in range(num_fields)],
        axis=1)
    feat_ids = (field_lo[None, :] + local).astype(np.int32)

    w = rng.normal(0.0, 1.0, size=vocab_size)
    logits = w[feat_ids].sum(axis=1)
    if num_fields >= 2:
        logits += 0.5 * w[feat_ids[:, 0]] * w[feat_ids[:, 1]]
    logits = (logits - logits.mean()) / (logits.std() + 1e-8)
    labels = (rng.random(num_rows) < 1.0 / (1.0 + np.exp(-1.5 * logits))).astype(np.int64)
    return SynthArrays(vocab_sizes, field_lo, feat_ids, labels, _split(rng, num_rows, splits))


def generate_realistic_arrays(num_rows: int = 1_000_000,
                              vocab_sizes: Optional[Sequence[int]] = None,
                              seed: int = 7, zipf_a: float = 1.2, num_latent: int = 8,
                              num_clusters: int = 16, positive_rate: float = 0.17,
                              splits=(0.8, 0.1, 0.1)) -> SynthArrays:
    """map_tpu's `generate_realistic`: fields that depend on one another
    through a latent z, a label read out of z and the ids."""
    rng = np.random.default_rng(seed)
    vocab_sizes = [int(v) for v in (AVAZU_LIKE_VOCABS if vocab_sizes is None
                                    else vocab_sizes)]
    num_fields = len(vocab_sizes)
    field_lo = _field_lo(vocab_sizes)
    vocab_size = artifacts.NUM_RESERVED + sum(v + 1 for v in vocab_sizes)

    z = rng.normal(0.0, 1.0, size=(num_rows, num_latent))
    # int64, as the reference preprocessing writes numpy's default ints
    feat_ids = np.empty((num_rows, num_fields), dtype=np.int64)
    w = rng.normal(0.0, 0.35, size=vocab_size)
    logits = np.zeros(num_rows)
    for fi in range(num_fields):
        vs = vocab_sizes[fi]
        c = min(num_clusters, vs)
        u = rng.normal(0.0, 1.0, size=(num_latent, c))
        cl_logits = z @ u + rng.gumbel(size=(num_rows, c))
        cluster = np.argmax(cl_logits, axis=1)
        block = max(1, vs // c)
        ranks = np.arange(1, block + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        p /= p.sum()
        within = rng.choice(block, size=num_rows, p=p)
        local = np.minimum(cluster * block + within, vs - 1)
        feat_ids[:, fi] = field_lo[fi] + local
        logits += w[feat_ids[:, fi]]
    v_out = rng.normal(0.0, 1.0, size=num_latent)
    logits += z @ v_out
    logits = (logits - logits.mean()) / (logits.std() + 1e-8)
    # the intercept for the positive rate: 50 bisection steps, the labels
    # drawn at the last midpoint, as map_tpu draws them
    lo_b, hi_b = -8.0, 8.0
    for _ in range(50):
        b = 0.5 * (lo_b + hi_b)
        rate = (1.0 / (1.0 + np.exp(-(1.2 * logits + b)))).mean()
        lo_b, hi_b = (b, hi_b) if rate < positive_rate else (lo_b, b)
    labels = (rng.random(num_rows)
              < 1.0 / (1.0 + np.exp(-(1.2 * logits + b)))).astype(np.int64)
    return SynthArrays(vocab_sizes, field_lo, feat_ids, labels, _split(rng, num_rows, splits))


class InMemoryDataset:
    """`data/dataset.CTRDataset`'s attributes over `SynthArrays`."""

    split_names = ("train", "valid", "test")

    def __init__(self, arrays: SynthArrays, pretrain: bool = False):
        feat_ids = np.ascontiguousarray(arrays.feat_ids.astype(np.int32))
        labels = np.ascontiguousarray(arrays.labels.astype(np.float32))
        self.X = {s: feat_ids[arrays.splits[s]] for s in self.split_names}
        self.Y = {s: labels[arrays.splits[s]] for s in self.split_names}
        self.idx_low = feat_ids.min(axis=0).astype(np.int32)
        self.idx_high = (feat_ids.max(axis=0) + 1).astype(np.int32)
        self.field_blocked_ok = field_blocked_ok(self.idx_low, self.idx_high)
        self.input_size = arrays.vocab_size
        self.num_fields = len(arrays.vocab_sizes)
        self.feat_count = (compute_feat_count(self.X["train"], self.input_size)
                           if pretrain else None)


def in_memory(arrays: SynthArrays, pretrain: bool = False) -> InMemoryDataset:
    return InMemoryDataset(arrays, pretrain)


def write(arrays: SynthArrays, data_dir: str, name: str) -> str:
    """The artifacts of `arrays` in `data_dir`: meta (feat_map in id order:
    the reserved tokens, then each field's `f{i}::{v}` and `f{i}::<oov>`),
    the h5 and the split."""
    os.makedirs(data_dir, exist_ok=True)
    field_names = arrays.field_names
    field_map = {artifacts.RSV_FIELD: 0}
    feat_map = {tok: i for i, tok in enumerate(artifacts.RESERVED_TOKENS)}
    for fi, (fname, vs) in enumerate(zip(field_names, arrays.vocab_sizes)):
        field_map[fname] = fi + 1
        lo = int(arrays.field_lo[fi])
        feat_map.update({f"{fname}::{v}": lo + v for v in range(vs)})
        feat_map[f"{fname}::<oov>"] = lo + vs
    artifacts.write_meta(data_dir, name, field_names, feat_map, field_map)
    artifacts.write_ctr_h5(data_dir, name, arrays.feat_ids, arrays.labels)
    artifacts.write_split(data_dir, arrays.splits)
    return data_dir


def generate(data_dir: str, name: str = "synth", **kwargs) -> str:
    """`generate_arrays(**kwargs)` written to `data_dir` as `name`."""
    return write(generate_arrays(**kwargs), data_dir, name)


def generate_realistic(data_dir: str, name: str = "synthazu", **kwargs) -> str:
    """`generate_realistic_arrays(**kwargs)` written to `data_dir` as `name`."""
    return write(generate_realistic_arrays(**kwargs), data_dir, name)
