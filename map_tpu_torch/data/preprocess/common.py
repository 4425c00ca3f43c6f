"""The vocabulary of the offline preprocessing. Counterpart:
`map_tpu/data/preprocess/common.py`, the same ids for the same raw values.

The id space (the reference's `data_preprocess/proc_avazu.py:210-251`,
`proc_criteo.py:106-153`): the 10 reserved ids (`<pad>` = 0, `<cls>`,
`<sep>`, `<mask>` = 3, `<unused0..5>`); `field_map` headed by `<rsv>`; in
each field, the values seen at least `n_core` times get ids one after
another in descending frequency (first seen first among equals), then the
field's `<oov>` id: each field one contiguous block.

pandas is imported inside the functions that use it, so the module imports
on a host without pandas (the card's machine; preprocessing is a host job).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from map_tpu_torch.data.artifacts import NUM_RESERVED, RESERVED_TOKENS, RSV_FIELD


def encode_field(values: np.ndarray, field_name: str, n_core: int,
                 feat_map: Dict[str, int]) -> np.ndarray:
    """One field's ids (int64), feat_map extended in place: the values seen
    at least n_core times in descending frequency, the rest `<oov>`."""
    import pandas as pd

    codes, uniques = pd.factorize(pd.Series(values), sort=False)
    counts = np.bincount(codes[codes >= 0], minlength=len(uniques))
    order = np.argsort(-counts, kind="stable")  # first seen first among equals
    kept = order[counts[order] >= n_core]
    base = len(feat_map)
    for rank, uidx in enumerate(kept.tolist()):
        feat_map[f"{field_name}-{uniques[uidx]}"] = base + rank
    oov_id = base + len(kept)
    feat_map[f"{field_name}-<oov>"] = oov_id
    lut = np.full(len(uniques) + 1, oov_id, dtype=np.int64)
    lut[kept] = base + np.arange(len(kept))
    codes = np.where(codes < 0, len(uniques), codes)  # NaN -> <oov>
    return lut[codes]


def build_dataset_arrays(columns: Dict[str, np.ndarray], n_core: int
                         ) -> Tuple[np.ndarray, Dict[str, int], Dict[str, int], List[str]]:
    """(feat_ids (N, F) int32, feat_map, field_map, field_names)."""
    feat_map = {tok: i for i, tok in enumerate(RESERVED_TOKENS)}
    assert len(feat_map) == NUM_RESERVED
    field_map = {RSV_FIELD: 0}
    field_names: List[str] = []
    cols = []
    for name, values in columns.items():
        field_map[name] = len(field_map)
        field_names.append(name)
        cols.append(encode_field(values, name, n_core, feat_map))
    return np.stack(cols, axis=1).astype(np.int32), feat_map, field_map, field_names


def verify_field_blocked(feat_ids: np.ndarray, field_map: Dict[str, int]) -> None:
    """Asserts that each field's ids lie below the next field's."""
    lows, highs = feat_ids.min(axis=0), feat_ids.max(axis=0)
    for f in range(feat_ids.shape[1] - 1):
        assert highs[f] < lows[f + 1] or highs[f] < NUM_RESERVED, \
            f"field blocks overlap at column {f}"


class ChunkedVocabBuilder:
    """`build_dataset_arrays` in two passes over chunks, for raw files whose
    pandas frame does not fit the host's RAM. Pass 1 (`observe`) counts each
    field's values in a dict whose insertion order is each value's first
    occurrence in the stream, the order `pd.factorize(sort=False)` gives on
    the whole column; `finalize` ranks by stable descending count; so the
    ids are `encode_field`'s on the whole column. Pass 2: `map_chunk`."""

    def __init__(self, field_names, n_core: int):
        self.field_names = list(field_names)
        self.n_core = int(n_core)
        self._counts = {f: {} for f in self.field_names}
        self._maps = None

    def observe(self, field: str, values: np.ndarray) -> None:
        import pandas as pd

        assert self._maps is None, "finalize() already called"
        c = self._counts[field]
        codes, uniques = pd.factorize(pd.Series(values), sort=False)
        cnt = np.bincount(codes[codes >= 0], minlength=len(uniques))
        for u, k in zip(uniques.tolist(), cnt.tolist()):
            c[u] = c.get(u, 0) + k

    def finalize(self):
        """-> (feat_map, field_map); builds each field's value -> id dict."""
        feat_map = {tok: i for i, tok in enumerate(RESERVED_TOKENS)}
        field_map = {RSV_FIELD: 0}
        self._maps, self.oov = {}, {}
        for name in self.field_names:
            field_map[name] = len(field_map)
            items = list(self._counts[name].items())  # first-seen order
            counts = np.asarray([k for _, k in items])
            order = np.argsort(-counts, kind="stable")
            kept = order[counts[order] >= self.n_core]
            base = len(feat_map)
            m = {}
            for rank, uidx in enumerate(kept.tolist()):
                val = items[uidx][0]
                feat_map[f"{name}-{val}"] = base + rank
                m[val] = base + rank
            feat_map[f"{name}-<oov>"] = self.oov[name] = base + len(kept)
            self._maps[name] = m
            self._counts[name] = None  # pass 1's counts go as each field is done
        self.feat_map, self.field_map = feat_map, field_map
        return feat_map, field_map

    def map_chunk(self, field: str, values: np.ndarray) -> np.ndarray:
        import pandas as pd

        assert self._maps is not None, "call finalize() first"
        ids = pd.Series(values).map(self._maps[field])
        return ids.fillna(self.oov[field]).to_numpy(dtype=np.int32)
