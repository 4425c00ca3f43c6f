"""Fixed-shape shuffled batches. Counterpart: `map_tpu/data/loader.py:24
Batcher`, the `epoch()` path of one process.

Every batch has batch_size rows; the last one is padded with row 0 at weight
0, so the weighted loss and the metrics drop the padding. The shuffled order
is map_tpu's, `np.random.default_rng(SeedSequence([seed, epoch]))
.permutation(n)`, and rows are gathered by numpy fancy indexing (map_tpu
gathers with its C++ helper; the values are the same), so the batch stream
is bit-identical to map_tpu's.

With `noise_rows_per_example` M > 0 (RFD's Unigram generators), every batch
also carries `noise_rows` (B * M, F) int32: rows of `noise_source` (the train
split, for every split) at `rng.integers(0, len(noise_source), B * M)`,
drawn after the batch is gathered from the same per-epoch generator as the
permutation (map_tpu `loader.py:157-174`), so this stream is map_tpu's too.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class Batcher:
    def __init__(self, X: np.ndarray, Y: np.ndarray, batch_size: int,
                 shuffle: bool, seed: int = 42, noise_source: Optional[np.ndarray] = None,
                 noise_rows_per_example: int = 0):
        self.X = X if X.dtype == np.int32 else X.astype(np.int32)
        self.Y = Y if Y.dtype == np.float32 else Y.astype(np.float32)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.noise_rows_per_example = int(noise_rows_per_example)
        if self.noise_rows_per_example > 0 and noise_source is None:
            raise ValueError("noise rows need a noise_source (the train split)")
        self.noise_source = (None if noise_source is None
                             else np.ascontiguousarray(noise_source, dtype=np.int32))
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.Y) + self.batch_size - 1) // self.batch_size

    def num_examples(self) -> int:
        return len(self.Y)

    def epoch(self, epoch: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Yields {input_ids (B, F) int32, labels (B,) float32, weight (B,)
        float32 in {0, 1}}, and noise_rows (B * M, F) int32 when M > 0."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        n = len(self.Y)
        bs = self.batch_size
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        for b in range(len(self)):
            idx = order[b * bs:(b + 1) * bs]
            real = len(idx)
            if real < bs:
                idx = np.concatenate([idx, np.zeros(bs - real, dtype=idx.dtype)])
            batch = {"input_ids": self.X[idx],
                     "labels": self.Y[idx],
                     "weight": (np.arange(bs) < real).astype(np.float32)}
            if self.noise_rows_per_example > 0:
                pick = rng.integers(0, len(self.noise_source),
                                    size=bs * self.noise_rows_per_example)
                batch["noise_rows"] = self.noise_source[pick]
            yield batch
