"""Fixed-shape shuffled batches. Counterpart: `map_tpu/data/loader.py:24
Batcher`, the `epoch()` and `epoch_stacked()` paths of one process.

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

Index batches (map_tpu `loader.py:70-74`, `:140-175`), set by the Trainer
when the train matrix lies on the device: `emit_indices` yields the rows'
`index` (B,) int32 and `real_count` (a 0-d int32) in place of `input_ids`,
and `noise_index` (B * M,) int32 in place of `noise_rows`; with
`emit_start_only` as well, the scalar batch number `start` in place of
`index` (the step reads the rows from the epoch's order on the device).
Both keep `labels` and `weight` for the host's window AUC; nothing sends
them to the card. The draws are the same, so the stream is the same.

`alloc` ((shape, dtype) -> array, `np.empty` by default) makes the arrays a
batch's rows, labels, weight and noise rows are written to: the Trainer's
eval passes give it pinned memory on the card, so their batches are copied
to the device from where they were gathered, with no copy in between.

`start_batch` (resume, map_tpu `loader.py:90-132`, `:178-266`) skips an
epoch's first batches without making them: the order is the epoch's, and
the noise draws of the skipped batches are burnt in one call of
start_batch * B * M (numpy's bounded integers take the bit stream value by
value, so one call of n * k draws what n calls of k draw), so the stream
from there is the tail of the unskipped one.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]


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
        self.emit_indices = False
        self.emit_start_only = False
        self.alloc = np.empty  # (shape, dtype) -> the array a batch's key is written to

    def __len__(self) -> int:
        return (len(self.Y) + self.batch_size - 1) // self.batch_size

    def num_examples(self) -> int:
        return len(self.Y)

    def order(self, epoch: int) -> Tuple[np.ndarray, np.random.Generator]:
        """The epoch's row order and the generator its noise draws continue."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        n = len(self.Y)
        return (rng.permutation(n) if self.shuffle else np.arange(n)), rng

    def epoch(self, epoch: Optional[int] = None, start_batch: int = 0) -> Iterator[Batch]:
        """Yields {input_ids (B, F) int32, labels (B,) float32, weight (B,)
        float32 in {0, 1}}, and noise_rows (B * M, F) int32 when M > 0 (or
        the index forms above), from batch `start_batch` on."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order, rng = self.order(epoch)
        self._burn(rng, start_batch)
        yield from self._batches(order, rng, start_batch)

    def _burn(self, rng: np.random.Generator, start_batch: int) -> None:
        """Draw the noise rows of the epoch's first `start_batch` batches."""
        if start_batch and self.noise_rows_per_example > 0:
            rng.integers(0, len(self.noise_source),
                         size=min(start_batch, len(self)) * self.batch_size
                         * self.noise_rows_per_example)

    def _batches(self, order: np.ndarray, rng: np.random.Generator,
                 first: int) -> Iterator[Batch]:
        """Batches first, first + 1, ... of the epoch whose order is `order`,
        the noise drawn from `rng` (which has drawn the batches' before)."""
        bs = self.batch_size
        for b in range(first, len(self)):
            idx = order[b * bs:(b + 1) * bs]
            real = len(idx)
            if real < bs:
                idx = np.concatenate([idx, np.zeros(bs - real, dtype=idx.dtype)])
            weight = self.alloc(bs, np.float32)
            weight[:] = np.arange(bs) < real
            batch = {"labels": self._take(self.Y, idx), "weight": weight}
            if self.emit_indices:
                batch["real_count"] = np.int32(real)
                if self.emit_start_only:
                    batch["start"] = np.int32(b)
                else:
                    batch["index"] = idx.astype(np.int32)
            else:
                batch["input_ids"] = self._take(self.X, idx)
            if self.noise_rows_per_example > 0:
                pick = rng.integers(0, len(self.noise_source),
                                    size=bs * self.noise_rows_per_example)
                if self.emit_indices:
                    batch["noise_index"] = pick.astype(np.int32)
                else:
                    batch["noise_rows"] = self._take(self.noise_source, pick)
            yield batch

    def _take(self, src: np.ndarray, idx: np.ndarray) -> np.ndarray:
        """src[idx] (rows along axis 0), written to an array of `alloc`
        (mode 'clip' writes it unbuffered; every index lies in range)."""
        return np.take(src, idx, axis=0, mode="clip",
                       out=self.alloc(idx.shape + src.shape[1:], src.dtype))

    def epoch_stacked(self, spc: int, epoch: Optional[int] = None, start_batch: int = 0
                      ) -> Iterator[Tuple[int, Batch, List[Batch]]]:
        """Yields (n, batch, views): from batch `start_batch` on, groups of
        `spc` full batches stacked on a leading axis of n = spc (one numpy
        pass a group; the noise rows drawn in one call of spc * B * M, which
        gives the per-batch draws), then the epoch's tail (a short group and
        the padded last batch; from map_tpu's `tail_start`) as single
        batches (n = 1). `views` are the group's batches for host consumers.
        The stream is `epoch(epoch, start_batch)`'s."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        spc = max(1, int(spc))
        bs = self.batch_size
        order, rng = self.order(epoch)
        n_groups = max(0, len(self.Y) // bs - start_batch) // spc
        npe = self.noise_rows_per_example
        self._burn(rng, start_batch)
        for gi in range(n_groups):
            b0 = start_batch + gi * spc
            idx = order[b0 * bs:(b0 + spc) * bs].reshape(spc, bs)
            weight = self.alloc((spc, bs), np.float32)
            weight[:] = 1.0
            stacked = {"labels": self._take(self.Y, idx), "weight": weight}
            if self.emit_indices:
                stacked["real_count"] = np.full(spc, bs, np.int32)
                if self.emit_start_only:
                    stacked["start"] = np.arange(b0, b0 + spc, dtype=np.int32)
                else:
                    stacked["index"] = idx.astype(np.int32)
            else:
                stacked["input_ids"] = self._take(self.X, idx)
            if npe > 0:
                pick = rng.integers(0, len(self.noise_source),
                                    size=spc * bs * npe).reshape(spc, bs * npe)
                if self.emit_indices:
                    stacked["noise_index"] = pick.astype(np.int32)
                else:
                    stacked["noise_rows"] = self._take(self.noise_source, pick)
            yield spc, stacked, [{k: v[i] for k, v in stacked.items()} for i in range(spc)]
        for b in self._batches(order, rng, start_batch + n_groups * spc):
            yield 1, b, [b]
