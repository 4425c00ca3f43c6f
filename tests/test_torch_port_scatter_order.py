"""The order contract of K3 (`map_tpu_torch/ops/scatter.py`), on the CPU.

K3 sums each touched table row in float32, from 0.0, in index order (the
order of the row's segment of the stably sorted ids); its plain version, the
bwd_pallas route's K6b and the card's plain route give the same bits because
they add in that order too. Here the plain version on the CPU is held, bit
for bit, to a float32 running sum in index order (`np.cumsum` adds in
sequence), on ids with a hot segment of thousands of rows whose gradients
are ill-conditioned (mixed +-1e4..2e4 and 1e-3), where another order would give
other bits. And it is held to map_tpu's Pallas kernel in interpret mode,
which sums by one-hot matmuls in another order, within the bound on the
rounding of a float32 sum in any order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu.ops import pallas_scatter
from map_tpu_torch.ops import scatter

E = 16


def _ids(kind: str, rng: np.random.Generator) -> tuple:
    if kind == "hot":  # one id in 3,000 of 4,137 rows, the rest spread
        vocab = 1000
        ids = np.concatenate([np.full(3000, 7), rng.integers(0, 200, 1000),
                              rng.integers(600, vocab, 137)])
        rng.shuffle(ids)
        return ids.astype(np.int32), vocab
    # field-blocked, as the training step's (B, F) ids: 4- and 8-id fields
    # hit about 500 and 250 times each, and a 600-id field
    sizes = [4, 8, 600]
    lo = np.cumsum([10] + sizes[:-1])
    ids = np.stack([rng.integers(a, a + s, 2048) for a, s in zip(lo, sizes)], axis=1)
    return ids.astype(np.int32), int(10 + sum(sizes))


def _grads(shape, rng: np.random.Generator) -> np.ndarray:
    big = rng.random(shape) < 0.5
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    mag = np.where(big, 1e4 * (1 + rng.random(shape)), 1e-3 * rng.random(shape))
    return (sign * mag).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["hot", "field_blocked"])
def test_plain_sums_each_row_in_index_order(kind, dtype):
    rng = np.random.default_rng(7)
    ids, vocab = _ids(kind, rng)
    g = torch.from_numpy(_grads(ids.shape + (E,), rng)).to(dtype)
    before = scatter.launches
    out = scatter.scatter_add(torch.from_numpy(ids), g, vocab).numpy()
    assert scatter.launches == before  # the CPU route launches nothing
    flat, rows = ids.reshape(-1), g.float().reshape(-1, E).numpy()
    touched = np.unique(flat)
    assert np.bincount(flat).max() >= 250
    want = np.zeros((vocab, E), np.float32)
    for v in touched:  # np.nonzero keeps index order
        want[v] = np.cumsum(rows[np.nonzero(flat == v)[0]], axis=0, dtype=np.float32)[-1]
    assert np.array_equal(out, want)
    untouched = np.setdiff1d(np.arange(vocab), touched)
    assert not out[untouched].any()
    if dtype == torch.bfloat16:
        return  # 8-bit mantissas: the large values' sums are exact in any order
    # the order matters on these values: the reversed order gives other bits
    hot = np.bincount(flat).argmax()
    reverse = np.cumsum(rows[np.nonzero(flat == hot)[0]][::-1], axis=0, dtype=np.float32)[-1]
    assert not np.array_equal(reverse, want[hot])


@pytest.mark.parametrize("kind", ["hot", "field_blocked"])
def test_plain_matches_map_tpu_pallas_within_the_rounding_bound(kind):
    rng = np.random.default_rng(11)
    ids, vocab = _ids(kind, rng)
    grads = _grads(ids.shape + (E,), rng)
    ref = np.asarray(pallas_scatter.scatter_add(jnp.asarray(ids), jnp.asarray(grads), vocab,
                                                interpret=True))
    out = scatter.scatter_add_plain(torch.from_numpy(ids), torch.from_numpy(grads), vocab).numpy()
    # each side's float32 sum of a row's n gradients, in whatever order, is
    # within (n - 1) 2**-24 sum|g| of the exact sum
    flat, rows = ids.reshape(-1), grads.reshape(-1, E).astype(np.float64)
    count = np.bincount(flat, minlength=vocab).astype(np.float64)[:, None]
    abs_sum = np.zeros((vocab, E))
    np.add.at(abs_sum, flat, np.abs(rows))
    bound = 2 * np.maximum(count - 1, 0) * 2.0 ** -24 * abs_sum
    assert np.all(np.abs(out.astype(np.float64) - ref) <= bound)
    untouched = count[:, 0] == 0
    assert not out[untouched].any() and not ref[untouched].any()
