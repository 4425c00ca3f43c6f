"""K4's and K6a's launch plans (`map_tpu_torch/ops/embedding.py:plan`,
`ops/field_gather.py:gather_plan`), on the CPU, and K4's plain version
against map_tpu's Pallas gather (interpret mode).

K4 (`csrc/embedding_gather.cu`): the output is cut into units of `vec`
floats; block x takes tiles x, x + blocks, ... of THREADS * units_a_thread
units, thread t units t, t + THREADS, ... of a tile, unit i being row
i // per_row, piece i % per_row. K6a (`csrc/field_block.cu`): block x takes
T rows of b, and thread t the pieces t, t + 256, ... of its span, (j, pos,
q) stepped with two carries. `_k4_writes` and `_k6a_writes` follow the
kernels' index arithmetic step by step; each output element must be
written once, from the right id, for the main path's shapes and the edge
sizes. Exact: a gather does no arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu.ops.pallas_embedding import pallas_embedding_lookup
from map_tpu_torch.ops import embedding, field_gather

H100_SMS = 132
SMEM = 48 * 1024

# (n, E, bf16 out): the main path's launches (PERF.md §6): serving and eval
# (10000 x 24, both dtypes), the training input (4096 x 24, bf16), the MFP
# per-position candidates (4096 x 7 x 26 into the E = 32 decoder table, and
# its eval batch), per-field shared targets and noise (E = 32); then the
# card tests' edge sizes and widths
MAIN_PATH = [(240_000, 16, False), (240_000, 16, True), (98_304, 16, True),
             (745_472, 32, False), (1_820_000, 32, False), (28_672, 32, False),
             (2_400, 32, False), (70_000, 32, False)]
EDGES = [(n, e, bf16) for n in (1, 31, 33, 4097) for e in (4, 8, 12, 16, 20, 32, 64, 1024)
         for bf16 in (False, True)]


def _k4_writes(p: embedding.Plan, n: int, e: int) -> np.ndarray:
    """Writes of each (row, unit) of the output by the batched kernel, in
    its arithmetic: block x's thread t takes unit i = tile * THREADS * u + t
    + k * THREADS for k < u, tile = x, x + blocks, ..., while i < units; it
    loads ids[i // per_row] and stores unit i at i * vec floats."""
    per_row = e // p.vec
    units = n * per_row
    u = p.units_a_thread
    tile = embedding.THREADS * u
    writes = np.zeros((n, per_row), np.int8)
    t = np.arange(embedding.THREADS)
    for x in range(p.blocks):
        for t0 in range(x * tile, units, p.blocks * tile):
            for k in range(u):
                i = t0 + t + k * embedding.THREADS
                i = i[i < units]
                np.add.at(writes, (i // per_row, i % per_row), 1)
    return writes


@pytest.mark.parametrize("n,e,bf16", MAIN_PATH + EDGES)
def test_k4_plan_writes_every_element_once(n, e, bf16):
    p = embedding.plan(n, e, bf16, True)
    if e % 4:
        assert p.vec == 0
        return
    assert p.vec == (8 if bf16 and e % 8 == 0 else 4)
    assert p.units_a_thread == (4 if n * e >= embedding.FOUR_UNITS_FROM else
                                2 if n * e >= embedding.TWO_UNITS_FROM else 1)
    assert p.units_a_thread in embedding.UNITS
    tiles = -(-(n * e // p.vec) // (embedding.THREADS * p.units_a_thread))
    assert p.blocks == min(tiles, embedding.MAX_BLOCKS)  # one wave of tiles
    assert (_k4_writes(p, n, e) == 1).all()


@pytest.mark.parametrize("n,e,vec,units,blocks", [(4097, 16, 4, 1, 3), (33, 64, 8, 2, 1),
                                                  (70_000, 32, 4, 4, 7), (31, 8, 8, 4, 2)])
def test_k4_blocks_walk_on_past_one_wave(n, e, vec, units, blocks):
    """Fewer blocks than tiles (the grid capped at MAX_BLOCKS): the blocks
    walk on over the tiles, and every element is still written once."""
    assert (_k4_writes(embedding.Plan(vec, units, blocks), n, e) == 1).all()


@pytest.mark.parametrize("n,e,bf16,aligned", [(240_000, 16, False, False), (33, 1, True, True),
                                              (4097, 12, False, False), (1, 3, False, True)])
def test_k4_plan_takes_the_scalar_path(n, e, bf16, aligned):
    p = embedding.plan(n, e, bf16, aligned)
    assert p.vec == 0 and p.units_a_thread == 0
    assert p.blocks == min(-(-n * e // embedding.THREADS), embedding.MAX_BLOCKS)


@pytest.mark.parametrize("n,e,bf16", MAIN_PATH[:3])
def test_k4_plan_is_cached_per_shape(n, e, bf16):
    assert embedding.plan(n, e, bf16, True) is embedding.plan(n, e, bf16, True)


def test_k4_main_path_plans():
    """bf16 out at E = 16 stores 16 bytes a lane (units of 8 floats); the
    serving and decoder shapes take 4 units a thread, the training input and
    the per-field shared targets 2, its noise 1; one wave of blocks."""
    assert embedding.plan(98_304, 16, True, True) == (8, 2, 384)
    assert embedding.plan(240_000, 16, True, True) == (8, 4, 469)
    assert embedding.plan(240_000, 16, False, True) == (4, 4, 938)
    assert embedding.plan(745_472, 32, False, True) == (4, 4, 5824)
    assert embedding.plan(28_672, 32, False, True) == (4, 2, 448)
    assert embedding.plan(2_400, 32, False, True) == (4, 1, 75)


def _k6a_writes(t: int, b: int, fs: int, w: int, phys: np.ndarray) -> np.ndarray:
    """The ids each output piece of (b, fs * w // 4) is written from, by
    K6a's arithmetic: block x's thread th takes pieces th, th + 256, ... of
    its span, (j, pos, q) stepped by (dj, dpos, dq) with two carries, 8 a
    batch; -2 where no piece was written, -3 where one was written twice."""
    threads, batch = field_gather.GATHER_THREADS, 8
    per_pos = w // 4
    per_b = fs * per_pos
    dj, rest = divmod(threads, per_b)
    dpos, dq = divmod(rest, per_pos)
    got = np.full((b, per_b), -2, np.int64)
    for x in range(-(-b // t)):
        b0 = x * t
        nb = min(t, b - b0)
        pieces = nb * per_b
        th = np.arange(threads)
        j, pos, q = th // per_b, th % per_b // per_pos, th % per_pos
        for k0 in range(0, pieces, threads * batch):
            for u in range(batch):
                k = k0 + u * threads + th
                live = k < pieces
                bb, col = b0 + j[live], pos[live] * per_pos + q[live]
                assert ((bb - b0) * per_b + col == k[live]).all()
                got[bb, col] = np.where(got[bb, col] == -2, phys[pos[live], bb], -3)
                q = q + dq
                carry = q >= per_pos
                q, pos = np.where(carry, q - per_pos, q), pos + carry + dpos
                carry = pos >= fs
                pos, j = np.where(carry, pos - fs, pos), j + carry + dj
    return got


# (b, fs, w, SMs): serving (21 small fields x 10000), the training batch,
# B off the block's range, widths 4 (a piece a field) to 32, many fields
K6A = [(10_000, 21, 16, 132), (4096, 21, 16, 132), (1001, 5, 4, 132), (1001, 5, 16, 132),
       (1001, 5, 32, 132), (37, 3, 16, 132), (1, 21, 16, 132), (333, 64, 8, 4),
       (5000, 700, 4, 132)]


@pytest.mark.parametrize("b,fs,w,sms", K6A)
def test_k6a_plan_writes_every_piece_once_from_its_id(b, fs, w, sms):
    t = field_gather.gather_plan(b, fs, w, sms)
    assert 1 <= t <= field_gather.GATHER_MAX_B and t & (t - 1) == 0
    assert t * fs * 4 <= SMEM and t * fs * w < 2 ** 31
    target = sms * field_gather.GATHER_BLOCKS_PER_SM
    assert t == 1 or -(-b // t) >= target
    if t < field_gather.GATHER_MAX_B:  # the largest such power of two
        assert -(-b // (2 * t)) < target or 2 * t * fs * 4 > SMEM
    phys = np.random.default_rng(b + fs).integers(0, 10 ** 6, (fs, b))
    got = _k6a_writes(t, b, fs, w, phys)
    want = np.repeat(phys.T, w // 4, axis=1)  # (b, fs * per_pos): piece (pos, q) from pos's id
    np.testing.assert_array_equal(got, want)


def test_k6a_plan_at_the_serving_shape():
    assert field_gather.gather_plan(10_000, 21, 16, H100_SMS) == 16
    with pytest.raises(ValueError, match="exceed a block"):
        field_gather.gather_plan(10, 13_000, 16, H100_SMS)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("e,shape", [(32, (20, 8)), (32, (6, 7, 26)), (16, (6, 7, 26)),
                                     (32, (24, 100)), (16, (5, 3, 2, 4))])
def test_embedding_plain_matches_pallas_gather_at_main_path_layouts(e, shape):
    """(B, M, C) candidate ids and E = 32 as the MFP decoder gathers them:
    exact, and the bf16 out the round-to-nearest cast of the same rows."""
    rng = np.random.default_rng(e + len(shape))
    table = rng.normal(size=(500, e)).astype(np.float32)
    ids = rng.integers(0, 500, size=shape).astype(np.int32)
    ids.reshape(-1)[:2] = (0, 499)
    ref = np.asarray(pallas_embedding_lookup(jnp.asarray(table), jnp.asarray(ids), True))
    before = embedding.launches
    out = embedding.embedding_lookup(_t(table), _t(ids))
    assert out.shape == (*shape, e)
    np.testing.assert_array_equal(out.numpy(), ref)
    out_bf16 = embedding.embedding_lookup(_t(table), _t(ids), torch.bfloat16)
    np.testing.assert_array_equal(
        out_bf16.float().numpy(),
        np.asarray(jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32)))
    assert embedding.launches == before  # the CPU path launches nothing
