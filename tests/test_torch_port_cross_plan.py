"""K2's launch plan (`map_tpu_torch/ops/cross.py:plan`), on the CPU.

The plan is a pure function of the shapes, the dtype and the card's
shared-memory opt-in; the C entry (`csrc/cross_net.cu`) checks it against
the shapes and refuses one that does not fit. Here it is held to what the
kernel needs: shared memory within the H100's opt-in for every D the kernel
takes, clusters of at most 8 blocks, a first wave that gives work to nearly
every SM at the serving and training shapes, the 16-byte load path (TMA for
bf16) only where D * size and the pointers are 16-byte aligned, and every row
and column of the output owned by exactly one block.
"""

import numpy as np
import pytest
import torch

from map_tpu_torch.ops import cross

DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_shared_memory_and_cluster_fit_every_width(dtype, aligned):
    for d in range(1, cross.MAX_D + 1):
        p = cross.plan(4096, d, dtype, aligned=aligned)
        assert p.smem <= cross.H100_SMEM_OPTIN, (d, p)
        assert 1 <= p.cluster <= 8 and p.cluster * cross.COLS >= d, (d, p)
        assert p.blocks_per_sm >= 1
        assert (p.blocks_per_sm + 1) * (p.smem + cross.BLOCK_RESERVED_BYTES) > \
            cross.SM_SHARED_BYTES or p.blocks_per_sm == 2
        dp = p.cluster * cross.COLS
        assert p.smem == cross.smem_bytes(dtype, dp, p.stages, p.x_buffers)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [4096, 10000])
@pytest.mark.parametrize("d", [384, 624])
def test_first_wave_fills_the_card(dtype, batch, d):
    p = cross.plan(batch, d, dtype)
    assert cross.first_wave_sms(p) >= 128, p


@pytest.mark.parametrize("dtype", DTYPES)
def test_vector_path_only_where_aligned(dtype):
    size = 4 if dtype == torch.float32 else 2
    for d in range(1, cross.MAX_D + 1):
        p = cross.plan(10000, d, dtype)
        assert p.vector == ((d * size) % 16 == 0), d
        assert not cross.plan(10000, d, dtype, aligned=False).vector


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,d", [(1, 1), (63, 37), (64, 128), (65, 129),
                                     (4097, 384), (10000, 624), (300, 1000),
                                     (130, 1024)])
def test_every_output_has_one_owner(dtype, batch, d):
    # block g of the grid owns row tile g // cluster and the 128 columns of
    # its rank g % cluster (cross_net.cu: blockIdx.x / csize, block_rank)
    p = cross.plan(batch, d, dtype)
    owners = np.zeros((batch, d), np.int64)
    for g in range(p.grid):
        tile, rank = divmod(g, p.cluster)
        owners[tile * p.tile_rows:(tile + 1) * p.tile_rows,
               rank * cross.COLS:(rank + 1) * cross.COLS] += 1
    assert (owners == 1).all()
    # and no block is idle: its tile starts inside the batch
    assert (p.grid // p.cluster - 1) * p.tile_rows < batch


@pytest.mark.parametrize("dtype", DTYPES)
def test_refuses_what_the_kernel_does_not_take(dtype):
    for d in (0, cross.MAX_D + 1, 4096):
        with pytest.raises(ValueError):
            cross.plan(100, d, dtype)
    with pytest.raises(ValueError):  # an opt-in too small for any shape
        cross.plan(100, 384, dtype, smem_optin=16 * 1024)


def test_refuses_other_dtypes():
    with pytest.raises(ValueError):
        cross.plan(100, 384, torch.float16)


def test_bf16_keeps_two_blocks_an_sm_at_the_canonical_width():
    # D = 384: one 64-row X tile beside a 3-chunk ring fits two blocks an SM
    p = cross.plan(4096, 384, torch.bfloat16)
    assert (p.tile_rows, p.x_buffers, p.stages, p.blocks_per_sm) == (64, 1, 3, 2)
    # D = 1024: two X tiles no longer fit; one, with the exchange's second signal
    assert cross.plan(4096, 1024, torch.bfloat16).x_buffers == 1
