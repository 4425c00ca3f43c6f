"""Embedding row gather (K4) and its gradient (K3). Counterparts:
`map_tpu/ops/embedding.py` `embedding_lookup` / `gather_rows` (:21-45, whose
custom VJP is the scatter-add) and the Pallas kernel
`map_tpu/ops/pallas_embedding.py:_gather`.

Kernel: `map_tpu_torch/csrc/embedding_gather.cu` (CUDA C++, sm_90a).
- Replaces `pallas_embedding.py:_gather` (per-row DMAs from an HBM table,
  pipelined behind a semaphore ring).
- Bound on the H100: device-memory bytes: the ids, the distinct rows and the
  output once; there is no arithmetic. The main path launches it at (4096,
  24) ids, E = 16, bf16 out (the training input), (4096, 7, 26) ids into the
  1,013,519 x 32 decoder table (the MFP per-position candidates: 95 MB out),
  (4096, 7) and (24, 100) ids at E = 32 (per-field shared noise), and (10000,
  24) at eval and in serving.
- Design: units of 4 floats (8 in bf16 out with E % 8 == 0: a 16-byte
  store of the fused f32 -> bf16 cast); a thread loads the ids of its 1 to
  4 units, then their rows, then stores them, so its row loads wait on one
  id latency; one wave of blocks covers the output. `plan` sizes the
  launch, once per shape.

Under autograd the lookup is `_Lookup`: K4 forward, K3 (`ops/scatter.py`)
backward. The upstream gradient arrives in the output's dtype (bf16 when the
gather casts to bf16) and K3 sums it into a dense float32 (V, E) table
gradient, as map_tpu's f32 scatter of the up-cast cotangent does.

CUDA tensors go to the kernels, CPU tensors to `embedding_lookup_plain` and
`scatter_add_plain`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from map_tpu_torch.kernels import build
from map_tpu_torch.ops.scatter import scatter_add

# Launches of the K4 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0

THREADS = 256       # embedding_gather.cu's kThreads
MAX_BLOCKS = 65535  # the grid at most; past it the blocks walk on over the tiles
UNITS = (1, 2, 4)   # units a thread the kernel is built for
# output floats from which a thread takes 2 units, and 4 (below: 1)
TWO_UNITS_FROM, FOUR_UNITS_FROM = 1 << 17, 1 << 21


class Plan(NamedTuple):
    vec: int             # floats a unit: 4, or 8 (bf16 out, E % 8 == 0); 0: the scalar path
    units_a_thread: int  # units a thread takes (0 on the scalar path)
    blocks: int


@functools.lru_cache(maxsize=512)
def plan(n: int, e: int, bf16: bool, aligned: bool) -> Plan:
    """K4's launch for n rows of width e (bf16 out or f32), the table
    16-byte `aligned` or not. The batched path cuts the output into units
    of `vec` floats; a block takes THREADS * units_a_thread of them (1, 2
    from TWO_UNITS_FROM output floats on, 4 from FOUR_UNITS_FROM: a small
    launch spreads over more SMs), and one wave of blocks covers the output
    (up to MAX_BLOCKS). Rows whose width is not a multiple of 4,
    or an unaligned table, take the scalar path: an element a thread."""
    if e % 4 or not aligned:
        return Plan(0, 0, max(1, min(-(-n * e // THREADS), MAX_BLOCKS)))
    vec = 8 if bf16 and e % 8 == 0 else 4
    units_a_thread = 4 if n * e >= FOUR_UNITS_FROM else 2 if n * e >= TWO_UNITS_FROM else 1
    tiles = -(-(n * e // vec) // (THREADS * units_a_thread))
    return Plan(vec, units_a_thread, max(1, min(tiles, MAX_BLOCKS)))


def embedding_lookup_plain(table: torch.Tensor, ids: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    out = table[ids]
    return out if out_dtype is None else out.to(out_dtype)


def _gather(table: torch.Tensor, ids: torch.Tensor,
            out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    if table.device.type == "cpu":
        return embedding_lookup_plain(table, ids, out_dtype)
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(f"embedding_lookup: table on {table.device}, "
                         f"ids on {ids.device}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("embedding_lookup: table must be a contiguous 2-D "
                         f"float32 tensor, got {table.dtype} {tuple(table.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"embedding_lookup: ids must be int32, got {ids.dtype}")
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"embedding_lookup: out_dtype {out_dtype}")
    global launches
    ids_c = ids.contiguous()
    e = table.shape[1]
    n = ids_c.numel()
    bf16 = out_dtype == torch.bfloat16
    out = torch.empty((*ids.shape, e), dtype=out_dtype, device=table.device)
    t = table.data_ptr()
    p = plan(n, e, bf16, t % 16 == 0)
    status = build.library().map_tpu_embedding_gather(
        t, ids_c.data_ptr(), out.data_ptr(), n, e, int(bf16), p.vec, p.units_a_thread,
        p.blocks, build.current_stream(table.device.index))
    build.check_status(status, "embedding_gather")
    launches += 1
    return out


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, out_dtype):
        ctx.save_for_backward(ids)
        ctx.vocab_size = table.shape[0]
        return _gather(table, ids, out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        return scatter_add(ids.contiguous(), grad_out.contiguous(),
                           ctx.vocab_size), None, None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(V, E) table, (...) ids -> (..., E) rows, cast to `out_dtype` if given.
    On the card: table float32, ids int32 in [0, V) (unchecked by the
    kernels), out_dtype None, float32 or bfloat16. Differentiable in `table`.

    A row block of a sharded table (`parallel/sharding.shard_tables`) goes
    through the exchange of the active mesh (map_tpu `ops/embedding.py:71-85`):
    `hotcold_embedding_lookup` for batch-leading ids when the exchange is
    'hotcold' and the table has hot rows, else `sharded_embedding_lookup`."""
    if getattr(table, "map_tpu_shard", None) is not None:
        return _sharded(table, ids, out_dtype)
    if torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(table, ids, out_dtype)
    return _gather(table, ids, out_dtype)


def _sharded(table: torch.Tensor, ids: torch.Tensor,
             out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    from map_tpu_torch.parallel import context
    from map_tpu_torch.parallel.embedding import (
        hotcold_embedding_lookup,
        sharded_embedding_lookup,
    )

    mesh = context.table_mesh()
    if mesh is None:
        raise RuntimeError("a row-sharded table is looked up with no table mesh active")
    shard = table.map_tpu_shard
    hot = (context.table_hot_rows_on(shard.total, table.device)
           if context.table_exchange() == "hotcold" and ids.dim() >= 2 else None)
    if hot is not None and hot.numel() > 0:
        return hotcold_embedding_lookup(table, ids, mesh.model_group, hot,
                                        out_dtype=out_dtype)
    return sharded_embedding_lookup(table, ids, mesh.model_group, out_dtype)
