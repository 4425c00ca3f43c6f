"""Embedding row gather (K4) and its gradient (K3). Counterparts:
`map_tpu/ops/embedding.py` `embedding_lookup` / `gather_rows` (:21-45, whose
custom VJP is the scatter-add) and the Pallas kernel
`map_tpu/ops/pallas_embedding.py:_gather`.

Kernel: `map_tpu_torch/csrc/embedding_gather.cu` (CUDA C++, sm_90a).
- Replaces `pallas_embedding.py:_gather` (per-row DMAs from an HBM table,
  pipelined behind a semaphore ring).
- Bound on the H100: device-memory bytes. At the serving shape (ids
  10000 x 24, E = 16) it reads up to 240k rows of 64 B plus the ids and
  writes 240k rows; there is no arithmetic.
- Design: E/4 threads per row, one float4 each, grid-stride over the rows;
  the f32 -> bf16 cast of the bf16 compute path is fused into the store.

Under autograd the lookup is `_Lookup`: K4 forward, K3 (`ops/scatter.py`)
backward. The upstream gradient arrives in the output's dtype (bf16 when the
gather casts to bf16) and K3 sums it into a dense float32 (V, E) table
gradient, as map_tpu's f32 scatter of the up-cast cotangent does.

CUDA tensors go to the kernels, CPU tensors to `embedding_lookup_plain` and
`scatter_add_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from map_tpu_torch.kernels import build
from map_tpu_torch.ops.scatter import scatter_add

# Launches of the K4 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0


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
    out = torch.empty((*ids.shape, e), dtype=out_dtype, device=table.device)
    lib = build.library()
    status = lib.map_tpu_embedding_gather(
        table.data_ptr(), ids_c.data_ptr(), out.data_ptr(), ids_c.numel(), e,
        int(out_dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
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
    kernels), out_dtype None, float32 or bfloat16. Differentiable in `table`."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(table, ids, out_dtype)
    return _gather(table, ids, out_dtype)
