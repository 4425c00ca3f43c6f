"""Embedding row gather (K4). Counterpart: `map_tpu/ops/embedding.py`
`embedding_lookup` and its Pallas kernel `map_tpu/ops/pallas_embedding.py:_gather`.

Kernel: `map_tpu_torch/csrc/embedding_gather.cu` (CUDA C++, sm_90a).
- Replaces `pallas_embedding.py:_gather` (per-row DMAs from an HBM table,
  pipelined behind a semaphore ring).
- Bound on the H100: device-memory bytes. At the serving shape (ids
  10000 x 24, E = 16) it reads up to 240k rows of 64 B plus the ids and
  writes 240k rows; there is no arithmetic.
- Design: E/4 threads per row, one float4 each, grid-stride over the rows;
  the f32 -> bf16 cast of the serving path is fused into the store.

CUDA tensors go to the kernel, CPU tensors to `embedding_lookup_plain`. The
kernel has no backward yet (it lands with the training slice), so a CUDA
lookup that would need one raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from map_tpu_torch.kernels import build

# Launches of the K4 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0


def embedding_lookup_plain(table: torch.Tensor, ids: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    out = table[ids]
    return out if out_dtype is None else out.to(out_dtype)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(V, E) table, (...) ids -> (..., E) rows, cast to `out_dtype` if given.
    On the card: table float32, ids int32 in [0, V) (unchecked by the kernel),
    out_dtype None, float32 or bfloat16."""
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
    if torch.is_grad_enabled() and table.requires_grad:
        raise NotImplementedError(
            "embedding_lookup: the CUDA gather has no backward yet; call it "
            "under torch.no_grad() / torch.inference_mode()")
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
