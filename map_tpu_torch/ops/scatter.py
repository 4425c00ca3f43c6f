"""Embedding-gradient scatter-add (K3). Counterpart:
`map_tpu/ops/pallas_scatter.py:scatter_add` and its Pallas kernel
`_scatter_add_pallas`; the backward of `map_tpu/ops/embedding.py:gather_rows`.

Kernel: `map_tpu_torch/csrc/scatter_add.cu` (CUDA C++, sm_90a).
- Replaces `pallas_scatter.py:_scatter_add_pallas` (a (chunk, tile) pair list
  and one-hot MXU matmuls, which the TPU needs for want of fast scattered
  writes).
- Bound on the H100: device-memory bytes; the dense (V, E) float32 output
  dominates (64.9 MB for the canonical 1,013,519 x 16 table).
- Design: the flat ids are sorted here (`torch.sort`, stable, as map_tpu
  sorts in XLA outside its kernel); `scatter_add_sorted` then clears the
  table at the memory rate and walks the sorted stream, one warp per span of
  segment heads, staging each chunk's permutation and gradient rows in
  shared memory (cp.async) ahead of the adds; the walk's loads overlap the
  clearing. Each touched row is summed from 0.0 in float32 in index order;
  no atomics, bf16 or f32 gradients.

CUDA tensors go to the kernel, CPU tensors to `scatter_add_plain`. The
plain version sums each row's duplicates in a fixed order on either device:
on the CPU `index_add_` onto zeros, which adds in index order as K3 does; on
the card (chip_smoke.py's comparison runs) `index_put_` with accumulate,
autograd's own backward of a row gather, which sorts the ids and sums each
row's duplicates in turn, where `index_add_`'s atomics would add them in any
order (and the CPU's `index_put_` too, above 32,768 elements).
"""

from __future__ import annotations

import torch

from map_tpu_torch.kernels import build

# Launches of the K3 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0


def scatter_add_plain(ids: torch.Tensor, grads: torch.Tensor,
                      vocab_size: int) -> torch.Tensor:
    e = grads.shape[-1]
    out = torch.zeros(vocab_size, e, dtype=torch.float32, device=grads.device)
    flat_ids, flat_g = ids.reshape(-1).long(), grads.reshape(-1, e).float()
    if out.is_cuda:
        return out.index_put_((flat_ids,), flat_g, accumulate=True)
    return out.index_add_(0, flat_ids, flat_g)


def scatter_add(ids: torch.Tensor, grads: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """ids (...,) int32 in [0, vocab_size) (unchecked by the kernel), grads
    (..., E) float32 or bfloat16 -> (vocab_size, E) float32, duplicates
    summed."""
    if grads.device.type == "cpu":
        return scatter_add_plain(ids, grads, vocab_size)
    if grads.device.type != "cuda" or ids.device != grads.device:
        raise ValueError(f"scatter_add: ids on {ids.device}, grads on {grads.device}")
    if ids.dtype != torch.int32:
        raise ValueError(f"scatter_add: ids must be int32, got {ids.dtype}")
    if grads.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scatter_add: grads must be float32 or bfloat16, "
                         f"got {grads.dtype}")
    if tuple(grads.shape[:-1]) != tuple(ids.shape):
        raise ValueError(f"scatter_add: grads {tuple(grads.shape)} do not fit "
                         f"ids {tuple(ids.shape)}")
    if not (ids.is_contiguous() and grads.is_contiguous()):
        raise ValueError("scatter_add: ids and grads must be contiguous")
    sorted_ids, perm = torch.sort(ids.reshape(-1), stable=True)
    return scatter_add_sorted(sorted_ids, perm, grads, vocab_size)


def scatter_add_sorted(sorted_ids: torch.Tensor, perm: torch.Tensor,
                       grads: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The K3 launch after `scatter_add`'s stable sort: sorted_ids (N,) int32
    ascending, perm (N,) int64 with sorted_ids == flat ids[perm], grads
    (..., E) on the card as `scatter_add` checked them."""
    global launches
    e = grads.shape[-1]
    out = torch.empty(vocab_size, e, dtype=torch.float32, device=grads.device)
    lib = build.library()
    status = lib.map_tpu_scatter_add(
        sorted_ids.data_ptr(), perm.data_ptr(), grads.data_ptr(), out.data_ptr(),
        sorted_ids.numel(), vocab_size, e, int(grads.dtype == torch.bfloat16),
        build.current_stream(grads.device.index))
    build.check_status(status, "scatter_add")
    launches += 1
    return out
