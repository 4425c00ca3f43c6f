"""Dense gradient from a sorted, duplicate-free update stream (K5).
Counterpart: `map_tpu/ops/pallas_scatter.py:scatter_unique_sorted`, the
scatter stage of the NCE decoder's duplicate-folding backward
(`ops/dedup_scatter.py`).

Kernel: `map_tpu_torch/csrc/scatter_unique_sorted.cu` (CUDA C++, sm_90a).
- Replaces `pallas_scatter.py:scatter_unique_sorted` (one-hot (512 x 512)
  MXU matmuls per 512-row table tile, for want of fast scattered writes).
- Bound on the H100: device-memory bytes; the dense output dominates
  (133.8 MB for the decoder's 1,013,519 x 33 gradient).
- Design: a block per 256-row tile finds its window of the stream with two
  warp-wide searches, maps its rows to window slots in shared memory and
  writes every row once, the value or zeros; no atomics, no memset,
  deterministic.

`matmul` names the TPU kernel's precision modes: 'highest' copies each value
exactly, 'bf16x2' writes bf16(v) + bf16(v - bf16(v)). `widths` splits the
columns over contiguous outputs (at most two), so the decoder gets its
(V, 32) emb and (V, 1) bias gradients without a slice.

CUDA tensors go to the kernel, CPU tensors to `scatter_unique_sorted_plain`
(zeros, then `index_copy_` of the valid entries).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from map_tpu_torch.kernels import build

MODES = ("highest", "bf16x2")

# Launches of the K5 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0


def _rounded(vals: torch.Tensor, matmul: str) -> torch.Tensor:
    if matmul == "highest":
        return vals
    hi = vals.to(torch.bfloat16).float()
    return hi + (vals - hi).to(torch.bfloat16).float()


def _widths(vals: torch.Tensor, widths: Optional[Sequence[int]],
            matmul: str) -> Tuple[int, ...]:
    if matmul not in MODES:
        raise ValueError(f"scatter_unique_sorted: matmul must be one of {MODES}, "
                         f"got {matmul!r}")
    w = tuple(widths) if widths else (vals.shape[-1],)
    if not 1 <= len(w) <= 2 or sum(w) != vals.shape[-1] or min(w) < 1:
        raise ValueError(f"scatter_unique_sorted: widths {w} do not split "
                         f"{vals.shape[-1]} columns into one or two parts")
    return w


def scatter_unique_sorted_plain(uids: torch.Tensor, vals: torch.Tensor,
                                vocab_size: int, widths: Optional[Sequence[int]] = None,
                                matmul: str = "highest") -> Tuple[torch.Tensor, ...]:
    w = _widths(vals, widths, matmul)
    # sentinels (and the negative ids of a shard's offset stream) land on a
    # spare row past the table, dropped below
    slots = torch.where((uids >= 0) & (uids < vocab_size), uids, vocab_size).long()
    out = torch.zeros(vocab_size + 1, vals.shape[-1], dtype=torch.float32,
                      device=vals.device)
    out.index_copy_(0, slots, _rounded(vals.float(), matmul))
    return tuple(t.contiguous() for t in out[:vocab_size].split(list(w), dim=1))


def scatter_unique_sorted(uids: torch.Tensor, vals: torch.Tensor, vocab_size: int,
                          widths: Optional[Sequence[int]] = None,
                          matmul: str = "highest") -> Tuple[torch.Tensor, ...]:
    """uids (C,) int32, ascending and unique below vocab_size, every entry
    >= vocab_size (a sentinel) after the last one below it (unchecked by the
    kernel); vals (C, E') float32 -> float32 (vocab_size, w) tensors, one per
    width in `widths` (default: one of E'), holding the columns of vals in
    order: row uids[j] is vals[j], every row no uid names is 0. Negative
    entries (ascending, before the others: a row-sharded table's stream
    offset to its block, `parallel/embedding.sharded_rows_scatter_add`) fall
    in no row and are skipped."""
    w = _widths(vals, widths, matmul)
    if vals.device.type == "cpu":
        return scatter_unique_sorted_plain(uids, vals, vocab_size, w, matmul)
    if vals.device.type != "cuda" or uids.device != vals.device:
        raise ValueError(f"scatter_unique_sorted: uids on {uids.device}, "
                         f"vals on {vals.device}")
    if uids.dtype != torch.int32 or vals.dtype != torch.float32:
        raise ValueError("scatter_unique_sorted: uids must be int32 and vals "
                         f"float32, got {uids.dtype} and {vals.dtype}")
    if uids.dim() != 1 or vals.dim() != 2 or vals.shape[0] != uids.shape[0]:
        raise ValueError(f"scatter_unique_sorted: uids {tuple(uids.shape)} and "
                         f"vals {tuple(vals.shape)} are not (C,) and (C, E')")
    if not (uids.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_unique_sorted: uids and vals must be contiguous")
    global launches
    outs = tuple(torch.empty(vocab_size, x, dtype=torch.float32, device=vals.device)
                 for x in w)
    lib = build.library()
    status = lib.map_tpu_scatter_unique_sorted(
        uids.data_ptr(), vals.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr() if len(outs) > 1 else None, uids.shape[0], vocab_size,
        vals.shape[1], w[0], int(matmul == "bf16x2"),
        build.current_stream(vals.device.index))
    build.check_status(status, "scatter_unique_sorted")
    launches += 1
    return outs
