"""Inclusive prefix sum over axis 0 (K8). Counterpart:
`map_tpu/ops/pallas_scan.py:block_cumsum`, built for the MFP decoder's fold
(`map_tpu/ops/dedup_scatter.py:_fold_stream2`); here it is the fold's scan
(`ops/dedup_scatter.py:sort_and_fold`), on the path of every MFP mode.

Kernel: `map_tpu_torch/csrc/block_cumsum.cu` (CUDA C++, sm_90a; a reduction
Triton would serve, written in CUDA to keep the one nvcc + ctypes build of
`kernels/build.py`).
- Replaces `pallas_scan.py:block_cumsum`, a sequential grid of 512-row
  blocks carrying the running sum in scratch, (n, 128) with n % 512 == 0.
  This one takes any n and any width up to 128.
- Bound on the H100: device-memory bytes, n * W * 4 read and written once;
  0.059 ms for the per-position fold's (745,472, 33) stream at 3.35 TB/s.
- Design: three launches with a fixed association (tile sums, a scan of the
  tile sums, a scan of each tile from its carry), so every call gives the
  same bits; no decoupled look-back, whose association depends on timing.

The plain version is what the fold did before K8: one `torch.cumsum` per
column, each column a contiguous 1-D tensor (PyTorch scans the columns of an
(n, W) tensor over dim 0 with one thread each, 261 ms for the fold's stream
on the H100). It sums in another order than the kernel: the two agree to
the rounding of the running prefix, not bit for bit.

CUDA tensors go to the kernel, CPU tensors to `block_cumsum_plain`.
"""

from __future__ import annotations

import torch

from map_tpu_torch.kernels import build

MAX_WIDTH = 128

# Launches of the K8 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0


def block_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([col.contiguous().cumsum(0) for col in x.t()], dim=1)


def block_cumsum(x: torch.Tensor) -> torch.Tensor:
    """x (n, W) float32, W <= 128 -> (n, W) float32, out[r] = x[0] + ... + x[r]."""
    if x.dim() != 2 or not 1 <= x.shape[1] <= MAX_WIDTH:
        raise ValueError(f"block_cumsum: x must be (n, W) with 1 <= W <= {MAX_WIDTH}, "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return block_cumsum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"block_cumsum: x on {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("block_cumsum: x must be a contiguous float32 tensor, got "
                         f"{x.dtype}")
    global launches
    n, w = x.shape
    out = torch.empty_like(x)
    scratch = torch.empty(2 * -(-n // 32) * w, dtype=torch.float32, device=x.device)
    lib = build.library()
    status = lib.map_tpu_block_cumsum(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                      n, w, torch.cuda.current_stream().cuda_stream)
    build.check_status(status, "block_cumsum")
    launches += 1
    return out
