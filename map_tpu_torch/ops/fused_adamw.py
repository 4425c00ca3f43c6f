"""One-pass AdamW update (K1). Counterpart: `map_tpu/ops/fused_adamw.py`
(`_adamw_math`, `fused_adamw_dense`, `pack_scalars`).

Kernel: `map_tpu_torch/csrc/fused_adamw.cu` (CUDA C++, sm_90a; Triton would
suit this elementwise pass too, but CUDA C++ keeps one build route for all
the port's kernels).
- Replaces `fused_adamw.py:fused_adamw_dense`, a (512, W)-tiled Pallas pass
  with p / mu / nu aliased in place.
- Bound on the H100: device-memory bytes, 28 per element (4 arrays read,
  3 written). The canonical 1,013,519 x 16 table moves 454 MB: 0.1355 ms at
  3.35 TB/s.
- Design: a grid-stride elementwise pass, one float4 of each array per
  thread, over any contiguous float32 tensor; the scalars are passed by
  value. Every operation rounds on its own (no FMA contraction), in the order
  of optax's algebra, so the kernel and `fused_adamw_plain` agree bit for bit.

Both update p, mu and nu in place. `scalars(...)` computes lr's companions
bc1 = 1 - b1**t and bc2 = 1 - b2**t in float32, as `pack_scalars` does, with
t the step count after the increment (the first update has t = 1).

CUDA tensors go to the kernel, CPU tensors to `fused_adamw_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from map_tpu_torch.kernels import build

# Launches of the K1 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0


class AdamScalars(NamedTuple):
    lr: float
    wd: float
    b1: float
    b2: float
    eps: float
    bc1: float
    bc2: float


def scalars(lr, wd, b1, b2, eps, count_inc: int) -> AdamScalars:
    """Every scalar rounded to float32; bc = 1 - b**t computed in float32."""
    f = np.float32
    t = f(count_inc)
    return AdamScalars(*(float(f(x)) for x in (
        lr, wd, b1, b2, eps, f(1.0) - f(b1) ** t, f(1.0) - f(b2) ** t)))


def fused_adamw_plain(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                      g: torch.Tensor, s: AdamScalars) -> None:
    """`_adamw_math` in PyTorch ops, in place. The scalars are 0-d tensors on
    p's device: PyTorch divides a CUDA tensor by a host scalar as a product
    with its reciprocal, which rounds differently."""
    lr, wd, b1, b2, eps, bc1, bc2 = (
        torch.tensor(x, dtype=torch.float32, device=p.device) for x in s)
    one = torch.ones((), dtype=torch.float32, device=p.device)
    with torch.no_grad():
        mu.copy_(b1 * mu + (one - b1) * g)
        nu.copy_(b2 * nu + (one - b2) * g * g)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p
        p.copy_(p - lr * upd)


def fused_adamw(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                g: torch.Tensor, s: AdamScalars) -> None:
    """p, mu, nu, g: float32 tensors of one shape; p, mu and nu are updated
    in place. On the card all four must be contiguous on one device."""
    if p.device.type == "cpu":
        fused_adamw_plain(p, mu, nu, g, s)
        return
    tensors = (p, mu, nu, g)
    if p.device.type != "cuda" or any(t.device != p.device for t in tensors):
        raise ValueError("fused_adamw: p, mu, nu, g on "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 or t.shape != p.shape or not t.is_contiguous()
           for t in tensors):
        raise ValueError("fused_adamw: p, mu, nu and g must be contiguous float32 "
                         f"tensors of one shape, got "
                         f"{[(t.dtype, tuple(t.shape)) for t in tensors]}")
    global launches
    lib = build.library()
    status = lib.map_tpu_fused_adamw(
        p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g.data_ptr(), p.numel(),
        *s, torch.cuda.current_stream().cuda_stream)
    build.check_status(status, "fused_adamw")
    launches += 1
