"""DCNv2 cross network (K2): X_{l+1} = X_l + X_0 * (X_l W_l^T + b_l).

Counterparts: `map_tpu/ops/cross.py` (`cross_net_xla`) and the fused Pallas
kernel `map_tpu/ops/pallas_cross.py:_cross_forward`.

Kernel: `map_tpu_torch/csrc/cross_net.cu` (CUDA C++, sm_90a).
- Replaces `pallas_cross.py:_cross_forward`: all L layers in one kernel,
  with a batch tile of X_0 and X_l resident on chip and W streamed.
- Bound on the H100 at the serving shape (B = 10000, D = 384, L = 3):
  operations. 2*L*B*D^2 = 8.8 GFLOP against about 15 MB of bf16 bytes.
- Design: 16-64 row tiles in shared memory for all L layers, W in chunks
  of 128 output rows from L2, the next chunk read into registers while the
  current one is multiplied; bf16 products on the tensor cores (WMMA, f32
  accumulate), f32 products as FMA loops; any D (the ragged edge is masked).

Weights are in nn.Linear layout: `w` is (L, D, D) with w[l] = (out, in), `b`
is (L, D). x0, w and b share one dtype (float32 or bfloat16); the product
accumulates in f32 and U_l is rounded to that dtype once per layer, as
`pallas_cross.py:120-123` does. With `save_residuals` the call also returns
X_l and U_l, each (L, B, D), outside autograd.

Under autograd the call is `_Cross`, the counterpart of the custom VJP
`pallas_cross.py:_cross_fused` (:64-95): K2 forward with the residuals saved,
and the backward chain of :75-92 in `cross_net_backward`. Its products are
`torch.matmul` (map_tpu leaves them to XLA) and its rounding points are
map_tpu's: dW_l and the carried g are summed in float32 and rounded to the
compute dtype once per layer, db_l is a float32-accumulated sum rounded once,
and dX_0's gate term is accumulated in the compute dtype.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from map_tpu_torch.kernels import build

# Launches of the K2 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0

CrossOut = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def cross_net_plain(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    save_residuals: bool = False) -> CrossOut:
    xi = x0
    xs, us = [], []
    for layer in range(w.shape[0]):
        u = (torch.matmul(xi.float(), w[layer].float().t())
             + b[layer].float()).to(x0.dtype)
        xs.append(xi)
        us.append(u)
        xi = xi + x0 * u
    if save_residuals:
        return xi, torch.stack(xs), torch.stack(us)
    return xi


def _forward(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             save_residuals: bool) -> CrossOut:
    if x0.device.type == "cpu":
        return cross_net_plain(x0, w, b, save_residuals)
    if x0.device.type != "cuda" or w.device != x0.device or b.device != x0.device:
        raise ValueError(f"cross_net: x0 on {x0.device}, w on {w.device}, "
                         f"b on {b.device}")
    if x0.dtype not in (torch.float32, torch.bfloat16) or \
            w.dtype != x0.dtype or b.dtype != x0.dtype:
        raise ValueError(f"cross_net: dtypes x0 {x0.dtype}, w {w.dtype}, "
                         f"b {b.dtype}; one of float32 / bfloat16 is needed")
    if x0.dim() != 2:
        raise ValueError(f"cross_net: x0 must be (B, D), got {tuple(x0.shape)}")
    batch, d = x0.shape
    num_layers = w.shape[0]
    if w.shape != (num_layers, d, d) or b.shape != (num_layers, d):
        raise ValueError(f"cross_net: w {tuple(w.shape)} / b {tuple(b.shape)} "
                         f"do not fit D = {d}")
    if not (x0.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("cross_net: x0, w and b must be contiguous")
    global launches
    y = torch.empty_like(x0)
    xs = us = None
    if save_residuals:
        xs = torch.empty((num_layers, batch, d), dtype=x0.dtype, device=x0.device)
        us = torch.empty_like(xs)
    lib = build.library()
    status = lib.map_tpu_cross_net(
        x0.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        None if xs is None else xs.data_ptr(),
        None if us is None else us.data_ptr(),
        batch, d, num_layers, int(x0.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    build.check_status(status, "cross_net")
    launches += 1
    return (y, xs, us) if save_residuals else y


def cross_net_backward(x0: torch.Tensor, w: torch.Tensor, xs: torch.Tensor,
                       us: torch.Tensor, g: torch.Tensor):
    """`pallas_cross.py:_cross_fused_bwd` in the port's layout (w[l] is
    (out, in)): returns dX_0, dW (L, D, D) and db (L, D) in the primal
    dtypes."""
    dx0_gate = torch.zeros_like(x0)
    dw = [None] * w.shape[0]
    db = [None] * w.shape[0]
    for layer in reversed(range(w.shape[0])):
        du = g * x0
        # bf16 x bf16 products are exact in float32: these are f32-accumulated
        dw[layer] = torch.matmul(du.float().t(), xs[layer].float())
        db[layer] = du.sum(dim=0)
        dx0_gate = dx0_gate + g * us[layer]
        g = (g.float() + torch.matmul(du.float(), w[layer].float())).to(g.dtype)
    return ((g + dx0_gate).to(x0.dtype), torch.stack(dw).to(w.dtype),
            torch.stack(db).to(w.dtype))


class _Cross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, w, b):
        y, xs, us = _forward(x0, w, b, save_residuals=True)
        ctx.save_for_backward(x0, w, xs, us)
        return y

    @staticmethod
    def backward(ctx, g):
        return cross_net_backward(*ctx.saved_tensors, g.contiguous())


def cross_net(x0: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              save_residuals: bool = False) -> CrossOut:
    """x0 (B, D), w (L, D, D), b (L, D) -> X_L (B, D) [, X_l, U_l (L, B, D)].
    Differentiable in x0, w and b unless the residuals are asked for."""
    if (not save_residuals and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x0, w, b))):
        return _Cross.apply(x0, w, b)
    return _forward(x0, w, b, save_residuals)
