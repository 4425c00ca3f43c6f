"""DCNv2 cross network (K2): X_{l+1} = X_l + X_0 * (X_l W_l^T + b_l).

Counterparts: `map_tpu/ops/cross.py` (`cross_net_xla`) and the fused Pallas
kernel `map_tpu/ops/pallas_cross.py:_cross_forward`.

Kernel: `map_tpu_torch/csrc/cross_net.cu` (CUDA C++, sm_90a).
- Replaces `pallas_cross.py:_cross_forward`: all L layers in one launch.
- Bound on the H100 at the serving shape (B = 10000, D = 384, L = 3):
  operations, 2*L*B*D^2 = 8.8 GFLOP against about 15 MB of bf16 bytes; the
  bf16 training call (4096 rows with the residuals) by its 26 MB of bytes.
- Design: a cluster of dp / 128 blocks (dp = D rounded up to 128) shares
  each row tile; block c computes output columns [128c, 128c + 128) of every
  layer from the whole X_l tile, streaming only its slice of W. bf16 runs
  `wgmma` (m64n128k16, f32 accumulate) on 64-row tiles in shared memory, W
  and X_0 brought by TMA from a producer warp, and each block pushes its
  columns of X_{l+1} into the others' shared memory by bulk copies. f32
  runs 8 x 8 register-tiled FMA loops in full f32 on X_l and W chunks
  streamed from L2 by cp.async, the blocks passing X_{l+1} through global
  memory (the residual, a scratch, or Y) between cluster barriers. Any
  D <= 1024 (the ragged edge is masked); unaligned W or x0, or a D whose
  rows are not 16-byte multiples, take the kernel's element-by-element load
  path.

The launch plan (`plan`) is computed here, a pure function of the shapes,
the dtype and the card's shared-memory opt-in, and handed to the C entry,
which checks it.

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

import functools
from typing import NamedTuple, Tuple, Union

import torch

from map_tpu_torch.kernels import build

# Launches of the K2 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0

CrossOut = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

# The kernel's geometry (cross_net.cu): output columns a block, the widest D
# (8 blocks a cluster); the SM's shared memory and what each block reserves
COLS = 128
MAX_D = 1024
SM_SHARED_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024
# Rows a tile in both dtypes (bf16: one wgmma tile; f32: 128 threads of 8 x 8
# outputs); the most blocks an SM by registers (__launch_bounds__(.., 2));
# depth of a W chunk in the ring: f32, bf16 (one 128-byte swizzled row)
TILE_ROWS = 64
REG_BLOCKS = 2
F32_CHUNK, BF16_CHUNK = 32, 64
# The H100's defaults, for a plan made without a card (the CPU tests)
H100_SMS, H100_SMEM_OPTIN = 132, 232_448


class Plan(NamedTuple):
    tile_rows: int      # batch rows a cluster owns
    cluster: int        # blocks a cluster: one per COLS output columns
    grid: int           # blocks in all: row tiles x cluster
    smem: int           # dynamic shared memory a block, bytes
    stages: int         # W chunks in the ring
    x_buffers: int      # X_l tiles a block holds (2: the next layer's is written
                        # while this one is read)
    vector: bool        # W (and x0) in 16-byte pieces: TMA for bf16, cp.async
                        # for f32; else element by element
    blocks_per_sm: int  # by shared memory and registers


def smem_bytes(dtype: torch.dtype, dp: int, stages: int, x_buffers: int) -> int:
    """cross_net.cu's shared-memory layout. f32: a ring of (TILE_ROWS +
    COLS, F32_CHUNK + 4) f32 chunks of X_l and W, whatever D. bf16: X_l
    tiles in wgmma's 128-byte-swizzled layout (dp x 128 bytes for 64 rows),
    a ring of (COLS, 64) bf16 chunks, the block's X_0 columns (swizzled
    too), its bias columns for two layers, then 128 bytes of mbarriers."""
    if dtype == torch.float32:
        return 4 * stages * (TILE_ROWS + COLS) * (F32_CHUNK + 4)
    return (x_buffers * TILE_ROWS * dp * 2 + stages * COLS * BF16_CHUNK * 2
            + TILE_ROWS * COLS * 2 + 2 * COLS * 2 + 128)


def _shapes(dtype: torch.dtype):
    """-> [(stages, x_buffers)] in order of preference. f32: one ring of 3;
    bf16: two X tiles if they fit (the next layer's is written while this
    one is read), the deepest ring that fits."""
    if dtype == torch.float32:
        return [(3, 1)]
    if dtype == torch.bfloat16:
        return [(4, 2), (3, 2), (4, 1), (3, 1), (2, 1)]
    raise ValueError(f"cross_net: dtype {dtype}; float32 or bfloat16 is needed")


@functools.lru_cache(maxsize=256)
def plan(batch: int, d: int, dtype: torch.dtype,
         smem_optin: int = H100_SMEM_OPTIN, aligned: bool = True) -> Plan:
    """K2's launch for x0 (batch, d) in `dtype` (float32 or bfloat16) with W
    (and x0) 16-byte aligned or not: of the shapes that fit, the one that
    keeps the most blocks on an SM, then the first. Raises ValueError for a
    d the kernel does not take."""
    if not 0 < d <= MAX_D:
        raise ValueError(f"cross_net: D = {d} is outside 1..{MAX_D}")
    dp = -(-d // COLS) * COLS
    cluster = dp // COLS
    fits = []
    for stages, x_buffers in _shapes(dtype):
        smem = smem_bytes(dtype, dp, stages, x_buffers)
        if smem <= smem_optin:
            per_sm = min(REG_BLOCKS, SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES))
            fits.append((per_sm, -len(fits), stages, x_buffers, smem))
    if not fits:
        raise ValueError(f"cross_net: D = {d} needs more shared memory than "
                         f"{smem_optin} bytes")
    per_sm, _, stages, x_buffers, smem = max(fits)
    size = 4 if dtype == torch.float32 else 2
    return Plan(tile_rows=TILE_ROWS, cluster=cluster,
                grid=-(-batch // TILE_ROWS) * cluster, smem=smem, stages=stages,
                x_buffers=x_buffers, vector=(d * size) % 16 == 0 and aligned,
                blocks_per_sm=per_sm)


def first_wave_sms(p: Plan, sm_count: int = H100_SMS) -> int:
    """SMs that get a block in the first wave, blocks placed one an SM
    before a second, whole clusters at a time."""
    blocks = min(p.grid, sm_count * p.blocks_per_sm // p.cluster * p.cluster)
    return min(sm_count, blocks)


@functools.lru_cache(maxsize=8)
def _smem_optin(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin", H100_SMEM_OPTIN)


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
    optin = _smem_optin(x0.device.index if x0.device.index is not None
                        else torch.cuda.current_device())
    p = plan(batch, d, x0.dtype, optin,
             w.data_ptr() % 16 == 0 and x0.data_ptr() % 16 == 0)
    y = torch.empty_like(x0)
    xs = us = scratch = None
    if save_residuals:
        xs = torch.empty((num_layers, batch, d), dtype=x0.dtype, device=x0.device)
        us = torch.empty_like(xs)
    elif x0.dtype == torch.float32 and num_layers > 1:
        # f32 passes X_l between layers through global memory
        scratch = torch.empty((2, batch, d), dtype=x0.dtype, device=x0.device)
    lib = build.library()
    status = lib.map_tpu_cross_net(
        x0.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (xs, us, scratch)),
        batch, d, num_layers, int(x0.dtype == torch.bfloat16),
        p.tile_rows, p.cluster, p.grid, p.smem, p.stages, p.x_buffers,
        int(p.vector), build.current_stream(x0.device.index))
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
