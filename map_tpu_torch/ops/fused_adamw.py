"""One-pass AdamW update (K1). Counterpart: `map_tpu/ops/fused_adamw.py`
(`_adamw_math`, `fused_adamw_dense`, `pack_scalars`).

Kernel: `map_tpu_torch/csrc/fused_adamw.cu` (CUDA C++, sm_90a; Triton would
suit this elementwise pass too, but CUDA C++ keeps one build route for all
the port's kernels).
- Replaces `fused_adamw.py:fused_adamw_dense`, a (512, W)-tiled Pallas pass
  with p / mu / nu aliased in place, called once per table.
- Bound on the H100: device-memory bytes, 28 per element (4 arrays read,
  3 written). A canonical DCNv2 step's 17 leaves (about 19 M elements) move
  about 533 MB: about 0.16 ms at 3.35 TB/s.
- Design: one launch updates a list of leaves (a training step's dense
  parameters). `plan` lays every leaf's elements out in one flat space of
  4-element units (one 16-byte vector each) and splits the list into
  launches of at most MAX_LEAVES leaves; the descriptor block of a launch
  (each leaf's pointers, size, first unit, wd and 16-byte alignment) goes to
  the kernel by value. A block takes THREADS * UNITS_PER_THREAD consecutive
  units, finds each unit's leaf among the launch's first units, and keeps
  UNITS_PER_THREAD vectors of each array in flight. An unaligned leaf, or
  the last partial unit of a leaf, goes element by element in the same
  launch. Every operation rounds on its own (no FMA contraction), in the
  order of optax's algebra (`adamw_math.cuh`, shared with K7), so the
  kernel and `fused_adamw_plain` agree bit for bit.

The step's scalars reach the kernel on the card: `fused_adamw_leaves`
takes the optimizer's (K, 8) float32 scalar buffer and the step's slot, a
row `[lr, wd, b1, b2, eps, bc1, bc2, 0]` (`scalar_row`, the layout of
`pack_scalars`), which the kernel reads for lr, b1, b2, eps, bc1 and bc2;
wd is each leaf's own. So a CUDA graph that captured the launch reads
each replay's scalars, which the host writes before the replay
(`train/optimizer.py`). `fused_adamw_multi` updates a list of leaves from
scalars by value, each leaf with its own (which may differ in wd only),
through a one-row buffer; `fused_adamw` is its one-leaf case. All update
p, mu and nu in place. `scalars(...)` computes lr's companions
bc1 = 1 - b1**t and bc2 = 1 - b2**t in float32, as `pack_scalars` does, with
t the step count after the increment (the first update has t = 1).

CUDA tensors go to the kernel, CPU tensors to the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from map_tpu_torch.kernels import build

# Launches of the K1 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0

# The kernel's geometry (fused_adamw.cu): float32 elements a unit (one
# 16-byte vector), threads a block, units a thread keeps in flight, leaves
# a launch's descriptor block holds (it is passed by value, within 4 KB)
UNIT = 4
THREADS = 256
UNITS_PER_THREAD = 2
MAX_LEAVES = 64
# floats a row of the scalar buffer (step_scalars.cuh)
SCALAR_WIDTH = 8

# One leaf of the descriptor block: fused_adamw.cu's `Leaf`, 56 bytes
LEAF_DTYPE = np.dtype([("p", "<u8"), ("mu", "<u8"), ("nu", "<u8"), ("g", "<u8"),
                       ("numel", "<i8"), ("start", "<i8"), ("wd", "<f4"),
                       ("aligned", "<i4")])


class AdamScalars(NamedTuple):
    lr: float
    wd: float
    b1: float
    b2: float
    eps: float
    bc1: float
    bc2: float


class Launch(NamedTuple):
    leaves: Tuple[int, ...]  # indices into the caller's list, in order
    starts: Tuple[int, ...]  # each leaf's first unit in the launch's flat space
    units: int               # units in all
    blocks: int              # THREADS * UNITS_PER_THREAD units a block


def scalars(lr, wd, b1, b2, eps, count_inc: int) -> AdamScalars:
    """Every scalar rounded to float32; bc = 1 - b**t computed in float32."""
    f = np.float32
    t = f(count_inc)
    return AdamScalars(*(float(f(x)) for x in (
        lr, wd, b1, b2, eps, f(1.0) - f(b1) ** t, f(1.0) - f(b2) ** t)))


def scalar_row(s: AdamScalars) -> Tuple[float, ...]:
    """s as a row of the scalar buffer: [lr, wd, b1, b2, eps, bc1, bc2, 0]."""
    return (*s, 0.0)


def plan(numels: Sequence[int], max_leaves: int = MAX_LEAVES) -> Tuple[Launch, ...]:
    """The launches that update leaves of `numels` elements: the non-empty
    leaves in order, at most `max_leaves` a launch; leaf i of a launch takes
    units [starts[i], starts[i] + ceil(numel / UNIT)) of its flat space."""
    if max_leaves < 1:
        raise ValueError(f"fused_adamw: max_leaves = {max_leaves}")
    live = [i for i, n in enumerate(numels) if n > 0]
    out = []
    for k in range(0, len(live), max_leaves):
        leaves = tuple(live[k:k + max_leaves])
        units = [-(-numels[i] // UNIT) for i in leaves]
        starts = tuple(int(s) for s in np.cumsum([0] + units[:-1]))
        total = int(sum(units))
        per_block = THREADS * UNITS_PER_THREAD
        out.append(Launch(leaves, starts, total, -(-total // per_block)))
    return tuple(out)


def descriptor(launch: Launch, ptrs: Sequence[Tuple[int, int, int, int]],
               numels: Sequence[int], wds: Sequence[float],
               aligned: Sequence[bool]) -> np.ndarray:
    """The launch's descriptor block: one LEAF_DTYPE record per leaf, from
    the caller's per-leaf (p, mu, nu, g) addresses, sizes, wd and 16-byte
    alignment (all indexed as the caller's list)."""
    d = np.zeros(len(launch.leaves), LEAF_DTYPE)
    for row, (i, start) in enumerate(zip(launch.leaves, launch.starts)):
        d[row] = (*ptrs[i], numels[i], start, np.float32(wds[i]), int(aligned[i]))
    return d


def _update_plain(p, mu, nu, g, lr, wd, b1, b2, eps, bc1, bc2) -> None:
    """`_adamw_math` in PyTorch ops, in place, every scalar a 0-d float32
    tensor on p's device: PyTorch divides a CUDA tensor by a host scalar as
    a product with its reciprocal, which rounds differently."""
    one = torch.ones((), dtype=torch.float32, device=p.device)
    with torch.no_grad():
        mu.copy_(b1 * mu + (one - b1) * g)
        nu.copy_(b2 * nu + (one - b2) * g * g)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p
        p.copy_(p - lr * upd)


def fused_adamw_plain(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                      g: torch.Tensor, s: AdamScalars) -> None:
    """One leaf, the scalars by value."""
    _update_plain(p, mu, nu, g, *(torch.tensor(x, dtype=torch.float32, device=p.device)
                                  for x in s))


def fused_adamw_leaves_plain(ps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                             nus: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                             wds: Sequence[float], scal: torch.Tensor, slot: int) -> None:
    """`fused_adamw_leaves`' plain version: the scalars from row `slot` of
    `scal`, leaf i's wd = wds[i]."""
    lr, _, b1, b2, eps, bc1, bc2, _ = scal[slot].unbind()
    for p, mu, nu, g, wd in zip(ps, mus, nus, gs, wds, strict=True):
        _update_plain(p, mu, nu, g, lr,
                      torch.full((), wd, dtype=torch.float32, device=p.device),
                      b1, b2, eps, bc1, bc2)


def fused_adamw_multi_plain(ps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                            nus: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                            ss: Sequence[AdamScalars]) -> None:
    """`fused_adamw_plain` on each leaf."""
    for p, mu, nu, g, s in zip(ps, mus, nus, gs, ss, strict=True):
        fused_adamw_plain(p, mu, nu, g, s)


def fused_adamw_multi(ps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                      nus: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                      ss: Sequence[AdamScalars]) -> None:
    """Leaf i: p, mu, nu, g float32 tensors of one shape, p, mu and nu
    updated in place with the scalars ss[i], which may differ in wd only:
    `fused_adamw_leaves` from a one-row scalar buffer (on the CPU, the plain
    version of each leaf)."""
    n = len(ps)
    if not (len(mus) == len(nus) == len(gs) == len(ss) == n):
        raise ValueError(f"fused_adamw: {n} p, {len(mus)} mu, {len(nus)} nu, "
                         f"{len(gs)} g and {len(ss)} scalars")
    if n == 0:
        return
    common = ss[0]._replace(wd=0.0)
    if any(s._replace(wd=0.0) != common for s in ss):
        raise ValueError("fused_adamw: one launch takes one lr, b1, b2, eps, bc1 "
                         f"and bc2; got {sorted(set(s._replace(wd=0.0) for s in ss))}")
    if all(t.device.type == "cpu" for leaf in (ps, mus, nus, gs) for t in leaf):
        fused_adamw_multi_plain(ps, mus, nus, gs, ss)
        return
    scal = torch.tensor([scalar_row(common)], dtype=torch.float32, device=ps[0].device)
    fused_adamw_leaves(ps, mus, nus, gs, [s.wd for s in ss], scal, 0)


def fused_adamw_leaves(ps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                       nus: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                       wds: Sequence[float], scal: torch.Tensor, slot: int) -> None:
    """Leaf i: p, mu, nu, g float32 tensors of one shape, p, mu and nu
    updated in place with wd = wds[i] and the other scalars from row `slot`
    of `scal`, a (K, SCALAR_WIDTH) float32 buffer on the leaves' device. On
    the card every tensor is contiguous on one device, and the list takes
    one launch for every MAX_LEAVES non-empty leaves."""
    n = len(ps)
    if not (len(mus) == len(nus) == len(gs) == len(wds) == n):
        raise ValueError(f"fused_adamw: {n} p, {len(mus)} mu, {len(nus)} nu, "
                         f"{len(gs)} g and {len(wds)} wd")
    if scal.dim() != 2 or scal.shape[1] != SCALAR_WIDTH or scal.dtype != torch.float32 \
            or not scal.is_contiguous() or not 0 <= slot < scal.shape[0]:
        raise ValueError(f"fused_adamw: scalar buffer {scal.dtype} {tuple(scal.shape)}, "
                         f"slot {slot}: expected a contiguous (K, {SCALAR_WIDTH}) float32 "
                         "buffer and 0 <= slot < K")
    if n == 0:
        return
    dev = ps[0].device
    if all(t.device.type == "cpu" for leaf in (ps, mus, nus, gs, [scal]) for t in leaf):
        fused_adamw_leaves_plain(ps, mus, nus, gs, wds, scal, slot)
        return
    for p, mu, nu, g in zip(ps, mus, nus, gs):
        tensors = (p, mu, nu, g, scal)
        if dev.type != "cuda" or any(t.device != dev for t in tensors):
            raise ValueError("fused_adamw: p, mu, nu, g and the scalars on "
                             f"{[str(t.device) for t in tensors]}, expected {dev}")
        if any(t.dtype != torch.float32 or t.shape != p.shape or not t.is_contiguous()
               for t in tensors[:4]):
            raise ValueError("fused_adamw: p, mu, nu and g must be contiguous float32 "
                             f"tensors of one shape, got "
                             f"{[(t.dtype, tuple(t.shape)) for t in tensors[:4]]}")
    numels = [p.numel() for p in ps]
    ptrs = [tuple(t.data_ptr() for t in leaf) for leaf in zip(ps, mus, nus, gs)]
    aligned = [all(t.data_ptr() % 16 == 0 for t in leaf) for leaf in zip(ps, mus, nus, gs)]
    global launches
    lib = build.library()
    stream = build.current_stream(dev.index)
    for launch in plan(numels):
        desc = descriptor(launch, ptrs, numels, wds, aligned)
        status = lib.map_tpu_fused_adamw_leaves(
            desc.ctypes.data, len(launch.leaves), launch.units, launch.blocks,
            scal.data_ptr(), slot, stream)
        build.check_status(status, "fused_adamw")
        launches += 1


def fused_adamw(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                g: torch.Tensor, s: AdamScalars) -> None:
    """One leaf: `fused_adamw_multi` of [p], [mu], [nu], [g], [s]."""
    fused_adamw_multi([p], [mu], [nu], [g], [s])
