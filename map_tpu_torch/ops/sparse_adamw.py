"""AdamW on the MFP decoder table from its sorted gradient streams (K7).
Counterpart: `map_tpu/ops/sparse_adamw.py` (`sparse_fused_adamw`, the
engagement switch `enable`, the plan `pf_plan`, the registry).

With `--sparse_table_update` and a shared-noise MFP mode, the decoder's
backward (`ops/dedup_scatter.py`) folds the target rows' and the noise rows'
gradients into two sorted streams of distinct ids, as it does for K5, and
hands them to the optimizer instead of writing a dense (V, E) gradient. The
optimizer's update of `mfp_criterion.emb.weight` then runs K7: every row's
gradient is assembled from the two streams inside the AdamW pass, so the
dense gradient never exists.

Kernel: `map_tpu_torch/csrc/sparse_adamw.cu` (CUDA C++, sm_90a).
- Replaces `sparse_adamw.py:sparse_fused_adamw`, whose (128, 128) tiles
  place the streams' entries with one-hot MXU matmuls over an exact 3-way
  bf16 split; none of that carries over.
- Bound on the H100: device-memory bytes, p / mu / nu read and written
  (24 B an element, 778.4 MB for the decoder's 1,013,519 x 32) plus the
  streams' valid entries read once: about 0.234 ms at 3.35 TB/s.
- Design: a block per 256-row tile finds the tile's window in each stream by
  a warp-wide search, maps rows to window slots in shared memory, and
  updates each row once with K1's arithmetic (`csrc/adamw_math.cuh`); the
  gradient of a row is 0 + target value + noise value, each add rounded on
  its own, so the kernel gives the plain version's bits.

The handoff: map_tpu encodes the streams into a dense cotangent because
`jax.grad` needs one (`sparse_adamw.py:19-35`); the port's autograd
Functions return no emb gradient and deposit the streams in a
`StreamHandoff` that the optimizer reads and clears. A mixed state fails
loudly (map_tpu's atomic engagement): a dense emb gradient beside the
streams, one stream of the two, or a stream left from an earlier step.

Engagement (`engages`): map_tpu's rule with its default packed tables
(`trainer.py:208-218`, `objectives/nce.py:105-130`): the flag, a shared-noise
mode and no global-norm clip. Per-position noise registers no plan in
map_tpu, so the port stays dense there too. map_tpu's other conditions
(a table mesh, whether the encoding fits the packed table's rows) are about
its sharding and its encoding; the port has neither.

The scalars: `sparse_adamw_step` takes wd by value and the others from
row `slot` of the optimizer's (K, 8) float32 scalar buffer on the device
(`fused_adamw.scalar_row`), which the kernel reads on the card, so that a
captured CUDA graph reads each replay's lr, bc1 and bc2;
`sparse_adamw(..., s)` takes them by value, through a one-row buffer.

CUDA tensors go to the kernel, CPU tensors to the plain versions.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from map_tpu_torch.kernels import build
from map_tpu_torch.ops.fused_adamw import (
    SCALAR_WIDTH,
    AdamScalars,
    fused_adamw_leaves_plain,
    fused_adamw_plain,
    scalar_row,
)

# Launches of the K7 kernel; the wrapper adds one where it launches, nowhere else.
launches = 0

STREAMS = ("target", "noise")


class Stream(NamedTuple):
    """uids (n,) int32, ascending and distinct below V, then sentinels >= V;
    vals (n, E) float32, the folded gradient of each id (zeros past the
    valid ids), as `ops/dedup_scatter.sort_and_fold` gives them."""

    uids: torch.Tensor
    vals: torch.Tensor


def engages(sparse_table_update: bool, shared_noise: bool,
            max_grad_norm: float) -> bool:
    """map_tpu's engagement rule for the port's single-device, unsharded
    decoder table."""
    return bool(sparse_table_update and shared_noise
                and not (max_grad_norm and max_grad_norm > 0))


class StreamHandoff:
    """The decoder backward's streams, from autograd to the optimizer.

    `put` deposits one of "target" or "noise" (the optimizer's step count,
    `step`, is stamped on it); `take(step)` returns both and clears them. It
    raises when a stream of the same kind is still pending from an earlier
    backward, when one of the two is missing, and when a stream was deposited
    at another step than the one taking it."""

    def __init__(self):
        self.step = 0
        self._pending: Dict[str, Tuple[int, Stream]] = {}

    def pending(self) -> bool:
        return bool(self._pending)

    def put(self, kind: str, stream: Stream) -> None:
        if kind not in STREAMS:
            raise ValueError(f"StreamHandoff: kind {kind!r} is not one of {STREAMS}")
        if kind in self._pending:
            raise RuntimeError(
                f"sparse table update: a stale {kind} stream of step "
                f"{self._pending[kind][0]} was never consumed by the optimizer")
        self._pending[kind] = (self.step, stream)

    def take(self, step: int) -> Tuple[Stream, Stream]:
        missing = [k for k in STREAMS if k not in self._pending]
        if missing:
            raise RuntimeError(
                f"sparse table update: the {' and '.join(missing)} stream of step "
                f"{step} never arrived (a shared-noise MFP step deposits both)")
        stale = {k: s for k, (s, _) in self._pending.items() if s != step}
        if stale:
            raise RuntimeError(f"sparse table update: streams {stale} are stale at "
                               f"step {step}")
        target, noise = (self._pending.pop(k)[1] for k in STREAMS)
        return target, noise


def _dense_grad(p: torch.Tensor, target: Stream, noise: Stream) -> torch.Tensor:
    """Zeros, `index_add_` of the target stream, `index_add_` of the noise
    stream (sentinels onto a spare row): the (V, E) gradient."""
    v = p.shape[0]
    g = torch.zeros(v + 1, p.shape[1], dtype=torch.float32, device=p.device)
    for stream in (target, noise):
        g.index_add_(0, stream.uids.long().clamp(max=v), stream.vals.float())
    return g[:v]


def sparse_adamw_plain(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                       target: Stream, noise: Stream, s: AdamScalars) -> None:
    """The streams' dense gradient, then K1's plain update, in place."""
    fused_adamw_plain(p, mu, nu, _dense_grad(p, target, noise), s)


def sparse_adamw_step_plain(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                            target: Stream, noise: Stream, wd: float,
                            scal: torch.Tensor, slot: int) -> None:
    """`sparse_adamw_step`'s plain version."""
    fused_adamw_leaves_plain([p], [mu], [nu], [_dense_grad(p, target, noise)], [wd],
                             scal, slot)


def sparse_adamw(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                 target: Stream, noise: Stream, s: AdamScalars) -> None:
    """`sparse_adamw_step` with the scalars by value (on the CPU,
    `sparse_adamw_plain`)."""
    if p.device.type == "cpu":
        sparse_adamw_plain(p, mu, nu, target, noise, s)
        return
    scal = torch.tensor([scalar_row(s)], dtype=torch.float32, device=p.device)
    sparse_adamw_step(p, mu, nu, target, noise, s.wd, scal, 0)


def sparse_adamw_step(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                      target: Stream, noise: Stream, wd: float,
                      scal: torch.Tensor, slot: int) -> None:
    """p, mu, nu (V, E) float32, updated in place; the streams as `Stream`
    says (ascending distinct ids, unchecked by the kernel); wd by value, the
    other scalars from row `slot` of `scal`, a (K, SCALAR_WIDTH) float32
    buffer on p's device."""
    if scal.dim() != 2 or scal.shape[1] != SCALAR_WIDTH or scal.dtype != torch.float32 \
            or not scal.is_contiguous() or not 0 <= slot < scal.shape[0]:
        raise ValueError(f"sparse_adamw: scalar buffer {scal.dtype} {tuple(scal.shape)}, "
                         f"slot {slot}: expected a contiguous (K, {SCALAR_WIDTH}) float32 "
                         "buffer and 0 <= slot < K")
    if p.device.type == "cpu" and scal.device.type == "cpu":
        sparse_adamw_step_plain(p, mu, nu, target, noise, wd, scal, slot)
        return
    tensors = (p, mu, nu, *target, *noise, scal)
    if p.device.type != "cuda" or any(t.device != p.device for t in tensors):
        raise ValueError("sparse_adamw: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}")
    if p.dim() != 2 or any(t.dtype != torch.float32 or t.shape != p.shape
                           or not t.is_contiguous() for t in (p, mu, nu)):
        raise ValueError("sparse_adamw: p, mu and nu must be contiguous (V, E) float32 "
                         f"tensors of one shape, got {[(t.dtype, tuple(t.shape)) for t in (p, mu, nu)]}")
    for name, st in zip(STREAMS, (target, noise)):
        if (st.uids.dtype != torch.int32 or st.vals.dtype != torch.float32
                or st.uids.dim() != 1 or st.vals.shape != (st.uids.shape[0], p.shape[1])
                or not (st.uids.is_contiguous() and st.vals.is_contiguous())):
            raise ValueError(f"sparse_adamw: the {name} stream must be contiguous int32 "
                             f"(n,) ids and float32 (n, {p.shape[1]}) values, got "
                             f"{st.uids.dtype} {tuple(st.uids.shape)} and "
                             f"{st.vals.dtype} {tuple(st.vals.shape)}")
    global launches
    lib = build.library()
    status = lib.map_tpu_sparse_adamw(
        p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        target.uids.data_ptr(), target.vals.data_ptr(), target.uids.shape[0],
        noise.uids.data_ptr(), noise.vals.data_ptr(), noise.uids.shape[0],
        p.shape[0], p.shape[1], wd, scal.data_ptr(), slot,
        build.current_stream(p.device.index))
    build.check_status(status, "sparse_adamw")
    launches += 1
