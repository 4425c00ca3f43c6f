"""AdamW with decoupled weight decay, a no-decay mask and an optional
global-norm clip. Counterpart: `map_tpu/train/optimizer.py`
(`no_decay_mask`, `is_table_leaf`, `PartitionedTx`, `build_optimizer`).

The algebra is optax.adamw's (eps_root 0) as map_tpu's fused kernel computes
it (`map_tpu/ops/fused_adamw.py:_adamw_math`), not torch.optim.AdamW's. A
step updates every dense parameter in one `ops.fused_adamw_leaves` call: one
K1 launch on the card (for up to 64 parameters), its plain version on the
CPU, with wd = 0 where the mask says so. map_tpu splits the parameters
(tables through its Pallas kernel, the rest through optax) only because
optax is the TPU's path for the rest; the update is the same.

State: (mu, nu) per parameter, float32, plus the host int `count`. The
learning rate of a step is the schedule at `count` (before the increment);
bc1 = 1 - b1**t and bc2 = 1 - b2**t use t = count + 1, in float32.

The step scalars reach the kernels through a (slots, 8) float32 buffer on
the parameters' device, a row a step (`fused_adamw.scalar_row`), which K1
and K7 read on the card. `begin(n)` writes the rows of the next n steps
(one copy from pinned memory on the card, from one of two staging buffers,
the other's copy being waited for before it is written again), and step j
of them reads row j; a step with no row written writes its own first. So
the multi-step dispatch (`train/graph.py`) writes a call's rows once and
replays a graph that captured the steps' launches: `reserve(n)` gives a
capture its rows without writing them, `rewind(count)` puts the host state
back after the capture, and `advance(n)` moves it (the count and every
handoff's step) past n steps that ran without this object.

Under data parallelism (`grad_group`, the data group) every dense
gradient is summed over the group before the update, as one flat buffer in
the parameters' order (`parallel/collectives.all_reduce_flat_`): a table's
row block with the rest, so K1 still updates them all in one launch.

With `max_grad_norm > 0` the gradients are first clipped by their global
norm, as optax.clip_by_global_norm does (`optimizer.py:170-192`); under a
table mesh the norm sums the row blocks' squares over the model group.

The sparse table update (`ops/sparse_adamw.py`, map_tpu `optimizer.py:129-146`):
a parameter given a `StreamHandoff` in `sparse` (the MFP decoder's emb when
the update engages) takes no dense gradient; each step reads its target
and noise streams from the handoff and updates it through K7, with the same
scalars. It raises on a dense gradient of that parameter, and on missing or
stale streams. A clip needs every gradient, so it refuses a handoff.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from map_tpu_torch.ops import fused_adamw as k1
from map_tpu_torch.ops import sparse_adamw as k7
from map_tpu_torch.parallel import context
from map_tpu_torch.parallel.collectives import all_reduce_flat_
from map_tpu_torch.parallel.mesh import Group
from map_tpu_torch.parallel.sharding import is_vocab_table as is_table_leaf  # noqa: F401 (map_tpu's name)
from map_tpu_torch.parallel.sharding import shard_of
from map_tpu_torch.train.schedules import Schedule, make_schedule

# (params, mus, nus, grads, wds, scalar buffer, slot): an entry a dense parameter
UpdateFn = Callable[[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor],
                     List[torch.Tensor], List[float], torch.Tensor, int], None]
# (param, mu, nu, target stream, noise stream, wd, scalar buffer, slot)
SparseUpdateFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, k7.Stream,
                           k7.Stream, float, torch.Tensor, int], None]


def decays(name: str) -> bool:
    """True = weight decay applies. map_tpu's rule (`no_decay_mask`: no decay
    for leaves named bias* and for LayerNorm and BatchNorm scales,
    `map_tpu/train/optimizer.py:33-38`) on torch names: any name holding
    `bias` (a Linear's `*.bias`, the NCE decoder's
    `mfp_criterion.bias.weight`, FiGNN's `bias_p`), a LayerNorm's `weight`
    (`embed.layer_norm.weight`, `encoder.layers.0.norm1.weight`) and a
    BatchNorm's `weight`, which FGCNN's stages hold as the second module of
    each `conv_layers.{i}` (`fgcnn_layer.conv_layers.0.1.weight`), take
    none."""
    if "bias" in name:
        return False
    parts = name.split(".")
    if parts[-1] != "weight" or len(parts) < 2:
        return True
    batch_norm = len(parts) >= 4 and parts[-4] == "conv_layers" and parts[-2] == "1"
    return not ("norm" in parts[-2] or batch_norm)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        blocks: Optional[List[bool]] = None,
                        group: Optional[Group] = None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g unchanged when the global norm is below
    max_norm, else g / norm * max_norm. Stays on the device (no sync).
    Under a table mesh (`blocks`: which gradients are a table's row block;
    `group`: the model group) the blocks' squares are summed over the
    group, so every rank clips by the norm of the whole gradient."""
    squares = [torch.sum(g.float() * g.float()) for g in grads]
    if group is None or not any(blocks or ()):
        total = sum(squares)
    else:
        total = group.all_reduce_(sum(s for s, b in zip(squares, blocks) if b))
        total = total + sum(s for s, b in zip(squares, blocks) if not b)
    norm = torch.sqrt(total)
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


class AdamW:
    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float = 0.0,
                 update: UpdateFn = k1.fused_adamw_leaves,
                 sparse: Optional[Dict[str, k7.StreamHandoff]] = None,
                 sparse_update: SparseUpdateFn = k7.sparse_adamw_step,
                 slots: int = 1, grad_group: Optional[Group] = None):
        named = list(named_params)
        self.grad_group = grad_group
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decay = [decays(n) for n in self.names]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.update = update
        self.sparse_update = sparse_update
        sparse = dict(sparse or {})
        if sparse and max_grad_norm and max_grad_norm > 0:
            raise ValueError("the sparse table update cannot run under a global-norm "
                             "clip, which needs every dense gradient")
        unknown = set(sparse) - set(self.names)
        if unknown:
            raise ValueError(f"sparse table update for unknown parameters {unknown}")
        # parameter index -> its handoff
        self.sparse = {self.names.index(n): h for n, h in sparse.items()}
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in self.params]
        self.nu = [torch.zeros_like(m) for m in self.mu]
        self.count = 0
        # each parameter's wd, float32 as the kernels take it
        self.wds = [float(np.float32(weight_decay)) if d else 0.0 for d in self.decay]
        device = self.params[0].device if self.params else torch.device("cpu")
        self.scal = torch.zeros(max(1, int(slots)), k1.SCALAR_WIDTH, dtype=torch.float32,
                                device=device)
        self._staging = ([torch.zeros_like(self.scal, device="cpu").pin_memory()
                          for _ in range(2)] if device.type == "cuda" else [])
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._flip = 0
        self._slot = self._left = 0  # the next step's row; rows written and not yet read

    def scalar_rows(self, n: int) -> np.ndarray:
        """(n, 8) float32: the rows of steps count, ..., count + n - 1."""
        return np.asarray([k1.scalar_row(k1.scalars(
            self.schedule(c), self.weight_decay, self.b1, self.b2, self.eps, c + 1))
            for c in range(self.count, self.count + n)], np.float32)

    def begin(self, n: int) -> None:
        """Write the next n steps' rows into slots 0, ..., n - 1."""
        if not 0 < n <= self.scal.shape[0]:
            raise ValueError(f"AdamW.begin: {n} steps for {self.scal.shape[0]} slots")
        rows = torch.from_numpy(self.scalar_rows(n))
        if not self._staging:
            self.scal[:n] = rows
        else:
            buf, done = self._staging[self._flip], self._copied[self._flip]
            if done is not None:
                done.synchronize()
            buf[:n] = rows
            self.scal[:n].copy_(buf[:n], non_blocking=True)
            self._copied[self._flip] = torch.cuda.Event()
            self._copied[self._flip].record()
            self._flip ^= 1
        self.reserve(n)

    def reserve(self, n: int) -> None:
        """The next n steps read slots 0, ..., n - 1, as they stand."""
        if not 0 < n <= self.scal.shape[0]:
            raise ValueError(f"AdamW.reserve: {n} steps for {self.scal.shape[0]} slots")
        self._slot, self._left = 0, n

    def rewind(self, count: int) -> None:
        """The host state at step `count`, no row pending."""
        self.count = count
        self._slot = self._left = 0
        for handoff in self.sparse.values():
            handoff.step = count

    def advance(self, n: int) -> None:
        """n steps ran on the card without this object (a graph replay)."""
        self.rewind(self.count + n)

    @torch.no_grad()
    def step(self, grads: Optional[List[Optional[torch.Tensor]]] = None) -> None:
        """One update from `grads` (default: each parameter's .grad; None
        for a parameter updated from its streams)."""
        if grads is None:
            grads = [p.grad for p in self.params]
        streams = {}
        for i, handoff in self.sparse.items():
            if grads[i] is not None:
                raise RuntimeError(
                    f"sparse table update: {self.names[i]} has a dense gradient "
                    f"beside its streams{' (pending)' if handoff.pending() else ''}")
            streams[i] = handoff.take(self.count)
        # a dense parameter the loss does not reach (AutoInt's W_res without
        # the residual) takes a zero gradient, as in map_tpu: its moments
        # decay and its weight decays
        grads = [None if i in streams else
                 torch.zeros_like(p) if g is None else g.float().contiguous()
                 for i, (p, g) in enumerate(zip(self.params, grads))]
        if self.grad_group is not None:
            dense = [i for i, g in enumerate(grads) if g is not None]
            for i, g in zip(dense, all_reduce_flat_([grads[i] for i in dense],
                                                    self.grad_group)):
                grads[i] = g
        if self.max_grad_norm and self.max_grad_norm > 0:
            mesh = context.table_mesh()
            grads = clip_by_global_norm(
                grads, self.max_grad_norm, [shard_of(p) is not None for p in self.params],
                None if mesh is None else mesh.model_group)
        if self._left == 0:
            self.begin(1)
        slot = self._slot
        dense = [i for i in range(len(self.params)) if i not in streams]
        self.update(*([seq[i] for i in dense]
                      for seq in (self.params, self.mu, self.nu, grads, self.wds)),
                    self.scal, slot)
        for i, (target, noise) in streams.items():
            self.sparse_update(self.params[i], self.mu[i], self.nu[i], target, noise,
                               self.wds[i], self.scal, slot)
        self.count += 1
        self._slot += 1
        self._left -= 1
        for handoff in self.sparse.values():
            handoff.step = self.count

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return {n: (m, v) for n, m, v in zip(self.names, self.mu, self.nu)}


def build_optimizer(model: torch.nn.Module, args, num_training_steps: int,
                    num_warmup_steps: int, update: UpdateFn = k1.fused_adamw_leaves,
                    sparse: Optional[Dict[str, k7.StreamHandoff]] = None,
                    sparse_update: SparseUpdateFn = k7.sparse_adamw_step,
                    grad_group: Optional[Group] = None) -> Tuple[AdamW, Schedule]:
    beta1, beta2 = (float(x) for x in args.adam_betas.split(","))
    schedule = make_schedule(args.lr_sched, args.learning_rate,
                             num_warmup_steps, num_training_steps)
    opt = AdamW(model.named_parameters(), schedule, beta1, beta2,
                args.adam_epsilon, args.weight_decay,
                max_grad_norm=args.max_grad_norm or 0.0, update=update,
                sparse=sparse, sparse_update=sparse_update,
                slots=getattr(args, "steps_per_call", 1), grad_group=grad_group)
    return opt, schedule
