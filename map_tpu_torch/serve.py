"""Inference: load a checkpoint and score id blocks on the card.

Counterpart: `map_tpu/serve.py:28-208` (its Predictor v2). `Predictor`
reads the run's config.json and either the port's `{step}.model`
(`source="torch"`) or map_tpu's (`source="jax"`, carried across by
`interop/from_jax.py` with its `batch_stats`), scores with the supervised
head (`config.pretrain = False`, as map_tpu's `:45`) in eval mode (FGCNN's
BatchNorm from the checkpoint's running statistics), and keeps map_tpu's
constructor parameters, defaults and CLI flags:

- The forward is fixed at construction, for the (batch_size, F) shape, as
  map_tpu's AOT `lower().compile()` (`:84-91`): on the card a CUDA graph of
  it is captured (after one eager warm-up call on a side stream), with
  static inputs and a static (batch_size,) float32 output; a chunk is one
  replay. The weights sit on the device, and the products' weights that a
  layer casts on every call (TorchDense, CrossNetV2) are cast once
  (`nn.layers.cast_weights_once`).
- `compress_transfer` (map_tpu `_pack`, `:94-104`): with the fields' id
  ranges in the config, each field goes over as its offsets from its
  `idx_low`, in uint8 (fields of at most 256 ids), uint16 (at most 65,536;
  sent as int16 and masked back) or int32, three blocks a chunk. The
  blocks are field-major, (fields, batch_size), where map_tpu's are
  (batch_size, fields): the same bytes, but numpy's passes then run over
  whole rows. On the card the ids are rebuilt by casting, adding each
  field's `idx_low`, putting the fields back in order and transposing.
- Padding: the last chunk is padded to batch_size rows, each field with its
  `idx_low` (offset 0) when packing, else with id 0; the padding rows'
  scores are dropped. map_tpu pads with id 0 and relies on its clamped
  gather to keep a wrapped offset in bounds; K4 does not bound-check, so
  the port pads inside every block.
- The real rows' ids are checked on the host: each field's against
  [idx_low_f, idx_high_f) when packing, else every id against [0,
  input_size); a bad id raises `ValueError`. This departs from map_tpu,
  whose packed transfer wraps an id outside its field's block.
- `predict_logits` runs map_tpu's three stages (`:105-171`), `prefetch`
  chunks apart: a producer stage checks, pads and packs a chunk into
  pinned memory and copies it to the device on a side stream; a device
  stage moves the chunk `prefetch` behind into the graph's inputs, replays
  it and copies its logits back into pinned memory; a drainer stage waits
  for the chunk `2 prefetch` behind by its event and writes its logits into
  the result. map_tpu runs the producer and the drainer on threads of
  their own; here the three run interleaved on the caller's thread, and
  the card overlaps their copies with the forwards: with threads, the
  interpreter lock's handoffs cost more host time a chunk than they hide
  (PERF.md §5, `kernels/serve_times.py --threaded`). An error is raised
  to the caller. On the CPU the chunks run one after another through the
  same checks, packing and forward.

float32 products on the card run in full float32
(`torch.backends.cuda.matmul.allow_tf32` is set to False).

CLI: python -m map_tpu_torch.serve --model_dir outputs/... --step 42 \
        --data_dir data/avazu --dataset_name avazu --split test --out scores.npy \
        [--batch_size 10000] [--jax_checkpoint] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from map_tpu_torch import models, resolve_device
from map_tpu_torch.config import Config
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.nn.layers import cast_weights_once
from map_tpu_torch.train import checkpoints
from map_tpu_torch.utils.metrics import sigmoid

# the packed blocks' host dtypes (uint16 goes as int16 and is masked back)
_BLOCK_DTYPES = (np.uint8, np.int16, np.int32)


class Predictor:
    def __init__(self, model_dir: str, step: int, batch_size: int = 10000,
                 device=None, source: str = "torch",
                 config: Optional[Config] = None, prefetch: int = 2,
                 compress_transfer: bool = True):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        config = config if config is not None else Config.load(model_dir)
        self.config = dataclasses.replace(config, pretrain=False)  # the supervised head
        if source == "torch":
            state_dict = checkpoints.load_model(model_dir, step)
        elif source == "jax":
            state_dict = state_dict_from_jax(
                checkpoints.load_jax_model_file(
                    checkpoints.model_checkpoint_path(model_dir, step)),
                self.config)
        else:
            raise ValueError(f"source must be 'torch' or 'jax', got {source!r}")
        model = models.from_config(self.config)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        cast_weights_once(self.model)
        self.batch_size = int(batch_size)
        self.prefetch = max(1, int(prefetch))
        c = self.config
        f = int(c.num_fields)
        self._groups = None
        if (compress_transfer and c.idx_low is not None and c.idx_high is not None
                and len(c.idx_high) == f):
            lo = np.asarray(c.idx_low, np.int64)
            hi = np.asarray(c.idx_high, np.int64)
            sizes = hi - lo  # field-blocked: an id - idx_low lies in [0, size)
            g8 = np.flatnonzero(sizes <= 256)
            g16 = np.flatnonzero((sizes > 256) & (sizes <= 65536))
            g32 = np.flatnonzero(sizes > 65536)
            order = np.concatenate([g8, g16, g32])
            self._groups = (lo, hi, (g8, g16, g32))
            self._order = order
            self._lo_ord = lo[order].astype(np.int32)
            self._size_ord = sizes[order].astype(np.uint32)
            self._perm = torch.from_numpy(np.argsort(order)).to(self.device)
            self._lo_cat = torch.from_numpy(self._lo_ord).to(self.device)
        # the block shapes and host dtypes of a chunk
        if self._groups is None:
            self._blocks = [((self.batch_size, f), np.int32)]
        else:  # field-major: a row of offsets a field
            self._blocks = [((len(g), self.batch_size), dt)
                            for g, dt in zip(self._groups[2], _BLOCK_DTYPES)]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured: Dict[str, int] = {}  # the launches one replay runs
        self.replays = 0
        if self.device.type == "cuda":
            self._capture()

    # ---- the fixed forward -----------------------------------------------------

    def _ids(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        """The chunk's blocks on the device -> its (batch_size, F) int32 ids."""
        if self._groups is None:
            return blocks[0]
        b8, b16, b32 = blocks
        ids = torch.cat([b8.to(torch.int32), b16.to(torch.int32) & 0xFFFF, b32], 0)
        ids = (ids + self._lo_cat[:, None]).index_select(0, self._perm)
        return ids.t().contiguous()

    def _forward(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        return self.model(self._ids(blocks)).reshape(-1).float()

    def _capture(self) -> None:
        """The forward as a CUDA graph of static inputs and output, after one
        eager call on a side stream (the warm-up PyTorch asks for)."""
        from map_tpu_torch.train.graph import launch_counts, no_collection

        self._static_in = [torch.zeros(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                                       device=self.device) for shape, dt in self._blocks]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.inference_mode():
            with torch.cuda.stream(side):
                self._forward(self._static_in)
            main.wait_stream(side)
            before = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with no_collection(), torch.cuda.graph(self.graph):
                self._static_out = self._forward(self._static_in)
        after = launch_counts()
        self.captured = {k: after[k] - before[k] for k in after}

    def launches_run(self, counts: Dict[str, int]) -> Dict[str, int]:
        """The launches that ran, from the wrappers' counters `counts` (taken
        from 0 before this Predictor was built): each replay runs the
        launches its capture counted."""
        return {k: v + self.captured.get(k, 0) * (self.replays - 1)
                for k, v in counts.items()}

    # ---- the host side of a chunk ------------------------------------------------

    def _fill(self, chunk: np.ndarray, lo: int, out: List[np.ndarray]) -> None:
        """A chunk's real rows checked and written to the blocks `out`, the
        padding after them at offset 0 (packed) or id 0: the ids as they are,
        or each packed field's offsets from its idx_low as a row of its
        block (field-major: numpy's passes then run over whole rows, and one
        transposing gather brings the fields into the blocks' order)."""
        chunk = np.ascontiguousarray(chunk, dtype=np.int32)
        real = len(chunk)
        if self._groups is None:
            if (chunk.view(np.uint32) >= self.config.input_size).any():  # negatives wrap
                raise ValueError(f"ids of rows {lo}..{lo + real - 1} leave "
                                 f"[0, {self.config.input_size})")
            out[0][:real] = chunk
            out[0][real:] = 0
            return
        off = np.take(chunk.T, self._order, axis=0, mode="clip")  # (F, real)
        np.subtract(off, self._lo_ord[:, None], out=off)
        bad = (off.view(np.uint32) >= self._size_ord[:, None]).any(1)  # below idx_low wraps
        if bad.any():
            f = int(self._order[np.flatnonzero(bad)[0]])
            lo_f, hi_f, _ = self._groups
            raise ValueError(f"ids of rows {lo}..{lo + real - 1} leave field {f}'s "
                             f"block [{lo_f[f]}, {hi_f[f]})")
        start = 0
        for o in out:
            width = o.shape[0]
            np.copyto(o[:, :real], off[start:start + width], casting="unsafe")
            o[:, real:] = 0
            start += width

    def _check_and_pad(self, chunk: np.ndarray, lo: int) -> np.ndarray:
        """The chunk's ids checked and padded to batch_size rows as the
        blocks carry them: each field's idx_low when packing, else id 0 (a
        reference for the tests: the ids the device rebuilds)."""
        self._fill(chunk, lo, self._host_blocks(pinned=False))
        pad = (np.zeros(self.config.num_fields, np.int64) if self._groups is None
               else self._groups[0])
        return np.concatenate([np.asarray(chunk, np.int64), np.broadcast_to(
            pad, (self.batch_size - len(chunk), len(pad)))]).astype(np.int32)

    def _host_blocks(self, pinned: bool) -> List[np.ndarray]:
        if not pinned:
            return [np.empty(shape, dt) for shape, dt in self._blocks]
        return [torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                            pin_memory=True).numpy() for shape, dt in self._blocks]

    # ---- scoring -------------------------------------------------------------------

    def predict_logits(self, feat_ids: np.ndarray) -> np.ndarray:
        """feat_ids (N, F) int -> logits (N,) float32, in padded chunks."""
        feat_ids = np.asarray(feat_ids)
        c = self.config
        if feat_ids.ndim != 2 or feat_ids.shape[1] != c.num_fields:
            raise ValueError(f"feat_ids must be (N, {c.num_fields}), "
                             f"got {feat_ids.shape}")
        out = np.empty(len(feat_ids), np.float32)
        if self.graph is None:
            self._predict_eager(feat_ids, out)
        else:
            self._predict_pipelined(feat_ids, out)
        return out

    def _predict_eager(self, feat_ids: np.ndarray, out: np.ndarray) -> None:
        host = self._host_blocks(pinned=False)
        with torch.inference_mode():
            for lo in range(0, len(feat_ids), self.batch_size):
                chunk = feat_ids[lo:lo + self.batch_size]
                self._fill(chunk, lo, host)
                logits = self._forward([torch.from_numpy(h).to(self.device) for h in host])
                out[lo:lo + len(chunk)] = logits[:len(chunk)].cpu().numpy()

    def _predict_pipelined(self, feat_ids: np.ndarray, out: np.ndarray) -> None:
        """map_tpu's three stages, `prefetch` chunks apart, interleaved on
        this thread: step i checks and packs chunk i into pinned memory and
        copies it to the card on a side stream (the producer), moves chunk
        i - prefetch into the graph's inputs, replays it and copies its
        logits back into pinned memory (the device stage), then waits for
        chunk i - 2 prefetch's logits by their event and writes them out
        (the drainer). The card overlaps the copies with the forwards; no
        slot is written again before its last chunk was drained."""
        n, bs, dev = len(feat_ids), self.batch_size, self.device
        depth = self.prefetch
        slots = 2 * depth + 1
        starts = list(range(0, n, bs))
        host_in = [self._host_blocks(pinned=True) for _ in range(slots)]
        dev_in = [[torch.empty_like(t) for t in self._static_in] for _ in range(slots)]
        host_out = [torch.empty(bs, dtype=torch.float32, pin_memory=True)
                    for _ in range(slots)]
        copied = [torch.cuda.Event() for _ in range(slots)]  # chunk's H2D done
        fetched = [torch.cuda.Event() for _ in range(slots)]  # its logits on the host
        side, compute = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
        try:
            with torch.inference_mode():
                for i in range(len(starts) + 2 * depth):
                    if i < len(starts):  # produce chunk i
                        s, lo = i % slots, starts[i]
                        self._fill(feat_ids[lo:lo + bs], lo, host_in[s])
                        with torch.cuda.stream(side):
                            for d, h in zip(dev_in[s], host_in[s]):
                                d.copy_(torch.from_numpy(h), non_blocking=True)
                            copied[s].record(side)
                    j = i - depth
                    if 0 <= j < len(starts):  # run chunk j
                        s = j % slots
                        compute.wait_event(copied[s])
                        for st, d in zip(self._static_in, dev_in[s]):
                            st.copy_(d)
                        self.graph.replay()
                        self.replays += 1
                        host_out[s].copy_(self._static_out, non_blocking=True)
                        fetched[s].record(compute)
                    j = i - 2 * depth
                    if 0 <= j < len(starts):  # drain chunk j
                        s, lo = j % slots, starts[j]
                        fetched[s].synchronize()
                        out[lo:lo + bs] = host_out[s].numpy()[:min(bs, n - lo)]
        finally:  # no copy may still read a buffer when it is freed
            torch.cuda.synchronize(dev)

    def predict_proba(self, feat_ids: np.ndarray) -> np.ndarray:
        return sigmoid(self.predict_logits(feat_ids)).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="score a split with map_tpu_torch")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--step", type=int, required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=10000)
    p.add_argument("--jax_checkpoint", action="store_true",
                   help="the {step}.model in model_dir is map_tpu's (flax msgpack)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--host_data_budget_mb", type=int, default=0,
                   help="-1 in RAM, 0 auto, > 0 a budget: over it, memmapped splits")
    a = p.parse_args(argv)

    from map_tpu_torch.data.dataset import CTRDataset

    ds = CTRDataset(a.data_dir, a.dataset_name, host_data_budget_mb=a.host_data_budget_mb)
    pred = Predictor(a.model_dir, a.step, batch_size=a.batch_size,
                     device=a.device, source="jax" if a.jax_checkpoint else "torch")
    probs = pred.predict_proba(ds.X[a.split])
    np.save(a.out, probs)
    y = ds.Y[a.split]
    if len(np.unique(y)) == 2:
        from map_tpu_torch.utils.metrics import binary_log_loss, roc_auc

        print(f"scored {len(probs)} rows: auc={roc_auc(y, probs):.6f} "
              f"logloss={binary_log_loss(y, probs):.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
