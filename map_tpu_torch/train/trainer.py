"""Trainer: supervised train -> eval per epoch -> best-step checkpoint ->
test; MFP and RFD pretraining; finetune transfer. Counterpart:
`map_tpu/train/trainer.py` (the noise setup :89-114, the noise rows
:120-124, `load_for_finetune` :671-680, `train` :740-796, `_window_auc`
:799-808, the exact-AUC `eval` :810-923, `MFP_pretrain` /
`MFP_pretrain_eval` :929-987, `RFD_pretrain` / `RFD_pretrain_eval`
:993-1051, `save_model` / `load_model` / `test` :1057-1117).

- train: epochs of `data/loader.Batcher` batches through the train step;
  every `logging_steps` steps the window's losses and probabilities are read
  back once and logged with the window AUC (nan, and training goes on, when
  the window holds one class only); `train_windows` keeps each window's line.
- eval: the exact AUC / log loss of the split on the host (float64), after
  every epoch; a better AUC saves `{step}.model` (keeping the newest
  `save_total_limit`), `patience` evals without one stop the run.
- test: reload the best step and evaluate the test split.
- MFP_pretrain (a model built with `config.mfp`): epochs of MFP steps, the
  window loss and accuracy (sum of hits / sum of counts) every
  `logging_steps`, one masked eval per epoch (`eval_mfp_loss` and
  `eval_mfp_acc`, weighted by each batch's count, drawn from a generator
  seeded anew for every eval, so every eval masks the same way), then the
  model saved at the last step. The noise is map_tpu's: the unigram of
  `config.feat_count` with backoff, log q, norm_term = log V, and the alias
  table, cached in `data_dir` when that is a directory; with
  `--pt_per_field_noise` the per-field tables of each field's id block
  (`alias.build_per_field_alias`, not cached, as in map_tpu).
  `--pt_shared_noise` draws one noise set a step (a set a field with
  per-field noise). With `--sparse_table_update`, a shared mode and no clip
  (`ops/sparse_adamw.engages`, map_tpu `trainer.py:208-218`) the decoder's
  emb is updated from its gradient streams through K7.
- RFD_pretrain (a model built with `config.rfd`): epochs of RFD steps with
  `--RFD_replace`'s generator, the window's `window_rfd_loss`,
  `window_rfd_acc` and `window_pos_ratio` (means over its steps) every
  `logging_steps`, one eval per epoch (`eval_rfd_loss`, `eval_rfd_acc` and
  `eval_pos_ratio`, weighted by each batch's count, from a generator seeded
  anew for every eval), then the model saved at the last step. The Unigram
  generators read M noise rows an example from the train split, drawn by
  the Batcher (map_tpu's stream).
- finetune (`--finetune --pretrained_model_path`): every tensor of the
  checkpoint whose name and shape match the model's is copied in before
  training (`checkpoints.partial_restore`); the checkpoint is the port's
  `{step}.model` or map_tpu's msgpack one, carried through `interop`.

The parallel layer (map_tpu `trainer.py:74-87`, `:125-152`, `:172-205`,
`:252-290`, `:310`, `:486-512`, `:703-721`; `parallel/`): the Trainer lays
the world's ranks out as a (data, model) mesh (`parallel/mesh.build_mesh`;
one rank without a process group is the 1 x 1 mesh and makes no
collective). Under `table_sharding` rows (auto: when the model axis > 1)
each vocabulary table keeps this rank's row block (`parallel/sharding`),
and its lookups go through `table_exchange` ('psum', or 'hotcold' with
`_build_hot_rows`; a typo raises). A rank reads its data block of every
global batch (`_row_shard`); the steps normalise by the global count, sum
their metrics and the dense gradients over the data group and draw the
global batch's noise; FGCNN's BatchNorm takes the global batch's
statistics. A multi-rank eval is the streaming AUC (its histograms summed
over the data group) unless `exact_eval_allgather`, which gathers every
example of each batch (one batch a call); `device_resident_data` auto is
off with more than one rank (`on` still works); the sparse table update is
off. Checkpoints are gathered: every rank takes part, rank 0 writes the
same `{step}.model` and `resume.state` an unsharded run writes, and every
load (finetune, test, resume) cuts the full tensors to this rank's blocks,
moments with their tables. Only rank 0 writes metrics.jsonl (with
`process_count`); the checkpoint writer's join is a barrier. The dispatch
rule: under NCCL the collectives are captured in the graphs of
`steps_per_call` steps; gloo (the CPU, or ranks sharing one card) cannot
be captured, so there the Trainer runs one eager step a call, and its run
header says so.

The model comes built (`models.from_config`), as map_tpu's Trainer takes it;
the dataset is any object with `X[split]` (N, F) int ids and `Y[split]` (N,)
labels for "train", "valid" and "test", so an in-memory dataset serves as
well as `data/dataset.CTRDataset` (whose splits may be read-only memmaps,
the >RAM mode: the resident upload reads their pages, `host_tensor`, and
the host batches gather from them). On a CUDA run the Batcher gathers its
host batches and the MFP alias table is built by the host library
(`data/native.py`); on the CPU by numpy. float32 products on the card run in full
float32 (`torch.backends.cuda.matmul.allow_tf32 = False`).

The input pipeline and the multi-step dispatch (map_tpu `trainer.py:298-370
_setup_resident_data`, `:416-459 _grouped_stream`, `:515-533
_run_train_step`, `:617-632 _ensure_epoch_perm`), for train,
MFP_pretrain and RFD_pretrain:
- `device_resident_data` (auto: on when the train matrix fits
  `device_data_budget_gb`): the train split goes to the device once and
  the Batcher yields index batches; without RFD noise rows (stream v2) each
  epoch's order goes to the device once too and a step ships its batch
  number only, else its indices and noise indices.
- the train stream: `Batcher.epoch_stacked` groups of `steps_per_call`
  batches (then the epoch's tail one by one), copied to the device by a
  producer thread `prefetch_batches` groups ahead, from pinned memory on a
  side stream that the compute stream waits for by event; an error in the
  thread is raised in the loop.
- `steps_per_call` steps a host call (`train/graph.py:MultiStep`): a
  captured CUDA graph on the card, eager steps on the CPU. A call moves
  `global_step` by n, and a logging window closes when a call crosses a
  multiple of `logging_steps` (map_tpu's `_crossed`).
`--device_resident_data=off --steps_per_call=1` is the path of one host
batch a step.

The eval passes (`eval`, its streaming pass, `MFP_pretrain_eval`,
`RFD_pretrain_eval`) go through the eval dispatch (map_tpu
`trainer.py:244-248`, `:464-482`, `train_step.py:114 make_multi_eval`;
`_eval_calls`): with `steps_per_call` K > 1 the eval split's batches go in
groups of K (`Batcher.epoch_stacked`), gathered into pinned memory and
copied by the producer thread, each group one call of a `MultiEval` (a
captured CUDA graph of the K forward passes on the card, its calls one by
one on the CPU), the tail one by one; the MFP and RFD evals' generator is
registered with the graphs, so a grouped pass draws what the eager one
does. `launches_run` turns the kernels' counters into the launches that
ran, over the train graphs and the eval graphs.

Run management (map_tpu `trainer.py:550-731`, `:1057-1092`):
- resume: with `save_steps`, a call that crosses a multiple of it
  (`_crossed`: a call of 8 steps saves at the step it ends on) writes
  `{output_dir}/resume.state` (`checkpoints.save_train_state`): the
  parameters and buffers, the AdamW moments and count (K7's decoder state
  among them: its moments, its handoff's step is the count), the dropout
  and step generators' states and the trainer's meta. `--resume` restores
  it before the first step: the tensors in place, `AdamW.rewind(count)`
  (from which `begin` writes the card's scalar rows), the generators'
  states set before any graph is captured (a capture registers them as
  they stand, so the replays draw what the straight run drew), and
  `_epochs_with_skip` starts at epoch global_step // batches and batch
  global_step % batches (`Batcher.epoch` / `epoch_stacked`'s
  `start_batch`, whose groups from there and `tail_start` are map_tpu's;
  the epoch's order is written to the resident permutation anew).
- the checkpoint writer (`train/async_writer.py`, `async_checkpoint`): the
  model and resume saves are written by a worker thread from host copies
  taken on this thread, or with `async_checkpoint_fetch` from device copies
  taken on the compute stream, fetched by the worker; every checkpoint read
  and the end of a run wait for it (`_join_ckpt_writer`).
- `{output_dir}/metrics.jsonl` (`_emit_metrics`): one strict JSON line a
  logged window or eval, of kind `train_window`, `eval`, `test`,
  `mfp_window`, `mfp_eval`, `rfd_window` or `rfd_eval`, with `step`,
  `time` and map_tpu's keys; a non-finite value is null. No line marks
  where a run starts (map_tpu writes none either; a resumed run appends).
- `--streaming_auc`: the supervised eval reduces each batch on the device
  to two histograms of `auc_bins` buckets and four sums
  (`train_step.streaming_sums`), accumulated there (the histograms in
  float64, the sums fetched once and added in float64); the AUC is
  `auc_from_histograms`, and while its error bound exceeds 5e-5 (up to
  2^20 bins) the bins double and the pass runs again.
- `--profile_steps` N: torch.profiler (CPU, and CUDA on the card) from the
  call that ends at a step in [2, 2 + N) to the first one that reaches
  2 + N (or the run's end), its trace written as
  `{output_dir}/profile/trace_{step}.json`.
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import threading
import time
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from map_tpu_torch import resolve_device
from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.data.dataset import NUM_RESERVED
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.nn.layers import set_dropout_generator
from map_tpu_torch.objectives import alias
from map_tpu_torch.objectives.corruption import mask_num_of
from map_tpu_torch.ops import sparse_adamw
from map_tpu_torch.parallel import context
from map_tpu_torch.parallel.mesh import build_mesh, world_size
from map_tpu_torch.parallel.sharding import (
    gather_tables,
    process_data_blocks,
    shard_tables,
    slice_tables,
)
from map_tpu_torch.train import checkpoints
from map_tpu_torch.train.async_writer import (
    AsyncCheckpointWriter,
    fetch_snapshot,
    host_copy,
    snapshot_tensors,
)
from map_tpu_torch.train.graph import CUDA_WORK, GraphedCalls, MultiEval, MultiStep, launches_run
from map_tpu_torch.train.optimizer import build_optimizer
from map_tpu_torch.train.train_step import (
    MFPDraws,
    NoiseTables,
    ResidentData,
    make_mfp_steps,
    make_rfd_steps,
    make_supervised_steps,
    to_device,
)
from map_tpu_torch.utils.metrics import (
    auc_from_histograms,
    auc_histogram_error_bound,
    binary_log_loss,
    roc_auc,
)
from map_tpu_torch.utils.seeds import stream_generator, stream_seed

logger = logging.getLogger(__name__)

# the streaming AUC's largest error bound, and the most bins it doubles to
STREAMING_AUC_BOUND, STREAMING_BINS_CAP = 5e-5, 1 << 20


def _with_draws(batches, draws):
    """(n, batch, views) with the next n of `draws` (host tensors) as the
    batch's keys (stacked (n, ...) when n > 1; a field that is None left
    out). It runs on the producer thread: host work only, the copy to the
    card is the batch's."""
    for n, batch, views in batches:
        group = [next(draws) for _ in range(n)]
        batch = dict(batch)
        for k in group[0]._fields:
            parts = [getattr(d, k) for d in group]
            if parts[0] is None:
                continue
            batch[k] = torch.stack(parts) if n > 1 else parts[0]
        yield n, batch, views


def host_tensor(a: np.ndarray, dtype) -> torch.Tensor:
    """A CPU tensor over `a`'s memory when it is C-contiguous `dtype` (a
    read-only memmap's too: its pages are read from the page cache, never
    copied into anonymous memory; nothing writes through the tensor)."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.flags.writeable:
        return torch.from_numpy(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a)


class Trainer:
    def __init__(self, model: torch.nn.Module, model_config: Config,
                 training_args: TrainingArguments, dataset, device=None):
        self.device = resolve_device(device if device is not None
                                     else training_args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        # host batches and the alias build by the host library on the card
        # (`data/native.py`; its build raises if it fails), numpy on the CPU
        self._native = self.device.type == "cuda"
        self.model = model.to(self.device)
        self.config = model_config
        self.args = training_args
        self.dataset = dataset
        self.world = world_size()
        self.mesh = build_mesh(training_args.num_data_shards,
                               training_args.num_model_shards)
        mode = training_args.table_sharding
        if mode == "auto":
            mode = "rows" if self.mesh.num_model > 1 else "replicated"
        self._table_mode = mode
        self._shards: Dict[str, Any] = {}  # a table's name -> this rank's Shard
        # gloo cannot be captured: one eager step a call (the run header says so)
        self._eager_collectives = (self.mesh.distributed
                                   and self.mesh.world.backend == "gloo")
        self._spc = (1 if self._eager_collectives
                     else max(1, int(training_args.steps_per_call)))
        # ranks of one model group read the same rows, so draw the same masks
        self._dropout_generator = stream_generator(
            training_args.seed, "dropout", self.mesh.data_index, self.device)
        set_dropout_generator(self.model, self._dropout_generator)

        self.global_step = 0
        self.eval_metrics: List[List[float]] = []
        self.train_windows: List[Dict[str, float]] = []  # each logged window
        self.best_eval_auc = 0.0
        self.best_eval_step = -1
        self._patience = 0
        self._stop_training = False
        self.optimizer = self.schedule = None
        self.train_step = self.eval_step = None
        self.multi: Optional[MultiStep] = None
        self._evals: Dict[str, MultiEval] = {}  # the eval passes' dispatch, by kind
        self._retired: List[GraphedCalls] = []  # dispatches replaced (launch accounting)
        self._eval_generator: Optional[torch.Generator] = None
        self._data: Optional[ResidentData] = None
        self._stream_v2 = False
        self._perm_epoch = -1
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self.noise: Optional[NoiseTables] = None
        self.finetune_counts: Optional[Tuple[int, int]] = None  # (loaded, skipped)
        self._step_generator: Optional[torch.Generator] = None
        self._ckpt_writer = AsyncCheckpointWriter()
        self._async_ckpt = bool(training_args.async_checkpoint)
        self._async_fetch = self._async_ckpt and bool(training_args.async_checkpoint_fetch)
        streaming = bool(training_args.streaming_auc)
        if not streaming and self.world > 1 and not training_args.exact_eval_allgather:
            # map_tpu's multi-host default: no rank gathers every example
            streaming = True
            logger.info("multi-process eval: streaming-histogram AUC enabled by "
                        "default (pass --exact_eval_allgather to override)")
        self._streaming_bins = int(training_args.auc_bins) if streaming else 0
        self._profiler = None
        self.streaming_auc_bound: Optional[float] = None  # the last streaming eval's
        if model_config.mfp:
            self.noise = self._noise_tables()
        if training_args.finetune and training_args.pretrained_model_path:
            self.load_for_finetune(training_args.pretrained_model_path)
        self._setup_mesh()

    # ---- the parallel layer ----------------------------------------------------

    def _setup_mesh(self) -> None:
        """The table blocks and the context the steps read (map_tpu
        `trainer.py:172-205`); called before any step is built."""
        exch = str(self.args.table_exchange)
        if exch not in context.EXCHANGES:
            raise ValueError(f"table_exchange={exch!r} — valid: 'psum', 'hotcold' "
                             "(a typo here must not silently fall back to psum)")
        self._shards = shard_tables(self.model, self.mesh, self._table_mode)
        context.set_mesh(self.mesh)
        context.set_table_exchange("psum")
        if self._shards and exch == "hotcold":
            context.set_table_exchange("hotcold", self._build_hot_rows())
        if self.mesh.distributed:
            for g in (self.mesh.world, self.mesh.data_group, self.mesh.model_group):
                g.all_reduce_(torch.zeros(1, device=self.device))  # warm-up, before capture
        if self._shards:
            logger.info(f"table sharding: rows over mesh {self.mesh.shape}; exchange = "
                        + ("hot-prefix cache + capacity-bounded cold segments"
                           if exch == "hotcold" else "masked gather + all_reduce"))

    def _build_hot_rows(self) -> Dict[int, np.ndarray]:
        """The hotcold exchange's hot ids (map_tpu `trainer.py:252-290` at pack
        factor 1): the first `hot_rows_per_field` ids of every field's block
        (the preprocessing orders a field's ids by falling frequency) and the
        reserved ids (the <mask> id is the hottest of an MFP stream); every
        table has V rows, so one list serves them all."""
        cfg = self.config
        if cfg.idx_low is None:
            return {}
        r = int(self.args.hot_rows_per_field)
        hots = [np.arange(0, NUM_RESERVED)]
        for lo, hi in zip(cfg.idx_low, cfg.idx_high):
            stop = min(int(lo) + r, int(hi))
            if stop > int(lo):
                hots.append(np.arange(int(lo), stop))
        return {int(cfg.input_size): np.unique(np.concatenate(hots)).astype(np.int32)}

    def _row_shard(self) -> Optional[Tuple[int, int, int]]:
        """(start_block, n_blocks, D): this rank's data blocks of a global
        batch (map_tpu `_row_shard`), None with one rank."""
        if self.world == 1:
            return None
        blocks, d = process_data_blocks(self.mesh)
        return blocks[0], len(blocks), d

    def _dp(self):
        """The data group the steps reduce over, None without a process group."""
        return self.mesh.data_group if self.mesh.distributed else None

    def _full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with every table whole (a collective over
        the model group when tables are sharded)."""
        sd = self.model.state_dict()
        return gather_tables(sd, self._shards, self.mesh.model_group) if self._shards else sd

    def _load_full_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(slice_tables(sd, self._shards))
    def _noise_tables(self) -> NoiseTables:
        c = self.config

        def on_dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        if self.args.pt_per_field_noise:
            if c.idx_low is None or c.idx_high is None:
                raise ValueError("per-field noise needs the fields' id ranges "
                                 "(config.idx_low / idx_high)")
            prob, alias_ids, logprob, _ = alias.build_per_field_alias(
                c.feat_count, c.idx_low, c.idx_high, native=self._native)
            low = np.asarray(c.idx_low, np.int32)
            sizes = np.asarray(c.idx_high, np.int32) - low
            return NoiseTables(on_dev(alias.build_fused_alias(prob, alias_ids, logprob)),
                               on_dev(logprob), float(np.log(len(logprob))),
                               idx_low=on_dev(low), field_sizes=on_dev(sizes))
        probs, logprob, norm_term = alias.noise_log_prior(c.feat_count)
        prob, alias_ids = alias.load_or_build_alias(self.args.data_dir, probs,
                                                    native=self._native)
        fused = alias.build_fused_alias(prob, alias_ids, logprob)
        return NoiseTables(on_dev(fused), on_dev(logprob), norm_term,
                           prob=on_dev(prob), alias=on_dev(alias_ids))

    def _noise_rows_per_example(self) -> int:
        if self.config.rfd and self.args.RFD_replace in ("Unigram", "Whole-Unigram"):
            return mask_num_of(self.config.num_fields, self.args.mask_ratio)
        return 0

    def get_batcher(self, split: str, is_training: bool) -> Batcher:
        bs = (self.args.train_batch_size if is_training
              else self.args.eval_batch_size)
        m = self._noise_rows_per_example()
        b = Batcher(self.dataset.X[split], self.dataset.Y[split],
                    batch_size=bs, shuffle=is_training, seed=self.args.seed,
                    noise_source=self.dataset.X["train"] if m else None,
                    noise_rows_per_example=m)
        b.row_shard = self._row_shard()
        b.native = self._native
        return b

    def build_steps(self, num_batches_per_epoch: int) -> None:
        self._t_total = int(num_batches_per_epoch * self.args.num_train_epochs)
        self._t_warmup = int(self._t_total * self.args.warmup_ratio)
        context.set_mesh(self.mesh)
        dp = self._dp()
        sparse = None
        if self.noise is not None:
            handoff = None
            if self.world == 1 and sparse_adamw.engages(
                    self.args.sparse_table_update, self.args.pt_shared_noise,
                    self.args.max_grad_norm):
                handoff = sparse_adamw.StreamHandoff()
                sparse = {"mfp_criterion.emb.weight": handoff}
            self.model.mfp_criterion.handoff = handoff
        self.optimizer, self.schedule = build_optimizer(
            self.model, self.args, self._t_total, self._t_warmup, sparse=sparse,
            grad_group=dp)
        step_generator = None
        if self.noise is not None or self.config.rfd:
            step_generator = stream_generator(self.args.seed, "step", device=self.device)
        self._step_generator = step_generator
        if self.noise is not None:
            self.train_step, self.eval_step = make_mfp_steps(
                self.model, self.optimizer, self.config, self.args.mask_ratio,
                self.args.sampling_method, self.noise, step_generator,
                self.device, shared_noise=self.args.pt_shared_noise, data=self._data,
                dp=dp)
        elif self.config.rfd:
            self.train_step, self.eval_step = make_rfd_steps(
                self.model, self.optimizer, self.config, self.args.mask_ratio,
                self.args.sampling_method, self.args.RFD_replace, step_generator,
                self.device, data=self._data, dp=dp)
        else:
            self.train_step, self.eval_step = make_supervised_steps(
                self.model, self.optimizer, self.device, data=self._data,
                streaming_bins=self._streaming_bins, dp=dp)
        self.multi = MultiStep(self.train_step, self._spc, self.optimizer,
                               self.device, (step_generator, self._dropout_generator))
        self._retire_evals()

    def _log_run_header(self, title: str = "training") -> None:
        logger.info(f"\n***** running {title} *****")
        logger.info(f"  dataset_name = {self.args.dataset_name}")
        logger.info(f"  input_size = {self.config.input_size}")
        logger.info(f"  num_fields = {self.config.num_fields}")
        logger.info(f"  num_examples = {len(self.dataset.Y['train'])}")
        logger.info(f"  num_epochs = {self.args.num_train_epochs}")
        logger.info(f"  batch_size = {self.args.train_batch_size}")
        logger.info(f"  total_steps = {self._t_total}")
        logger.info(f"  warmup_steps = {self._t_warmup}")
        logger.info(f"  learning_rate = {self.args.learning_rate}")
        logger.info(f"  weight_decay = {self.args.weight_decay}")
        logger.info(f"  lr_sched = {self.args.lr_sched}")
        logger.info(f"  device = {self.device}")
        logger.info(f"  mesh = {self.mesh.num_data} x {self.mesh.num_model} (data x model), "
                    f"{self.world} rank(s), backend = {self.mesh.world.backend or 'none'}, "
                    f"table sharding = {self._table_mode}")
        logger.info("  dispatch = " + (
            "one eager step a call (gloo collectives cannot be captured)"
            if self._eager_collectives else
            f"{self._spc} steps a call" + (", collectives captured"
                                           if self.mesh.distributed else "")))
        if (self._shards and str(self.args.table_exchange) == "hotcold"
                and not self._eager_collectives and self._spc > 1):
            logger.info("  table exchange = hotcold captured in the graphs: each lookup "
                        "runs both branches (the full masked gather and the cold segment) "
                        "and selects on the card, more gather and scatter work than psum")

    def _crossed(self, prev: int, every: int) -> bool:
        """A call that moved global_step from prev crossed a multiple of every."""
        return every > 0 and self.global_step // every != prev // every

    def _should_log(self, prev: int) -> bool:
        if self.args.logging_first_step and prev == 0:
            return True
        return self._crossed(prev, self.args.logging_steps)

    def _current_lr(self) -> float:
        return float(self.schedule(max(self.global_step - 1, 0)))

    # ---- the input pipeline and the multi-step dispatch ----------------------

    def _setup_resident_data(self, batcher: Batcher) -> None:
        """The train split on the device (map_tpu `_setup_resident_data`):
        `auto` when the id matrix fits `device_data_budget_gb`, `on` even if
        not (with a warning), `off` never. Stream v2 (the epoch's order on
        the device too) unless the batches carry RFD noise rows."""
        self._data, self._stream_v2, self._perm_epoch = None, False, -1
        mode = self.args.device_resident_data
        if mode == "off" or (mode == "auto" and self.world > 1):
            # map_tpu `trainer.py:310`: each rank would hold the whole matrix
            return
        x = self.dataset.X["train"]
        budget = float(self.args.device_data_budget_gb) * 1e9
        if x.nbytes > budget:
            if mode == "auto":
                logger.info(f"device-resident data: off (train matrix {x.nbytes/1e9:.1f} "
                            f"GB > budget {budget/1e9:.1f} GB)")
                return
            logger.warning(f"device-resident data FORCED on: train matrix "
                           f"{x.nbytes/1e9:.1f} GB exceeds device_data_budget_gb "
                           f"{budget/1e9:.1f} — the upload may OOM the device")
        self._stream_v2 = self._noise_rows_per_example() == 0
        bs = batcher.batch_size
        lo, rows = batcher.block()
        self._data = ResidentData(
            host_tensor(x, np.int32).to(self.device),
            host_tensor(self.dataset.Y["train"], np.float32).to(self.device),
            (torch.zeros(len(batcher) * bs, dtype=torch.int32, device=self.device)
             if self._stream_v2 else None), bs, lo, rows if self.world > 1 else 0)
        logger.info(f"device-resident data: on ({x.nbytes/1e9:.2f} GB train matrix in HBM; "
                    "per-step transfer = "
                    + ("batch number only (resident epoch permutation)"
                       if self._stream_v2 else "indices only)"))

    def _ensure_epoch_perm(self, epoch: int, batcher: Batcher) -> None:
        """Stream v2: the epoch's order, padded with row 0 to whole batches,
        written into the resident permutation in place (the Batcher's order)."""
        if self._perm_epoch == epoch:
            return
        order, _ = batcher.order(epoch)
        padded = np.zeros(self._data.perm.numel(), np.int32)
        padded[:len(order)] = order
        self._data.perm.copy_(torch.from_numpy(padded))
        self._perm_epoch = epoch

    def _put(self, batch, wait: bool = False
             ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
        """The batch's device keys on the device; on the card copied on the
        copy stream, with the event of its copies, which `wait` waits for
        here (so the host arrays may go as soon as the batch is handed on)."""
        if self._copy_stream is None:
            return to_device(batch, self.device), None
        with CUDA_WORK, torch.cuda.stream(self._copy_stream):
            out = to_device(batch, self.device)
            done = torch.cuda.Event()
            done.record()
            if wait:
                done.synchronize()
        return out, done

    def _grouped_stream(self, batches, wait: bool = False
                        ) -> Iterator[Tuple[int, Dict[str, torch.Tensor], list]]:
        """(n, device batch, host batches) of each (n, batch, views) of
        `batches`, copied by a producer thread at most `prefetch_batches`
        groups ahead (`_put`, `wait` as there); the compute stream waits for
        each group's copies. An error in the thread is raised here."""
        q: queue.Queue = queue.Queue(maxsize=max(1, int(self.args.prefetch_batches)))
        stop = threading.Event()

        def producer():
            try:
                for n, payload, views in batches:
                    if stop.is_set():
                        return
                    q.put((n, *self._put(payload, wait), views))
                q.put(None)
            except BaseException as e:  # raised in the consumer
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True, name="map_tpu_torch-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                n, dev_batch, done, views = item
                if done is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(done)
                    for t in dev_batch.values():
                        t.record_stream(compute)
                yield n, dev_batch, views
        finally:
            stop.set()
            while thread.is_alive():  # a producer blocked on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.01)


    # ---- the eval dispatch (map_tpu `_eval_dispatch`, `make_multi_eval`) -----

    def _pinned(self, shape, dtype) -> np.ndarray:
        """An array in pinned memory (the eval batches' `alloc`)."""
        with CUDA_WORK:  # the pinned allocator's calls wait for a capture
            t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                            pin_memory=True)
        return t.numpy()

    def _eval_dispatch_of(self, key: str) -> MultiEval:
        """The dispatch of `key`: an eval kind, and "+draws" when its batches
        carry draws (other inputs, so graphs of their own). The pretraining
        evals' step draws from the eval generator, which their graphs
        register."""
        d = self._evals.get(key)
        if d is None:
            step, gens = self.eval_step, ()
            if key.split("+")[0] in ("mfp", "rfd"):
                gen = self._eval_generator
                step, gens = (lambda b: self.eval_step(b, gen)), (gen,)
            d = self._evals[key] = MultiEval(step, self._eval_spc(key), self.device, gens)
        return d

    def _eval_spc(self, key: str) -> int:
        """Eval batches a call: one for a multi-rank exact eval, whose
        examples are gathered batch by batch (map_tpu `trainer.py:244-246`)."""
        return 1 if key == "eval" and self.world > 1 else self._spc

    def _retire_evals(self) -> None:
        """Drop the eval dispatches (their steps are rebuilt); their launches
        stay counted."""
        self._retired.extend(self._evals.values())
        self._evals = {}

    def graphs(self) -> List[GraphedCalls]:
        """Every dispatch that may have captured graphs: the train steps' and
        each eval pass's (those retired included)."""
        return self._retired + list(self._evals.values()) + ([self.multi] if self.multi
                                                             else [])

    def launches_run(self, counts: Dict[str, int]) -> Dict[str, int]:
        """The launches that ran, from the wrappers' counters `counts` (taken
        from 0 before this Trainer's first step or eval): the train steps'
        and every eval pass's graphs accounted (`graph.launches_run`)."""
        return launches_run(counts, self.graphs())

    def _eval_calls(self, kind: str, batcher: Batcher, draws=None
                    ) -> Iterator[Tuple[int, Dict[str, torch.Tensor], list]]:
        """An eval pass over `batcher`'s epoch 0 (map_tpu `_eval_dispatch`):
        (n, the n batches' metrics stacked (n, ...), their host batches) a
        host call. With `steps_per_call` K > 1 the batches go in groups of K
        (`Batcher.epoch_stacked`, then the tail one by one), each group one
        call of the `kind` dispatch (`MultiEval`: a captured graph on the
        card). The batches are gathered into pinned memory on the card and
        copied from there by the producer thread (`_grouped_stream`).
        `draws`, one for each batch (MFPDraws / RFDDraws), go with their
        batch as its keys (`train_step.handed_in`). The MFP and RFD evals
        draw from the eval generator, seeded anew for every pass (its stream
        of `utils/seeds.py`),
        so every pass masks the same way."""
        if kind in ("mfp", "rfd"):
            if self._eval_generator is None:
                self._eval_generator = torch.Generator(device=self.device)
            self._eval_generator.manual_seed(stream_seed(self.args.seed, "eval"))
        if self._copy_stream is not None:
            batcher.alloc = self._pinned
        spc = self._eval_spc(kind)
        batches = (batcher.epoch_stacked(spc, 0) if spc > 1
                   else ((1, b, [b]) for b in batcher.epoch(0)))
        if draws is not None:  # on the host here, before any capture of this pass
            draws = [type(d)(*(None if t is None else torch.as_tensor(t).cpu() for t in d))
                     for d in draws]
            batches = _with_draws(batches, iter(draws))
        dispatch = self._eval_dispatch_of(kind if draws is None else kind + "+draws")
        for n, dev_batch, views in self._grouped_stream(batches, wait=True):
            yield n, dispatch(n, dev_batch), views

    def _run_train_step(self, n: int, dev_batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        metrics = self.multi(n, dev_batch)
        prev = self.global_step
        self.global_step += n
        self._post_step(prev)
        return metrics

    def train_epoch(self, batcher: Batcher, epoch: int, start_batch: int = 0
                    ) -> Iterator[Tuple[int, Dict[str, torch.Tensor], list]]:
        """One epoch of train steps through the pipeline, from batch
        `start_batch` on, a host call at a time: (n, the n steps' metrics
        stacked (n, ...), their host batches)."""
        batcher.emit_indices = self._data is not None
        batcher.emit_start_only = self._data is not None and self._stream_v2
        if batcher.emit_start_only:
            self._ensure_epoch_perm(epoch, batcher)
        spc = self._spc
        batches = (batcher.epoch_stacked(spc, epoch, start_batch) if spc > 1
                   else ((1, b, [b]) for b in batcher.epoch(epoch, start_batch)))
        for n, dev_batch, views in self._grouped_stream(batches):
            yield n, self._run_train_step(n, dev_batch), views

    def _epochs_with_skip(self, batcher: Batcher) -> Iterator[Tuple[int, int]]:
        """(epoch, start_batch) of each epoch still to run: after a resume,
        from the batch global_step gives (map_tpu `_epochs_with_skip`)."""
        per_epoch = len(batcher)
        start_epoch, skip = divmod(self.global_step, per_epoch)
        for epoch in range(start_epoch, self.args.num_train_epochs):
            yield epoch, skip if epoch == start_epoch else 0

    def _prepare_training(self) -> Batcher:
        batcher = self.get_batcher("train", True)
        self._setup_resident_data(batcher)
        self.build_steps(len(batcher))
        self._maybe_resume()
        return batcher

    def _end_run(self) -> None:
        """A run's end: the profiler stopped, the checkpoints on disk."""
        self._stop_profiler()
        self._join_ckpt_writer()

    def train(self) -> None:
        batcher = self._prepare_training()
        self._log_run_header()
        self._stop_training = False
        losses: List[torch.Tensor] = []
        probs: List[torch.Tensor] = []
        labels: List[np.ndarray] = []
        weights: List[np.ndarray] = []
        window_t0 = time.time()
        for epoch, start_batch in self._epochs_with_skip(batcher):
            logger.info(f"-------------------- epoch-{epoch} --------------------")
            for n, metrics, group in self.train_epoch(batcher, epoch, start_batch):
                prev = self.global_step - n
                losses.append(metrics["loss"])
                probs.append(metrics["probs"])
                labels.extend(b["labels"] for b in group)
                weights.extend(b["weight"] for b in group)
                if self._should_log(prev):
                    loss_w = torch.cat(losses).cpu().numpy().astype(np.float64)
                    probs_w = torch.cat(probs).reshape(-1).cpu().numpy().astype(np.float64)
                    w = np.concatenate(weights) > 0
                    dt = time.time() - window_t0
                    _log = {"window_auc": self._window_auc(
                                np.concatenate(labels)[w], probs_w[w]),
                            "window_loss": float(loss_w.mean()),
                            "examples_per_sec": round(w.sum() / max(dt, 1e-9)),
                            "time_cost": round(dt, 3)}
                    tag = (f" [shard-local metrics, 1 of {self.world} processes]"
                           if self.world > 1 else "")
                    logger.info(f"step = {self.global_step}, {_log}{tag}")
                    self.train_windows.append({"step": self.global_step, **_log})
                    self._emit_metrics("train_window", _log)
                    losses, probs, labels, weights = [], [], [], []
                    window_t0 = time.time()
            self.eval()
            if self._stop_training:
                break
        self._end_run()
        logger.info(self._metrics_table("auc", "log_loss"))

    def _metrics_table(self, *columns: str) -> str:
        """The final eval table, as map_tpu prints its pandas DataFrame."""
        rows = [f"{'':>4} " + " ".join(f"{c:>10}" for c in columns)]
        rows += [f"{i:>4} " + " ".join(f"{x:>10.6f}" for x in metrics)
                 for i, metrics in enumerate(self.eval_metrics)]
        return "\n".join(rows)

    def MFP_pretrain(self) -> None:
        batcher = self._prepare_training()
        self._log_run_header("pretraining")
        logger.info(f"  mask_ratio = {self.args.mask_ratio}")
        logger.info(f"  pt_neg_num = {self.config.pt_neg_num}")
        logger.info(f"  pt_type = {self.config.pt_type}")
        logger.info(f"  noise = {'per-field' if self.args.pt_per_field_noise else 'global'}"
                    f"{', shared' if self.args.pt_shared_noise else ''}, "
                    f"loss = {self.config.nce_loss_type}, sparse table update = "
                    f"{self.model.mfp_criterion.handoff is not None}")
        window: Dict[str, List[torch.Tensor]] = {"loss": [], "count": [], "acc_count": []}
        window_t0 = time.time()
        for epoch, start_batch in self._epochs_with_skip(batcher):
            logger.info(f"-------------------- epoch-{epoch} --------------------")
            for n, metrics, _ in self.train_epoch(batcher, epoch, start_batch):
                prev = self.global_step - n
                for key, values in window.items():
                    values.append(metrics[key])
                if self._should_log(prev):
                    host = {k: torch.cat(v).cpu().numpy().astype(np.float64)
                            for k, v in window.items()}
                    dt = time.time() - window_t0
                    _log = {"window_loss": float(host["loss"].mean()),
                            "window_acc": float(host["acc_count"].sum()
                                                / host["count"].sum()),
                            "time_cost": round(dt, 3)}
                    logger.info(f"step = {self.global_step}, {_log}")
                    self.train_windows.append({"step": self.global_step, **_log})
                    self._emit_metrics("mfp_window", _log)
                    window = {k: [] for k in window}
                    window_t0 = time.time()
            self.MFP_pretrain_eval()
        self.save_model(self.args.output_dir)
        self._end_run()
        logger.info(self._metrics_table("mfp_loss", "mfp_acc"))

    def MFP_pretrain_eval(self, draws: Optional[List[MFPDraws]] = None) -> Dict[str, float]:
        """The masked eval of the valid split; `draws`, one for each batch,
        in place of the eval generator's (the tests hand in map_tpu's)."""
        if self.eval_step is None:
            self.build_steps(len(self.get_batcher("train", True)))
        batcher = self.get_batcher("valid", False)
        logger.info("***** running eval *****")
        logger.info(f"  num examples = {batcher.num_examples()}")
        t0 = time.time()
        metrics = [m for _, m, _ in self._eval_calls("mfp", batcher, draws)]
        host = {k: torch.cat([m[k] for m in metrics]).cpu().numpy().astype(np.float64)
                for k in ("loss", "count", "acc_count")}
        count = host["count"].sum()
        _log = {"learning_rate": self._current_lr(),
                "eval_mfp_loss": float((host["loss"] * host["count"]).sum() / count),
                "eval_mfp_acc": float(host["acc_count"].sum() / count),
                "eval_time_cost": time.time() - t0}
        self.eval_metrics.append([_log["eval_mfp_loss"], _log["eval_mfp_acc"]])
        logger.info(str(_log))
        self._emit_metrics("mfp_eval", _log)
        return _log

    def RFD_pretrain(self) -> None:
        batcher = self._prepare_training()
        self._log_run_header("pretraining")
        logger.info(f"  pt_type = {self.config.pt_type}")
        logger.info(f"  mask_ratio = {self.args.mask_ratio}")
        logger.info(f"  RFD_replace = {self.args.RFD_replace}")
        logger.info(f"  hybrid lookup = {self.model.embed.field_bounds is not None}, "
                    f"mode = {self.config.hybrid_mode or 'default'}")
        keys = ("loss", "acc", "pos_ratio")
        window: Dict[str, List[torch.Tensor]] = {k: [] for k in keys}
        window_t0 = time.time()
        for epoch, start_batch in self._epochs_with_skip(batcher):
            logger.info(f"-------------------- epoch-{epoch} --------------------")
            for n, metrics, _ in self.train_epoch(batcher, epoch, start_batch):
                prev = self.global_step - n
                for key in keys:
                    window[key].append(metrics[key])
                if self._should_log(prev):
                    host = {k: torch.cat(v).cpu().numpy().astype(np.float64)
                            for k, v in window.items()}
                    _log = {"window_rfd_loss": float(host["loss"].mean()),
                            "window_rfd_acc": float(host["acc"].mean()),
                            "window_pos_ratio": float(host["pos_ratio"].mean()),
                            "time_cost": round(time.time() - window_t0, 3)}
                    logger.info(f"step = {self.global_step}, {_log}")
                    self.train_windows.append({"step": self.global_step, **_log})
                    self._emit_metrics("rfd_window", _log)
                    window = {k: [] for k in keys}
                    window_t0 = time.time()
            self.RFD_pretrain_eval()
        self.save_model(self.args.output_dir)
        self._end_run()
        logger.info(self._metrics_table("rfd_loss", "rfd_acc"))

    def RFD_pretrain_eval(self, draws: Optional[list] = None) -> Dict[str, float]:
        """The eval's loss and accuracy (and, in the log line and the
        result, its pos_ratio, which map_tpu's record does not carry);
        `draws` as `MFP_pretrain_eval`'s (RFDDraws)."""
        if self.eval_step is None:
            self.build_steps(len(self.get_batcher("train", True)))
        batcher = self.get_batcher("valid", False)
        logger.info("***** running eval *****")
        logger.info(f"  num examples = {batcher.num_examples()}")
        t0 = time.time()
        metrics = [m for _, m, _ in self._eval_calls("rfd", batcher, draws)]
        host = {k: torch.cat([m[k] for m in metrics]).cpu().numpy().astype(np.float64)
                for k in ("loss", "count", "acc", "pos_ratio")}
        count = host["count"].sum()
        _log = {"learning_rate": self._current_lr(),
                **{f"eval_{name}": float((host[k] * host["count"]).sum() / count)
                   for name, k in (("rfd_loss", "loss"), ("rfd_acc", "acc"),
                                   ("pos_ratio", "pos_ratio"))},
                "eval_time_cost": time.time() - t0}
        self.eval_metrics.append([_log["eval_rfd_loss"], _log["eval_rfd_acc"]])
        logger.info(str(_log))
        self._emit_metrics("rfd_eval", {k: v for k, v in _log.items()
                                        if k != "eval_pos_ratio"})
        return _log

    def load_for_finetune(self, model_path: str) -> None:
        """Copy in every tensor of the checkpoint at `model_path` whose name
        and shape match (map_tpu's `load_for_finetune`)."""
        self._join_ckpt_writer()
        merged, loaded, skipped = checkpoints.partial_restore(
            self._full_state_dict(), checkpoints.load_any_model_file(model_path,
                                                                     self.config))
        self._load_full_state_dict(merged)
        self.finetune_counts = (loaded, skipped)
        logger.info(f"finetune restore: {loaded} tensors loaded, {skipped} skipped")

    @staticmethod
    def _window_auc(labels: np.ndarray, probs: np.ndarray) -> float:
        """A single-class window gives nan, and training goes on; eval()
        keeps the strict contract, since it selects the model."""
        try:
            return roc_auc(labels, probs)
        except ValueError:
            return float("nan")

    def eval(self, split: str = "valid", test_eval: bool = False) -> Dict[str, float]:
        if self.eval_step is None:  # test() before train()
            self.build_steps(len(self.get_batcher("train", True)))
        batcher = self.get_batcher(split, False)
        logger.info("\n***** running TEST *****" if test_eval
                    else "\n***** running eval *****")
        logger.info(f"  num examples = {batcher.num_examples()}")
        logger.info(f"  batch size = {batcher.batch_size}")
        if self._streaming_bins:
            auc, ll, avg_logits, avg_probs = self._streaming_eval(batcher)
        else:
            logits, probs, labels, weights = [], [], [], []
            for _, m, views in self._eval_calls("eval", batcher):
                logits.append(m["logits"].reshape(-1))
                probs.append(m["probs"].reshape(-1))
                labels.extend(v["labels"] for v in views)
                weights.extend(v["weight"] for v in views)
                if self.world > 1:  # the global batch's rows, in block order
                    logits[-1], probs[-1], labels[-1], weights[-1] = (
                        self.mesh.data_group.all_gather(torch.as_tensor(r, device=self.device))
                        .reshape(-1) for r in (logits[-1], probs[-1], labels[-1], weights[-1]))
            if self.world > 1:
                labels = [t.cpu().numpy() for t in labels]
                weights = [t.cpu().numpy() for t in weights]
            w = np.concatenate(weights) > 0
            logits_h = torch.cat(logits).cpu().numpy().astype(np.float64)[w]
            probs_h = torch.cat(probs).cpu().numpy().astype(np.float64)[w]
            labels_h = np.concatenate(labels)[w]
            auc = roc_auc(labels_h, probs_h)
            ll = binary_log_loss(labels_h, probs_h)
            avg_logits, avg_probs = float(logits_h.mean()), float(probs_h.mean())
        self.eval_metrics.append([auc, ll])
        _log = {"learning_rate": self._current_lr(), "eval_auc": auc,
                "eval_loss": ll, "avg_logits": avg_logits, "avg_probs": avg_probs}
        logger.info(str(_log))
        self._emit_metrics("test" if test_eval else "eval", _log)
        if not test_eval:
            if auc > self.best_eval_auc:
                self.best_eval_auc = auc
                self.best_eval_step = self.global_step
                self._patience = 0
                self.save_model(self.args.output_dir)
            else:
                self._patience += 1
            if self._patience > self.args.patience:
                self._stop_training = True
        return _log

    def _streaming_eval(self, batcher: Batcher) -> Tuple[float, float, float, float]:
        """The streaming pass (map_tpu `trainer.py:342-382`) -> (AUC, log
        loss, mean logit, mean probability); bins doubled and the pass run
        again while the AUC's error bound exceeds STREAMING_AUC_BOUND."""
        while True:
            nb = self._streaming_bins
            hist_pos = torch.zeros(nb, dtype=torch.float64, device=self.device)
            hist_neg = torch.zeros_like(hist_pos)
            sums = []
            for _, m, _ in self._eval_calls("streaming", batcher):
                # whole counts in float32: their float64 sum is exact in any order
                hist_pos += m["hist_pos"].sum(0, dtype=torch.float64)
                hist_neg += m["hist_neg"].sum(0, dtype=torch.float64)
                sums.append(torch.stack([m[k] for k in ("ll_sum", "logit_sum",
                                                        "prob_sum", "count")], 1))
            hp, hn = hist_pos.cpu().numpy(), hist_neg.cpu().numpy()
            ll_sum, logit_sum, prob_sum, count = (
                torch.cat(sums).cpu().numpy().astype(np.float64).sum(axis=0))
            auc = auc_from_histograms(hp, hn)
            bound = auc_histogram_error_bound(hp, hn)
            if bound > STREAMING_AUC_BOUND and nb < STREAMING_BINS_CAP:
                logger.warning(
                    f"streaming AUC certified error bound {bound:.2e} exceeds "
                    f"{STREAMING_AUC_BOUND:.0e}; escalating auc_bins {nb} -> {nb * 2} "
                    f"and re-running the eval pass")
                self._rebuild_streaming_eval(nb * 2)
                continue
            if bound > STREAMING_AUC_BOUND:
                logger.warning(
                    f"streaming AUC certified error bound {bound:.2e} still exceeds "
                    f"{STREAMING_AUC_BOUND:.0e} at the {nb}-bin cap — disable "
                    f"--streaming_auc for model selection")
            else:
                logger.info(f"streaming AUC certified error bound {bound:.2e}")
            self.streaming_auc_bound = bound
            return auc, ll_sum / count, logit_sum / count, prob_sum / count

    def _rebuild_streaming_eval(self, new_bins: int) -> None:
        """The supervised eval step at `new_bins` bins; the train step and
        its graphs stay."""
        self._streaming_bins = int(new_bins)
        _, self.eval_step = make_supervised_steps(
            self.model, self.optimizer, self.device, data=self._data,
            streaming_bins=self._streaming_bins, dp=self._dp())
        self._retire_evals()

    # ---- run management --------------------------------------------------------

    def _post_step(self, prev: int) -> None:
        self._maybe_save_resume(prev)
        self._profile_hook()

    def _profile_hook(self) -> None:
        """torch.profiler over the calls ending at steps [2, 2 + profile_steps)
        (map_tpu's `_profile_hook`, which runs jax.profiler)."""
        ps = int(self.args.profile_steps or 0)
        if not ps:
            return
        if self._profiler is None and 2 <= self.global_step < 2 + ps:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif self._profiler is not None and self.global_step >= 2 + ps:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = os.path.join(self.args.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"trace_{self.global_step}.json"))

    def _train_state(self) -> Dict[str, Any]:
        """The live tensors and host state a resume restores, every table
        (and its moments) whole."""
        gens = {"dropout": self._dropout_generator.get_state(),
                "step": (None if self._step_generator is None
                         else self._step_generator.get_state())}
        opt = self.optimizer
        moments = [gather_tables(dict(zip(opt.names, seq)), self._shards,
                                 self.mesh.model_group) for seq in (opt.mu, opt.nu)]
        return {"model": self._full_state_dict(),
                "optimizer": {"names": list(opt.names), "count": opt.count,
                              "mu": [moments[0][n] for n in opt.names],
                              "nu": [moments[1][n] for n in opt.names]},
                "generators": gens}

    @torch.no_grad()
    def _restore_train_state(self, state: Dict[str, Any]) -> None:
        self._load_full_state_dict(state["model"])
        opt = state["optimizer"]
        names = list(self.optimizer.names)
        if list(opt["names"]) != names:
            raise ValueError("resume state: the optimizer's parameters differ from the model's")
        for lives, saved in ((self.optimizer.mu, opt["mu"]), (self.optimizer.nu, opt["nu"])):
            cut = slice_tables(dict(zip(names, saved)), self._shards)
            for live, name in zip(lives, names):
                live.copy_(cut[name])
        self.optimizer.rewind(int(opt["count"]))
        gens = state["generators"]
        self._dropout_generator.set_state(gens["dropout"])
        if self._step_generator is not None:
            self._step_generator.set_state(gens["step"])

    def _maybe_resume(self) -> None:
        """Restore `{output_dir}/resume.state` under `--resume`, before any
        step (so before any graph is captured)."""
        if not self.args.resume:
            return
        self._join_ckpt_writer()  # a write in flight lands first
        if not checkpoints.has_resume_state(self.args.output_dir):
            return
        state, meta = checkpoints.load_train_state(self.args.output_dir)
        self._restore_train_state(state)
        self.global_step = int(meta["global_step"])
        self.best_eval_auc = float(meta["best_eval_auc"])
        self.best_eval_step = int(meta["best_eval_step"])
        self._patience = int(meta["patience"])
        self.eval_metrics = [list(m) for m in meta.get("eval_metrics", [])]
        logger.info(f"resumed from step {self.global_step} "
                    f"(best_eval_auc={self.best_eval_auc:.6f})")

    def _maybe_save_resume(self, prev: int) -> None:
        if not self._crossed(prev, self.args.save_steps):
            return
        meta = {"global_step": self.global_step, "best_eval_auc": self.best_eval_auc,
                "best_eval_step": self.best_eval_step, "patience": self._patience,
                "eval_metrics": [list(m) for m in self.eval_metrics]}
        out = self.args.output_dir
        state = self._train_state()  # every rank takes part; rank 0 writes
        if self.mesh.rank == 0:
            self._write(state, lambda host: checkpoints.save_train_state(out, host, meta),
                        f"resume-{self.global_step}")

    def _write(self, tensors: Any, save, label: str) -> None:
        """save(host copy of `tensors`): on this thread, or by the writer
        from host copies taken here, or (fetch) from device copies."""
        if self._async_fetch:
            snap, done = snapshot_tensors(tensors)
            self._ckpt_writer.submit(lambda: save(fetch_snapshot(snap, done)), label=label)
        elif self._async_ckpt:
            host = host_copy(tensors)
            self._ckpt_writer.submit(lambda: save(host), label=label)
        else:
            save(host_copy(tensors))

    def _join_ckpt_writer(self) -> None:
        """The writer's saves on disk; with several ranks a barrier, so no
        rank reads a checkpoint rank 0 is still writing."""
        self._ckpt_writer.wait()
        if self.world > 1:
            self.mesh.world.barrier()

    def _emit_metrics(self, kind: str, payload: Dict[str, Any]) -> None:
        """One line of `{output_dir}/metrics.jsonl`: kind, step, time and the
        payload, numpy numbers as Python ones, a non-finite float as null."""
        if self.mesh.rank != 0:
            return
        rec: Dict[str, Any] = {"kind": kind, "step": self.global_step,
                               "time": round(time.time(), 3)}
        if self.world > 1:
            rec["process_count"] = self.world
        for k, v in payload.items():
            if isinstance(v, (np.floating, np.integer)):
                v = v.item()
            if isinstance(v, float) and not math.isfinite(v):
                v = None
            rec[k] = v
        os.makedirs(self.args.output_dir, exist_ok=True)
        with open(os.path.join(self.args.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec, allow_nan=False) + "\n")

    # ---- checkpoints ---------------------------------------------------------

    def save_model(self, model_dir: str) -> str:
        step = self.global_step
        limit = self.args.save_total_limit

        def save(state_dict):
            checkpoints.save_model(state_dict, model_dir, step)
            if limit:
                checkpoints.prune_checkpoints(model_dir, limit)

        state = self._full_state_dict()  # every rank takes part; rank 0 writes
        if self.mesh.rank == 0:
            self._write(state, save, f"model-{step}")
        return checkpoints.model_checkpoint_path(model_dir, step)

    def load_model(self, load_step: int, model_dir: str) -> None:
        self._join_ckpt_writer()  # the step being read may still be in flight
        self._load_full_state_dict(checkpoints.load_model(model_dir, load_step))

    def test(self, load_step: int = -1, model_dir: Optional[str] = None
             ) -> Dict[str, float]:
        if load_step == -1:
            load_step = self.best_eval_step
        self.load_model(load_step, model_dir or self.args.output_dir)
        return self.eval("test", test_eval=True)
