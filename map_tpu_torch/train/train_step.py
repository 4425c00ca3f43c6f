"""Supervised, MFP and RFD train and eval steps. Counterpart:
`map_tpu/train/train_step.py:207-263 make_supervised_steps` (the exact and
the streaming eval step), `:270-531 make_mfp_steps` and `:538-585
make_rfd_steps`.

A step takes one batch from `data/loader.Batcher`: a host batch (numpy
arrays, copied to the device from pinned memory without blocking the host,
or tensors already there), or an index batch (`index` or `start`,
`real_count`, `noise_index`) that `resident_batch` rebuilds on the device
from the resident train data (`ResidentData`, map_tpu's `_resident_batch`):
the rows, labels and noise rows gathered there, the weight rebuilt from
`real_count`. It returns device tensors: nothing is read back, so the host
runs ahead of the card until a logging window or an eval pass reads the
values. Nothing in a train step waits for the host or copies from it, so
`train/graph.py` can capture it whole into a CUDA graph.

supervised train step: forward in train mode, the weighted BCE
(`objectives`), backward (K3 for the table, the cross-net chain from K2's
residuals), then one `AdamW.step` (K1 for every parameter); returns
{loss, probs}. eval step: forward in eval mode under
`torch.inference_mode`; returns {loss, logits, probs}, or with
`streaming_bins` nb > 0 (`--streaming_auc`, map_tpu `:240-261`) the
batch reduced on the device: `hist_pos` / `hist_neg` (nb,) float32, the
weight x label and weight x (1 - label) of each row added into bucket
clip(int(p nb), 0, nb - 1), and `ll_sum` (of softplus(x) - y x, the exact
BCE from the logit), `logit_sum`, `prob_sum` and `count`, all weighted, so
the padding rows (weight 0) drop out. map_tpu adds with `.at[].add`, not
Pallas: plain PyTorch here too.

Train mode is map_tpu's `train=True` in every step (supervised, MFP, RFD):
FGCNN's BatchNorm normalises by the batch and moves its running
statistics in place (map_tpu threads `batch_stats` through the step,
`train_step.py:149-199`); eval steps read the running statistics. The
batch is the padded one, so the statistics count the weight-0 padding
rows of an epoch's last batch, as map_tpu's do (flax's BatchNorm takes no
mask); the reference emits a short last batch instead. The port keeps
map_tpu's departure.

MFP train step: masked positions and noise drawn on the device from the
step's generator (or handed in as `draws`), the corruption, the scores
through the MFP head, the per-position loss weighted by the example weights
over max(sum w, 1) * mask_num, backward and one `AdamW.step`; returns
{loss, count = sum w * mask_num, acc_count}. The eval step does the same
forward under `torch.inference_mode` with the generator it is given, or
with draws handed in (its `draws` argument, or the batch's keys of the
same names, `handed_in`: how a grouped pass gives each batch its own). The
modes, as map_tpu's:
- per-position noise (`:305-321`): k ids a masked position, scored with the
  target as (B, M, 1 + k) candidates (K4 forward, fold + K5 backward);
- global shared noise (`--pt_shared_noise`, `:369-407`): one (k,) set a
  step, drawn with `alias_draw` on the global alias table;
- per-field noise (`--pt_per_field_noise`, `:311-313`): each position's k
  ids from its masked field's block;
- per-field shared (both flags, `:409-449`): one (F, k) set a step, a set
  for every field;
- the `full` loss (`:343-365`): exact cross-entropy over the vocabulary,
  no noise.
The norm_term is log V, a scalar, without per-field noise, and log(size of
the masked field) with it (`:325-332`). In the shared modes the decoder's
emb gradient goes to K7 when the Trainer engages the sparse table update.

RFD train step: masked positions and the generator's draws on the device
from the step's generator (or handed in as `draws`), `rfd_corrupt` with the
batch's noise rows, the (B, F) field logits of the RFD head, the per-field
BCE weighted by the example weights over max(sum w, 1) * F, backward and one
`AdamW.step`; returns {loss, count = max(sum w, 1) * F, acc (sigmoid > 0.5
against the labels, on the same weights and denominator), pos_ratio (the
replaced share)}. The eval step does the same forward under
`torch.inference_mode` with the generator it is given, or with draws
handed in as the MFP eval step takes them.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from map_tpu_torch.config import Config
from map_tpu_torch.objectives import alias, corruption
from map_tpu_torch.objectives.nce import (
    full_ce_loss,
    mfp_accuracy_count,
    nce_loss,
    sampled_softmax_loss,
)
from map_tpu_torch.objectives.supervised import bce_loss, bce_with_logits
from map_tpu_torch.train.optimizer import AdamW

Batch = Dict[str, np.ndarray]
Step = Callable[[Batch], Dict[str, torch.Tensor]]

# an index batch's keys that go to the device; its labels and weight stay on
# the host (the window AUC reads them), the step regathers them
INDEX_KEYS = ("index", "start", "real_count", "noise_index")


class ResidentData(NamedTuple):
    """The train split on the device (map_tpu `trainer.py:298-370`): x (N,
    F) int32, y (N,) float32, and with stream v2 `perm`, the epoch's order
    padded to whole batches (int32), which the Trainer rewrites in place
    once an epoch, so that a captured step reads each epoch's."""

    x: torch.Tensor
    y: torch.Tensor
    perm: Optional[torch.Tensor]
    batch_size: int


def is_index_batch(batch) -> bool:
    return "index" in batch or "start" in batch


def to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's device keys on `device` (an index batch's INDEX_KEYS, else
    all): numpy arrays through pinned memory, copied without blocking the
    host on the card; tensors moved (nothing to do where they lie there)."""
    out = {}
    for k, v in batch.items():
        if is_index_batch(batch) and k not in INDEX_KEYS:
            continue
        if not isinstance(v, torch.Tensor):
            a = np.asarray(v)
            v = torch.from_numpy(a if a.flags.c_contiguous else np.ascontiguousarray(a))
        if device.type == "cuda" and v.device.type == "cpu":
            v = v.pin_memory().to(device, non_blocking=True)
        out[k] = v.to(device)
    return out


def resident_batch(batch: Dict[str, torch.Tensor], data: ResidentData
                   ) -> Dict[str, torch.Tensor]:
    """An index batch on the device -> the step batch: input_ids = x[index],
    labels = y[index], weight = (arange(B) < real_count), noise_rows =
    x[noise_index]; with `start`, index is row `start` of perm viewed as
    (batches, B), taken on the device (no host read, so it captures)."""
    if "start" in batch:
        idx = data.perm.view(-1, data.batch_size).index_select(
            0, batch["start"].reshape(1)).reshape(-1)
    else:
        idx = batch["index"]
    out = {"input_ids": data.x.index_select(0, idx),
           "labels": data.y.index_select(0, idx),
           "weight": (torch.arange(idx.shape[0], device=idx.device)
                      < batch["real_count"]).float()}
    if "noise_index" in batch:
        out["noise_rows"] = data.x.index_select(0, batch["noise_index"])
    return out


def device_batch(batch, device: torch.device, data: Optional[ResidentData] = None
                 ) -> Dict[str, torch.Tensor]:
    """A host or index batch -> the step batch on `device`."""
    b = to_device(batch, device)
    if not is_index_batch(b):
        return b
    if data is None:
        raise ValueError("an index batch needs the train data on the device")
    return resident_batch(b, data)


def streaming_sums(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor,
                   bins: int) -> Dict[str, torch.Tensor]:
    """A batch's streaming eval reduction (float32 logits, labels, weight)."""
    probs = torch.sigmoid(logits)
    bucket = torch.clamp((probs * bins).to(torch.int32), 0, bins - 1).long()
    hist_pos = torch.zeros(bins, dtype=torch.float32, device=logits.device)
    hist_neg = torch.zeros_like(hist_pos)
    hist_pos.index_add_(0, bucket, weight * labels)
    hist_neg.index_add_(0, bucket, weight * (1.0 - labels))
    per_ll = torch.logaddexp(torch.zeros_like(logits), logits) - labels * logits
    return {"hist_pos": hist_pos, "hist_neg": hist_neg,
            "ll_sum": torch.sum(weight * per_ll), "logit_sum": torch.sum(weight * logits),
            "prob_sum": torch.sum(weight * probs), "count": torch.sum(weight)}


def make_supervised_steps(model: torch.nn.Module, optimizer: AdamW,
                          device: torch.device, data: Optional[ResidentData] = None,
                          streaming_bins: int = 0) -> Tuple[Step, Step]:
    def train_step(batch: Batch) -> Dict[str, torch.Tensor]:
        b = device_batch(batch, device, data)
        model.train()
        logits = model(b["input_ids"]).reshape(-1)
        loss = bce_loss(logits, b["labels"], b["weight"])
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "probs": torch.sigmoid(logits.detach().float())}

    @torch.inference_mode()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        b = to_device(batch, device)
        model.eval()
        logits = model(b["input_ids"]).reshape(-1).float()
        loss = bce_loss(logits, b["labels"], b["weight"])
        if streaming_bins:
            return {"loss": loss, **streaming_sums(logits, b["labels"], b["weight"],
                                                   int(streaming_bins))}
        return {"loss": loss, "logits": logits, "probs": torch.sigmoid(logits)}

    return train_step, eval_step


class MFPDraws(NamedTuple):
    """One step's random draws: masked positions (B, M), noise ids int32
    and their log-probabilities float32, both (B, M, k) with per-position
    noise, (k,) with global shared noise, (F, k) with per-field shared
    noise, None under the `full` loss."""

    masked_index: torch.Tensor
    noise: Optional[torch.Tensor] = None
    noise_logq: Optional[torch.Tensor] = None


class NoiseTables(NamedTuple):
    """The noise distribution on the device: the fused (V, 4) alias table
    (`objectives/alias.build_fused_alias`, of the per-field tables in
    per-field mode), log q (V,) float32 (per field in per-field mode) and
    norm_term = log V. The global shared mode draws from `prob` and `alias`
    (V,); per-field mode keeps each field's first id and size, (F,) int32."""

    fused: torch.Tensor
    logprob: torch.Tensor
    norm_term: float
    prob: Optional[torch.Tensor] = None
    alias: Optional[torch.Tensor] = None
    idx_low: Optional[torch.Tensor] = None
    field_sizes: Optional[torch.Tensor] = None

    @property
    def per_field(self) -> bool:
        return self.idx_low is not None


def draw_mfp(generator: torch.Generator, tables: NoiseTables, batch_size: int,
             num_fields: int, mask_num: int, k: int, sampling_method: str,
             shared_noise: bool = False, full: bool = False) -> MFPDraws:
    masked_index = corruption.sample_masked_index(
        generator, batch_size, num_fields, mask_num, sampling_method,
        tables.fused.device)
    if full:
        return MFPDraws(masked_index)
    if tables.per_field:
        fields = (torch.arange(num_fields, device=masked_index.device)
                  if shared_noise else masked_index)
        noise, noise_logq = alias.per_field_alias_draw_logq(
            generator, tables.fused, tables.idx_low, tables.field_sizes, fields, k)
    elif shared_noise:
        noise = alias.alias_draw(generator, tables.prob, tables.alias, (k,)).int()
        noise_logq = tables.logprob[noise]
    else:
        noise, noise_logq = alias.alias_draw_logq(generator, tables.fused,
                                                  (batch_size, mask_num, k))
    return MFPDraws(masked_index, noise, noise_logq)


def make_mfp_steps(model: torch.nn.Module, optimizer: AdamW, config: Config,
                   mask_ratio: float, sampling_method: str, tables: NoiseTables,
                   generator: torch.Generator, device: torch.device,
                   shared_noise: bool = False, data: Optional[ResidentData] = None):
    """-> (train_step(batch, draws=None), eval_step(batch, generator))."""
    mask_num = corruption.mask_num_of(config.num_fields, mask_ratio)
    k = int(config.pt_neg_num)
    loss_type = config.nce_loss_type
    if loss_type not in ("nce", "sampled", "full"):
        raise NotImplementedError(f"nce_loss_type={loss_type}")
    if shared_noise and loss_type == "full":
        # map_tpu's shared step scores sampled candidates only (_loss_from_logits)
        raise NotImplementedError("the full loss scores every id: no shared noise")
    full = loss_type == "full"
    log_sizes = (torch.log(tables.field_sizes.float()) if tables.per_field
                 else None)

    def candidate_logits(corrupted, labels, draws: MFPDraws):
        """-> (logits (B, M, 1+k), noise logq (B, M, k))."""
        mi = draws.masked_index
        if not shared_noise:
            candidates = torch.cat([labels[..., None], draws.noise.to(labels.dtype)], -1)
            return (model.mfp_candidate_logits(corrupted, mi, candidates),
                    draws.noise_logq)
        b, m = labels.shape
        if tables.per_field:
            return (model.mfp_per_field_shared_logits(corrupted, mi, labels, draws.noise),
                    draws.noise_logq[mi.long()])
        return (model.mfp_shared_noise_logits(corrupted, mi, labels, draws.noise),
                draws.noise_logq.expand(b, m, k))

    def forward(b, draws: MFPDraws):
        corrupted, labels = corruption.mfp_corrupt(b["input_ids"], draws.masked_index)
        w = b["weight"]
        if full:
            scores = model.mfp_full_scores(corrupted, draws.masked_index)
            per_pos = full_ce_loss(scores, labels)
            hit = (torch.argmax(scores.detach(), dim=-1) == labels.long()).float()
            acc_count = torch.sum(hit * w[:, None])
        else:
            logits, noise_logq = candidate_logits(corrupted, labels, draws)
            cand_logq = torch.cat([tables.logprob[labels][..., None], noise_logq], -1)
            norm = (log_sizes[draws.masked_index.long()][..., None] if tables.per_field
                    else tables.norm_term)
            if loss_type == "nce":
                per_pos = nce_loss(logits, cand_logq, norm, k)
            else:
                per_pos = sampled_softmax_loss(logits, cand_logq, norm)
            acc_count = mfp_accuracy_count(logits.detach(), w)
        loss = (per_pos * w[:, None]).sum() / (torch.clamp_min(w.sum(), 1.0) * mask_num)
        return loss, {"loss": loss.detach(), "count": w.sum() * mask_num,
                      "acc_count": acc_count}

    def draw(gen, b) -> MFPDraws:
        return draw_mfp(gen, tables, b["input_ids"].shape[0], config.num_fields,
                        mask_num, k, sampling_method, shared_noise, full)

    def train_step(batch: Batch, draws: Optional[MFPDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        b = device_batch(batch, device, data)
        if draws is None:
            draws = draw(generator, b)
        else:
            draws = MFPDraws(*(None if t is None else t.to(device) for t in draws))
        model.train()
        loss, metrics = forward(b, draws)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return metrics

    @torch.inference_mode()
    def eval_step(batch: Batch, gen: torch.Generator, draws: Optional[MFPDraws] = None
                  ) -> Dict[str, torch.Tensor]:
        b = to_device(batch, device)
        draws = draws or handed_in(b, MFPDraws)
        if draws is None:
            draws = draw(gen, b)
        else:
            draws = MFPDraws(*(None if t is None else t.to(device) for t in draws))
        model.eval()
        return forward(b, draws)[1]

    return train_step, eval_step


def handed_in(batch: Dict[str, torch.Tensor], kind) -> Optional[Tuple]:
    """The draws a batch carries as keys named after `kind`'s fields
    (MFPDraws, corruption.RFDDraws; a field that is None is left out), or
    None: how a grouped eval pass hands each batch its draws."""
    if kind._fields[0] not in batch:
        return None
    return kind(*(batch.get(k) for k in kind._fields))


def make_rfd_steps(model: torch.nn.Module, optimizer: AdamW, config: Config,
                   mask_ratio: float, sampling_method: str, rfd_replace: str,
                   generator: torch.Generator, device: torch.device,
                   data: Optional[ResidentData] = None):
    """-> (train_step(batch, draws=None), eval_step(batch, generator))."""
    f = int(config.num_fields)
    mask_num = corruption.mask_num_of(f, mask_ratio)

    def on_dev(a):
        return None if a is None else torch.tensor(a, dtype=torch.int32, device=device)

    idx_low, idx_high = on_dev(config.idx_low), on_dev(config.idx_high)

    def forward(b, draws: corruption.RFDDraws):
        corrupted, labels = corruption.rfd_corrupt(
            b["input_ids"], draws, rfd_replace, idx_low, idx_high, b.get("noise_rows"))
        logits = model.rfd_logits(corrupted).float()
        w = b["weight"][:, None]
        denom = torch.clamp_min(b["weight"].sum(), 1.0) * f
        loss = (bce_with_logits(logits, labels) * w).sum() / denom
        pred = (torch.sigmoid(logits.detach()) > 0.5).float()
        acc = ((pred == labels).float() * w).sum() / denom
        pos_ratio = (labels * w).sum() / denom
        return loss, {"loss": loss.detach(), "count": denom, "acc": acc,
                      "pos_ratio": pos_ratio}

    def draw(gen, b) -> corruption.RFDDraws:
        return corruption.draw_rfd(gen, b["input_ids"].shape[0], f, mask_num,
                                   sampling_method, rfd_replace, int(config.input_size),
                                   device)

    def train_step(batch: Batch, draws: Optional[corruption.RFDDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        b = device_batch(batch, device, data)
        if draws is None:
            draws = draw(generator, b)
        else:
            draws = corruption.RFDDraws(*(None if t is None else t.to(device)
                                          for t in draws))
        model.train()
        loss, metrics = forward(b, draws)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return metrics

    @torch.inference_mode()
    def eval_step(batch: Batch, gen: torch.Generator,
                  draws: Optional[corruption.RFDDraws] = None) -> Dict[str, torch.Tensor]:
        b = to_device(batch, device)
        draws = draws or handed_in(b, corruption.RFDDraws)
        if draws is None:
            draws = draw(gen, b)
        else:
            draws = corruption.RFDDraws(*(None if t is None else t.to(device)
                                          for t in draws))
        model.eval()
        return forward(b, draws)[1]

    return train_step, eval_step
