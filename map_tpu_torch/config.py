"""Run flags and the model config. Counterpart: `map_tpu/config.py`.

`TrainingArguments` and `ModelArguments` are the ported subset of map_tpu's
flags (`config.py:21-245`) with map_tpu's defaults: the models of
`models/zoo.py` (all ten of map_tpu's), supervised training, MFP
pretraining (per-position, shared, per-field and per-field-shared noise; the
`nce`, `sampled` and `full` losses; the sparse table update), RFD
pretraining (its four generators), the field-blocked hybrid lookup and its
backward modes, and finetune transfer; plus the port's own `--device`
(default: the card). `parse_args` registers every field as a `--flag`; a
bool whose default is True takes `BooleanOptionalAction`, so `--no-<flag>`
can turn it off (map_tpu registers every bool as store_true, which cannot).
`build_config` assembles the model `Config` from the flags and the dataset,
as `config.py:330-373` does. `steps_per_call`, `prefetch_batches`,
`device_resident_data` and `device_data_budget_gb` are map_tpu's input
pipeline and multi-step dispatch, with its defaults (`train/trainer.py`);
`save_steps`, `async_checkpoint`, `async_checkpoint_fetch`, `resume`,
`profile_steps`, `streaming_auc` and `auc_bins` its run management, with
its defaults. The parallel layer's (`parallel/`, map_tpu `config.py:83-84`,
`:123-132`, `:156`): `num_data_shards` (-1: the world over the model
axis), `num_model_shards` (the tables' row blocks), `table_sharding`
(auto: rows when the model axis > 1 | rows | replicated), `table_exchange`
(psum | hotcold), `hot_rows_per_field`, `mock_devices` (the CLI launches
that many local gloo ranks on the CPU, `parallel/launch.py`: map_tpu's
virtual CPU devices) and `exact_eval_allgather` (a multi-rank eval gathers
every example instead of the streaming AUC). The global batch is the
per-device batch times the data axis' size, from the port's own world
size (`parallel/mesh.data_parallel_size`).

The field-blocked hybrid lookup (`ops/hybrid_gather.py`) engages where
map_tpu's does with its default packed tables (`packed_tables=True`, which
routes (B, F) ids through `hybrid_rows_gather`): `field_blocked_lookup` on,
the dataset's blocks valid (`field_blocked_ok`), and not under RFD's
`Whole-*` generators, whose replacements leave their field's block. The
packing itself is TPU layout (128-lane rows) and is not ported: the port's
table is plain, so its pack factor is 1 and `packed_tables` stays False in
the port's config. An empty `hybrid_mode` becomes `matmul` for MFP, as in
map_tpu, and otherwise resolves at the call (`MAP_TPU_HYBRID_MODE`, else
`fwd`).

`Config` holds the model fields of map_tpu's `config.json` that the port
reads (map_tpu's `Config` / `Config.load`). map_tpu's Config is a free-form
bag; the port keeps a dataclass of the fields its modules read and carries
every other key along in `extra`, unread. Defaults are what map_tpu's
model code assumes when a key is absent (`getattr(config, key, default)` in
`map_tpu/models/zoo.py`), so a config.json without `compute_dtype` runs in
float32 in both packages. `feat_count` (the train split's unigram counts,
for MFP) is never written to config.json, as in map_tpu.
`pt_per_field_noise` is a run flag in map_tpu, whose trainer hands the
model the per-field noise prior through the config (`trainer.py:89-109`);
the port's model reads the flag itself to start its decoder bias there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Config:
    model_name: str = "dcnv2"
    input_size: int = 0
    num_fields: int = 0
    embed_size: int = 32
    hidden_size: int = 128
    num_hidden_layers: int = 1
    hidden_act: str = "relu"
    num_cross_layers: int = 1
    embed_norm: bool = False
    layer_norm_eps: float = 1e-12
    embed_dropout_rate: float = 0.0
    hidden_dropout_rate: float = 0.0
    compute_dtype: str = "float32"
    packed_tables: bool = False
    idx_low: Optional[List[int]] = None
    idx_high: Optional[List[int]] = None
    pretrain: bool = False
    pt_type: str = "MFP"
    RFD_replace: str = "Unigram"
    pt_per_field_noise: bool = False
    pt_neg_num: int = 25
    proj_size: int = 32
    nce_loss_type: str = "nce"
    field_blocked_lookup: bool = True
    hybrid_mode: str = ""
    # the rest of the zoo (map_tpu config.py:188-241): AutoInt's and the
    # Transformer's attention, xDeepFM's CIN, the LR and MLP towers
    num_attn_heads: int = 1
    attn_probs_dropout_rate: float = 0.1
    intermediate_size: int = 128
    norm_first: bool = False
    res_conn: bool = False
    output_reduction: str = "sum,max,sum"
    attn_scale: bool = False
    use_lr: bool = False
    attn_size: int = 40
    num_attn_layers: int = 2
    cin_layer_units: str = "50,50"
    dnn_size: int = 1000
    num_dnn_layers: int = 0
    dnn_act: str = "relu"
    dnn_drop: float = 0.0
    # FGCNN's feature generation and FiGNN's graph (map_tpu config.py:205-213)
    share_embedding: bool = False
    channels: str = "14,16,18,20"
    kernel_heights: str = "7,7,7,7"
    pooling_sizes: str = "2,2,2,2"
    recombined_channels: str = "3,3,3,3"
    conv_act: str = "tanh"
    reuse_graph_layer: bool = False
    # the layers no model of the zoo calls (nn/extras.py, nn/layers.py),
    # with map_tpu's defaults (config.py:195-221)
    agg_type: str = "mean"
    num_channels: int = 1
    reduction_ratio: int = 3
    bilinear_type: str = "field_interaction"
    outer_product_kernel_type: str = "mat"
    prod_layer_norm: bool = False
    prod_dropout_rate: float = 0.1
    inter_layer_norm: bool = False
    feat_count: Optional[np.ndarray] = field(default=None, repr=False)
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        known = {k: v for k, v in d.items() if k in names}
        if known.get("compute_dtype") is None:
            known.pop("compute_dtype", None)
        return cls(**known, extra={k: v for k, v in d.items() if k not in names})

    @property
    def mfp(self) -> bool:
        """The model carries the MFP head instead of fc_out."""
        return bool(self.pretrain) and self.pt_type == "MFP"

    @property
    def rfd(self) -> bool:
        """The model carries the RFD head instead of fc_out."""
        return bool(self.pretrain) and self.pt_type == "RFD"

    @classmethod
    def load(cls, load_directory: str) -> "Config":
        with open(os.path.join(load_directory, "config.json"), "r",
                  encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name not in ("extra", "feat_count")}
        return {**self.extra, **d}

    def save(self, save_directory: str) -> None:
        with open(os.path.join(save_directory, "config.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")


@dataclass
class TrainingArguments:
    """Run-level flags (map_tpu `config.py:21-74`, the ported subset)."""

    output_dir: str = ""
    dataset_name: str = "avazu"
    data_dir: str = "data/avazu"
    per_device_train_batch_size: int = 128
    per_device_eval_batch_size: int = 10000
    learning_rate: float = 1e-4
    weight_decay: float = 0.1
    adam_epsilon: float = 1e-8
    adam_betas: str = "0.9,0.999"
    max_grad_norm: float = 0.0  # 0 disables clipping
    patience: int = 2
    num_train_epochs: int = 20
    lr_sched: str = "cosine"  # cosine | const
    warmup_ratio: float = 0.0
    logging_first_step: bool = False
    logging_steps: int = 1000
    # run management (map_tpu config.py:41-56, :79-80, :137-138): the resume
    # state written when a call crosses a multiple of save_steps; checkpoint
    # writes on a worker thread, with the device-to-host copy there too under
    # async_checkpoint_fetch; --resume restores {output_dir}/resume.state;
    # torch.profiler over steps [2, 2 + profile_steps) into
    # {output_dir}/profile; the streaming eval's histogram AUC on auc_bins
    # buckets (doubled while its error bound exceeds 5e-5)
    save_steps: int = 1000
    async_checkpoint: bool = True
    async_checkpoint_fetch: bool = False
    resume: bool = False
    profile_steps: int = 0
    streaming_auc: bool = False
    auc_bins: int = 32768
    save_total_limit: Optional[int] = 20
    seed: int = 42
    # the MFP decoder table's AdamW from its sorted gradient streams (K7,
    # map_tpu config.py:102-111); engages in a shared-noise mode without a
    # clip (ops/sparse_adamw.engages)
    sparse_table_update: bool = False
    # pretraining (map_tpu config.py:59-74)
    sampling_method: str = "normal"  # normal (no repeats in a row) | randint
    mask_ratio: float = 0.1
    pretrain: bool = False
    pt_type: str = "MFP"  # MFP | RFD
    RFD_replace: str = "Unigram"  # Unigram | Uniform | Whole-Uniform | Whole-Unigram
    finetune: bool = False
    pretrained_model_path: Optional[str] = None
    pt_per_field_noise: bool = False  # noise from the masked field's own unigram
    pt_shared_noise: bool = False  # one noise set a step (a field), not a position
    compute_dtype: str = "bfloat16"  # float32 | bfloat16 for activations
    # the field-blocked hybrid lookup (ops/hybrid_gather.py, map_tpu
    # config.py:112-123) and its backward mode: fwd | fwd_split | matmul |
    # both | bwd | bwd_pallas; "" = matmul for MFP, else MAP_TPU_HYBRID_MODE
    # or fwd
    field_blocked_lookup: bool = True
    hybrid_mode: str = ""
    device: Optional[str] = None  # None: the card ("cuda"); "cpu" for the plain path
    # the input pipeline and the multi-step dispatch (map_tpu config.py:85-86,
    # :144-145): train steps a host call (a captured CUDA graph on the card),
    # the depth of the prefetch thread's queue, and the train matrix on the
    # device (auto: when it fits device_data_budget_gb) so that a step ships
    # a batch number (or indices, with RFD's noise rows) instead of its rows
    steps_per_call: int = 8
    prefetch_batches: int = 2
    device_resident_data: str = "auto"  # auto | on | off
    device_data_budget_gb: float = 8.0
    # the host's dataset budget (map_tpu config.py:146-152): over it, the
    # splits are memory-mapped files (data/dataset.py); -1 always in RAM,
    # 0 auto (60 % of physical RAM), > 0 a budget in MB
    host_data_budget_mb: int = 0
    # the parallel layer (map_tpu config.py:83-84, :123-132, :156)
    num_data_shards: int = -1  # the data axis; -1 = the world // num_model_shards
    num_model_shards: int = 1  # the tables' row blocks (the model axis)
    table_sharding: str = "auto"  # auto | replicated | rows
    table_exchange: str = "psum"  # psum | hotcold
    hot_rows_per_field: int = 512  # hotcold: each field's hot id prefix
    mock_devices: int = 0  # > 0: the CLI runs that many local gloo ranks on the CPU
    exact_eval_allgather: bool = False  # a multi-rank eval gathers every example

    @property
    def train_batch_size(self) -> int:
        """The global batch: per device x the data axis."""
        from map_tpu_torch.parallel.mesh import data_parallel_size

        return self.per_device_train_batch_size * data_parallel_size(self)

    @property
    def eval_batch_size(self) -> int:
        from map_tpu_torch.parallel.mesh import data_parallel_size

        return self.per_device_eval_batch_size * data_parallel_size(self)


@dataclass
class ModelArguments:
    """The hyperparameters of the ported models and of the pretraining
    heads (map_tpu `config.py:176-241`)."""

    model_name: str = "dcnv2"
    embed_size: int = 32
    embed_dropout_rate: float = 0.0
    hidden_size: int = 128
    num_hidden_layers: int = 1
    hidden_act: str = "relu"
    hidden_dropout_rate: float = 0.0
    layer_norm_eps: float = 1e-12
    embed_norm: bool = False
    num_cross_layers: int = 1
    num_attn_heads: int = 1
    attn_probs_dropout_rate: float = 0.1
    intermediate_size: int = 128
    norm_first: bool = False
    res_conn: bool = False
    output_reduction: str = "sum,max,sum"  # trans: fc | mean,fc | sum,fc | attn,fc
    attn_scale: bool = False
    use_lr: bool = False
    attn_size: int = 40
    num_attn_layers: int = 2
    cin_layer_units: str = "50,50"
    dnn_size: int = 1000
    num_dnn_layers: int = 0
    dnn_act: str = "relu"
    dnn_drop: float = 0.0
    share_embedding: bool = False
    channels: str = "14,16,18,20"  # FGCNN: conv channels, kernel heights,
    kernel_heights: str = "7,7,7,7"  # pooling sizes and recombined channels
    pooling_sizes: str = "2,2,2,2"  # of each stage
    recombined_channels: str = "3,3,3,3"
    conv_act: str = "tanh"
    reuse_graph_layer: bool = False  # FiGNN: one GraphLayer for every round
    # read by the layers no model of the zoo calls (nn/extras.py: ProductLayer's
    # aggregation, norm and dropout, MultiChannelOutputHead's channels;
    # nn/layers.py: SENET's reduction, the bilinear and outer-product kernels,
    # IntermediateLayer's norm), map_tpu's flags and defaults
    agg_type: str = "mean"
    num_channels: int = 1
    reduction_ratio: int = 3
    bilinear_type: str = "field_interaction"
    outer_product_kernel_type: str = "mat"
    prod_layer_norm: bool = False
    prod_dropout_rate: float = 0.1
    inter_layer_norm: bool = False
    pt_neg_num: int = 25
    proj_size: int = 32
    nce_loss_type: str = "nce"  # nce | sampled | full


def _flag_type(f: dataclasses.Field) -> type:
    # annotations are strings under `from __future__ import annotations`
    name = str(f.type)
    for t in (bool, int, float):
        if t.__name__ in name:
            return t
    return str


def add_dataclass_args(parser: argparse.ArgumentParser, cls: type) -> None:
    for f in dataclasses.fields(cls):
        ftype = _flag_type(f)
        if ftype is bool:
            action = (argparse.BooleanOptionalAction if f.default is True
                      else "store_true")
            parser.add_argument(f"--{f.name}", action=action, default=f.default)
        else:
            parser.add_argument(f"--{f.name}", type=ftype, default=f.default)


def parse_args(argv: Optional[Sequence[str]] = None
               ) -> Tuple[ModelArguments, TrainingArguments]:
    parser = argparse.ArgumentParser(description="map_tpu_torch trainer")
    add_dataclass_args(parser, ModelArguments)
    add_dataclass_args(parser, TrainingArguments)
    ns = vars(parser.parse_args(argv))
    pick = lambda cls: cls(**{f.name: ns[f.name]  # noqa: E731
                              for f in dataclasses.fields(cls)})
    model_args, training_args = pick(ModelArguments), pick(TrainingArguments)
    check_supported(model_args, training_args)
    return model_args, training_args


RFD_REPLACE = ("Unigram", "Uniform", "Whole-Uniform", "Whole-Unigram")


def check_supported(model_args: ModelArguments,
                    training_args: TrainingArguments) -> None:
    """Raise on a pretraining type or RFD generator map_tpu does not have,
    on a device_resident_data other than auto, on or off, and on a model
    config map_tpu refuses (`validate_model_config`)."""
    if training_args.pretrain and training_args.pt_type not in ("MFP", "RFD"):
        raise NotImplementedError(f"pt_type={training_args.pt_type}: MFP | RFD")
    if (training_args.pretrain and training_args.pt_type == "RFD"
            and training_args.RFD_replace not in RFD_REPLACE):
        raise NotImplementedError(f"RFD_replace={training_args.RFD_replace}: "
                                  f"one of {RFD_REPLACE}")
    if training_args.table_sharding not in ("auto", "rows", "replicated"):
        raise ValueError(f"table_sharding={training_args.table_sharding}: "
                         "auto | rows | replicated")
    if training_args.device_resident_data not in ("auto", "on", "off"):
        raise ValueError(f"device_resident_data={training_args.device_resident_data}: "
                         "auto | on | off")
    validate_model_config(model_args)


def validate_model_config(c) -> None:
    """map_tpu's `validate_model_config` (`models/base.py:143-147`): the
    Transformer adds its layers' outputs to the embeddings, so it needs
    embed_size == hidden_size."""
    if c.model_name.lower() == "trans" and c.embed_size != c.hidden_size:
        raise ValueError(f"model trans requires embed_size == hidden_size, got "
                         f"{c.embed_size} and {c.hidden_size}")


def build_config(model_args: ModelArguments, training_args: TrainingArguments,
                 dataset) -> Config:
    """Flags + the dataset's input_size and num_fields (the reserved <rsv>
    field not counted), its per-field id ranges and, for pretraining, its
    unigram `feat_count` -> the model Config. The hybrid lookup's rules are
    map_tpu's (`config.py:355-372`): off when the dataset is not
    field-blocked or under RFD's `Whole-*` generators; `matmul` for MFP when
    no mode is given."""
    check_supported(model_args, training_args)
    t = training_args
    d = dataclasses.asdict(model_args)
    idx = lambda a: None if a is None else [int(x) for x in a]  # noqa: E731
    blocked = (t.field_blocked_lookup and getattr(dataset, "field_blocked_ok", True)
               and not (t.pretrain and t.pt_type == "RFD"
                        and t.RFD_replace.startswith("Whole")))
    mode = t.hybrid_mode
    if not mode and t.pretrain and t.pt_type == "MFP" and blocked:
        mode = "matmul"
    d.update(input_size=dataset.input_size, num_fields=dataset.num_fields,
             compute_dtype=t.compute_dtype, packed_tables=False,
             data_dir=t.data_dir, pretrain=t.pretrain, pt_type=t.pt_type,
             RFD_replace=t.RFD_replace, pt_per_field_noise=t.pt_per_field_noise,
             field_blocked_lookup=blocked, hybrid_mode=mode,
             feat_count=getattr(dataset, "feat_count", None),
             idx_low=idx(getattr(dataset, "idx_low", None)),
             idx_high=idx(getattr(dataset, "idx_high", None)))
    return Config.from_dict(d)
