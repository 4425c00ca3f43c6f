"""Same-data validation: the five stages of map_tpu's certification on the
synthazu set, through the port's Trainer, held to map_tpu's seed band.

    python -m map_tpu_torch.validate [--model dcnv2] [--seeds 42,43,44,45]
        [--stages scratch,mfp,rfd,finetune,finetune_rfd] [--rows 400000]
        [--mfp_modes matmul,fwd,bwd_pallas] [--pf_shared]
        [--output_dir validate_out] [--device cpu]

The port's counterpart of `validation/gen_data.py` + `validation/run_tpu.sh`
+ `validation/seed_stats.py` (it imports none of them, nor map_tpu):

- data: `data/synth.generate_realistic_arrays` in memory, 400,000 rows from
  data seed 7 (`validation/gen_data.py 400000`), 80/10/10 split, no file;
- stages, each a `Trainer` run with `validation/run_tpu.sh:16-62`'s flags
  (DCNv2, embed 16, MLP 3 x 1000, 3 cross layers, dropout 0, batch 4096,
  lr 1e-3, eps 1e-8, no clip, `--seed`; the port's defaults otherwise, which
  are map_tpu's: bf16, the field-blocked lookup, `steps_per_call` 8):
  `scratch` (wd 0.1, const, 1 epoch), `mfp` (wd 5e-2, cosine, 3 epochs,
  mask 0.3, randint, k = 25, proj 32), `rfd` (the same, Unigram),
  `finetune` and `finetune_rfd` (as scratch, from the newest checkpoint of
  `mfp` / `rfd`); each in `{output_dir}/s{seed}/{stage}` (train.log,
  metrics.jsonl, checkpoints), started afresh;
- `--mfp_modes`: MFP and its finetune under each table-gradient mode
  (`matmul`, map_tpu's MFP default, is the `mfp` stage; `mfp@fwd`,
  `finetune@fwd`, ...); `--pf_shared`: per-field shared noise
  (`--pt_shared_noise --pt_per_field_noise`, with `--sparse_table_update`,
  whose K7 update equals the dense route's) at k = 25 and k = 100
  (`mfp@pf25`, `finetune@pf25`, `mfp@pf100`, `finetune@pf100`);
- each stage's metric from its `metrics.jsonl`: the last `test` record's
  AUC and log loss (supervised stages), the last `mfp_eval` / `rfd_eval`
  record's accuracy and loss (pretraining);
- output: one JSON line a stage and seed, then a table of the port's mean
  and std over the seeds against map_tpu's (`MAP_TPU_BAND`), with Δmean,
  2σ(Δ) = 2 sqrt(s_port² / n_port + s_map² / n_map) and the verdict
  |Δmean| ≤ 2σ(Δ) + eps (eps 5e-4; 1e-3 for the accuracy rows), the rule
  of `tests/test_multiseed_parity.py:8-11`; for the `mfp` stage a second
  table against map_tpu's band rerun on the CPU (`MAP_TPU_CPU_BAND`); then
  one JSON line of the rows (`validate_rows`, `validate_rows_map_tpu_cpu`).

`--model` runs the same stages for any of map_tpu's ten models, at
`ZOO_KNOBS`' widths (map_tpu's model defaults on the DCNv2 scripts' shared
settings), on 120,000 rows by default, held to map_tpu's band rerun on the
CPU at that size (`MAP_TPU_ZOO_CPU_BAND`); LR and FM run `scratch` alone
and refuse the pretraining stages, as map_tpu's models do.

`--rows`, `--vocab_sizes`, `--batch` and the widths are there for quick runs
(the CPU tests run the five stages on a few thousand rows), and
`--compute_dtype float32` for a control; the band holds for the defaults
only. The pf-shared pretrainings have no band (map_tpu certified them by
their finetunes): their rows give the port's numbers alone.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import math
import os
import shutil
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from map_tpu_torch import models
from map_tpu_torch.config import ModelArguments, TrainingArguments, build_config
from map_tpu_torch.data import synth
from map_tpu_torch.train.trainer import Trainer
from map_tpu_torch.utils.seeds import stream_generator

# a stage's two numbers, by its kind: its metric, then its loss
METRICS = {"supervised": ("test_auc", "logloss"), "mfp": ("acc", "loss"),
           "rfd": ("acc", "loss")}
# map_tpu's certified band on this data (validation/README.md:84-95, the
# seeds 42-45 sweep, round 3; the mfp rows n = 8, seeds 42-49,
# README.md:155-158): stage -> ((mean, std, n) of its metric, of its loss)
MAP_TPU_BAND = {
    "scratch": ((0.747400, 0.001078, 4), (0.398766, 0.000550, 4)),
    "mfp": ((0.728718, 0.002796, 8), (1.376592, 0.007622, 8)),
    "rfd": ((0.766583, 0.004583, 4), (0.516655, 0.009119, 4)),
    "finetune": ((0.747375, 0.001236, 4), (0.398698, 0.000608, 4)),
    "finetune_rfd": ((0.747389, 0.000951, 4), (0.398662, 0.000586, 4)),
}
# map_tpu's mfp row rerun by its current code on the JAX CPU backend at the
# port's seeds 42-57 (f32, 400,000 rows: `python tests/torch_port_mfp_probe.py
# runs --package map_tpu --seeds 42-57 --rows 400000`): a second comparison,
# recorded beside MAP_TPU_BAND, which stays the verdict
MAP_TPU_CPU_BAND = {"mfp": ((0.728742, 0.002274, 16), (1.378617, 0.007748, 16))}
# map_tpu's band for the rest of the zoo, rerun by its current code on the
# JAX CPU backend (f32, 120,000 rows, seeds 42-45, each model at ZOO_KNOBS;
# `python tests/torch_port_zoo_probe.py runs --package map_tpu --model NAME
# --seeds 42-45 --rows 120000`, then `bands --pool` of the jobs' logs; FGCNN
# with `--one_step_calls` but in `scratch`, the same math): model -> stage ->
# ((mean, std, n) of its metric, of its loss). The rows marked with more
# seeds were taken further on both sides: DNN's, DeepFM's and xDeepFM's
# `mfp` and FiGNN's `scratch` fell outside the rule at 42-45, and FGCNN's
# `scratch` spread 0.0004 in AUC there against 0.0066 at 42-49
MAP_TPU_ZOO_CPU_BAND: Dict[str, Dict] = {
    "lr": {
        "scratch": ((0.512045, 0.048532, 4), (1.794174, 0.242364, 4)),
    },
    "fm": {
        "scratch": ((0.518754, 0.035618, 4), (1.876187, 0.207610, 4)),
    },
    "dnn": {
        "scratch": ((0.731386, 0.001417, 4), (0.424189, 0.000520, 4)),
        "mfp": ((0.377865, 0.004976, 8), (2.970527, 0.008412, 8)),  # seeds 42-49
        "rfd": ((0.757639, 0.000118, 4), (0.553211, 0.000124, 4)),
        "finetune": ((0.732684, 0.001490, 4), (0.422747, 0.000846, 4)),
        "finetune_rfd": ((0.733258, 0.001415, 4), (0.422798, 0.000982, 4)),
    },
    "deepfm": {
        "scratch": ((0.609048, 0.018281, 4), (1.258167, 0.016241, 4)),
        "mfp": ((0.373711, 0.006266, 8), (2.986724, 0.007330, 8)),  # seeds 42-49
        "rfd": ((0.757639, 0.000118, 4), (0.553450, 0.000093, 4)),
        "finetune": ((0.614930, 0.013112, 4), (1.245521, 0.016055, 4)),
        "finetune_rfd": ((0.620466, 0.018305, 4), (1.284688, 0.030234, 4)),
    },
    "xdeepfm": {
        "scratch": ((0.729862, 0.000980, 4), (0.424500, 0.000589, 4)),
        "mfp": ((0.382080, 0.005861, 8), (2.955875, 0.007422, 8)),  # seeds 42-49
        "rfd": ((0.757639, 0.000118, 4), (0.553143, 0.000105, 4)),
        "finetune": ((0.731351, 0.001313, 4), (0.423606, 0.000959, 4)),
        "finetune_rfd": ((0.729769, 0.001160, 4), (0.424336, 0.000870, 4)),
    },
    "autoint": {
        "scratch": ((0.519462, 0.013917, 4), (0.581966, 0.019777, 4)),
        "mfp": ((0.348402, 0.011352, 4), (2.997805, 0.016611, 4)),
        "rfd": ((0.757639, 0.000118, 4), (0.556691, 0.000271, 4)),
        "finetune": ((0.520467, 0.034440, 4), (0.478658, 0.004466, 4)),
        "finetune_rfd": ((0.522007, 0.022667, 4), (0.523404, 0.023642, 4)),
    },
    "trans": {
        "scratch": ((0.573250, 0.037163, 4), (0.475000, 0.003886, 4)),
        "mfp": ((0.411295, 0.005719, 4), (2.898306, 0.008381, 4)),
        "rfd": ((0.757639, 0.000118, 4), (0.553657, 0.000166, 4)),
        "finetune": ((0.567562, 0.045847, 4), (0.476604, 0.005115, 4)),
        "finetune_rfd": ((0.575171, 0.029247, 4), (0.474855, 0.003187, 4)),
    },
    "fignn": {
        "scratch": ((0.575529, 0.022486, 10), (0.478804, 0.002283, 10)),  # seeds 42-51
        "mfp": ((0.343491, 0.004330, 4), (3.011893, 0.008149, 4)),
        "rfd": ((0.757639, 0.000118, 4), (0.553781, 0.000122, 4)),
        "finetune": ((0.557172, 0.054361, 4), (0.499810, 0.043378, 4)),
        "finetune_rfd": ((0.538909, 0.026614, 4), (0.477035, 0.004993, 4)),
    },
    "fgcnn": {
        "scratch": ((0.728466, 0.006575, 8), (0.428088, 0.004536, 8)),  # seeds 42-49
        "mfp": ((0.443667, 0.009459, 4), (2.939632, 0.032075, 4)),
        "rfd": ((0.757639, 0.000118, 4), (0.553135, 0.000106, 4)),
        "finetune": ((0.734762, 0.002207, 4), (0.421846, 0.001279, 4)),
        "finetune_rfd": ((0.730364, 0.005048, 4), (0.428801, 0.010534, 4)),
    },
}
# map_tpu's single seed-42 finetune runs after per-field shared pretraining
# (validation/README.md:185-192, CPU backend): the finetune std above
# stands for their run-to-run spread
MAP_TPU_PF_SHARED = {"finetune@pf25": 0.744174, "finetune@pf100": 0.747224}
EPS = 5e-4  # tests/test_multiseed_parity.py; twice this for accuracy rows

DATA_SEED = 7
COMMON_MODEL = dict(model_name="dcnv2", embed_size=16, hidden_size=1000, num_hidden_layers=3,
                    num_cross_layers=3, hidden_dropout_rate=0.0)
COMMON_TRAIN = dict(per_device_train_batch_size=4096, per_device_eval_batch_size=4096,
                    learning_rate=1e-3, adam_epsilon=1e-8, max_grad_norm=0.0,
                    logging_steps=100, dataset_name="synthazu", data_dir="")
SUPERVISED = dict(weight_decay=0.1, lr_sched="const", num_train_epochs=1)
PRETRAIN = dict(weight_decay=5e-2, lr_sched="cosine", num_train_epochs=3, pretrain=True,
                sampling_method="randint", mask_ratio=0.3)
MFP = dict(PRETRAIN, pt_type="MFP")
RFD = dict(PRETRAIN, pt_type="RFD", RFD_replace="Unigram")
BASE_STAGES = ("scratch", "mfp", "rfd", "finetune", "finetune_rfd")
MFP_MODES = ("matmul", "fwd", "bwd_pallas")

# the zoo at full width: map_tpu's model defaults (the reference's
# code/arguments.py) on the canonical DCNv2 scripts' shared settings (24
# fields, embed 16, batch 4096, the MLP 3 x 1000 of run_DCNv2_*.sh); the
# attention dropout of AutoInt stays at its default 0.1
ZOO_KNOBS = {
    "lr": {},
    "fm": {},
    "dnn": {},
    "deepfm": {},
    "xdeepfm": dict(cin_layer_units="50,50"),
    "autoint": dict(num_attn_layers=2, attn_size=40, num_attn_heads=1,
                    attn_probs_dropout_rate=0.1),
    "trans": dict(hidden_size=COMMON_MODEL["embed_size"], num_hidden_layers=3,
                  num_attn_heads=2, intermediate_size=128, output_reduction="attn,fc",
                  norm_first=False, layer_norm_eps=1e-12),
    # 3 GNN rounds (num_hidden_layers, the canonical 3), no residual, a
    # GraphLayer a round
    "fignn": dict(num_hidden_layers=3, res_conn=False, reuse_graph_layer=False),
    # the default conv stack (24 fields -> 12, 6, 3, 2 rows; 93 fields in
    # all, final_dim 5,766) beside a table of its own, then the MLP 3 x 1000
    "fgcnn": dict(share_embedding=False, channels="14,16,18,20", kernel_heights="7,7,7,7",
                  pooling_sizes="2,2,2,2", recombined_channels="3,3,3,3", conv_act="tanh"),
}
MODELS = ("dcnv2", *ZOO_KNOBS)
# LR and FM have no pretraining head (map_tpu/models/zoo.py:101-117)
SUPERVISED_ONLY = ("lr", "fm")
ZOO_ROWS = 120_000  # the zoo's band size (DCNv2's is 400,000)


class Stage(NamedTuple):
    name: str
    train: Dict  # TrainingArguments fields
    model: Dict  # ModelArguments fields
    source: Optional[str] = None  # the stage whose newest checkpoint it finetunes
    band: Optional[str] = None  # its MAP_TPU_BAND row

    @property
    def kind(self) -> str:
        return ("supervised" if not self.train.get("pretrain")
                else self.train["pt_type"].lower())


def _stages() -> Dict[str, Stage]:
    st = {"scratch": Stage("scratch", SUPERVISED, {}, band="scratch"),
          "mfp": Stage("mfp", MFP, dict(pt_neg_num=25, proj_size=32), band="mfp"),
          "rfd": Stage("rfd", RFD, {}, band="rfd"),
          "finetune": Stage("finetune", SUPERVISED, {}, "mfp", "finetune"),
          "finetune_rfd": Stage("finetune_rfd", SUPERVISED, {}, "rfd", "finetune_rfd")}
    for mode in MFP_MODES[1:]:
        st[f"mfp@{mode}"] = st["mfp"]._replace(name=f"mfp@{mode}",
                                               train=dict(MFP, hybrid_mode=mode))
        st[f"finetune@{mode}"] = st["finetune"]._replace(name=f"finetune@{mode}",
                                                         source=f"mfp@{mode}")
    for k in (25, 100):
        # no band: map_tpu certified these pretrainings by their finetunes only,
        # and their accuracy ranks 1 + k candidates from the masked field
        st[f"mfp@pf{k}"] = Stage(f"mfp@pf{k}", dict(MFP, pt_shared_noise=True,
                                                     pt_per_field_noise=True,
                                                     sparse_table_update=True),
                                 dict(pt_neg_num=k, proj_size=32))
        st[f"finetune@pf{k}"] = Stage(f"finetune@pf{k}", SUPERVISED, {}, f"mfp@pf{k}",
                                      "finetune")
    return st


STAGES = _stages()


def model_stages(model: str) -> Tuple[str, ...]:
    """The stages `model` runs: the five, or `scratch` alone for LR and FM."""
    if model not in MODELS:
        raise ValueError(f"--model: {model} is not one of {MODELS}")
    return ("scratch",) if model in SUPERVISED_ONLY else BASE_STAGES


def plan(stages: Sequence[str], mfp_modes: Sequence[str] = (), pf_shared: bool = False,
         model: str = "dcnv2") -> List[Stage]:
    """The stages to run, in an order where each source runs before the
    finetune that reads it (a finetune's source is added if missing). LR and
    FM refuse every stage that pretrains or reads a pretraining, as map_tpu's
    models refuse `--pretrain`."""
    model_stages(model)
    names = list(stages)
    for mode in mfp_modes:
        if mode not in MFP_MODES:
            raise ValueError(f"--mfp_modes: {mode} is not one of {MFP_MODES}")
        names += ["mfp", "finetune"] if mode == "matmul" else [f"mfp@{mode}",
                                                                f"finetune@{mode}"]
    if pf_shared:
        names += ["mfp@pf25", "finetune@pf25", "mfp@pf100", "finetune@pf100"]
    for name in names:
        if name not in STAGES:
            raise ValueError(f"unknown stage {name}: one of {sorted(STAGES)}")
    names += [STAGES[n].source for n in names if STAGES[n].source]
    if model in SUPERVISED_ONLY:
        for n in names:
            if STAGES[n].kind != "supervised" or STAGES[n].source:
                raise ValueError(f"stage {n}: {model.upper()} is not pretrain-capable "
                                 "(reference parity)")
    ordered = list(dict.fromkeys(names))  # first occurrence, deduplicated
    return ([STAGES[n] for n in ordered if STAGES[n].source is None]
            + [STAGES[n] for n in ordered if STAGES[n].source is not None])


def newest_checkpoint(run_dir: str) -> str:
    paths = glob.glob(os.path.join(run_dir, "*.model"))
    steps = [int(os.path.basename(p)[:-len(".model")]) for p in paths
             if os.path.basename(p)[:-len(".model")].isdigit()]
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {run_dir}")
    return os.path.join(run_dir, f"{max(steps)}.model")


def stage_result(run_dir: str, kind: str) -> Tuple[float, float]:
    """(metric, loss) from the stage's metrics.jsonl: the last test record's
    AUC and log loss, or the last MFP / RFD eval's accuracy and loss."""
    record_kind, metric, loss = {"supervised": ("test", "eval_auc", "eval_loss"),
                                 "mfp": ("mfp_eval", "eval_mfp_acc", "eval_mfp_loss"),
                                 "rfd": ("rfd_eval", "eval_rfd_acc", "eval_rfd_loss")}[kind]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    last = [r for r in recs if r["kind"] == record_kind][-1]
    return float(last[metric]), float(last[loss])


def model_flags(model: str = "dcnv2") -> Dict:
    """The ModelArguments fields every stage of `model` shares."""
    return {**COMMON_MODEL, "model_name": model, **ZOO_KNOBS.get(model, {})}


def stage_args(stage: Stage, seed: int, out_root: str, device: Optional[str] = None,
               overrides: Optional[Dict] = None, model: str = "dcnv2"
               ) -> Tuple[ModelArguments, TrainingArguments]:
    """The stage's flags for `model` at `seed`, its run in
    `{out_root}/s{seed}/{name}`; a finetune reads its source's newest
    checkpoint there."""
    overrides = overrides or {}
    train_kw = {**COMMON_TRAIN, **stage.train, **overrides.get("train", {})}
    if stage.source:
        train_kw.update(finetune=True, pretrained_model_path=newest_checkpoint(
            os.path.join(out_root, f"s{seed}", stage.source)))
    targs = TrainingArguments(output_dir=os.path.join(out_root, f"s{seed}", stage.name),
                              seed=seed, device=device, **train_kw)
    margs = ModelArguments(**{**model_flags(model), **stage.model,
                              **overrides.get("model", {})})
    return margs, targs


def run_stage(stage: Stage, seed: int, dataset, out_root: str, device: Optional[str],
              overrides: Dict, model: str = "dcnv2") -> Tuple[Dict, Trainer]:
    """One stage of `model` at one seed through the Trainer -> (its result
    line, the Trainer)."""
    margs, targs = stage_args(stage, seed, out_root, device, overrides, model)
    run_dir = targs.output_dir
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    root = logging.getLogger()
    handler = logging.FileHandler(os.path.join(run_dir, "train.log"), mode="w")
    handler.setFormatter(logging.Formatter("%(message)s"))
    saved = (root.level, root.handlers[:])
    root.handlers, root.level = [handler], logging.INFO
    t0 = time.perf_counter()
    try:
        config = build_config(margs, targs, dataset)
        config.save(run_dir)
        net = models.from_config(config, stream_generator(seed, "init"))
        trainer = Trainer(net, config, targs, dataset)
        if stage.kind == "mfp":
            trainer.MFP_pretrain()
        elif stage.kind == "rfd":
            trainer.RFD_pretrain()
        else:
            trainer.train()
            trainer.test()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
    finally:
        handler.close()
        root.handlers, root.level = saved[1], saved[0]
    wall = time.perf_counter() - t0
    metric, loss = stage_result(run_dir, stage.kind)
    return {"model": model, "stage": stage.name, "seed": seed, "kind": stage.kind,
            "metric": metric, "loss": loss, "steps": trainer.global_step, "wall_s": wall,
            "finetune_counts": trainer.finetune_counts, "source": stage.source}, trainer


def mean_std(values: Sequence[float]) -> Tuple[float, float]:
    """Mean and sample std (n - 1), as `validation/seed_stats.py`."""
    n = len(values)
    mu = sum(values) / n
    if n < 2:
        return mu, 0.0
    return mu, math.sqrt(sum((v - mu) ** 2 for v in values) / (n - 1))


def verdict(port: Sequence[float], ref_mean: float, ref_std: float, ref_n: int,
            eps: float) -> Dict:
    """The port's mean against map_tpu's: Δmean, 2σ(Δ) and whether
    |Δmean| ≤ 2σ(Δ) + eps."""
    mu, sd = mean_std(port)
    delta = mu - ref_mean
    band = 2.0 * math.sqrt(sd ** 2 / len(port) + ref_std ** 2 / ref_n)
    return {"port_mean": mu, "port_std": sd, "n": len(port), "map_tpu_mean": ref_mean,
            "map_tpu_std": ref_std, "map_tpu_n": ref_n, "delta": delta, "two_sigma": band,
            "eps": eps, "within": abs(delta) <= band + eps}


def single_run_band(ref_std: float, ref_n: int, eps: float) -> float:
    """The band of one port run against map_tpu's mean: 2 sqrt(s² + s² / n)
    + eps, s being map_tpu's std (its own run-to-run spread)."""
    return 2.0 * math.sqrt(ref_std ** 2 + ref_std ** 2 / ref_n) + eps


def reference_rows(stage: Stage, bands: Dict = MAP_TPU_BAND
                   ) -> List[Tuple[float, float, int, float]]:
    """(map_tpu mean, std, n, eps) of the stage's metric, then of its loss,
    from `bands`; the pf-shared finetunes' metric alone, against map_tpu's
    single runs with the finetune stage's std; none for a stage without a
    band."""
    if stage.band not in bands:
        return []
    (m_mu, m_sd, m_n), loss = bands[stage.band]
    eps_m = 2 * EPS if METRICS[stage.kind][0] == "acc" else EPS
    if stage.name in MAP_TPU_PF_SHARED:
        return [(MAP_TPU_PF_SHARED[stage.name], m_sd, 1, eps_m)]
    return [(m_mu, m_sd, m_n, eps_m), (*loss, EPS)]


def table(results: List[Dict], stages: Sequence[Stage],
          bands: Dict = MAP_TPU_BAND) -> List[Dict]:
    """A row a stage and number: the verdict against map_tpu's band in
    `bands`, or the port's mean and std alone where map_tpu has none."""
    rows = []
    for stage in stages:
        got = [r for r in results if r["stage"] == stage.name]
        if not got:
            continue
        refs = reference_rows(stage, bands)
        for i, name in enumerate(METRICS[stage.kind]):
            vals = [r["metric"] if i == 0 else r["loss"] for r in got]
            if i < len(refs):
                rows.append({"stage": stage.name, "metric": name, **verdict(vals, *refs[i])})
            else:
                mu, sd = mean_std(vals)
                rows.append({"stage": stage.name, "metric": name, "port_mean": mu,
                             "port_std": sd, "n": len(vals), "within": None})
    return rows


def print_table(rows: List[Dict]) -> None:
    print("| stage | metric | port mean±std (n) | map_tpu mean±std (n) | Δmean | 2σ(Δ) "
          "| verdict |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        port = f"{r['port_mean']:.6f}±{r['port_std']:.6f} ({r['n']})"
        if r["within"] is None:
            print(f"| {r['stage']} | {r['metric']} | {port} | — | — | — | no band |")
            continue
        print(f"| {r['stage']} | {r['metric']} | {port} | {r['map_tpu_mean']:.6f}±"
              f"{r['map_tpu_std']:.6f} ({r['map_tpu_n']}) | {r['delta']:+.6f} | "
              f"{r['two_sigma']:.6f} | {'within noise' if r['within'] else 'OUTSIDE'} |")


def _ints(text: str) -> List[int]:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="dcnv2", choices=MODELS)
    ap.add_argument("--seeds", default="42,43,44,45")
    ap.add_argument("--stages", default="", help="default: the model's stages (the five; "
                    "scratch alone for LR and FM)")
    ap.add_argument("--rows", type=int, default=0, help="default: 400,000 for DCNv2, "
                    "120,000 for the rest of the zoo (the rows of their bands)")
    ap.add_argument("--mfp_modes", default="")
    ap.add_argument("--pf_shared", action="store_true")
    ap.add_argument("--output_dir", default="validate_out")
    ap.add_argument("--device", default=None, help="cpu for the plain path; default: the card")
    ap.add_argument("--vocab_sizes", default="", help="per-field ids (default: map_tpu's "
                    "AVAZU_LIKE_VOCABS)")
    ap.add_argument("--batch", type=int, default=0, help="train and eval batch (default 4096)")
    ap.add_argument("--hidden_size", type=int, default=0, help="MLP width (default 1000; "
                    "the Transformer keeps its hidden width = embed)")
    ap.add_argument("--compute_dtype", default="", help="float32 for a control run "
                    "(default: the flag's default, bfloat16, map_tpu's)")
    args = ap.parse_args(argv)

    model = args.model
    stages = plan([s for s in args.stages.split(",") if s] or model_stages(model),
                  [m for m in args.mfp_modes.split(",") if m], args.pf_shared, model)
    rows = args.rows or (400_000 if model == "dcnv2" else ZOO_ROWS)
    overrides: Dict[str, Dict] = {"train": {}, "model": {}}
    if args.batch:
        overrides["train"].update(per_device_train_batch_size=args.batch,
                                  per_device_eval_batch_size=args.batch)
    if args.hidden_size and model != "trans":
        overrides["model"]["hidden_size"] = args.hidden_size
    if args.compute_dtype:
        overrides["train"]["compute_dtype"] = args.compute_dtype
    t0 = time.perf_counter()
    arrays = synth.generate_realistic_arrays(
        num_rows=rows, seed=DATA_SEED,
        vocab_sizes=_ints(args.vocab_sizes) or None)
    dataset = synth.in_memory(arrays, pretrain=True)
    print(json.dumps({"data": "synthazu", "rows": rows, "seed": DATA_SEED,
                      "input_size": dataset.input_size, "num_fields": dataset.num_fields,
                      "train_rows": len(dataset.Y["train"]),
                      "positive_rate": float(arrays.labels.mean()),
                      "seconds": time.perf_counter() - t0}), flush=True)
    results = []
    for seed in _ints(args.seeds):
        for stage in stages:
            r, _ = run_stage(stage, seed, dataset, args.output_dir, args.device, overrides,
                             model)
            results.append(r)
            print(json.dumps(r), flush=True)
    if model != "dcnv2":  # the zoo's one band: map_tpu's, rerun on the CPU
        zoo_rows = table(results, stages, MAP_TPU_ZOO_CPU_BAND.get(model, {}))
        print(f"{model} against map_tpu's CPU band (MAP_TPU_ZOO_CPU_BAND):")
        print_table(zoo_rows)
        print(json.dumps({"model": model, "validate_rows": zoo_rows}), flush=True)
        return 0
    table_rows = table(results, stages)
    print_table(table_rows)
    cpu_rows = table(results, [s for s in stages if s.band in MAP_TPU_CPU_BAND],
                     MAP_TPU_CPU_BAND)
    if cpu_rows:
        print("against map_tpu's CPU rerun (MAP_TPU_CPU_BAND):")
        print_table(cpu_rows)
    print(json.dumps({"validate_rows": table_rows, "validate_rows_map_tpu_cpu": cpu_rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
