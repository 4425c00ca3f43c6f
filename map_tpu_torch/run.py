"""Training CLI. Counterpart: `map_tpu/run.py`.

    python -m map_tpu_torch.run --model_name=dcnv2 --output_dir=out \\
        --dataset_name=avazu --data_dir=data/avazu \\
        --per_device_train_batch_size=4096 --per_device_eval_batch_size=10000 \\
        --learning_rate=1e-3 --lr_sched=const --weight_decay=1e-1 \\
        --num_train_epochs=1 --embed_size=16 --hidden_size=1000 \\
        --num_hidden_layers=3 --num_cross_layers=3 [--device cpu]

takes the flags of `run_script/run_DCNv2_scratch.sh`; with `--pretrain
--pt_type=MFP --mask_ratio=0.3 --sampling_method=randint --pt_neg_num=25
--proj_size=32` those of `run_DCNv2_MFP.sh`, and with `--finetune
--pretrained_model_path=<dir>/<step>.model` those of `run_DCNv2_finetune.sh`;
with `--pretrain --pt_type=RFD --RFD_replace=Unigram --sampling_method=randint
--mask_ratio=0.3 --proj_size=32` those of `run_DCNv2_RFD.sh` (RFD_replace:
Unigram | Uniform | Whole-Uniform | Whole-Unigram).
MFP takes map_tpu's noise modes and losses: `--pt_shared_noise`,
`--pt_per_field_noise` (both: one noise set per field a step),
`--nce_loss_type=nce|sampled|full`, and `--sparse_table_update` (the decoder
table's AdamW from its gradient streams, in a shared mode without a clip).
The embedding lookup is field-blocked by default (`--no-field_blocked_lookup`
turns it off) with `--hybrid_mode=fwd|fwd_split|matmul|both|bwd|bwd_pallas`
(default: matmul for MFP, fwd otherwise).
Run management as map_tpu's: `--save_steps` (the resume state) and
`--resume`, `--async_checkpoint` / `--async_checkpoint_fetch`,
`--streaming_auc` / `--auc_bins`, `--profile_steps`; every logged window
and eval also goes to `{output_dir}/metrics.jsonl` (`train/trainer.py`).
Parallel runs (`parallel/`): `--num_model_shards` (row-sharded tables),
`--num_data_shards`, `--table_exchange=psum|hotcold`,
`--hot_rows_per_field`, `--exact_eval_allgather`; the process group is
made from map_tpu's MAP_TPU_COORDINATOR / MAP_TPU_NUM_PROCESSES /
MAP_TPU_PROCESS_ID or torchrun's variables (`parallel/mesh.
maybe_init_distributed`, before the Trainer, as in map_tpu `run.py:28-43`);
`--mock_devices N` launches N local gloo ranks of this CLI
(`parallel/launch.py`). Rank 0 writes the run directory's files.
Lifecycle as map_tpu's: parse -> idempotency check (results.log exists ->
exit) -> logging -> dataset -> config.json -> model from --seed (finetune:
restored from the checkpoint where names and shapes match) -> train and test
on the best step, or MFP or RFD pretraining (no test phase) -> train.log
copied to results.log. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import sys

from map_tpu_torch import models
from map_tpu_torch.config import build_config, parse_args
from map_tpu_torch.train.trainer import Trainer
from map_tpu_torch.utils.logging import (
    job_already_finished,
    mark_job_finished,
    setup_logging,
)
from map_tpu_torch.utils.seeds import stream_generator


def main(argv=None, on_trainer=None) -> int:
    """The CLI; `on_trainer(trainer)`, if given, is called once the run
    ends (`parallel/worker.py` reports each rank's results through it)."""
    model_args, training_args = parse_args(argv)  # raises on an unknown pretraining
    if training_args.mock_devices > 0 and world_size_from_env() <= 1:
        from map_tpu_torch.parallel.launch import launch

        args = list(sys.argv[1:] if argv is None else argv)
        results = launch(training_args.mock_devices, args, backend="gloo")
        return max((abs(r.returncode) for r in results), default=0)
    if job_already_finished(training_args.output_dir):
        print("job already finished, quit")
        return 0
    import torch.distributed as dist

    from map_tpu_torch.parallel.mesh import maybe_init_distributed, rank

    maybe_init_distributed()
    logger = setup_logging(training_args.output_dir, rank())
    logger.info(f"training/evaluation parameters {training_args}")

    from map_tpu_torch.data.dataset import CTRDataset

    dataset = CTRDataset(training_args.data_dir, training_args.dataset_name,
                         pretrain=training_args.pretrain,
                         host_data_budget_mb=training_args.host_data_budget_mb)
    config = build_config(model_args, training_args, dataset)
    if rank() == 0:
        config.save(training_args.output_dir)
    model = models.from_config(config, stream_generator(training_args.seed, "init"))
    trainer = Trainer(model, config, training_args, dataset)
    if config.mfp:
        trainer.MFP_pretrain()
    elif config.rfd:
        trainer.RFD_pretrain()
    else:
        trainer.train()
        trainer.test()
    if on_trainer is not None:
        on_trainer(trainer)
    if rank() == 0:
        mark_job_finished(training_args.output_dir)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def world_size_from_env() -> int:
    import os

    for name in ("MAP_TPU_NUM_PROCESSES", "WORLD_SIZE"):
        if os.environ.get(name):
            return int(os.environ[name])
    return 1


if __name__ == "__main__":
    sys.exit(main())
