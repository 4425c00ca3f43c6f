"""One rank of a launched run that reports its results: the training CLI
(`map_tpu_torch.run`) with the same flags, then one line on stdout,

    RANK_RESULT {"rank": r, "world": n, "eval_metrics": [...], ...}

with the rank's eval metrics (every rank computes them), its streaming-AUC
bins (0: the exact eval), its dispatch (steps a call, graphs or eager),
its train windows and FGCNN's BatchNorm running statistics. Launched by

    python -m map_tpu_torch.parallel.launch --nprocs N \\
        --module map_tpu_torch.parallel.worker -- <run.py flags> [--stop_after_epochs K]

`--stop_after_epochs K` ends training after K epochs of the schedule's
(a run stopped there, for the resume checks: its resume state and eval
metrics are those of a run killed at that point).
"""

from __future__ import annotations

import json
import sys


def report(trainer) -> None:
    bn = {k: v.double().cpu().tolist() for k, v in trainer.model.state_dict().items()
          if k.endswith(("running_mean", "running_var"))}
    print("RANK_RESULT " + json.dumps({
        "rank": trainer.mesh.rank, "world": trainer.world,
        "mesh": [trainer.mesh.num_data, trainer.mesh.num_model],
        "eval_metrics": trainer.eval_metrics,
        "streaming_bins": trainer._streaming_bins,
        "steps_per_call": trainer._spc,
        "graphed": bool(trainer.multi is not None and trainer.multi.graphed),
        "global_step": trainer.global_step,
        "windows": trainer.train_windows, "bn": bn,
        "resident": trainer._data is not None,
        "param_sum": float(sum(p.double().sum() for p in trainer.model.parameters())),
    }, allow_nan=True), flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    stop = None
    if "--stop_after_epochs" in argv:
        i = argv.index("--stop_after_epochs")
        stop = int(argv[i + 1])
        del argv[i:i + 2]
    from map_tpu_torch import run
    from map_tpu_torch.train.trainer import Trainer

    if stop is not None:
        full = Trainer._epochs_with_skip

        def first_epochs(self, batcher):
            for epoch, start in full(self, batcher):
                if epoch >= stop:
                    return
                yield epoch, start

        Trainer._epochs_with_skip = first_epochs
    return run.main(argv, on_trainer=report)


if __name__ == "__main__":
    sys.exit(main())
