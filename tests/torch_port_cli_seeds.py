"""Two CLI checks whose outcome rests on the run's seed, over seeds, on the
CPU: the supervised FM run of `test_torch_port_zoo_cli.py` (its best eval
AUC, held there above 0.6) and the RFD pretraining of
`test_torch_port_rfd.py` (its last eval accuracy less the all-"original"
guess 1 - pos_ratio, held there above 0; and whether its loss fell), each
on the tests' synthetic data (`tests/conftest.py:synth_dir`).

    python tests/torch_port_cli_seeds.py fm --seeds 40-55 [--root TREE] -- \\
        --learning_rate=3e-2 --num_train_epochs=2
    python tests/torch_port_cli_seeds.py rfd --seeds 40-55 -- \\
        --RFD_replace=Uniform --learning_rate=3e-2 --num_train_epochs=4

The flags after `--` are added to the test's own; `--root` imports the
package from another tree (a parent commit unpacked by `git archive`).
Prints one JSON line of the values, by seed. Imports map_tpu for the data.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile

COMMON = ["--dataset_name=synth", "--embed_size=8", "--compute_dtype", "float32",
          "--logging_steps=5", "--device", "cpu", "--per_device_train_batch_size=256",
          "--per_device_eval_batch_size=200"]
FM = ["--model_name=fm", "--learning_rate=1e-2", "--lr_sched=const", "--weight_decay=1e-1",
      "--num_train_epochs=2"]
RFD = ["--model_name=dcnv2", "--hidden_size=32", "--num_hidden_layers=1",
       "--num_cross_layers=2", "--pretrain", "--pt_type=RFD", "--RFD_replace=Unigram",
       "--sampling_method=randint", "--mask_ratio=0.3", "--proj_size=8",
       "--learning_rate=1e-3", "--lr_sched=cosine", "--weight_decay=5e-2",
       "--num_train_epochs=2"]
RFD_EVAL = (r"'eval_rfd_loss': ([\d.]+), 'eval_rfd_acc': ([\d.]+), "
            r"'eval_pos_ratio': ([\d.]+)")


def main() -> int:
    argv = sys.argv[1:]
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    p = argparse.ArgumentParser()
    p.add_argument("which", choices=("fm", "rfd"))
    p.add_argument("--seeds", default="40-55")
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = p.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from map_tpu.data import synth
    from map_tpu_torch.run import main as port_main

    lo, hi = (int(x) for x in args.seeds.split("-"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        synth.generate(data, name="synth", num_rows=4000, num_fields=8,
                       vocab_per_field=25, seed=0)
        for seed in range(lo, hi + 1):
            run = os.path.join(tmp, f"run{seed}")
            flags = FM if args.which == "fm" else RFD
            assert port_main(COMMON + flags + extra + [
                f"--data_dir={data}", f"--output_dir={run}", f"--seed={seed}"]) == 0
            log = open(os.path.join(run, "train.log")).read()
            if args.which == "fm":
                aucs = [float(x) for x in re.findall(r"'eval_auc': ([\d.]+)", log)]
                out[seed] = max(aucs[:-1])  # the evals, not the TEST line
            else:
                ev = [tuple(float(x) for x in m) for m in re.findall(RFD_EVAL, log)]
                out[seed] = [ev[-1][1] - (1 - ev[-1][2]), ev[-1][0] < ev[0][0]]
    print(json.dumps({"which": args.which, "root": args.root, "extra": extra,
                      "by_seed": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
