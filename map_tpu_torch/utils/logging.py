"""Logging and the job-completion marker. The port's copy of
`map_tpu/utils/logging.py`:
- logs go to the console and to `{output_dir}/train.log`;
- a run whose `{output_dir}/results.log` exists is finished (idempotency);
- on success train.log is copied to results.log.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys


def setup_logging(output_dir: str, process_index: int = 0) -> logging.Logger:
    """Rank 0 logs at INFO to the console and train.log; any other rank
    warnings only, to the console (map_tpu's `setup_logging`)."""
    os.makedirs(output_dir, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(logging.INFO if process_index == 0 else logging.WARNING)
    for h in list(root.handlers):  # repeated setup (tests) must not duplicate
        root.removeHandler(h)
    fmt = logging.Formatter("%(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if process_index != 0:
        return root
    fh = logging.FileHandler(filename=train_log_path(output_dir), mode="w")
    fh.setFormatter(fmt)
    root.addHandler(fh)
    return root


def train_log_path(output_dir: str) -> str:
    return os.path.join(output_dir, "train.log")


def results_log_path(output_dir: str) -> str:
    return os.path.join(output_dir, "results.log")


def job_already_finished(output_dir: str) -> bool:
    return os.path.exists(results_log_path(output_dir))


def mark_job_finished(output_dir: str) -> None:
    shutil.copyfile(train_log_path(output_dir), results_log_path(output_dir))
