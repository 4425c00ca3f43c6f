"""What makes two data-parallel ranks' f32 parameters part from one rank's.

Two data-parallel ranks take, bit for bit, the steps of one process that
sums each batch's gradient over the batch's two row blocks
(`test_torch_port_multiprocess.py::test_data_parallel_steps_are_the_two_block_steps`).
So the ranks' drift from one rank is the drift of the two-block steps from
the one-block steps. This file runs both for 8 f32 steps from the same
weights and batches under two updates: AdamW (the port's, K1's plain
version) and a plain SGD step written here, p -= lr * g, at the largest
rate whose first step moves no element further than AdamW's does (lr; a
rate matching AdamW's mean step diverges at this size). It reports, for each, the largest gap to the one-block
parameters and the count of elements past 1e-5 after every step.
"""

import json

import numpy as np
import torch

from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.models import from_config
from map_tpu_torch.objectives.supervised import bce_loss
from map_tpu_torch.train.optimizer import build_optimizer

STEPS = 8
TOL = 1e-5  # the bound the smoke's row-sharded runs meet on every parameter
BATCH = 2048
CFG = Config(model_name="dcnv2", input_size=4000, num_fields=12, embed_size=16,
             hidden_size=384, num_hidden_layers=3, num_cross_layers=3)
TARGS = TrainingArguments(output_dir="", learning_rate=1e-3, weight_decay=0.1,
                          lr_sched="const", steps_per_call=1)


def batches():
    rng = np.random.default_rng(11)
    lo = 10 + np.arange(CFG.num_fields) * 300
    out = []
    for _ in range(STEPS):
        ids = lo + rng.zipf(1.3, (BATCH, CFG.num_fields)) % 300
        out.append({"input_ids": torch.from_numpy(ids.astype(np.int32)),
                    "labels": torch.from_numpy(rng.integers(0, 2, BATCH).astype(np.float32)),
                    "weight": torch.ones(BATCH)})
    return out


def block_gradient(model, params, b, k):
    """The batch's gradient summed over its k row blocks, each block's loss
    over the global count, as k data-parallel ranks compute it."""
    n = BATCH // k
    parts = [slice(j * n, (j + 1) * n) for j in range(k)]
    count = b["weight"][parts[0]].sum()
    for s in parts[1:]:
        count = count + b["weight"][s].sum()
    total = None
    for s in parts:
        model.train()
        loss = bce_loss(model(b["input_ids"][s]).reshape(-1), b["labels"][s],
                        b["weight"][s], count)
        for p in params:
            p.grad = None
        loss.backward()
        g = [torch.zeros_like(p) if p.grad is None else p.grad.float().contiguous()
             for p in params]
        total = g if total is None else [a + c for a, c in zip(total, g)]
    return total


def trajectories(update: str):
    """Parameters after each step, one block and two blocks side by side."""
    data = batches()
    runs = []
    for k in (1, 2):
        model = from_config(CFG, torch.Generator().manual_seed(5))
        opt, _ = build_optimizer(model, TARGS, STEPS, 0)
        params = opt.params
        states, sgd_lr = [], None
        for b in data:
            g = block_gradient(model, params, b, k)
            if update == "adamw":
                for p in params:
                    p.grad = None
                opt.step(g)
            else:
                if sgd_lr is None:  # no element's first step longer than AdamW's, lr
                    sgd_lr = TARGS.learning_rate / max(float(x.abs().max()) for x in g)
                with torch.no_grad():
                    for p, x in zip(params, g):
                        p.sub_(sgd_lr * x)
            states.append([p.detach().clone() for p in params])
        runs.append(states)
    return runs


def gaps(runs):
    """After each step: (largest |one - two|, elements past TOL)."""
    out = []
    for one, two in zip(*runs):
        d = [(a - b).abs() for a, b in zip(one, two)]
        out.append((max(float(x.max()) for x in d), sum(int((x > TOL).sum()) for x in d)))
    return out


def test_sgd_stays_within_the_bound_where_adamw_does_not():
    """The verdict of ROADMAP's data-parallel item: the first step's gap is
    rounding alone under both updates; over 8 steps plain SGD keeps every
    element within 1e-5 of one block, while AdamW moves elements whose
    second moment is near zero by about lr whatever their gradient's
    rounding, and so parts past the bound (at this size, from the second
    step on, as on the card at the canonical width)."""
    sgd, adamw = gaps(trajectories("sgd")), gaps(trajectories("adamw"))
    print(json.dumps({"sgd": sgd, "adamw": adamw}))
    assert sgd[0][0] < 1e-6 and adamw[0][0] < 1e-5
    assert max(g for g, _ in sgd) <= TOL and sgd[-1][1] == 0
    assert adamw[-1][1] > 0 and adamw[-1][0] > 10 * TOL
