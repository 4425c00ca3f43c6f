"""Multi-rank runs of the port on the CPU: N gloo ranks on localhost, each
a process of `python -m map_tpu_torch.parallel.worker` (the training CLI,
which reports every rank's results), launched by
`map_tpu_torch.parallel.launch`. The port's counterparts of map_tpu's
`tests/test_multiprocess.py:21-137`: the same global batches and seeds on
N ranks and on one must give the same eval, and the ranks must agree with
each other exactly. The worker processes import torch only. The
row-sharded MFP run and FGCNN's BatchNorm are in
`test_torch_port_multiprocess_mfp.py` (the two files run on two workers).
"""

import json
import os

import numpy as np
import pytest
import torch

from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.data import synth
from map_tpu_torch.models import from_config
from map_tpu_torch.parallel.launch import launch
from map_tpu_torch.train.optimizer import build_optimizer
from map_tpu_torch.train.train_step import make_supervised_steps

from test_torch_port_parallel_ops import run_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpdata")
    dirs = {}
    for name, rows, seed in (("sup", 2000, 3), ("mfp", 1500, 5)):
        dirs[name] = str(root / name)
        synth.generate(dirs[name], name="synth", num_rows=rows, num_fields=6,
                       vocab_per_field=30, seed=seed)
    return dirs


def run_ranks(nprocs, flags, out_dir, timeout=240):
    """Each rank's RANK_RESULT, in rank order."""
    env_path = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = env_path
    results = launch(nprocs, [*flags, f"--output_dir={out_dir}"],
                     module="map_tpu_torch.parallel.worker", backend="gloo",
                     timeout=timeout, capture=True)
    reports = []
    for r in results:
        assert r.returncode == 0, (r.stdout or "")[-2000:] + (r.stderr or "")[-3000:]
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("RANK_RESULT ")]
        assert line, r.stdout[-2000:]
        reports.append(json.loads(line[0][len("RANK_RESULT "):]))
    return reports


def model_flags(data_dir, model="dcnv2"):
    return [f"--model_name={model}", "--dataset_name=synth", f"--data_dir={data_dir}",
            "--device", "cpu", "--compute_dtype", "float32", "--embed_size=8",
            "--hidden_size=32", "--num_hidden_layers=2", "--num_cross_layers=2",
            "--hidden_dropout_rate=0.0", "--learning_rate=1e-3", "--weight_decay=0.1",
            "--lr_sched=const", "--num_train_epochs=1", "--steps_per_call=4", "--seed=42"]


def batch_flags(nprocs, train=128, evalb=64, data_axis=None):
    d = nprocs if data_axis is None else data_axis
    return [f"--per_device_train_batch_size={train // d}",
            f"--per_device_eval_batch_size={evalb // d}"]


def _agree(reports, key="eval_metrics"):
    for r in reports[1:]:
        np.testing.assert_allclose(r[key], reports[0][key], rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def one_rank_sup(data_dirs, tmp_path_factory):
    out = tmp_path_factory.mktemp("sup1")
    return run_ranks(1, model_flags(data_dirs["sup"]) + batch_flags(1)
                     + ["--logging_steps=5", "--exact_eval_allgather"], out)[0]


SUP_FLAGS = ["--logging_steps=5"]


@pytest.fixture(scope="module")
def two_rank_sup(data_dirs, tmp_path_factory):
    out = tmp_path_factory.mktemp("sup2")
    flags = model_flags(data_dirs["sup"]) + batch_flags(2) + SUP_FLAGS
    return run_ranks(2, flags + ["--exact_eval_allgather"], out), out


@pytest.mark.parametrize("nprocs", [2, 4])
def test_multi_rank_train_matches_one_rank(data_dirs, one_rank_sup, two_rank_sup,
                                           tmp_path, nprocs):
    """Supervised, data-parallel: the exact eval AUC of N ranks equals one
    rank's within 2e-5, the ranks agree to 1e-9; gloo runs one eager step a
    call (the dispatch rule) and the window logs are tagged shard-local. With
    no flags a 2-rank run picks the streaming AUC, within 5e-4."""
    flags = model_flags(data_dirs["sup"]) + batch_flags(nprocs) + SUP_FLAGS
    if nprocs == 2:
        exact, out = two_rank_sup
    else:
        exact, out = run_ranks(nprocs, flags + ["--exact_eval_allgather"],
                               tmp_path / "exact"), tmp_path / "exact"
    _agree(exact)
    assert abs(exact[0]["eval_metrics"][-1][0] - one_rank_sup["eval_metrics"][-1][0]) < 2e-5
    assert all(r["streaming_bins"] == 0 and r["world"] == nprocs for r in exact)
    assert one_rank_sup["steps_per_call"] == 4 and one_rank_sup["world"] == 1
    assert all(r["steps_per_call"] == 1 and not r["graphed"] for r in exact)
    log = open(out / "train.log").read()
    assert "dispatch = one eager step a call (gloo collectives cannot be captured)" in log
    assert f"[shard-local metrics, 1 of {nprocs} processes]" in log
    records = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert records and all(r["process_count"] == nprocs for r in records)
    if nprocs != 2:
        return
    stream = run_ranks(nprocs, flags, tmp_path / "stream")
    assert all(r["streaming_bins"] > 0 for r in stream)
    _agree(stream)
    assert abs(stream[0]["eval_metrics"][-1][0] - exact[0]["eval_metrics"][-1][0]) < 5e-4


def test_two_rank_device_resident_matches_host_pipeline(data_dirs, two_rank_sup,
                                                        tmp_path):
    """device_resident_data=on over 2 ranks (each rank's block of the
    batch rebuilt on the device from the global batch number) gives the
    host pipeline's AUC; auto stays off with more than one rank."""
    flags = model_flags(data_dirs["sup"]) + batch_flags(2) + SUP_FLAGS
    host = two_rank_sup[0]
    res = run_ranks(2, flags + ["--exact_eval_allgather", "--device_resident_data=on"],
                    tmp_path / "res")
    assert not host[0]["resident"] and res[0]["resident"]
    _agree(res)
    assert abs(host[0]["eval_metrics"][-1][0] - res[0]["eval_metrics"][-1][0]) < 1e-9


def test_loss_over_the_global_count_on_a_padded_batch():
    """A padded last batch whose real rows all sit on rank 0: the 2-rank step
    (the loss over the global weight sum, the gradients summed over the data
    group as one flat buffer) equals the 1-rank step on the whole batch; the
    mean of the ranks' own means would not."""
    cfg = Config(model_name="dnn", input_size=50, num_fields=4, embed_size=4,
                 hidden_size=8, num_hidden_layers=1)
    targs = TrainingArguments(output_dir="", learning_rate=1e-2, lr_sched="const",
                              steps_per_call=1)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (16, 4)).astype(np.int32)
    labels = rng.integers(0, 2, 16).astype(np.float32)
    weight = (np.arange(16) < 5).astype(np.float32)

    def step(rows, group=None):
        model = from_config(cfg, torch.Generator().manual_seed(1))
        opt, _ = build_optimizer(model, targs, 4, 0, grad_group=group)
        train, _ = make_supervised_steps(model, opt, torch.device("cpu"), dp=group)
        out = train({"input_ids": ids[rows], "labels": labels[rows], "weight": weight[rows]})
        return float(out["loss"]), [p.detach().clone() for p in model.parameters()]

    loss1, params1 = step(slice(0, 16))
    two = run_shards(2, lambda m, i: step(slice(8 * i, 8 * i + 8), m))
    for loss, params in two:
        assert abs(loss - loss1) < 1e-6
        for a, b in zip(params, params1):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    own_means = [step(slice(8 * i, 8 * i + 8))[0] for i in range(2)]
    assert abs(np.mean(own_means) - loss1) > 1e-3


def test_data_parallel_steps_are_the_two_block_steps():
    """Two data-parallel ranks (the loss over the global count, the
    gradients summed as one flat buffer) take, bit for bit, the steps of
    one process that sums each batch's gradient over its two row blocks,
    the blocks' losses over the global count; the first step's gradient
    lies within 1e-5 of each leaf's largest one-block gradient. The smoke
    holds the card's two ranks to the same witness."""
    from map_tpu_torch.objectives.supervised import bce_loss

    cfg = Config(model_name="dcnv2", input_size=60, num_fields=4, embed_size=4,
                 hidden_size=8, num_hidden_layers=2, num_cross_layers=2)
    targs = TrainingArguments(output_dir="", learning_rate=1e-2, weight_decay=0.1,
                              lr_sched="const", steps_per_call=1)
    rng = np.random.default_rng(1)
    steps = [{"input_ids": rng.integers(10, 60, (16, 4)).astype(np.int32),
              "labels": rng.integers(0, 2, 16).astype(np.float32),
              "weight": np.ones(16, np.float32)} for _ in range(3)]

    def ranks(member, i):
        model = from_config(cfg, torch.Generator().manual_seed(2))
        opt, _ = build_optimizer(model, targs, 3, 0, grad_group=member)
        train, _ = make_supervised_steps(model, opt, torch.device("cpu"), dp=member)
        losses = [train({k: v[8 * i:8 * i + 8] for k, v in b.items()})["loss"] for b in steps]
        return torch.stack(losses), [p.detach().clone() for p in model.parameters()]

    def blocks(k):
        model = from_config(cfg, torch.Generator().manual_seed(2))
        opt, _ = build_optimizer(model, targs, 3, 0)
        losses, first = [], None
        for b in steps:
            t = {key: torch.from_numpy(v) for key, v in b.items()}
            parts = [slice(j * 16 // k, (j + 1) * 16 // k) for j in range(k)]
            count = t["weight"][parts[0]].sum()
            for s in parts[1:]:
                count = count + t["weight"][s].sum()
            total, parts_loss = None, []
            for s in parts:
                model.train()
                part = bce_loss(model(t["input_ids"][s]).reshape(-1), t["labels"][s],
                                t["weight"][s], count)
                opt.zero_grad()
                part.backward()
                g = [p.grad.float().contiguous() for p in opt.params]
                total = g if total is None else [a + c for a, c in zip(total, g)]
                parts_loss.append(part.detach())
            loss = parts_loss[0]
            for x in parts_loss[1:]:
                loss = loss + x
            first = first or [x.clone() for x in total]
            opt.zero_grad()
            opt.step(total)
            losses.append(loss)
        return torch.stack(losses), [p.detach().clone() for p in model.parameters()], first

    two = run_shards(2, ranks)
    split_losses, split_params, split_first = blocks(2)
    *_, one_first = blocks(1)
    for losses, params in two:
        assert torch.equal(losses, split_losses)
        assert all(torch.equal(a, b) for a, b in zip(params, split_params))
    for a, b in zip(one_first, split_first):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_data_axis_follows_the_mesh():
    """The global batch is per device x the data axis of the mesh that
    `build_mesh` lays out: 1 without a process group whatever the flags
    (the mesh is 1 x 1 there), and a data axis that does not fill the world
    raises, as `build_mesh` does."""
    import torch.distributed as dist

    from map_tpu_torch.parallel.launch import free_port
    from map_tpu_torch.parallel.mesh import build_mesh, data_parallel_size

    args = TrainingArguments(output_dir="", per_device_train_batch_size=8,
                             per_device_eval_batch_size=4, num_data_shards=2)
    assert args.train_batch_size == 8 and args.eval_batch_size == 4
    assert build_mesh(2, 1).num_data == 1
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
            data_parallel_size(args)
        with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
            build_mesh(2, 1)
        args.num_data_shards = -1
        assert args.train_batch_size == 8 and data_parallel_size(args) == 1
    finally:
        dist.destroy_process_group()
