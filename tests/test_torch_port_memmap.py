"""The port's >RAM memmap mode against map_tpu's and its own in-RAM path.

The port's counterparts of map_tpu's `tests/test_memmap_dataset.py`: a
tiny host budget forces the memmap mode, whose split arrays, `feat_count`,
field ranges and Batcher stream (noise rows included) are the in-RAM
path's and map_tpu's bit for bit; the files are reused; auto keeps small
data in RAM; the budget's peak model takes the stored itemsize. Beside
them: the files one package materializes are opened by the other, two
processes materializing at once leave one writer and the same bytes, the
writer core takes rows in memory, and 5 supervised and 5 MFP Trainer steps
from the memmap dataset (resident data on and off) equal the in-RAM run's.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from map_tpu.config import TrainingArguments as JaxTrainingArguments
from map_tpu.data import artifacts as jax_artifacts
from map_tpu.data.dataset import CTRDataset as JaxCTRDataset
from map_tpu.data.loader import Batcher as JaxBatcher
from map_tpu_torch import models
from map_tpu_torch.config import ModelArguments, TrainingArguments, build_config
from map_tpu_torch.data import artifacts, native, synth
from map_tpu_torch.data.dataset import CTRDataset
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("train", "valid", "test")
FILES = [f"synth-{s}-{a}" for s in SPLITS for a in ("X.i32.mmap", "Y.f32.mmap")] + [
    "synth-mmap.done"]


def _generate(d):
    # 60,000 rows x 7 columns x 4 B x 2 ~ 3.4 MB: above a 1 MB budget
    synth.generate(str(d), name="synth", num_rows=60000, num_fields=6,
                   vocab_per_field=40, seed=11)
    return str(d)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return _generate(tmp_path_factory.mktemp("mmapdata"))


def _ds(d, budget, pretrain=True):
    return CTRDataset(d, "synth", pretrain=pretrain, host_data_budget_mb=budget)


def _jax_ds(d, budget):
    return JaxCTRDataset(JaxTrainingArguments(
        output_dir=os.path.join(d, "out"), data_dir=d, dataset_name="synth",
        host_data_budget_mb=budget, pretrain=True, pt_type="MFP"))


def _assert_same_data(a, b):
    np.testing.assert_array_equal(a.idx_low, b.idx_low)
    np.testing.assert_array_equal(a.idx_high, b.idx_high)
    assert a.idx_low.dtype == b.idx_low.dtype == np.int32
    np.testing.assert_array_equal(a.feat_count, b.feat_count)
    assert a.field_blocked_ok == b.field_blocked_ok
    for s in SPLITS:
        for x, y in ((a.X[s], b.X[s]), (a.Y[s], b.Y[s])):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_budget_forces_memmap_and_streams_match(data_dir):
    ram = _ds(data_dir, -1)
    assert not ram.memory_mapped
    lazy = _ds(data_dir, 1)  # 1 MB: anything real exceeds it
    assert lazy.memory_mapped and isinstance(lazy.X["train"], np.memmap)
    _assert_same_data(lazy, ram)
    jax_ram = _jax_ds(data_dir, -1)
    _assert_same_data(lazy, jax_ram)

    # the shuffled Batcher stream with noise rows: the in-RAM port, the
    # memmap port by np.take and by the native gather, map_tpu's
    def batcher(cls, ds, use_native=False):
        b = cls(ds.X["train"], ds.Y["train"], 64, shuffle=True, seed=7,
                noise_source=ds.X["train"], noise_rows_per_example=2)
        if use_native:
            b.native = True
        return b

    streams = [batcher(Batcher, ram), batcher(Batcher, lazy),
               batcher(Batcher, lazy, True), batcher(JaxBatcher, jax_ram)]
    calls = native.calls()
    for _, *batches in zip(range(5), *(b.epoch(0) for b in streams)):
        want = batches[0]
        for got in batches[1:]:
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    assert native.calls() - calls == 5 * 3  # labels, rows, noise rows a batch
    for _, *groups in zip(range(3), *(b.epoch_stacked(4, 1) for b in streams[:3])):
        for got in groups[1:]:
            for k in groups[0][1]:
                np.testing.assert_array_equal(got[1][k], groups[0][1][k], err_msg=k)


def test_memmap_files_are_reused(data_dir):
    _ds(data_dir, 1)
    assert os.path.exists(os.path.join(data_dir, "synth-mmap.done"))
    path = os.path.join(data_dir, "synth-train-X.i32.mmap")
    stamp = os.path.getmtime(path)
    again = _ds(data_dir, 1)  # must not write them again
    assert os.path.getmtime(path) == stamp and again.memory_mapped
    assert not os.path.exists(os.path.join(data_dir, "synth-mmap.lock"))


def test_auto_budget_keeps_small_data_in_ram(data_dir):
    assert not _ds(data_dir, 0).memory_mapped


def test_budget_model_uses_stored_itemsize(data_dir):
    """(max(stored itemsize, 4) + 4) bytes an element, as map_tpu's."""
    rows, nf, itemsize = artifacts.h5_matrix_info(data_dir, "synth")
    assert (rows, nf, itemsize) == jax_artifacts.h5_matrix_info(data_dir, "synth")
    assert (rows, nf) == artifacts.h5_dims(data_dir, "synth")
    need_mb = rows * nf * (max(itemsize, 4) + 4) / (1 << 20)
    for budget in (int(need_mb), int(need_mb) + 1):
        port, ref = _ds(data_dir, budget, False), _jax_ds(data_dir, budget)
        assert port.memory_mapped == ref.memory_mapped == (budget == int(need_mb))


@pytest.mark.parametrize("writer", ["map_tpu", "port"])
def test_files_of_one_package_are_opened_by_the_other(tmp_path, writer):
    d = _generate(tmp_path / writer)
    first, second = (_jax_ds, _ds) if writer == "map_tpu" else (_ds, _jax_ds)
    a = first(d, 1)
    stamps = {f: os.path.getmtime(os.path.join(d, f)) for f in FILES}
    b = second(d, 1)
    assert a.memory_mapped and b.memory_mapped
    assert stamps == {f: os.path.getmtime(os.path.join(d, f)) for f in FILES}
    _assert_same_data(b, a)
    assert np.array_equal(artifacts.h5_field_ranges(d, "synth", chunk_rows=7000),
                          jax_artifacts.h5_field_ranges(d, "synth", chunk_rows=7000))


def test_two_processes_materialize_at_once(tmp_path, data_dir):
    """Both processes open the memmap dataset in the same directory at the
    same time: one writes (its call returns the ranges), the other waits for
    `.done`; both read the in-RAM path's bytes."""
    d = str(tmp_path / "race")
    os.makedirs(d)
    for f in ("synth.h5", "synth-meta.json", "split.pkl"):
        shutil.copy(os.path.join(data_dir, f), d)
    code = (
        "import json, sys, numpy as np\n"
        "from map_tpu_torch.data import artifacts\n"
        "from map_tpu_torch.data.dataset import CTRDataset\n"
        "wrote = []\n"
        "real = artifacts.materialize_split_memmaps\n"
        "def spy(*a, **k):\n"
        "    r = real(*a, **k)\n"
        "    wrote.append(r is not None)\n"
        "    return r\n"
        "artifacts.materialize_split_memmaps = spy\n"
        f"ds = CTRDataset({d!r}, 'synth', host_data_budget_mb=1, chunk_rows=5000)\n"
        "x = np.asarray(ds.X['train'])\n"
        "print(json.dumps({'wrote': wrote, 'sum': int(x.astype(np.int64).sum()),"
        " 'lo': ds.idx_low.tolist(), 'mm': ds.memory_mapped}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(o["wrote"] for o in outs) == [[False], [True]]
    ram = _ds(data_dir, -1, False)
    for o in outs:
        assert o["mm"] and o["lo"] == ram.idx_low.tolist()
        assert o["sum"] == int(ram.X["train"].astype(np.int64).sum())
    for s in SPLITS:
        x, y = artifacts.open_split_memmaps(d, "synth", s, ram.num_fields)
        np.testing.assert_array_equal(x, ram.X[s])
        np.testing.assert_array_equal(y, ram.Y[s])
    assert not os.path.exists(os.path.join(d, "synth-mmap.lock"))


def test_writer_core_from_rows_in_memory(tmp_path, data_dir):
    """The split files written from (x, y) chunks in memory (no h5) are the
    h5's; a dataset opens them without the h5, its ranges the splits'."""
    ram = _ds(data_dir, -1, False)
    x, y = jax_artifacts.read_ctr_h5(data_dir, "synth")
    d = str(tmp_path / "rows")
    os.makedirs(d)
    for f in ("synth-meta.json", "split.pkl"):
        shutil.copy(os.path.join(data_dir, f), d)
    splits = artifacts.read_split(d)
    chunks = ((x[i:i + 6007], y[i:i + 6007]) for i in range(0, len(y), 6007))
    lo, hi = artifacts.materialize_split_memmaps(d, "synth", splits,
                                                 source=(len(y), x.shape[1], chunks))
    np.testing.assert_array_equal(lo, ram.idx_low)
    np.testing.assert_array_equal(hi, ram.idx_high)
    ds = _ds(d, 1, False)
    assert ds.memory_mapped
    _assert_same_data(ds, ram)


def _steps(ds, kind, resident, budget_dir, out):
    margs = ModelArguments(model_name="dcnv2", embed_size=8, hidden_size=32,
                           num_hidden_layers=2, num_cross_layers=2, proj_size=8,
                           pt_neg_num=5)
    targs = TrainingArguments(
        output_dir=str(out), data_dir=budget_dir, dataset_name="synth",
        per_device_train_batch_size=512, per_device_eval_batch_size=4096,
        learning_rate=1e-3, lr_sched="cosine", num_train_epochs=1, seed=3,
        compute_dtype="float32", device="cpu", steps_per_call=4,
        device_resident_data=resident, pretrain=kind == "mfp", pt_type="MFP",
        mask_ratio=0.3, sampling_method="randint")
    cfg = build_config(margs, targs, ds)
    trainer = Trainer(models.from_config(cfg, torch.Generator().manual_seed(3)), cfg,
                      targs, ds)
    batcher = trainer._prepare_training()
    assert (trainer._data is not None) == (resident == "auto")
    metrics = []
    for n, m, _ in trainer.train_epoch(batcher, 0):
        metrics.append(m["loss"].reshape(-1))
        if trainer.global_step >= 5:
            break
    ev = (trainer.MFP_pretrain_eval() if kind == "mfp" else None)
    return torch.cat(metrics)[:5], [p.detach().clone() for p in trainer.model.parameters()], ev


@pytest.mark.parametrize("kind", ["supervised", "mfp"])
@pytest.mark.parametrize("resident", ["auto", "off"])
def test_steps_from_memmap_equal_the_in_ram_run(tmp_path, data_dir, kind, resident):
    """5 Trainer steps (a group of 4, then one) from the memmap dataset, its
    train matrix uploaded from the memmap (`auto`) or its batches gathered
    from it on the host (`off`), are the in-RAM run's bit for bit."""
    ram, lazy = _ds(data_dir, -1), _ds(data_dir, 1)
    assert lazy.memory_mapped
    (l1, p1, e1), (l2, p2, e2) = (_steps(ds, kind, resident, data_dir, tmp_path / str(i))
                                  for i, ds in enumerate((ram, lazy)))
    assert len(l1) == 5 and torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    if kind == "mfp":
        assert e1["eval_mfp_loss"] == e2["eval_mfp_loss"]
        assert e1["eval_mfp_acc"] == e2["eval_mfp_acc"]
