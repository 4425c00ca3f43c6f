"""map_tpu_torch's resume, its checkpoint writer and the Batcher's
`start_batch`, on the CPU. Mirrors `tests/test_resume.py`,
`tests/test_async_checkpoint.py` and `tests/test_loader.py:100`.

- `Batcher.epoch` / `epoch_stacked` from `start_batch` equal the tail of
  map_tpu's Batcher stream, with and without RFD's noise rows;
- a straight run of 2 epochs equals a run stopped after its first epoch
  (as if killed there; the resume state written where a call crossed a
  multiple of `save_steps`, 5, not a multiple of 8) and resumed with
  `--resume`, bit for bit: parameters, buffers, Adam moments and count,
  the generators' states and the eval metrics, for supervised (with
  dropout), MFP and RFD (noise rows), at `steps_per_call` 1 and 8, and
  saved at one and resumed at the other (a start inside a group);
- sync, async and async-fetch saves write equal tensors;
- a writer exception is raised on the training thread.
"""

import numpy as np
import pytest
import torch

from map_tpu.data.loader import Batcher as JaxBatcher
from map_tpu_torch import models
from map_tpu_torch.config import ModelArguments, TrainingArguments, build_config
from map_tpu_torch.data import synth
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.train import checkpoints
from map_tpu_torch.train.async_writer import AsyncCheckpointWriter
from map_tpu_torch.train.trainer import Trainer

ROWS = 500  # 400 train rows: 12 batches of 32 and one of 16 an epoch
BATCH = 32
SAVE_STEPS = 5


@pytest.fixture(scope="module")
def dataset():
    return synth.in_memory(synth.generate_arrays(num_rows=ROWS, num_fields=6,
                                                 vocab_per_field=20, seed=1), pretrain=True)


def _batches(stream):
    out = []
    for item in stream:
        n, batch, _ = item if isinstance(item, tuple) else (1, item, None)
        out += [{k: v[i] for k, v in batch.items()} for i in range(n)] if n > 1 else [batch]
    return out


def _assert_streams_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("noise", [0, 3])
@pytest.mark.parametrize("start", [0, 3, 5, 12, 13])
def test_start_batch_streams_equal_map_tpus_tail(noise, start):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 500, (ROWS, 6)).astype(np.int32)
    y = rng.integers(0, 2, ROWS).astype(np.float32)
    kw = dict(batch_size=BATCH, shuffle=True, seed=9, noise_source=x if noise else None,
              noise_rows_per_example=noise)
    port, ref = Batcher(x, y, **kw), JaxBatcher(x, y, **kw)
    full = _batches(ref.epoch(2))
    _assert_streams_equal(_batches(port.epoch(2, start_batch=start)), full[start:])
    _assert_streams_equal(_batches(port.epoch(2, start_batch=start)),
                          _batches(ref.epoch(2, start_batch=start)))
    for spc in (4, 8):
        got = list(port.epoch_stacked(spc, 2, start_batch=start))
        want = list(ref.epoch_stacked(spc, 2, start_batch=start))
        assert [n for n, _, _ in got] == [n for n, _, _ in want]
        _assert_streams_equal(_batches(got), full[start:])


def _trainer(dataset, kind, out, spc, **kw):
    pretrain = kind != "supervised"
    margs = ModelArguments(model_name="dcnv2", embed_size=8, hidden_size=16,
                           num_hidden_layers=1, num_cross_layers=1,
                           hidden_dropout_rate=0.2 if kind == "supervised" else 0.0,
                           pt_neg_num=5, proj_size=8)
    targs = TrainingArguments(
        output_dir=str(out), dataset_name="synth", data_dir="",
        per_device_train_batch_size=BATCH, per_device_eval_batch_size=64,
        learning_rate=1e-3, weight_decay=0.05, lr_sched="cosine", num_train_epochs=2,
        logging_steps=4, save_steps=SAVE_STEPS, seed=3, compute_dtype="float32",
        device="cpu", steps_per_call=spc, pretrain=pretrain,
        pt_type="RFD" if kind == "rfd" else "MFP", RFD_replace="Unigram",
        mask_ratio=0.3, sampling_method="randint", **kw)
    cfg = build_config(margs, targs, dataset)
    return cfg, targs, models.from_config(cfg, torch.Generator().manual_seed(3))


def _make(dataset, kind, out, spc, cls=Trainer, **kw):
    cfg, targs, model = _trainer(dataset, kind, out, spc, **kw)
    return cls(model, cfg, targs, dataset)


def _run(trainer, kind):
    {"supervised": trainer.train, "mfp": trainer.MFP_pretrain,
     "rfd": trainer.RFD_pretrain}[kind]()
    return trainer


class _Killed(Trainer):
    """A run stopped after its first epoch, as if killed there."""

    def _epochs_with_skip(self, batcher):
        yield next(super()._epochs_with_skip(batcher))


def _state(trainer):
    return {"model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
            "mu": [m.clone() for m in trainer.optimizer.mu],
            "nu": [v.clone() for v in trainer.optimizer.nu],
            "count": trainer.optimizer.count, "step": trainer.global_step,
            "gens": [g.get_state() for g in (trainer._dropout_generator,
                                             trainer._step_generator) if g is not None],
            "eval": [list(m) for m in trainer.eval_metrics]}


def _assert_states_equal(got, ref):
    assert got["step"] == ref["step"] and got["count"] == ref["count"]
    assert sorted(got["model"]) == sorted(ref["model"])
    for k in ref["model"]:
        assert torch.equal(got["model"][k], ref["model"][k]), k
    for part in ("mu", "nu", "gens"):
        assert len(got[part]) == len(ref[part])
        for a, b in zip(got[part], ref[part]):
            assert torch.equal(a, b), part
    assert got["eval"] == ref["eval"]


@pytest.mark.parametrize("kind,spc,resume_spc", [
    ("supervised", 1, 1), ("supervised", 8, 8), ("mfp", 1, 1), ("mfp", 8, 8),
    ("rfd", 1, 1), ("rfd", 8, 8), ("supervised", 1, 8), ("rfd", 1, 8)])
def test_resume_equals_the_straight_run(dataset, tmp_path, kind, spc, resume_spc):
    straight = _state(_run(_make(dataset, kind, tmp_path / "straight", spc), kind))
    killed = _run(_make(dataset, kind, tmp_path / "part", spc, cls=_Killed), kind)
    assert killed.global_step == 13 and checkpoints.has_resume_state(str(tmp_path / "part"))
    saved_at = checkpoints.load_train_state(str(tmp_path / "part"))[1]["global_step"]
    # the last call that crossed a multiple of 5: 10 in a single-step call;
    # with 8 a call, the tail call ending at 10
    assert saved_at == 10
    resumed = _make(dataset, kind, tmp_path / "part", resume_spc, resume=True)
    _run(resumed, kind)
    _assert_states_equal(_state(resumed), straight)


def test_resume_without_a_state_starts_afresh(dataset, tmp_path):
    ref = _state(_run(_make(dataset, "supervised", tmp_path / "a", 8), "supervised"))
    got = _run(_make(dataset, "supervised", tmp_path / "b", 8, resume=True), "supervised")
    _assert_states_equal(_state(got), ref)


def _saved(out):
    state, meta = checkpoints.load_train_state(str(out))
    models_ = {p.name: torch.load(p, weights_only=True) for p in out.glob("*.model")}
    return state, meta, models_


@pytest.mark.parametrize("kind", ["supervised", "mfp"])
def test_async_and_sync_saves_write_equal_tensors(dataset, tmp_path, kind):
    runs = {}
    for name, kw in (("sync", dict(async_checkpoint=False)), ("async", {}),
                     ("fetch", dict(async_checkpoint_fetch=True))):
        t = _run(_make(dataset, kind, tmp_path / name, 8, **kw), kind)
        assert not t._ckpt_writer.busy  # the run's end waited for the writer
        runs[name] = _saved(tmp_path / name)
    ref_state, ref_meta, ref_models = runs["sync"]
    for name in ("async", "fetch"):
        state, meta, got_models = runs[name]
        assert meta == ref_meta and sorted(got_models) == sorted(ref_models)
        for key in ("model",):
            for k, v in ref_state[key].items():
                assert torch.equal(state[key][k], v), (name, k)
        for part in ("mu", "nu"):
            for a, b in zip(state["optimizer"][part], ref_state["optimizer"][part]):
                assert torch.equal(a, b), (name, part)
        for fname, sd in ref_models.items():
            for k, v in sd.items():
                assert torch.equal(got_models[fname][k], v), (name, fname, k)


def test_writer_reraises_a_job_exception(dataset, tmp_path, monkeypatch):
    w = AsyncCheckpointWriter()
    w.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    w.wait()  # raised once

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints, "save_train_state", fail)
    with pytest.raises(OSError, match="disk full"):
        _run(_make(dataset, "supervised", tmp_path / "x", 1), "supervised")
