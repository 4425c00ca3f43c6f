"""map_tpu_torch's input pipeline against map_tpu's on the CPU.

The Batcher's index batches (`emit_indices`, and `emit_start_only` for
stream v2) and its stacked groups (`epoch_stacked`) against map_tpu's
Batcher on the same arrays; `train_step.resident_batch` rebuilding them on
the device into the host batches bit for bit (the padded tail and RFD's
noise rows included) and into what map_tpu's `_resident_batch` rebuilds;
the Trainer's choice of the resident path (`device_resident_data`), its
epoch order on the device, and the prefetch thread's errors.
"""

import logging
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu.data.loader import Batcher as JaxBatcher
from map_tpu.train.train_step import _resident_batch as jax_resident_batch
from map_tpu_torch import models
from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.train.train_step import (
    ResidentData,
    device_batch,
    resident_batch,
    to_device,
)
from map_tpu_torch.train.trainer import Trainer

ROWS, FIELDS, BATCH, M = 1037, 6, 128, 3  # 9 batches, the last one 13 rows
MODES = [(False, False), (True, False), (True, True)]  # host, index, stream v2
CPU = torch.device("cpu")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 5000, (ROWS, FIELDS)).astype(np.int32)
    y = rng.integers(0, 2, ROWS).astype(np.float32)
    return x, y


def _batchers(m, emit_indices, start_only, shuffle=True):
    """The port's and map_tpu's Batcher on the same arrays, in one mode."""
    x, y = _arrays()
    out = []
    for cls in (Batcher, JaxBatcher):
        b = cls(x, y, batch_size=BATCH, shuffle=shuffle, seed=7,
                noise_source=x if m else None, noise_rows_per_example=m)
        b.emit_indices, b.emit_start_only = emit_indices, start_only
        out.append(b)
    return out


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _resident(x, y, order, batch_size):
    total = -(-len(order) // batch_size) * batch_size
    perm = np.zeros(total, np.int32)
    perm[:len(order)] = order
    return ResidentData(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(perm), batch_size)


@pytest.mark.parametrize("m", [0, M])
@pytest.mark.parametrize("emit_indices,start_only", MODES)
@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_stream_matches_map_tpu(m, emit_indices, start_only, shuffle):
    port, ref = _batchers(m, emit_indices, start_only, shuffle)
    got, want = list(port.epoch(2)), list(ref.epoch(2))
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("m", [0, M])
@pytest.mark.parametrize("emit_indices,start_only", MODES)
@pytest.mark.parametrize("spc", [4, 3, 1])
def test_stacked_groups_match_map_tpu_and_the_epoch(m, emit_indices, start_only, spc):
    port, ref = _batchers(m, emit_indices, start_only)
    got, want = list(port.epoch_stacked(spc, 1)), list(ref.epoch_stacked(spc, 1))
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    # 8 full batches: groups of spc, then the rest and the padded last one alone
    assert sum(n for n, _, _ in got) == 9 and got[-1][0] == 1
    for (_, a, views_a), (_, b, views_b) in zip(got, want):
        _assert_batches_equal(a, b)
        for va, vb in zip(views_a, views_b):
            _assert_batches_equal(va, vb)
    flat = list(port.epoch(1))
    for va, vb in zip([v for _, _, views in got for v in views], flat):
        _assert_batches_equal(va, vb)


@pytest.mark.parametrize("m", [0, M])
@pytest.mark.parametrize("start_only", [False, True])
def test_resident_batch_rebuilds_the_host_batches(m, start_only):
    host, _ = _batchers(m, False, False)
    index, _ = _batchers(m, True, start_only)
    x, y = _arrays()
    data = _resident(x, y, index.order(0)[0], BATCH)
    for want, idx_batch in zip(host.epoch(0), index.epoch(0)):
        sent = to_device(idx_batch, CPU)
        # labels and weight stay on the host for the window AUC
        assert "labels" not in sent and "weight" not in sent
        got = resident_batch(sent, data)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.from_numpy(want[k]).dtype, k
            assert torch.equal(got[k], torch.from_numpy(want[k])), k
        assert torch.equal(device_batch(idx_batch, CPU, data)["input_ids"], got["input_ids"])
    assert want["weight"].sum() == ROWS - 8 * BATCH  # the padded tail was among them


@pytest.mark.parametrize("m", [0, M])
@pytest.mark.parametrize("start_only", [False, True])
def test_resident_batch_matches_map_tpu(m, start_only):
    port, ref = _batchers(m, True, start_only)
    x, y = _arrays()
    data = _resident(x, y, port.order(3)[0], BATCH)
    jdata = {"x": jnp.asarray(x), "y": jnp.asarray(y), "perm": jnp.asarray(data.perm.numpy())}
    for mine, theirs in zip(port.epoch(3), ref.epoch(3)):
        got = resident_batch(to_device(mine, CPU), data)
        dev = {k: jnp.asarray(v) for k, v in theirs.items() if k not in ("labels", "weight")}
        want = jax_resident_batch(dev, jdata, BATCH)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_index_batch_needs_the_resident_data():
    index, _ = _batchers(0, True, True)
    with pytest.raises(ValueError):
        device_batch(next(index.epoch(0)), CPU)


# ---- the Trainer's side: the resident data and the stream ------------------------

def _trainer(**kw):
    x, y = _arrays()
    data = SimpleNamespace(X={"train": x, "valid": x[:300], "test": x[:300]},
                           Y={"train": y, "valid": y[:300], "test": y[:300]})
    cfg = Config(model_name="dcnv2", input_size=5000, num_fields=FIELDS, embed_size=4,
                 hidden_size=8, num_hidden_layers=1, num_cross_layers=1)
    args = TrainingArguments(per_device_train_batch_size=BATCH, device="cpu", seed=7,
                             num_train_epochs=2, **kw)
    return Trainer(models.from_config(cfg, torch.Generator().manual_seed(0)), cfg, args,
                   data)


@pytest.mark.parametrize("mode,budget,resident", [
    ("auto", 8.0, True), ("auto", 1e-6, False), ("on", 1e-6, True), ("off", 8.0, False)])
def test_resident_data_follows_map_tpus_rule(mode, budget, resident, caplog):
    trainer = _trainer(device_resident_data=mode, device_data_budget_gb=budget)
    with caplog.at_level(logging.INFO):
        trainer._setup_resident_data(trainer.get_batcher("train", True))
    assert (trainer._data is not None) == resident
    lines = [r.getMessage() for r in caplog.records if "device-resident" in r.getMessage()]
    if mode == "off":
        assert not lines
    else:  # map_tpu's lines: a warning first when forced past the budget
        assert len(lines) == (2 if mode == "on" and budget < 1 else 1)
        assert lines[-1].startswith("device-resident data: on" if resident
                                    else "device-resident data: off")
    if resident:
        assert trainer._stream_v2 and trainer._data.perm.numel() == 9 * BATCH
        x, y = _arrays()
        assert torch.equal(trainer._data.x, torch.from_numpy(x))
        assert torch.equal(trainer._data.y, torch.from_numpy(y))


def test_epoch_order_on_the_device_is_the_batchers():
    trainer = _trainer(device_resident_data="on")
    batcher = trainer.get_batcher("train", True)
    trainer._setup_resident_data(batcher)
    for epoch in (0, 1):
        trainer._ensure_epoch_perm(epoch, batcher)
        order = batcher.order(epoch)[0]
        perm = trainer._data.perm.numpy()
        np.testing.assert_array_equal(perm[:ROWS], order)
        assert not perm[ROWS:].any()  # the padded tail takes row 0


def test_prefetch_error_reaches_the_caller():
    trainer = _trainer()
    x, y = _arrays()
    batch = {"input_ids": x[:BATCH], "labels": y[:BATCH], "weight": np.ones(BATCH, np.float32)}

    def batches():
        yield 1, batch, [batch]
        yield 1, batch, [batch]
        raise RuntimeError("the batcher broke")

    got = []
    with pytest.raises(RuntimeError, match="the batcher broke"):
        for n, dev_batch, views in trainer._grouped_stream(batches()):
            got.append(dev_batch)
    assert len(got) == 2 and torch.equal(got[0]["input_ids"], torch.from_numpy(x[:BATCH]))


def test_prefetch_stops_when_the_caller_does():
    trainer = _trainer(prefetch_batches=1)
    x, y = _arrays()
    batch = {"input_ids": x[:BATCH], "labels": y[:BATCH], "weight": np.ones(BATCH, np.float32)}
    made = []

    def batches():
        for i in range(100):
            made.append(i)
            yield 1, batch, [batch]

    stream = trainer._grouped_stream(batches())
    next(stream)
    stream.close()  # the consumer leaves: the producer must not hang on its queue
    assert len(made) < 100


def test_pipeline_flags_take_map_tpus_defaults():
    from map_tpu import config as jax_config
    from map_tpu_torch.config import parse_args

    ref = jax_config.TrainingArguments()
    _, args = parse_args([])
    for name in ("steps_per_call", "prefetch_batches", "device_resident_data",
                 "device_data_budget_gb"):
        assert getattr(args, name) == getattr(ref, name), name
    _, args = parse_args(["--steps_per_call=1", "--device_resident_data=off",
                          "--prefetch_batches=3", "--device_data_budget_gb=0.5"])
    assert (args.steps_per_call, args.device_resident_data, args.prefetch_batches,
            args.device_data_budget_gb) == (1, "off", 3, 0.5)
    with pytest.raises(ValueError):
        parse_args(["--device_resident_data=maybe"])
