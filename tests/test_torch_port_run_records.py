"""map_tpu_torch's run records against map_tpu's on the CPU: metrics.jsonl,
the streaming AUC and profile_steps. Mirrors `tests/test_metrics_jsonl.py`,
`tests/test_streaming_eval.py` and `tests/test_profiler_hook.py`.

- metrics.jsonl: the same (kind, step) sequence and key sets as map_tpu's
  for the same supervised (2 epochs, from carried weights, the values
  within 1e-5) and RFD runs (MFP's: `test_torch_port_validate.py`, which
  reads them); strict JSON, non-finite values null;
- resume against map_tpu: the port's run stopped after its first epoch and
  resumed gives map_tpu's straight run's parameters and test metrics within
  1e-5 (f32);
- streaming AUC: the histogram helpers equal map_tpu's; the streaming eval
  step's count, ll_sum, logit_sum and prob_sum equal map_tpu's within 1e-5
  on the same weights and batches, its AUC is within 1e-4 of map_tpu's and
  within the error bound of the exact AUC; coarse bins escalate;
- `--profile_steps 2` writes a trace under `{output_dir}/profile`.
"""

import json
import math
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu import config as jax_config
from map_tpu import models as jax_models
from map_tpu.data.dataset import CTRDataset as JaxDataset
from map_tpu.data.loader import Batcher as JaxBatcher
from map_tpu.run import main as jax_main
from map_tpu.train import train_step as jax_ts
from map_tpu.train.trainer import Trainer as JaxTrainer
from map_tpu.utils import metrics as jax_metrics
from map_tpu_torch import models
from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.data.dataset import CTRDataset
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.run import main as port_main
from map_tpu_torch.train.train_step import make_supervised_steps
from map_tpu_torch.train.trainer import Trainer
from map_tpu_torch.utils import metrics

JAX_DEVICES = 8  # conftest's virtual CPU devices: map_tpu's batch is per device
BATCH, EVAL_BATCH = 256, 200
BINS = 4096
TIMING_KEYS = {"time", "time_cost", "eval_time_cost", "examples_per_sec"}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _records(out_dir):
    with open(os.path.join(str(out_dir), "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]  # strict JSON, every line


@pytest.fixture(scope="module")
def jax_supervised(synth_dir, tmp_path_factory):
    """map_tpu's supervised run, 2 epochs in f32 from its Trainer's own
    initial weights (kept for the port), and its streaming eval step's
    outputs on the valid split from the weights it ends with."""
    out = tmp_path_factory.mktemp("jax_supervised")
    model_args, targs = jax_config.parse_args([
        "--model_name", "dcnv2", "--dataset_name", "synth", "--data_dir", synth_dir,
        "--output_dir", str(out), "--compute_dtype", "float32",
        "--per_device_train_batch_size", str(BATCH // JAX_DEVICES),
        "--per_device_eval_batch_size", str(EVAL_BATCH // JAX_DEVICES),
        "--learning_rate", "1e-3", "--lr_sched", "const", "--weight_decay", "0.1",
        "--num_train_epochs", "2", "--embed_size", "8", "--hidden_size", "32",
        "--num_hidden_layers", "1", "--num_cross_layers", "2", "--logging_steps", "5",
        "--steps_per_call", "1"])
    ds = JaxDataset(targs)
    cfg = jax_config.build_config(model_args, targs, ds)
    model = jax_models.from_config(cfg)
    init_rng = jax.random.split(jax.random.PRNGKey(targs.seed), 3)[0]
    init = _np(model.init({"params": init_rng, "dropout": jax.random.fold_in(init_rng, 1)},
                          jnp.zeros((2, cfg.num_fields), jnp.int32), train=False))
    trainer = JaxTrainer(model, cfg, targs, ds)
    trainer.train()
    final = {"params": _np(trainer.state.params)}
    _, eval_step = jax_ts.make_supervised_steps(model, cfg, targs, trainer._tx,
                                                trainer._step_rng, streaming_bins=BINS)
    batcher = JaxBatcher(ds.X["valid"], ds.Y["valid"], EVAL_BATCH, shuffle=False)
    stream = [jax.device_get(eval_step(trainer.state, b)) for b in batcher.epoch(0)]
    test = trainer.test()
    return SimpleNamespace(cfg=cfg, init=init, final=final, out=out, stream=stream,
                           test=test)


def _port_trainer(jax_run, synth_dir, out, cls=Trainer, **kw):
    cfg = Config.from_dict({**jax_run.cfg.to_dict(), "compute_dtype": "float32"})
    model = models.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(jax_run.init, cfg))
    args = TrainingArguments(
        output_dir=str(out), dataset_name="synth", data_dir=synth_dir,
        per_device_train_batch_size=BATCH, per_device_eval_batch_size=EVAL_BATCH,
        learning_rate=1e-3, lr_sched="const", weight_decay=0.1, num_train_epochs=2,
        logging_steps=5, compute_dtype="float32", device="cpu", steps_per_call=1, **kw)
    return cls(model, cfg, args, CTRDataset(synth_dir, "synth"))


def _kinds_steps_keys(recs):
    return [(r["kind"], r["step"], sorted(r)) for r in recs]


def test_supervised_metrics_jsonl_matches_map_tpus(jax_supervised, synth_dir, tmp_path):
    t = _port_trainer(jax_supervised, synth_dir, tmp_path)
    t.train()
    t.test()
    ref, got = _records(jax_supervised.out), _records(tmp_path)
    assert _kinds_steps_keys(got) == _kinds_steps_keys(ref)
    assert [r["kind"] for r in got].count("eval") == 2 and got[-1]["kind"] == "test"
    for g, r in zip(got, ref):
        for k in set(r) - TIMING_KEYS - {"kind", "step"}:
            assert g[k] == pytest.approx(r[k], rel=0, abs=1e-5), (r["kind"], r["step"], k)
    # the stream mirrors the evals' results
    assert [[r["eval_auc"], r["eval_loss"]] for r in got
            if r["kind"] in ("eval", "test")] == t.eval_metrics


class _Killed(Trainer):
    """A run stopped after its first epoch, as if killed there."""

    def _epochs_with_skip(self, batcher):
        yield next(super()._epochs_with_skip(batcher))


def test_resumed_run_matches_map_tpus_straight_run(jax_supervised, synth_dir, tmp_path):
    killed = _port_trainer(jax_supervised, synth_dir, tmp_path, cls=_Killed, save_steps=5)
    killed.train()
    resumed = _port_trainer(jax_supervised, synth_dir, tmp_path, save_steps=5, resume=True)
    resumed.train()
    assert resumed.global_step == 26
    ref = state_dict_from_jax(jax_supervised.final, resumed.config)
    for name, value in resumed.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    test = resumed.test()
    for key in ("eval_auc", "eval_loss", "avg_logits", "avg_probs"):
        assert test[key] == pytest.approx(jax_supervised.test[key], abs=1e-5), key


def assert_pretrain_records_match_map_tpus(synth_dir, tmp_path, kind):
    """map_tpu's and the port's CLI, the same MFP or RFD run: the same
    (kind, step) sequence and key sets in metrics.jsonl."""
    flags = ["--model_name", "dcnv2", "--dataset_name", "synth", "--data_dir", synth_dir,
             "--embed_size", "8", "--hidden_size", "32", "--num_hidden_layers", "1",
             "--num_cross_layers", "2", "--logging_steps", "5", "--proj_size", "8",
             "--pretrain", "--pt_type", kind.upper(), "--sampling_method", "randint",
             "--mask_ratio", "0.3", "--pt_neg_num", "5", "--learning_rate", "1e-3",
             "--num_train_epochs", "1", "--lr_sched", "cosine", "--weight_decay", "0.05",
             "--compute_dtype", "float32", "--steps_per_call", "1"]
    assert jax_main(flags + ["--output_dir", str(tmp_path / "jax"),
                             "--per_device_train_batch_size", str(BATCH // JAX_DEVICES),
                             "--per_device_eval_batch_size", "64"]) == 0
    assert port_main(flags + ["--output_dir", str(tmp_path / "port"), "--device", "cpu",
                              "--per_device_train_batch_size", str(BATCH),
                              "--per_device_eval_batch_size", "512"]) == 0
    ref, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert _kinds_steps_keys(got) == _kinds_steps_keys(ref)
    assert {r["kind"] for r in got} == {f"{kind}_window", f"{kind}_eval"}


def test_rfd_metrics_jsonl_kinds_steps_and_keys(synth_dir, tmp_path):
    assert_pretrain_records_match_map_tpus(synth_dir, tmp_path, "rfd")


def test_nonfinite_values_become_null(synth_dir, tmp_path):
    cfg = Config(input_size=300, num_fields=8, embed_size=8, hidden_size=16)
    args = TrainingArguments(output_dir=str(tmp_path), device="cpu")
    t = Trainer(models.from_config(cfg), cfg, args, None)
    t._emit_metrics("train_window", {"window_auc": float("nan"), "window_loss": math.inf,
                                     "ok": 1.5, "n": np.int64(3), "x": np.float32(0.5)})
    (rec,) = _records(tmp_path)
    assert rec["window_auc"] is None and rec["window_loss"] is None
    assert (rec["ok"], rec["n"], rec["x"], rec["kind"], rec["step"]) == (
        1.5, 3, 0.5, "train_window", 0)


def test_histogram_helpers_equal_map_tpus():
    rng = np.random.default_rng(4)
    for nb in (1, 7, 512, 32768):
        pos = rng.integers(0, 5, nb).astype(np.float64)
        neg = rng.integers(0, 9, nb).astype(np.float64)
        pos[0], neg[-1] = 1.0, 1.0  # both classes present
        assert metrics.auc_from_histograms(pos, neg) == jax_metrics.auc_from_histograms(
            pos, neg)
        assert metrics.auc_histogram_error_bound(pos, neg) == \
            jax_metrics.auc_histogram_error_bound(pos, neg)
    assert metrics.auc_histogram_error_bound(np.zeros(4), np.ones(4)) == 0.0
    with pytest.raises(ValueError):
        metrics.auc_from_histograms(np.zeros(4), np.ones(4))


def test_streaming_eval_step_matches_map_tpus(jax_supervised, synth_dir):
    cfg = Config.from_dict({**jax_supervised.cfg.to_dict(), "compute_dtype": "float32"})
    model = models.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(jax_supervised.final, cfg))
    _, eval_step = make_supervised_steps(model, None, torch.device("cpu"),
                                         streaming_bins=BINS)
    ds = CTRDataset(synth_dir, "synth")
    batcher = Batcher(ds.X["valid"], ds.Y["valid"], EVAL_BATCH, shuffle=False)
    got = [eval_step(b) for b in batcher.epoch(0)]
    assert len(got) == len(jax_supervised.stream)
    hist = {"port": [np.zeros(BINS), np.zeros(BINS)], "jax": [np.zeros(BINS), np.zeros(BINS)]}
    for g, r in zip(got, jax_supervised.stream):
        for key in ("count", "ll_sum", "logit_sum", "prob_sum"):
            assert float(g[key]) == pytest.approx(float(r[key]), rel=1e-5, abs=1e-5), key
        assert float(g["count"]) == float(r["count"])
        for side, m in (("port", g), ("jax", r)):
            hist[side][0] += np.asarray(m["hist_pos"], np.float64)
            hist[side][1] += np.asarray(m["hist_neg"], np.float64)
    auc = metrics.auc_from_histograms(*hist["port"])
    assert auc == pytest.approx(metrics.auc_from_histograms(*hist["jax"]), abs=1e-4)
    # against the exact AUC of the same scores
    model.eval()
    with torch.inference_mode():
        probs = torch.sigmoid(model(torch.from_numpy(ds.X["valid"])).reshape(-1).float())
    exact = metrics.roc_auc(ds.Y["valid"], probs.numpy())
    bound = metrics.auc_histogram_error_bound(*hist["port"])
    assert abs(auc - exact) <= bound + 1e-12
    assert sum(hist["port"][0]) + sum(hist["port"][1]) == len(ds.Y["valid"])


def test_streaming_trainer_escalates_coarse_bins(jax_supervised, synth_dir, tmp_path, caplog):
    exact = _port_trainer(jax_supervised, synth_dir, tmp_path / "exact")
    stream = _port_trainer(jax_supervised, synth_dir, tmp_path / "stream",
                           streaming_auc=True, auc_bins=64)
    stream.model.load_state_dict(exact.model.state_dict())
    ref = exact.eval()
    with caplog.at_level("INFO"):
        got = stream.eval()
    assert "escalating auc_bins 64 -> 128" in caplog.text
    assert "still exceeds" not in caplog.text
    bound = float(re.findall(r"certified error bound ([\d.e+-]+)\n?", caplog.text)[-1])
    assert bound <= 5e-5 and stream._streaming_bins > 64
    assert abs(got["eval_auc"] - ref["eval_auc"]) <= bound + 1e-12
    for key in ("eval_loss", "avg_logits", "avg_probs"):
        assert got[key] == pytest.approx(ref[key], abs=1e-5), key


def test_profile_steps_write_a_trace(synth_dir, tmp_path):
    assert port_main([
        "--model_name", "dnn", "--output_dir", str(tmp_path), "--dataset_name", "synth",
        "--data_dir", synth_dir, "--per_device_train_batch_size", "1024",
        "--per_device_eval_batch_size", "512", "--embed_size", "8", "--hidden_size", "16",
        "--num_hidden_layers", "1", "--learning_rate", "1e-3", "--num_train_epochs", "1",
        "--lr_sched", "const", "--profile_steps", "2", "--steps_per_call", "1",
        "--device", "cpu"]) == 0
    traces = os.listdir(tmp_path / "profile")
    assert traces == ["trace_4.json"]
    with open(tmp_path / "profile" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
