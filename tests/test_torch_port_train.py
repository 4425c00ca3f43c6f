"""map_tpu_torch supervised training against map_tpu's on the CPU.

The same numpy-made inputs go through map_tpu and the port: the loss, the
schedules, the no-decay mask, the batch stream, k supervised steps from
carried weights (losses, parameters and Adam moments), a Trainer run from
carried weights (eval AUC / log loss per epoch), and both CLIs end to end.
On the CPU every port op takes its plain PyTorch version; the kernels are
held against those on the card by `chip_smoke.py` and
`tests/test_torch_port_cuda.py`.
"""

import argparse
import dataclasses
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from map_tpu import config as jax_config
from map_tpu import models as jax_models
from map_tpu.data.dataset import CTRDataset as JaxDataset
from map_tpu.data.loader import Batcher as JaxBatcher
from map_tpu.objectives.supervised import bce_loss as jax_bce_loss
from map_tpu.run import main as jax_main
from map_tpu.train import schedules as jax_schedules
from map_tpu.train import train_step as jax_ts
from map_tpu.train.optimizer import PartitionedTx
from map_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from map_tpu.train.optimizer import is_table_leaf as jax_is_table_leaf
from map_tpu.train.optimizer import no_decay_mask
from map_tpu.train.trainer import Trainer as JaxTrainer
from map_tpu_torch import models
from map_tpu_torch.config import (
    Config,
    TrainingArguments,
    add_dataclass_args,
    parse_args,
)
from map_tpu_torch.data.dataset import CTRDataset
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.interop.from_jax import model_rules, state_dict_from_jax
from map_tpu_torch.nn.layers import Dropout, set_dropout_generator
from map_tpu_torch.objectives.supervised import bce_loss
from map_tpu_torch.run import main as port_main
from map_tpu_torch.train import checkpoints, schedules
from map_tpu_torch.train.optimizer import build_optimizer, decays, is_table_leaf
from map_tpu_torch.train.train_step import make_supervised_steps
from map_tpu_torch.train.trainer import Trainer

from conftest import base_model_config

# conftest gives map_tpu 8 virtual CPU devices, and its global batch is the
# per-device batch times 8; the port runs on one device
JAX_DEVICES = 8
K_STEPS = 5
LR = 1e-3


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)  # owned copies


def test_bce_loss_matches_map_tpu():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(64, 1)) * 4).astype(np.float32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    weight = (np.arange(64) < 50).astype(np.float32)  # 14 padding rows
    ref = jax_bce_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weight))
    got = bce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                   torch.from_numpy(weight))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    zero = bce_loss(torch.ones(3), torch.ones(3), torch.zeros(3))
    assert zero.item() == 0.0  # an all-padding batch divides by max(0, 1)


@pytest.mark.parametrize("kind", ["const", "cosine"])
@pytest.mark.parametrize("warmup", [0, 4])
def test_schedule_matches_map_tpu(kind, warmup):
    ref = jax_schedules.make_schedule(kind, 1e-3, warmup, 30)
    got = schedules.make_schedule(kind, 1e-3, warmup, 30)
    for step in range(0, 34):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


def _flax_params(cfg, seed=0):
    model = jax_models.from_config(cfg)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((2, cfg.num_fields), jnp.int32))
    return model, _np(variables)


@pytest.mark.parametrize("packed", [False, True])
def test_no_decay_mask_and_table_rule_match_map_tpu(packed):
    cfg = base_model_config(input_size=5000, embed_norm=True, packed_tables=packed)
    _, variables = _flax_params(cfg)
    params = variables["params"]
    mask = traverse_util.flatten_dict(no_decay_mask(params))
    flat = traverse_util.flatten_dict(params)
    port_cfg = Config.from_dict(cfg.to_dict())
    sd = state_dict_from_jax(variables, port_cfg)
    model = models.from_config(port_cfg)
    names = [n for n, _ in model.named_parameters()]
    rules = model_rules(port_cfg)
    assert sorted(names) == sorted(key for key, _, _ in rules)
    for key, path, _ in rules:
        assert decays(key) == mask[path], key
        path_keys = [jax.tree_util.DictKey(k) for k in path]
        assert is_table_leaf(key, sd[key].shape) == jax_is_table_leaf(
            path_keys, flat[path]), key
    assert not decays("embed.layer_norm.weight") and not decays("fc_out.bias")
    assert decays("embed.embedding.weight")


def test_no_decay_rule_matches_map_tpu_on_the_mfp_head():
    # map_tpu leaves the NCE decoder's bias table undecayed (leaf `bias`);
    # its torch name is `mfp_criterion.bias.weight`
    cfg = base_model_config(input_size=600, num_hidden_layers=3, num_cross_layers=3,
                            pretrain=True, pt_type="MFP", proj_size=8, pt_neg_num=5)
    cfg.feat_count = np.ones(600, np.float32)
    cfg.logprob_noise = np.full(600, -np.log(600), np.float32)
    cfg.norm_term = float(np.log(600))
    variables = jax_models.from_config(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
        masked_index=jnp.zeros((2, 2), jnp.int32),
        candidates=jnp.zeros((2, 2, 6), jnp.int32))
    mask = traverse_util.flatten_dict(no_decay_mask(variables["params"]))
    port_cfg = Config.from_dict(cfg.to_dict())
    names = [n for n, _ in models.from_config(port_cfg).named_parameters()]
    assert len(names) == 17  # 13 of the backbone + feat_encoder + the decoder
    rules = model_rules(port_cfg)
    assert sorted(names) == sorted(key for key, _, _ in rules)
    assert len(mask) == 17
    for key, path, _ in rules:
        assert decays(key) == mask[path], key
    assert not decays("mfp_criterion.bias.weight")
    assert decays("mfp_criterion.emb.weight") and decays("feat_encoder.weight")


@pytest.mark.parametrize("shuffle", [True, False])
def test_batcher_stream_matches_map_tpu(shuffle):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1000, size=(1037, 6)).astype(np.int32)
    y = rng.integers(0, 2, 1037).astype(np.float32)
    ref = JaxBatcher(x, y, batch_size=128, shuffle=shuffle, seed=9)
    got = Batcher(x, y, batch_size=128, shuffle=shuffle, seed=9)
    assert len(got) == len(ref) == 9
    for epoch in (0, 1):
        ref_batches = list(ref.epoch(epoch))
        got_batches = list(got.epoch(epoch))
        assert len(got_batches) == len(ref_batches)
        for a, b in zip(got_batches, ref_batches):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got_batches[-1]["weight"].sum() == 1037 - 8 * 128


def _jax_moments(tx, opt_state, cfg):
    """map_tpu's Adam moments as the port's {name: (mu, nu)}: optax's
    ScaleByAdamState for the rest, PartitionedTx's table state for tables."""
    import optax

    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    mu = traverse_util.flatten_dict(_np(adam.mu))
    nu = traverse_util.flatten_dict(_np(adam.nu))
    if isinstance(tx, PartitionedTx):
        for path, mom in traverse_util.flatten_dict(opt_state[1]).items():
            if isinstance(mom, tuple) and len(mom) == 2:
                mu[path], nu[path] = np.array(mom[0]), np.array(mom[1])
    port_cfg = Config.from_dict(cfg.to_dict())
    carry = lambda flat: state_dict_from_jax(  # noqa: E731
        {"params": traverse_util.unflatten_dict(flat)}, port_cfg)
    m, v = carry(mu), carry(nu)
    return {k: (m[k], v[k]) for k in m}


def _k_step_runs(compute_dtype, packed, max_grad_norm, embed_norm=False):
    """k supervised steps through map_tpu and through the port, from the
    same carried weights on the same batches."""
    cfg = base_model_config(input_size=600, num_fields=8, embed_size=16,
                            hidden_size=32, num_hidden_layers=2,
                            num_cross_layers=2, compute_dtype=compute_dtype,
                            packed_tables=packed, embed_norm=embed_norm)
    rng = np.random.default_rng(17)
    batches = []
    for i in range(K_STEPS):
        weight = np.ones(64, np.float32)
        if i == K_STEPS - 1:
            weight[40:] = 0.0  # a padded last batch
        batches.append({
            "input_ids": rng.integers(0, cfg.input_size, (64, 8)).astype(np.int32),
            "labels": rng.integers(0, 2, 64).astype(np.float32),
            "weight": weight})
    jargs = jax_config.TrainingArguments(
        learning_rate=LR, weight_decay=0.1, lr_sched="cosine",
        max_grad_norm=max_grad_norm, compute_dtype=compute_dtype,
        packed_tables=packed)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": batches[0]["input_ids"]})
    port_cfg = Config.from_dict(cfg.to_dict())
    port_model = models.from_config(port_cfg)
    port_model.load_state_dict(state_dict_from_jax({"params": _np(state.params)},
                                                   port_cfg))
    args = TrainingArguments(learning_rate=LR, weight_decay=0.1, lr_sched="cosine",
                             max_grad_norm=max_grad_norm)
    opt, _ = build_optimizer(port_model, args, num_training_steps=10,
                             num_warmup_steps=2)
    port_step, _ = make_supervised_steps(port_model, opt, torch.device("cpu"))
    train_step, _ = jax_ts.make_supervised_steps(model, cfg, jargs, tx,
                                                 jax.random.PRNGKey(5))
    jax_losses, port_losses = [], []
    for batch in batches:
        state, m = train_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_losses.append(float(m["loss"]))
        port_losses.append(port_step(batch)["loss"].item())
    ref_params = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
    return (np.array(jax_losses), np.array(port_losses), ref_params,
            port_model.state_dict(), _jax_moments(tx, state.opt_state, cfg),
            opt.state(), opt)


@pytest.mark.parametrize("packed,max_grad_norm,embed_norm", [
    (False, 0.0, False), (True, 0.0, False), (False, 0.05, True)])
def test_supervised_steps_match_map_tpu_f32(packed, max_grad_norm, embed_norm):
    jax_losses, port_losses, ref, got, ref_mom, got_mom, opt = _k_step_runs(
        "float32", packed, max_grad_norm, embed_norm)
    assert opt.count == K_STEPS
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5, atol=1e-5)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
        for part, g, r in zip(("mu", "nu"), got_mom[key], ref_mom[key]):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-8,
                                       err_msg=f"{key} {part}")


def test_supervised_steps_bf16_band():
    # bf16 band: map_tpu differentiates its XLA cross path on the CPU, the
    # port runs the custom-VJP chain of the fused kernel, and the two round
    # the bf16 products at other points (about one bf16 ulp, 2**-8). Losses
    # stay within 1e-2; Adam moves a parameter by at most about lr per step,
    # so the parameters differ by at most 2 * lr * k.
    jax_losses, port_losses, ref, got, _, _, _ = _k_step_runs("bfloat16", True, 0.0)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-2, atol=1e-2)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=0, atol=2 * LR * K_STEPS, err_msg=key)


def test_dropout_is_flax_dropout_with_an_explicit_generator():
    layer = Dropout(0.25).train()
    x = torch.ones(20000)
    with pytest.raises(RuntimeError, match="generator"):
        layer(x)
    set_dropout_generator(layer, torch.Generator().manual_seed(0))
    a = layer(x)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    np.testing.assert_allclose(a[kept].numpy(), 1 / 0.75, rtol=1e-6)
    set_dropout_generator(layer, torch.Generator().manual_seed(0))
    assert torch.equal(layer(x), a)  # the generator alone decides the mask
    assert torch.equal(layer.eval()(x), x)


def test_flags_take_boolean_optional_for_default_true():
    @dataclasses.dataclass
    class Flags:
        on: bool = True
        off: bool = False
        n: int = 3

    parser = argparse.ArgumentParser()
    add_dataclass_args(parser, Flags)
    assert vars(parser.parse_args([])) == {"on": True, "off": False, "n": 3}
    assert vars(parser.parse_args(["--no-on", "--off", "--n=5"])) == {
        "on": False, "off": True, "n": 5}


def test_prune_checkpoints_keeps_the_newest(tmp_path):
    for step in (3, 10, 7, 12):
        checkpoints.save_model({"w": torch.zeros(1)}, str(tmp_path), step)
    (tmp_path / "notes.model").write_text("not a step")
    checkpoints.prune_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["10.model", "12.model", "notes.model"]


# ---- the whole slice: Trainer and CLI -----------------------------------------

def _jax_trainer_run(synth_dir, out_dir, epochs, batch, eval_batch):
    model_args, targs = jax_config.parse_args([
        "--model_name", "dcnv2", "--dataset_name", "synth", "--data_dir", synth_dir,
        "--output_dir", str(out_dir), "--compute_dtype", "float32",
        "--per_device_train_batch_size", str(batch // JAX_DEVICES),
        "--per_device_eval_batch_size", str(eval_batch // JAX_DEVICES),
        "--learning_rate", "1e-2", "--lr_sched", "const", "--weight_decay", "0.1",
        "--num_train_epochs", str(epochs), "--embed_size", "8", "--hidden_size", "32",
        "--num_hidden_layers", "1", "--num_cross_layers", "2",
        "--logging_steps", "5"])
    ds = JaxDataset(targs)
    cfg = jax_config.build_config(model_args, targs, ds)
    model = jax_models.from_config(cfg)
    # the parameters map_tpu's Trainer draws (trainer.py _build_steps)
    init_rng = jax.random.split(jax.random.PRNGKey(targs.seed), 3)[0]
    variables = model.init({"params": init_rng,
                            "dropout": jax.random.fold_in(init_rng, 1)},
                           jnp.zeros((2, cfg.num_fields), jnp.int32), train=False)
    init = _np(variables)
    trainer = JaxTrainer(model, cfg, targs, ds)
    trainer.train()
    return cfg, init, trainer.eval_metrics, trainer.test()


def test_trainer_matches_map_tpu_from_carried_weights(synth_dir, tmp_path):
    cfg, init, jax_metrics, jax_test = _jax_trainer_run(
        synth_dir, tmp_path / "jax", epochs=2, batch=256, eval_batch=200)
    port_cfg = Config.from_dict({**cfg.to_dict(), "compute_dtype": "float32"})
    model = models.from_config(port_cfg)
    model.load_state_dict(state_dict_from_jax(init, port_cfg))
    args = TrainingArguments(output_dir=str(tmp_path / "port"), dataset_name="synth",
                             data_dir=synth_dir, per_device_train_batch_size=256,
                             per_device_eval_batch_size=200, learning_rate=1e-2,
                             lr_sched="const", weight_decay=0.1, num_train_epochs=2,
                             logging_steps=5, compute_dtype="float32", device="cpu")
    trainer = Trainer(model, port_cfg, args, CTRDataset(synth_dir, "synth"))
    trainer.train()
    port_test = trainer.test()
    # target band: 1e-4 in eval AUC and log loss per epoch (f32 on both
    # sides; the sums run in other orders). Both lists hold the two epoch
    # evals and the test eval.
    assert len(trainer.eval_metrics) == len(jax_metrics) == 3
    np.testing.assert_allclose(np.array(trainer.eval_metrics),
                               np.array(jax_metrics), rtol=0, atol=1e-4)
    for key in ("eval_auc", "eval_loss"):
        np.testing.assert_allclose(port_test[key], jax_test[key], rtol=0, atol=1e-4)
    assert trainer.best_eval_step == 26 and os.path.exists(
        tmp_path / "port" / "26.model")


def _eval_aucs(out_dir):
    log = open(os.path.join(out_dir, "train.log")).read()
    return [float(x) for x in re.findall(r"'eval_auc': ([\d.]+)", log)]


def test_both_clis_learn_and_complete(synth_dir, tmp_path):
    flags = ["--model_name=dcnv2", "--dataset_name=synth", f"--data_dir={synth_dir}",
             "--learning_rate=1e-2", "--lr_sched=const", "--weight_decay=1e-1",
             "--num_train_epochs=2", "--embed_size=8", "--hidden_size=32",
             "--num_hidden_layers=1", "--num_cross_layers=2", "--logging_steps=5",
             "--compute_dtype", "float32"]
    runs = {
        "jax": (jax_main, [f"--per_device_train_batch_size={256 // JAX_DEVICES}",
                           f"--per_device_eval_batch_size={200 // JAX_DEVICES}"]),
        "port": (port_main, ["--per_device_train_batch_size=256",
                             "--per_device_eval_batch_size=200", "--device", "cpu"]),
    }
    for name, (main, extra) in runs.items():
        out = tmp_path / name
        assert main(flags + extra + [f"--output_dir={out}"]) == 0
        assert os.path.exists(out / "results.log"), name
        assert glob.glob(str(out / "*.model")), name
        aucs = _eval_aucs(out)
        assert len(aucs) == 3 and max(aucs[:2]) > 0.6, (name, aucs)  # 2 evals + TEST
    port_cfg = Config.load(str(tmp_path / "port"))
    assert port_cfg.compute_dtype == "float32" and port_cfg.num_fields == 8
    # a finished run is not run again
    before = os.path.getmtime(tmp_path / "port" / "results.log")
    assert port_main(flags + runs["port"][1] + [f"--output_dir={tmp_path / 'port'}"]) == 0
    assert os.path.getmtime(tmp_path / "port" / "results.log") == before


def test_cli_takes_the_scratch_script_flags():
    script = open(os.path.join(os.path.dirname(__file__), os.pardir, "run_script",
                               "run_DCNv2_scratch.sh")).read()
    flags = re.findall(r"(--\w+=\S+)", script)
    assert len(flags) == 14
    model_args, args = parse_args(flags)
    assert (model_args.embed_size, model_args.hidden_size, model_args.num_hidden_layers,
            model_args.num_cross_layers) == (16, 1000, 3, 3)
    assert (args.per_device_train_batch_size, args.per_device_eval_batch_size,
            args.learning_rate, args.lr_sched, args.weight_decay,
            args.num_train_epochs) == (4096, 10000, 1e-3, "const", 0.1, 1)
    assert args.device is None  # the card unless --device cpu


def test_cli_pretrain_is_not_ported(tmp_path):
    # MFP and RFD are ported (tests/test_torch_port_mfp.py,
    # tests/test_torch_port_rfd.py); a pretraining type or an RFD generator
    # that map_tpu lacks raises before anything is written
    for flags in (["--pt_type=ELECTRA"], ["--pt_type=RFD", "--RFD_replace=Bigram"]):
        with pytest.raises(NotImplementedError, match="ELECTRA|Bigram"):
            port_main([f"--output_dir={tmp_path}", "--pretrain", "--device", "cpu",
                       *flags])
    assert not os.path.exists(tmp_path / "train.log")


@pytest.mark.parametrize("flag", ["--pt_shared_noise", "--pt_per_field_noise",
                                  "--nce_loss_type=full"])
def test_cli_rejects_mfp_options_not_ported(synth_dir, tmp_path, flag):
    # these MFP options are ported now (tests/test_torch_port_shared_noise.py
    # holds them to map_tpu): the CLI pretrains with each; with an RFD
    # generator map_tpu lacks, it raises before it writes anything
    common = ["--model_name=dcnv2", "--dataset_name=synth", f"--data_dir={synth_dir}",
              "--embed_size=8", "--hidden_size=32", "--num_hidden_layers=1",
              "--num_cross_layers=1", "--compute_dtype", "float32",
              "--per_device_train_batch_size=256", "--per_device_eval_batch_size=200",
              "--num_train_epochs=1", "--logging_steps=5", "--sampling_method=randint",
              "--mask_ratio=0.3", "--pt_neg_num=5", "--proj_size=8", "--pretrain", flag,
              "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="RFD_replace"):
        port_main(common + [f"--output_dir={tmp_path / 'rfd'}", "--pt_type=RFD",
                            "--RFD_replace=Bigram"])
    assert not os.path.exists(tmp_path / "rfd" / "train.log")
    assert port_main(common + [f"--output_dir={tmp_path / 'mfp'}", "--pt_type=MFP"]) == 0
    log = open(tmp_path / "mfp" / "train.log").read()
    mode = {"--pt_shared_noise": "noise = global, shared, loss = nce",
            "--pt_per_field_noise": "noise = per-field, loss = nce",
            "--nce_loss_type=full": "noise = global, loss = full"}[flag]
    assert mode in log
    assert len(re.findall(r"'eval_mfp_acc': [\d.]+", log)) == 1


def test_trainer_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = models.from_config(Config.from_dict(base_model_config().to_dict()))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, Config(), TrainingArguments(), dataset=None)
