"""map_tpu_torch RFD pretraining, and training under the hybrid lookup's
backward modes, against map_tpu on the CPU.

The same numpy-made inputs go through map_tpu and the port: `rfd_corrupt`
with each of its four generators on map_tpu's own draws (integer-exact), the
Batcher's noise rows (bit-identical), the RFD head's weight carry, 5 RFD
steps and 5 supervised steps from carried weights under the `fwd` and
`bwd_pallas` backward modes (losses, metrics, parameters and Adam moments at
1e-5 in float32; map_tpu's CPU route for `bwd_pallas` is its XLA block
scatter, the same function as its Pallas kernel), the finetune restore from
an RFD checkpoint, and the CLI end to end: RFD pretraining, then finetuning
from its checkpoint. On the CPU every port op takes its plain version; the
kernels are held against those on the card by `chip_smoke.py` and
`tests/test_torch_port_cuda.py`.
"""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import map_tpu.ops.hybrid_gather as jax_hg
from map_tpu import config as jax_config
from map_tpu import models as jax_models
from map_tpu.data.loader import Batcher as JaxBatcher
from map_tpu.interop.torch_import import export_state_dict
from map_tpu.objectives import corruption as jax_corruption
from map_tpu.train import checkpoints as jax_checkpoints
from map_tpu.train import train_step as jax_ts
from map_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from map_tpu_torch import models
from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.interop.from_jax import model_rules, state_dict_from_jax
from map_tpu_torch.objectives import corruption
from map_tpu_torch.ops import hybrid_gather
from map_tpu_torch.run import main as port_main
from map_tpu_torch.train import checkpoints
from map_tpu_torch.train.optimizer import build_optimizer, decays
from map_tpu_torch.train.train_step import make_rfd_steps, make_supervised_steps

from conftest import base_model_config
from test_torch_port_train import _jax_moments, _np

K_STEPS = 5
LR = 1e-3
BATCH = 64
MASK_RATIO = 0.3
# 8 fields; with SMALL_FIELD_MAX held at 100 below, three are big
SIZES = [7, 24, 60, 300, 500, 5, 150, 80]
IDX_LOW = list(np.cumsum([10] + SIZES[:-1]))
IDX_HIGH = [a + s for a, s in zip(IDX_LOW, SIZES)]
VOCAB = IDX_HIGH[-1]
GENERATORS = ["Unigram", "Uniform", "Whole-Uniform", "Whole-Unigram"]


def _ids(rng, rows, reserved=0.0):
    ids = np.stack([rng.integers(a, b, rows) for a, b in zip(IDX_LOW, IDX_HIGH)], 1)
    hit = rng.random(ids.shape) < reserved
    ids[hit] = rng.integers(0, 10, hit.sum())
    return ids.astype(np.int32)


# ---- corruption and the noise rows ------------------------------------------------

def _map_tpu_rfd_draws(key, ids, mask_num, method, replace):
    """map_tpu's draws inside rfd_corrupt (corruption.py:98-150)."""
    b, f = ids.shape
    k_idx, k_rep = jax.random.split(key)
    masked_index = jax_corruption.sample_masked_index(k_idx, b, f, mask_num, method)
    rep = {"Unigram": None,
           "Uniform": lambda: jax.random.uniform(k_rep, (b * mask_num,)),
           "Whole-Uniform": lambda: jax.random.randint(k_rep, (b, mask_num), 10, VOCAB,
                                                       dtype=jnp.int32),
           "Whole-Unigram": lambda: jax.random.randint(k_rep, (b * mask_num,), 0, f)
           }[replace]
    return corruption.RFDDraws(*(None if a is None else torch.from_numpy(np.array(a))
                                 for a in (masked_index, rep and rep())))


@pytest.mark.parametrize("replace", GENERATORS)
@pytest.mark.parametrize("method", ["randint", "normal"])
def test_rfd_corrupt_matches_map_tpu(replace, method):
    rng = np.random.default_rng(4)
    ids = _ids(rng, BATCH)
    mask_num = corruption.mask_num_of(8, MASK_RATIO)
    noise_rows = _ids(rng, BATCH * mask_num)
    key = jax.random.PRNGKey(11)
    ref_c, ref_l = jax_corruption.rfd_corrupt(
        key, jnp.asarray(ids), mask_num, method, replace, VOCAB,
        idx_low=jnp.asarray(IDX_LOW, jnp.int32), idx_high=jnp.asarray(IDX_HIGH, jnp.int32),
        noise_rows=jnp.asarray(noise_rows))
    draws = _map_tpu_rfd_draws(key, ids, mask_num, method, replace)
    got_c, got_l = corruption.rfd_corrupt(
        torch.from_numpy(ids), draws, replace, torch.tensor(IDX_LOW, dtype=torch.int32),
        torch.tensor(IDX_HIGH, dtype=torch.int32), torch.from_numpy(noise_rows))
    assert got_c.dtype == torch.int32 and got_l.dtype == torch.float32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    if method == "randint":  # repeats in a row: the draws test last-wins
        mi = draws.masked_index.numpy()
        assert any(len(set(row)) < mask_num for row in mi)


def test_rfd_corrupt_last_occurrence_wins():
    ids = torch.tensor([[11, 20, 30, 40]], dtype=torch.int32)
    draws = corruption.RFDDraws(torch.tensor([[2, 0, 2, 2]]),
                                torch.tensor([[101, 102, 103, 104]], dtype=torch.int32))
    got, labels = corruption.rfd_corrupt(ids, draws, "Whole-Uniform")
    assert got.tolist() == [[102, 20, 104, 40]]
    assert labels.tolist() == [[1.0, 0.0, 1.0, 0.0]]
    # a replacement equal to the original is no replacement
    draws = corruption.RFDDraws(torch.tensor([[1, 3]]),
                                torch.tensor([[20, 7]], dtype=torch.int32))
    assert corruption.rfd_corrupt(ids, draws, "Whole-Uniform")[1].tolist() == [
        [0.0, 0.0, 0.0, 1.0]]


def test_port_draws_stay_in_range():
    gen = torch.Generator().manual_seed(0)
    for replace in GENERATORS:
        d = corruption.draw_rfd(gen, 256, 8, 2, "randint", replace, VOCAB,
                                torch.device("cpu"))
        assert d.masked_index.shape == (256, 2)
        if replace == "Uniform":
            assert 0.0 <= float(d.replace.min()) and float(d.replace.max()) < 1.0
        elif replace == "Whole-Uniform":
            assert 10 <= int(d.replace.min()) and int(d.replace.max()) < VOCAB
        elif replace == "Whole-Unigram":
            assert d.replace.shape == (512,) and int(d.replace.max()) < 8


@pytest.mark.parametrize("shuffle", [True, False])
def test_batcher_noise_rows_match_map_tpu(shuffle):
    rng = np.random.default_rng(5)
    x = _ids(rng, 523)
    y = rng.integers(0, 2, 523).astype(np.float32)
    train = _ids(rng, 777)
    kw = dict(batch_size=100, shuffle=shuffle, seed=3, noise_source=train,
              noise_rows_per_example=2)
    ref, got = JaxBatcher(x, y, **kw), Batcher(x, y, **kw)
    for epoch in (0, 1):
        pairs = list(zip(got.epoch(epoch), ref.epoch(epoch)))
        assert len(pairs) == 6
        for a, b in pairs:
            assert set(a) == set(b) and a["noise_rows"].shape == (200, 8)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- the RFD head ------------------------------------------------------------------

def _rfd_config(mode="", num_layers=2, packed=True, replace="Unigram"):
    return base_model_config(
        input_size=VOCAB, num_fields=8, embed_size=16, hidden_size=32,
        num_hidden_layers=num_layers, num_cross_layers=num_layers,
        compute_dtype="float32", packed_tables=packed, pretrain=True, pt_type="RFD",
        RFD_replace=replace, proj_size=8, idx_low=IDX_LOW, idx_high=IDX_HIGH,
        hybrid_mode=mode)


def test_rfd_head_carry_matches_map_tpu():
    cfg = _rfd_config(num_layers=3)
    model = jax_models.from_config(cfg)
    ids = _ids(np.random.default_rng(6), 32)
    variables = _np(model.init(jax.random.PRNGKey(2), jnp.asarray(ids)))
    port_cfg = Config.from_dict(cfg.to_dict())
    sd = state_dict_from_jax(variables, port_cfg)
    ref = export_state_dict(variables["params"], "dcnv2", cfg)
    heads = {k for k in ref if k.startswith("pred_rfd.")}
    assert heads == {"pred_rfd.0.weight", "pred_rfd.0.bias", "pred_rfd.2.weight",
                     "pred_rfd.2.bias"}
    ref["embed.embedding.weight"] = variables["params"]["embed"]["embedding"].reshape(
        -1, 16)[:VOCAB]
    assert set(sd) == set(ref) and len(sd) == 17
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    port = models.from_config(port_cfg)
    assert sorted(n for n, _ in port.named_parameters()) == sorted(
        k for k, _, _ in model_rules(port_cfg))
    assert not decays("pred_rfd.0.bias") and decays("pred_rfd.2.weight")
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    want = model.apply(variables, jnp.asarray(ids))
    assert got.shape == (32, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_partial_restore_from_rfd_matches_map_tpu():
    cfg = _rfd_config(num_layers=3, packed=False)
    rfd_vars = _np(jax_models.from_config(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32)))
    ft_cfg = base_model_config(input_size=VOCAB, num_fields=8, embed_size=16,
                               hidden_size=32, num_hidden_layers=3, num_cross_layers=3)
    ft_vars = _np(jax_models.from_config(ft_cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32)))
    _, jax_loaded, jax_skipped = jax_checkpoints.partial_restore(ft_vars, rfd_vars)
    target = state_dict_from_jax(rfd_vars, Config.from_dict(cfg.to_dict()))
    port_ft = models.from_config(Config.from_dict(ft_cfg.to_dict()))
    _, loaded, skipped = checkpoints.partial_restore(port_ft.state_dict(), target)
    assert (loaded, skipped) == (jax_loaded, jax_skipped) == (13, 4)


# ---- 5 steps against map_tpu, under the hybrid backward modes ----------------------

def _carry(cfg, state):
    port_cfg = Config.from_dict(cfg.to_dict())
    model = models.from_config(port_cfg)
    model.load_state_dict(state_dict_from_jax({"params": _np(state.params)}, port_cfg))
    return port_cfg, model


def _k_runs(kind, mode):
    """K steps of `kind` (rfd | supervised) through map_tpu and the port,
    from the same carried weights, on the same batches; the port's RFD steps
    take map_tpu's masked positions."""
    rfd = kind == "rfd"
    cfg = (_rfd_config(mode) if rfd else base_model_config(
        input_size=VOCAB, num_fields=8, embed_size=16, hidden_size=32,
        num_hidden_layers=2, num_cross_layers=2, compute_dtype="float32",
        packed_tables=True, idx_low=IDX_LOW, idx_high=IDX_HIGH, hybrid_mode=mode))
    mask_num = corruption.mask_num_of(8, MASK_RATIO)
    rng = np.random.default_rng(23)
    batches = []
    for i in range(K_STEPS):
        weight = np.ones(BATCH, np.float32)
        if i == K_STEPS - 1:
            weight[40:] = 0.0  # a padded last batch
        batch = {"input_ids": _ids(rng, BATCH, 0.0 if rfd else 0.05),
                 "labels": rng.integers(0, 2, BATCH).astype(np.float32),
                 "weight": weight}
        if rfd:
            batch["noise_rows"] = _ids(rng, BATCH * mask_num)
        batches.append(batch)
    jargs = jax_config.TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine", mask_ratio=MASK_RATIO,
        sampling_method="randint", pretrain=rfd, pt_type="RFD", RFD_replace="Unigram",
        compute_dtype="float32", packed_tables=True)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": batches[0]["input_ids"]})
    base_rng = jax.random.PRNGKey(5)
    make = jax_ts.make_rfd_steps if rfd else jax_ts.make_supervised_steps
    jax_step, _ = make(model, cfg, jargs, tx, base_rng)
    port_cfg, port_model = _carry(cfg, state)
    args = TrainingArguments(learning_rate=LR, weight_decay=0.05, lr_sched="cosine")
    opt, _ = build_optimizer(port_model, args, num_training_steps=10, num_warmup_steps=2)
    cpu = torch.device("cpu")
    if rfd:
        port_step, _ = make_rfd_steps(port_model, opt, port_cfg, MASK_RATIO, "randint",
                                      "Unigram", torch.Generator(), cpu)
    else:
        port_step, _ = make_supervised_steps(port_model, opt, cpu)
    keys = ("loss", "acc", "pos_ratio", "count") if rfd else ("loss",)
    jax_m, port_m = [], []
    for step, batch in enumerate(batches):
        if rfd:  # map_tpu's draws of this step (train_step.py:565-566)
            k_corrupt, _ = jax.random.split(jax.random.fold_in(base_rng, step))
            pm = port_step(batch, _map_tpu_rfd_draws(k_corrupt, batch["input_ids"],
                                                     mask_num, "randint", "Unigram"))
        else:
            pm = port_step(batch)
        state, m = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_m.append([float(m[k]) for k in keys])
        port_m.append([pm[k].item() for k in keys])
    ref = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
    return (np.array(jax_m), np.array(port_m), ref, port_model.state_dict(),
            _jax_moments(tx, state.opt_state, cfg), opt)


@pytest.mark.parametrize("mode", ["fwd", "bwd_pallas"])
@pytest.mark.parametrize("kind", ["rfd", "supervised"])
def test_steps_match_map_tpu_under_hybrid_modes(kind, mode, monkeypatch):
    for module in (jax_hg, hybrid_gather):
        monkeypatch.setattr(module, "SMALL_FIELD_MAX", 100)
    small, big = hybrid_gather.field_groups(tuple(zip(IDX_LOW, IDX_HIGH)))
    assert len(small) == 5 and big == (3, 4, 6)
    jax_m, port_m, ref, got, ref_mom, opt = _k_runs(kind, mode)
    assert opt.count == K_STEPS
    np.testing.assert_allclose(port_m, jax_m, rtol=1e-5, atol=1e-5)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        for part, g, r in zip(("mu", "nu"), opt.state()[key], ref_mom[key]):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-8,
                                       err_msg=f"{key} {part}")


# ---- the whole slice: the CLI ------------------------------------------------------

_COMMON = ["--model_name=dcnv2", "--dataset_name=synth", "--embed_size=8",
           "--hidden_size=32", "--num_hidden_layers=1", "--num_cross_layers=2",
           "--compute_dtype", "float32", "--logging_steps=5", "--device", "cpu",
           "--per_device_train_batch_size=256", "--per_device_eval_batch_size=200"]
# `Uniform` replacement: on this data of independent fields a `Unigram`
# replacement is drawn from the field's own distribution, so no detector
# beats the all-"original" guess (it converges to it); a uniform one is
# detectable (`tests/torch_port_cli_seeds.py` runs both over seeds). The
# CLI's `Unigram` path runs in `test_torch_port_zoo_cli.py`.
_RFD = ["--pretrain", "--pt_type=RFD", "--RFD_replace=Uniform", "--sampling_method=randint",
        "--mask_ratio=0.3", "--proj_size=8", "--learning_rate=3e-2", "--lr_sched=cosine",
        "--weight_decay=5e-2", "--num_train_epochs=4"]
_FINETUNE = ["--learning_rate=1e-2", "--lr_sched=const", "--num_train_epochs=1"]


@pytest.mark.parametrize("mode", ["", "bwd_pallas"])
def test_cli_pretrains_rfd_and_finetunes(synth_dir, tmp_path, mode):
    flags = _COMMON + [f"--data_dir={synth_dir}"] + (
        [f"--hybrid_mode={mode}"] if mode else [])
    pt_dir = tmp_path / "pt"
    assert port_main(flags + _RFD + [f"--output_dir={pt_dir}"]) == 0
    assert os.path.exists(pt_dir / "results.log")
    log = open(pt_dir / "train.log").read()
    assert f"mode = {mode or 'default'}" in log
    evals = [tuple(float(x) for x in m) for m in re.findall(
        r"'eval_rfd_loss': ([\d.]+), 'eval_rfd_acc': ([\d.]+), "
        r"'eval_pos_ratio': ([\d.]+)", log)]
    windows = re.findall(r"'window_rfd_loss': ([\d.]+), 'window_rfd_acc': ([\d.]+), "
                         r"'window_pos_ratio': ([\d.]+)", log)
    assert len(evals) == 4 and len(windows) >= 4  # an eval an epoch
    # the loss falls; accuracy beats the all-"original" guess 1 - pos_ratio
    assert evals[-1][0] < evals[0][0]
    assert evals[-1][1] > 1 - evals[-1][2]
    (ckpt,) = glob.glob(str(pt_dir / "*.model"))
    ft_dir = tmp_path / "ft"
    assert port_main(flags + _FINETUNE + [f"--output_dir={ft_dir}", "--finetune",
                                          f"--pretrained_model_path={ckpt}"]) == 0
    log = open(ft_dir / "train.log").read()
    assert "finetune restore: 7 tensors loaded, 4 skipped" in log
    aucs = [float(x) for x in re.findall(r"'eval_auc': ([\d.]+)", log)]
    assert len(aucs) == 2 and aucs[0] > 0.6  # one eval + TEST


def test_cli_takes_the_rfd_script_flags():
    from map_tpu_torch.config import parse_args

    script = open(os.path.join(os.path.dirname(__file__), os.pardir, "run_script",
                               "run_DCNv2_RFD.sh")).read()
    flags = re.findall(r"(--\w+(?:=\S+)?)", script.split("map_tpu.run")[1])
    model_args, args = parse_args([f for f in flags if f != '"$@"'])
    assert args.pretrain and (args.pt_type, args.RFD_replace) == ("RFD", "Unigram")
    assert (args.sampling_method, args.mask_ratio, args.lr_sched, args.weight_decay,
            args.learning_rate, args.per_device_train_batch_size) == (
        "randint", 0.3, "cosine", 5e-2, 1e-3, 4096)
    assert (model_args.proj_size, model_args.embed_size, model_args.hidden_size,
            model_args.num_cross_layers) == (32, 16, 1000, 3)
    assert args.field_blocked_lookup and args.hybrid_mode == ""
    _, args = parse_args(["--no-field_blocked_lookup", "--hybrid_mode=bwd_pallas"])
    assert not args.field_blocked_lookup and args.hybrid_mode == "bwd_pallas"
