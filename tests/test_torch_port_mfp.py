"""map_tpu_torch MFP pretraining and finetune transfer against map_tpu on the
CPU.

The same numpy-made inputs go through map_tpu and the port: the alias
tables and the draws' distribution, the corruption, 5 MFP steps from carried
weights with map_tpu's own draws handed to the port (losses, accuracy
counts, parameters and Adam moments), the carry of map_tpu MFP checkpoints,
the finetune restore, and both CLIs end to end (MFP pretraining, then
finetuning from its checkpoint). On the CPU every port op takes its plain
PyTorch version; the kernels are held against those on the card by
`chip_smoke.py` and `tests/test_torch_port_cuda.py`.
"""

import glob
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu import config as jax_config
from map_tpu import models as jax_models
from map_tpu.interop.torch_import import export_state_dict
from map_tpu.objectives import alias as jax_alias
from map_tpu.objectives import corruption as jax_corruption
from map_tpu.run import main as jax_main
from map_tpu.train import checkpoints as jax_checkpoints
from map_tpu.train import train_step as jax_ts
from map_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from map_tpu_torch import models
from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.objectives import alias, corruption
from map_tpu_torch.run import main as port_main
from map_tpu_torch.train import checkpoints
from map_tpu_torch.train.optimizer import build_optimizer
from map_tpu_torch.train.train_step import MFPDraws, NoiseTables, make_mfp_steps

from conftest import base_model_config
from test_torch_port_train import JAX_DEVICES, _jax_moments, _np

K_STEPS = 5
LR = 1e-3


def _feat_count(v, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.floor(rng.pareto(1.2, v) * 20).astype(np.float32)
    counts[:10] = 0.0  # the reserved ids never occur: backoff
    return counts


# ---- noise ---------------------------------------------------------------------

def test_alias_tables_equal_map_tpu_python_builder(monkeypatch):
    from map_tpu import native

    monkeypatch.setattr(native, "build_alias", lambda probs: None)
    probs = alias.noise_distribution(_feat_count(3000))
    np.testing.assert_array_equal(probs, jax_alias.noise_distribution(_feat_count(3000)))
    prob, ids = alias.build_alias_table(probs)
    ref_prob, ref_ids = jax_alias.build_alias_table(probs)
    assert prob.dtype == ref_prob.dtype and ids.dtype == ref_ids.dtype
    np.testing.assert_array_equal(prob, ref_prob)
    np.testing.assert_array_equal(ids, ref_ids)
    logq = np.log(probs).astype(np.float32)
    np.testing.assert_array_equal(
        alias.build_fused_alias(prob, ids, logq).view(np.uint32),
        jax_alias.build_fused_alias(ref_prob, ref_ids, logq).view(np.uint32))


def test_alias_table_cache_is_map_tpus(tmp_path):
    probs = alias.noise_distribution(_feat_count(500))
    built = alias.load_or_build_alias(str(tmp_path), probs)
    assert sorted(os.listdir(tmp_path)) == ["alias_alias.npy", "alias_prob.npy"]
    cached = jax_alias.load_or_build_alias(str(tmp_path), probs)
    for a, b in zip(built, cached):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_alias_draws_follow_the_distribution(fused):
    # chi-square goodness of fit of 200,000 draws over 20 skewed classes:
    # the statistic of a right sampler has 19 degrees of freedom, so it
    # passes 60 (p = 4e-6) except by a fluke the fixed seed rules out
    from scipy import stats

    rng = np.random.default_rng(2)
    probs = alias.noise_distribution(rng.random(20) ** 3 + 1e-4)
    prob, ids = alias.build_alias_table(probs)
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    if fused:
        logq = np.log(probs).astype(np.float32)
        table = torch.from_numpy(alias.build_fused_alias(prob, ids, logq))
        draws, draw_logq = alias.alias_draw_logq(gen, table, (n,))
        assert draws.dtype == torch.int32
        np.testing.assert_array_equal(draw_logq.numpy(), logq[draws.numpy()])
    else:
        draws = alias.alias_draw(gen, torch.from_numpy(prob), torch.from_numpy(ids), (n,))
    counts = np.bincount(draws.numpy(), minlength=20)
    chi2 = stats.chisquare(counts, probs * n).statistic
    assert chi2 < 60.0, chi2


@pytest.mark.parametrize("method", ["normal", "randint"])
def test_mfp_corrupt_matches_map_tpu(method):
    rng = np.random.default_rng(3)
    ids = rng.integers(10, 300, (64, 10)).astype(np.int32)
    corrupted, labels, masked_index = jax_corruption.mfp_corrupt(
        jax.random.PRNGKey(7), jnp.asarray(ids), 3, method, input_size=300)
    got_c, got_l = corruption.mfp_corrupt(torch.from_numpy(ids),
                                          torch.from_numpy(np.array(masked_index)))
    assert got_c.dtype == torch.int32 and got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(corrupted))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(labels))
    # the port's own draws: no repeats in a row under 'normal'
    idx = corruption.sample_masked_index(torch.Generator().manual_seed(0), 64, 10, 3,
                                         method, torch.device("cpu"))
    assert idx.shape == (64, 3) and 0 <= int(idx.min()) and int(idx.max()) < 10
    if method == "normal":
        assert all(len(set(row)) == 3 for row in idx.tolist())
    assert corruption.mask_num_of(24, 0.3) == jax_corruption.mask_num_of(24, 0.3) == 7


# ---- 5 MFP steps against map_tpu ------------------------------------------------

def _mfp_config(loss_type, packed, nce_grad, input_size=600):
    cfg = base_model_config(input_size=input_size, num_fields=8, embed_size=16,
                            hidden_size=32, num_hidden_layers=2, num_cross_layers=2,
                            compute_dtype="float32", packed_tables=packed,
                            pretrain=True, pt_type="MFP", nce_loss_type=loss_type,
                            nce_grad=nce_grad, proj_size=8, pt_neg_num=5)
    cfg.feat_count = _feat_count(input_size)
    probs = jax_alias.noise_distribution(cfg.feat_count)
    cfg.logprob_noise = np.log(probs).astype(np.float32)
    cfg.norm_term = float(np.log(input_size))
    return cfg, probs


def _k_mfp_runs(loss_type, packed, nce_grad):
    """K MFP steps through map_tpu and through the port, from the same
    carried weights, on the same batches, with map_tpu's draws."""
    cfg, probs = _mfp_config(loss_type, packed, nce_grad)
    prob_t, alias_t = jax_alias.build_alias_table(probs)
    fused = jax_alias.build_fused_alias(prob_t, alias_t, cfg.logprob_noise)
    rng = np.random.default_rng(21)
    batches = []
    for i in range(K_STEPS):
        weight = np.ones(64, np.float32)
        if i == K_STEPS - 1:
            weight[40:] = 0.0  # a padded last batch
        batches.append({"input_ids": rng.integers(10, cfg.input_size, (64, 8)
                                                  ).astype(np.int32),
                        "labels": np.zeros(64, np.float32), "weight": weight})
    jargs = jax_config.TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine", mask_ratio=0.3,
        sampling_method="randint", pretrain=True, pt_type="MFP",
        compute_dtype="float32", packed_tables=packed)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": batches[0]["input_ids"]})
    base_rng = jax.random.PRNGKey(5)
    train_step, _ = jax_ts.make_mfp_steps(model, cfg, jargs, tx, base_rng,
                                          prob_t, alias_t, cfg.logprob_noise)

    port_cfg = Config.from_dict(cfg.to_dict())
    port_model = models.from_config(port_cfg)
    port_model.load_state_dict(state_dict_from_jax({"params": _np(state.params)},
                                                   port_cfg))
    args = TrainingArguments(learning_rate=LR, weight_decay=0.05, lr_sched="cosine")
    opt, _ = build_optimizer(port_model, args, num_training_steps=10,
                             num_warmup_steps=2)
    tables = NoiseTables(torch.from_numpy(fused), torch.from_numpy(cfg.logprob_noise),
                         cfg.norm_term)
    port_step, _ = make_mfp_steps(port_model, opt, port_cfg, 0.3, "randint", tables,
                                  torch.Generator(), torch.device("cpu"))
    mask_num = jax_corruption.mask_num_of(8, 0.3)
    jax_m, port_m = [], []
    for step, batch in enumerate(batches):
        # map_tpu's draws for this step (train_step.py:452-453, 306)
        k_corrupt, _ = jax.random.split(jax.random.fold_in(base_rng, step))
        k_mask, k_noise = jax.random.split(k_corrupt)
        _, _, masked_index = jax_corruption.mfp_corrupt(
            k_mask, jnp.asarray(batch["input_ids"]), mask_num, "randint",
            input_size=cfg.input_size)
        noise, noise_logq = jax_alias.alias_draw_logq(k_noise, jnp.asarray(fused),
                                                      (64, mask_num, 5))
        draws = MFPDraws(*(torch.from_numpy(np.array(a)) for a in
                           (masked_index, noise, noise_logq)))
        state, m = train_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_m.append([float(m[k]) for k in ("loss", "count", "acc_count")])
        pm = port_step(batch, draws)
        port_m.append([pm[k].item() for k in ("loss", "count", "acc_count")])
    ref_params = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
    return (np.array(jax_m), np.array(port_m), ref_params, port_model.state_dict(),
            _jax_moments(tx, state.opt_state, cfg), opt)


def _assert_steps_agree(jax_m, port_m, ref, got, ref_mom, opt):
    """Losses at 1e-5, count and acc_count equal, Adam moments at 1e-5
    (atol 1e-8), parameters at 1e-5. One exception, with its own bound: an
    element whose every gradient so far lies within rounding of 0 (map_tpu's
    sqrt(nu) below 10 eps, 1e-7). There Adam's step lr mu / (sqrt(nu) + eps)
    is set by rounding, not by the gradient: both packages fold the decoder
    gradient as float32 prefix-sum differences, in other summation orders,
    and a candidate whose gradient is below one ulp of the prefix (a noise id
    of softmax weight ~1e-9) comes out as 0 in one and 1 ulp in the other.
    Such an element may move by up to lr a step: 2 lr k apart at most."""
    assert opt.count == K_STEPS
    np.testing.assert_allclose(port_m[:, 0], jax_m[:, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port_m[:, 1:], jax_m[:, 1:])  # count, acc_count
    assert set(got) == set(ref)
    loose = total = 0
    for key in ref:
        for part, g, r in zip(("mu", "nu"), opt.state()[key], ref_mom[key]):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-8,
                                       err_msg=f"{key} {part}")
        flat = np.sqrt(ref_mom[key][1].numpy()) < 1e-7
        diff = np.abs(got[key].numpy() - ref[key].numpy())
        np.testing.assert_array_less(
            diff[~flat], 1e-5 + 1e-5 * np.abs(ref[key].numpy()[~flat]), err_msg=key)
        assert (diff[flat] <= 2 * LR * K_STEPS).all(), key
        loose += int((flat & (diff > 1e-5)).sum())
        total += diff.size
    assert loose <= 0.001 * total, loose


@pytest.mark.parametrize("loss_type", ["nce", "sampled"])
def test_mfp_steps_match_map_tpu_f32(loss_type):
    runs = _k_mfp_runs(loss_type, False, "dedup_pallas")
    assert len(runs[3]) == 13  # 9 of the backbone + 4 of the MFP head
    _assert_steps_agree(*runs)


def test_mfp_steps_match_map_tpu_default_path():
    # map_tpu's defaults: lane-packed tables and the score-fused decoder
    # backward (nce_grad='dedup_bwd'). It forms the same products and folds
    # in another order of operations; the same tolerances hold.
    _assert_steps_agree(*_k_mfp_runs("nce", True, "dedup_bwd"))


# ---- parameters: decay mask, carry, finetune restore ----------------------------

def _flax_mfp(packed, num_layers=2, seed=0, input_size=600):
    cfg, _ = _mfp_config("nce", packed, "dedup_pallas", input_size)
    cfg.num_cross_layers = cfg.num_hidden_layers = num_layers
    model = jax_models.from_config(cfg)
    variables = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 8), jnp.int32),
        masked_index=jnp.zeros((2, 2), jnp.int32),
        candidates=jnp.zeros((2, 2, 6), jnp.int32))
    return cfg, _np(variables)


@pytest.mark.parametrize("packed", [False, True])
def test_mfp_checkpoint_carry_matches_export_state_dict(packed, tmp_path):
    # 4100 ids: the packed emb (16 ids of proj 8 a row) and bias (128 a
    # row) have padding rows to drop
    cfg, variables = _flax_mfp(packed, input_size=4100)
    jax_checkpoints.save_model_file(variables, str(tmp_path / "3.model"))
    cfg.save(str(tmp_path))
    sd = checkpoints.load_any_model_file(str(tmp_path / "3.model"), Config())
    params = variables["params"]
    dec = params["mfp_decoder"]
    assert (dec["emb"].shape == (257, 128)) == packed
    assert (dec["bias"].shape == (33, 128)) == packed
    ref = export_state_dict(params, "dcnv2", cfg)
    ref["mfp_criterion.emb.weight"] = dec["emb"].reshape(-1, 8)[:4100]
    ref["mfp_criterion.bias.weight"] = dec["bias"].reshape(-1, 1)[:4100]
    ref["embed.embedding.weight"] = params["embed"]["embedding"].reshape(-1, 16)[:4100]
    assert set(sd) == set(ref) and len(sd) == 13
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    assert sd["mfp_criterion.bias.weight"].shape == (4100, 1)
    models.from_config(Config.from_dict(cfg.to_dict())).load_state_dict(sd)


def test_partial_restore_counts_match_map_tpu():
    cfg, mfp_vars = _flax_mfp(packed=False, num_layers=3)
    ft_cfg = base_model_config(input_size=600, num_fields=8, embed_size=16,
                               hidden_size=32, num_hidden_layers=3, num_cross_layers=3)
    ft_vars = _np(jax_models.from_config(ft_cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((2, 8), jnp.int32)))
    merged, jax_loaded, jax_skipped = jax_checkpoints.partial_restore(ft_vars, mfp_vars)
    port_ft = models.from_config(Config.from_dict(ft_cfg.to_dict()))
    target = state_dict_from_jax(mfp_vars, Config.from_dict(cfg.to_dict()))
    got, loaded, skipped = checkpoints.partial_restore(port_ft.state_dict(), target)
    assert (loaded, skipped) == (jax_loaded, jax_skipped) == (13, 4)
    port_ft.load_state_dict(got)
    # the backbone is map_tpu's restored one; fc_out stays each package's own
    ref = state_dict_from_jax(merged, Config.from_dict(ft_cfg.to_dict()))
    assert set(ref) - set(target) == {"fc_out.weight", "fc_out.bias"}
    for key in set(ref) & set(target):
        np.testing.assert_array_equal(port_ft.state_dict()[key].numpy(),
                                      ref[key].numpy(), err_msg=key)


# ---- the whole slice: both CLIs --------------------------------------------------

_COMMON = ["--model_name=dcnv2", "--dataset_name=synth", "--embed_size=8",
           "--hidden_size=32", "--num_hidden_layers=1", "--num_cross_layers=2",
           "--compute_dtype", "float32", "--logging_steps=5", "--weight_decay=5e-2"]
_PRETRAIN = ["--pretrain", "--pt_type=MFP", "--sampling_method=randint",
             "--mask_ratio=0.3", "--pt_neg_num=5", "--proj_size=8",
             "--learning_rate=1e-3", "--lr_sched=cosine", "--num_train_epochs=2"]
_FINETUNE = ["--learning_rate=1e-2", "--lr_sched=const", "--num_train_epochs=1"]


def _mfp_evals(out_dir):
    log = open(os.path.join(out_dir, "train.log")).read()
    return [(float(a), float(b)) for a, b in re.findall(
        r"'eval_mfp_loss': ([\d.]+), 'eval_mfp_acc': ([\d.]+)", log)]


@pytest.mark.parametrize("source", ["port", "jax"])
def test_cli_pretrains_mfp_and_finetunes(synth_dir, tmp_path, source):
    """MFP pretraining by the port's CLI or map_tpu's (`source`), then the
    port's finetune from that checkpoint; map_tpu's own finetune from its
    checkpoint beside it."""
    batch = {"port": ["--per_device_train_batch_size=256",
                      "--per_device_eval_batch_size=200", "--device", "cpu"],
             "jax": [f"--per_device_train_batch_size={256 // JAX_DEVICES}",
                     f"--per_device_eval_batch_size={200 // JAX_DEVICES}"]}
    main = {"port": port_main, "jax": jax_main}[source]
    pt_dir = tmp_path / "pt"
    flags = _COMMON + [f"--data_dir={synth_dir}"]
    assert main(flags + _PRETRAIN + batch[source] + [f"--output_dir={pt_dir}"]) == 0
    assert os.path.exists(pt_dir / "results.log")
    evals = _mfp_evals(pt_dir)
    # 2 evals; accuracy above chance, 1 / (1 + k), and the loss falling
    assert len(evals) == 2 and min(acc for _, acc in evals) > 1 / 6
    assert evals[1][0] < evals[0][0]
    (ckpt,) = glob.glob(str(pt_dir / "*.model"))
    ft_dir = tmp_path / "ft"
    assert port_main(flags + _FINETUNE + batch["port"] + [
        f"--output_dir={ft_dir}", "--finetune",
        f"--pretrained_model_path={ckpt}"]) == 0
    log = open(ft_dir / "train.log").read()
    assert "finetune restore: 7 tensors loaded, 4 skipped" in log
    aucs = [float(x) for x in re.findall(r"'eval_auc': ([\d.]+)", log)]
    assert len(aucs) == 2 and aucs[0] > 0.6  # one eval + TEST
    if source == "jax":
        assert jax_main(flags + _FINETUNE + batch["jax"] + [
            f"--output_dir={tmp_path / 'jax_ft'}", "--finetune",
            f"--pretrained_model_path={ckpt}"]) == 0
        jax_log = open(tmp_path / "jax_ft" / "train.log").read()
        assert "finetune restore: 7 tensors loaded, 4 skipped" in jax_log


def test_feat_count_cache_is_map_tpus(synth_dir, tmp_path):
    from map_tpu.data.dataset import CTRDataset as JaxDataset
    from map_tpu_torch.data.dataset import CTRDataset

    data = tmp_path / "data"
    shutil.copytree(synth_dir, data)
    for name in ("feat-count.npy", "alias_prob.npy", "alias_alias.npy"):
        if (data / name).exists():
            (data / name).unlink()
    ds = CTRDataset(str(data), "synth", pretrain=True)
    assert (data / "feat-count.npy").exists()
    ref = JaxDataset(jax_config.TrainingArguments(data_dir=str(data),
                                                  dataset_name="synth", pretrain=True))
    np.testing.assert_array_equal(ds.feat_count, ref.feat_count)
    assert ds.feat_count.dtype == np.float32
    np.testing.assert_array_equal(ds.idx_low, ref.idx_low)
    np.testing.assert_array_equal(ds.idx_high, ref.idx_high)
    assert CTRDataset(str(data), "synth").feat_count is None


def test_cli_takes_the_mfp_and_finetune_script_flags():
    from map_tpu_torch.config import parse_args

    root = os.path.join(os.path.dirname(__file__), os.pardir, "run_script")
    script = open(os.path.join(root, "run_DCNv2_MFP.sh")).read()
    flags = re.findall(r"(--\w+(?:=\S+)?)", script.split("map_tpu.run")[1])
    model_args, args = parse_args([f for f in flags if f != '"$@"'])
    assert args.pretrain and args.pt_type == "MFP"
    assert (args.sampling_method, args.mask_ratio, args.lr_sched, args.weight_decay,
            args.learning_rate, args.per_device_train_batch_size) == (
        "randint", 0.3, "cosine", 5e-2, 1e-3, 4096)
    assert (model_args.pt_neg_num, model_args.proj_size, model_args.embed_size,
            model_args.hidden_size, model_args.num_cross_layers) == (25, 32, 16, 1000, 3)
    script = open(os.path.join(root, "run_DCNv2_finetune.sh")).read()
    flags = re.findall(r"(--\w+(?:=\S+)?)", script.split("map_tpu.run")[1])
    _, args = parse_args([f.replace('"$PRETRAINED_MODEL_PATH"', "p/9.model")
                          for f in flags])
    assert args.finetune and args.pretrained_model_path == "p/9.model"
    assert not args.pretrain and args.device is None  # the card unless --device cpu
