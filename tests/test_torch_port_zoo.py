"""map_tpu_torch's model zoo (LR, FM, DNN, DeepFM, xDeepFM, AutoInt,
Transformer) against map_tpu's on the CPU.

The same numpy-made inputs go through map_tpu and the port, with the weights
map_tpu draws carried by `state_dict_from_jax`: the carried keys against
map_tpu's `export_state_dict` (flat and lane-packed tables), the forward
logits (1e-5 in f32, a recorded bf16 band), 5 supervised steps for every
model, 5 MFP steps for the five pretrain-capable ones and 5 RFD steps for
DNN and AutoInt (losses, parameters and Adam moments at 1e-5 in f32), the
finetune restore's counts, the weight-decay rule, the refusals, and K
steps a call against K single steps with AutoInt's attention dropout on.
Dropout is 0 wherever map_tpu is compared: randomness is injected, never
compared. On the CPU every port op takes its plain PyTorch version; the
kernels are held against those on the card by `chip_smoke.py` and
`tests/test_torch_port_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from map_tpu import config as jax_config
from map_tpu import models as jax_models
from map_tpu.interop.torch_import import export_state_dict
from map_tpu.objectives import alias as jax_alias
from map_tpu.objectives import corruption as jax_corruption
from map_tpu.ops.packed_table import unpack_table
from map_tpu.train import checkpoints as jax_checkpoints
from map_tpu.train import train_step as jax_ts
from map_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from map_tpu.train.optimizer import no_decay_mask
from map_tpu_torch import models
from map_tpu_torch.config import Config, ModelArguments, TrainingArguments, parse_args
from map_tpu_torch.interop.from_jax import model_rules, state_dict_from_jax
from map_tpu_torch.train import checkpoints
from map_tpu_torch.train.optimizer import build_optimizer, decays
from map_tpu_torch.train.train_step import (
    MFPDraws,
    NoiseTables,
    make_mfp_steps,
    make_rfd_steps,
    make_supervised_steps,
)

from conftest import base_model_config
from test_torch_port_mfp import _assert_steps_agree, _feat_count
from test_torch_port_multistep import _port_trainer, _run_epochs
from test_torch_port_rfd import IDX_HIGH, IDX_LOW, VOCAB, _ids, _map_tpu_rfd_draws
from test_torch_port_train import _jax_moments, _np

K_STEPS = 5
LR = 1e-3
BATCH = 64
MASK_RATIO = 0.3

# small widths: 8 fields, E = 16, two layers of everything; AutoInt's
# 2 x 6 attention width differs from E, so its first layer has W_res (unused
# without res_conn: a zero gradient); the towers (use_lr, the MLP) are on
ZOO = {
    "lr": {},
    "fm": {},
    "dnn": dict(hidden_size=32, num_hidden_layers=2),
    "deepfm": dict(hidden_size=32, num_hidden_layers=2),
    "xdeepfm": dict(hidden_size=32, num_hidden_layers=2, cin_layer_units="6,5",
                    use_lr=True),
    "autoint": dict(attn_size=6, num_attn_heads=2, num_attn_layers=2, use_lr=True,
                    num_dnn_layers=1, dnn_size=16),
    "trans": dict(hidden_size=16, num_hidden_layers=2, num_attn_heads=2,
                  intermediate_size=32, output_reduction="attn,fc", use_lr=True,
                  num_dnn_layers=1, dnn_size=16),
}
PRETRAIN = ["dnn", "deepfm", "xdeepfm", "autoint", "trans"]
# further cases of the forward: the residual, the scale, the other
# reductions, pre-norm
VARIANTS = {
    "autoint res scale": ("autoint", dict(attn_size=6, num_attn_heads=2, res_conn=True,
                                          attn_scale=True)),
    "autoint 1 head": ("autoint", dict(attn_size=16, num_attn_heads=1)),
    "trans fc": ("trans", dict(hidden_size=16, num_attn_heads=2, intermediate_size=32,
                               output_reduction="fc")),
    "trans mean,fc": ("trans", dict(hidden_size=16, num_attn_heads=4, intermediate_size=32,
                                    output_reduction="mean,fc")),
    "trans sum,fc norm_first": ("trans", dict(hidden_size=16, num_attn_heads=2,
                                              intermediate_size=32, norm_first=True,
                                              output_reduction="sum,fc")),
    "xdeepfm cin only": ("xdeepfm", dict(num_hidden_layers=0, cin_layer_units="4,3,2")),
}

# bf16 band of the logits (map_tpu with lane-packed tables, the port with
# its plain table, the same weights): the embeddings, the MLP products and
# FM's sums round to bf16 at the same points, but the sums inside them run in
# other orders and XLA on the CPU may keep a bf16 sum in float32 where
# PyTorch rounds it; about one bf16 ulp (2**-8) of the logit's scale.
BF16_ATOL = 3e-2
BF16_RTOL = 3e-2


def _cfg(name, input_size=600, **overrides):
    kw = dict(ZOO.get(name, {}))
    kw.update(overrides)
    return base_model_config(model_name=name, input_size=input_size, num_fields=8,
                             embed_size=16, **kw)


def _pretrain_cfg(name, pt_type, **overrides):
    if pt_type == "MFP":
        cfg = _cfg(name, pretrain=True, pt_type="MFP", proj_size=8, pt_neg_num=5,
                   nce_loss_type="nce", nce_grad="dedup_pallas", **overrides)
        cfg.feat_count = _feat_count(cfg.input_size)
        probs = jax_alias.noise_distribution(cfg.feat_count)
        cfg.logprob_noise = np.log(probs).astype(np.float32)
        cfg.norm_term = float(np.log(cfg.input_size))
        return cfg
    return _cfg(name, input_size=VOCAB, pretrain=True, pt_type="RFD",
                RFD_replace="Unigram", proj_size=8, idx_low=IDX_LOW, idx_high=IDX_HIGH,
                **overrides)


def _init(cfg, seed=0):
    """map_tpu's variables of `cfg`, drawn from `seed`, as numpy."""
    kwargs = {}
    if cfg.pretrain and cfg.pt_type == "MFP":
        kwargs = dict(masked_index=jnp.zeros((2, 2), jnp.int32),
                      candidates=jnp.zeros((2, 2, 6), jnp.int32))
    model = jax_models.from_config(cfg)
    return model, _np(model.init(jax.random.PRNGKey(seed),
                                 jnp.zeros((2, cfg.num_fields), jnp.int32), **kwargs))


def _port(cfg, variables):
    port_cfg = Config.from_dict(cfg.to_dict())
    port_cfg.feat_count = getattr(cfg, "feat_count", None)
    model = models.from_config(port_cfg)
    model.load_state_dict(state_dict_from_jax(variables, port_cfg))
    return port_cfg, model


def _ids8(n, input_size, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, input_size, size=(n, 8)).astype(np.int32)


# ---- (a) the weight carry -----------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", list(ZOO))
def test_weight_carry_matches_export_state_dict(name, packed):
    # 4100 ids at E = 16 pack into 513 rows, padded to 1024 (ROW_ALIGN)
    cfg = _cfg(name, input_size=4100, packed_tables=packed)
    _, variables = _init(cfg)
    port_cfg = Config.from_dict(cfg.to_dict())
    sd = state_dict_from_jax(variables, port_cfg)
    ref = export_state_dict(variables["params"], name, cfg)
    assert set(sd) == set(ref)
    params = variables["params"]
    for key, val in ref.items():
        if key == "embed.embedding.weight" and packed:
            # export_state_dict passes the packed array through unchanged
            assert params["embed"]["embedding"].shape == (1024, 128)
            val = np.asarray(unpack_table(jnp.asarray(params["embed"]["embedding"]),
                                          4100, 16))
        assert sd[key].shape == val.shape, key
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    # the carried state_dict loads strictly, and holds every parameter
    model = models.from_config(port_cfg)
    model.load_state_dict(sd)
    assert set(sd) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("pt_type", ["MFP", "RFD"])
@pytest.mark.parametrize("name", PRETRAIN)
def test_pretraining_carry_matches_export_state_dict(name, pt_type):
    cfg = _pretrain_cfg(name, pt_type)
    _, variables = _init(cfg)
    port_cfg = Config.from_dict(cfg.to_dict())
    sd = state_dict_from_jax(variables, port_cfg)
    ref = export_state_dict(variables["params"], name, cfg)
    assert set(sd) == set(ref)
    heads = ({"feat_encoder.weight", "feat_encoder.bias", "mfp_criterion.emb.weight",
              "mfp_criterion.bias.weight"} if pt_type == "MFP" else
             {"pred_rfd.0.weight", "pred_rfd.0.bias", "pred_rfd.2.weight",
              "pred_rfd.2.bias"})
    assert heads <= set(sd)
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    port_cfg.feat_count = getattr(cfg, "feat_count", None)
    models.from_config(port_cfg).load_state_dict(sd)


# ---- (b) the forward ----------------------------------------------------------------

def _logits(cfg, seed, n=33):
    model, variables = _init(cfg, seed)
    ids = _ids8(n, cfg.input_size, seed)
    ref = np.asarray(model.apply(variables, jnp.asarray(ids)))
    _, port = _port(cfg, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(ids))
    assert out.dtype == torch.float32 and out.shape == (n, 1)
    return out.numpy(), ref


CASES = {**{name: (name, {}) for name in ZOO}, **VARIANTS}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_map_tpu_f32(case, packed):
    name, overrides = CASES[case]
    kw = dict(ZOO[name]) if case == name else {}
    kw.update(overrides)
    got, ref = _logits(_cfg(name, packed_tables=packed, **kw), seed=1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(ZOO))
def test_logits_match_map_tpu_bf16_band(name):
    got, ref = _logits(_cfg(name, packed_tables=True, compute_dtype="bfloat16"), seed=2)
    np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("output", ["product_sum", "bi_interaction", "inner_product"])
def test_inner_product_layer_matches_map_tpu(output):
    from map_tpu.nn.layers import InnerProductLayer as JaxInnerProduct
    from map_tpu_torch.nn.layers import InnerProductLayer

    x = np.random.default_rng(4).normal(size=(9, 7, 5)).astype(np.float32)
    layer = JaxInnerProduct(num_fields=7, output=output)
    ref = np.asarray(layer.apply({}, jnp.asarray(x)))
    got = InnerProductLayer(7, output)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", PRETRAIN)
def test_backbone_matches_map_tpu_f32(name):
    """The final_vec each pretraining head reads, and its width."""
    cfg = _pretrain_cfg(name, "RFD")
    model, variables = _init(cfg, seed=3)
    ids = _ids(np.random.default_rng(3), 17)
    ref = np.asarray(model.apply(variables, jnp.asarray(ids),
                                 method=lambda m, x: m.backbone(x)))
    _, port = _port(cfg, variables)
    with torch.no_grad():
        got = port.backbone(torch.from_numpy(ids))
    width = {"dnn": 32, "deepfm": 33, "xdeepfm": 6 + 5 + 32, "autoint": 8 * 12,
             "trans": 8 * 16}[name]
    assert tuple(got.shape) == ref.shape == (17, width)
    assert port.pred_rfd[0].in_features == width
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---- (c) 5 supervised steps -----------------------------------------------------------

def _supervised_runs(cfg):
    rng = np.random.default_rng(17)
    batches = []
    for i in range(K_STEPS):
        weight = np.ones(BATCH, np.float32)
        if i == K_STEPS - 1:
            weight[40:] = 0.0  # a padded last batch
        batches.append({"input_ids": rng.integers(0, cfg.input_size, (BATCH, 8)
                                                  ).astype(np.int32),
                        "labels": rng.integers(0, 2, BATCH).astype(np.float32),
                        "weight": weight})
    jargs = jax_config.TrainingArguments(learning_rate=LR, weight_decay=0.1,
                                         lr_sched="cosine", compute_dtype="float32",
                                         packed_tables=cfg.packed_tables)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": batches[0]["input_ids"]})
    port_cfg, port_model = _port(cfg, {"params": _np(state.params)})
    opt, _ = build_optimizer(port_model, TrainingArguments(
        learning_rate=LR, weight_decay=0.1, lr_sched="cosine"), 10, 2)
    port_step, _ = make_supervised_steps(port_model, opt, torch.device("cpu"))
    jax_step, _ = jax_ts.make_supervised_steps(model, cfg, jargs, tx,
                                               jax.random.PRNGKey(5))
    jax_losses, port_losses = [], []
    for batch in batches:
        state, m = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_losses.append(float(m["loss"]))
        port_losses.append(port_step(batch)["loss"].item())
    ref = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
    return (np.array(jax_losses), np.array(port_losses), ref, port_model.state_dict(),
            _jax_moments(tx, state.opt_state, cfg), opt)


def _assert_close_steps(jax_m, port_m, ref, got, ref_mom, opt):
    """Metrics and parameters at 1e-5. Adam's moments at 1e-5 of their
    tensor's scale: a moment is a sum of gradients that may cancel to far
    below its terms, and the terms' rounding, not the sum's, sets its error
    (the Transformer's v bias: 1.5e-8 on a moment of 2e-4 in a tensor of
    scale 3e-2). One exception, with its own bound: an element whose every
    gradient so far lies within rounding of 0 (map_tpu's sqrt(nu) below
    1e-7), which the attention has by construction: the k bias shifts each
    query's scores by one constant, and so does the `attn,fc` pooling's
    score bias, under a softmax that ignores it. There Adam's step lr mu /
    (sqrt(nu) + eps) is set by rounding, in both packages: such an element
    may move by up to lr a step, 2 lr k apart at most, and its moments stay
    at rounding level on both sides."""
    assert opt.count == K_STEPS
    np.testing.assert_allclose(port_m, jax_m, rtol=1e-5, atol=1e-5)
    assert set(got) == set(ref)
    for key in ref:
        r, g = ref[key].numpy(), got[key].numpy()
        (mu, nu), (ref_mu, ref_nu) = (m.numpy() for m in opt.state()[key]), (
            m.numpy() for m in ref_mom[key])
        flat = np.sqrt(ref_nu) < 1e-7
        diff = np.abs(g - r)
        np.testing.assert_array_less(diff[~flat], 1e-5 + 1e-5 * np.abs(r[~flat]),
                                     err_msg=key)
        assert (diff[flat] <= 2 * LR * K_STEPS).all(), key
        for part, a, b in (("mu", mu, ref_mu), ("nu", nu, ref_nu)):
            scale = float(np.abs(b).max())
            np.testing.assert_array_less(
                np.abs(a - b)[~flat], 1e-5 * scale + 1e-5 * np.abs(b[~flat]),
                err_msg=f"{key} {part}")
        assert (np.abs(mu[flat]) < 1e-6).all() and (np.sqrt(nu[flat]) < 1e-6).all(), key


@pytest.mark.parametrize("name", list(ZOO))
def test_supervised_steps_match_map_tpu_f32(name):
    runs = _supervised_runs(_cfg(name, packed_tables=True, compute_dtype="float32"))
    _assert_close_steps(*runs)
    if name == "autoint":
        # W_res is unused without the residual: it moves by weight decay only
        ref_mu = runs[4]["self_attention.0.W_res.weight"][0]
        assert float(ref_mu.abs().max()) == 0.0


# ---- (d) 5 MFP and 5 RFD steps ------------------------------------------------------------

def _mfp_runs(cfg):
    """map_tpu's MFP steps and the port's from the same carried weights, on
    the same batches, with map_tpu's draws (test_torch_port_mfp's pattern)."""
    probs = jax_alias.noise_distribution(cfg.feat_count)
    prob_t, alias_t = jax_alias.build_alias_table(probs)
    fused = jax_alias.build_fused_alias(prob_t, alias_t, cfg.logprob_noise)
    rng = np.random.default_rng(21)
    batches = []
    for i in range(K_STEPS):
        weight = np.ones(BATCH, np.float32)
        if i == K_STEPS - 1:
            weight[40:] = 0.0
        batches.append({"input_ids": rng.integers(10, cfg.input_size, (BATCH, 8)
                                                  ).astype(np.int32),
                        "labels": np.zeros(BATCH, np.float32), "weight": weight})
    jargs = jax_config.TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine", mask_ratio=MASK_RATIO,
        sampling_method="randint", pretrain=True, pt_type="MFP",
        compute_dtype="float32", packed_tables=False)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": batches[0]["input_ids"]})
    base_rng = jax.random.PRNGKey(5)
    jax_step, _ = jax_ts.make_mfp_steps(model, cfg, jargs, tx, base_rng, prob_t, alias_t,
                                        cfg.logprob_noise)
    port_cfg, port_model = _port(cfg, {"params": _np(state.params)})
    opt, _ = build_optimizer(port_model, TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine"), 10, 2)
    tables = NoiseTables(torch.from_numpy(fused), torch.from_numpy(cfg.logprob_noise),
                         cfg.norm_term)
    port_step, _ = make_mfp_steps(port_model, opt, port_cfg, MASK_RATIO, "randint", tables,
                                  torch.Generator(), torch.device("cpu"))
    mask_num = jax_corruption.mask_num_of(8, MASK_RATIO)
    jax_m, port_m = [], []
    for step, batch in enumerate(batches):
        k_corrupt, _ = jax.random.split(jax.random.fold_in(base_rng, step))
        k_mask, k_noise = jax.random.split(k_corrupt)
        _, _, masked_index = jax_corruption.mfp_corrupt(
            k_mask, jnp.asarray(batch["input_ids"]), mask_num, "randint",
            input_size=cfg.input_size)
        noise, noise_logq = jax_alias.alias_draw_logq(k_noise, jnp.asarray(fused),
                                                      (BATCH, mask_num, 5))
        draws = MFPDraws(*(torch.from_numpy(np.array(a)) for a in
                           (masked_index, noise, noise_logq)))
        state, m = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_m.append([float(m[k]) for k in ("loss", "count", "acc_count")])
        pm = port_step(batch, draws)
        port_m.append([pm[k].item() for k in ("loss", "count", "acc_count")])
    ref = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
    return (np.array(jax_m), np.array(port_m), ref, port_model.state_dict(),
            _jax_moments(tx, state.opt_state, cfg), opt)


@pytest.mark.parametrize("name", PRETRAIN)
def test_mfp_steps_match_map_tpu_f32(name):
    _assert_steps_agree(*_mfp_runs(_pretrain_cfg(name, "MFP", compute_dtype="float32")))


def _rfd_runs(cfg):
    mask_num = jax_corruption.mask_num_of(8, MASK_RATIO)
    rng = np.random.default_rng(23)
    batches = []
    for i in range(K_STEPS):
        weight = np.ones(BATCH, np.float32)
        if i == K_STEPS - 1:
            weight[40:] = 0.0
        batches.append({"input_ids": _ids(rng, BATCH),
                        "labels": rng.integers(0, 2, BATCH).astype(np.float32),
                        "weight": weight, "noise_rows": _ids(rng, BATCH * mask_num)})
    jargs = jax_config.TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine", mask_ratio=MASK_RATIO,
        sampling_method="randint", pretrain=True, pt_type="RFD", RFD_replace="Unigram",
        compute_dtype="float32", packed_tables=True)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": batches[0]["input_ids"]})
    base_rng = jax.random.PRNGKey(5)
    jax_step, _ = jax_ts.make_rfd_steps(model, cfg, jargs, tx, base_rng)
    port_cfg, port_model = _port(cfg, {"params": _np(state.params)})
    opt, _ = build_optimizer(port_model, TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine"), 10, 2)
    port_step, _ = make_rfd_steps(port_model, opt, port_cfg, MASK_RATIO, "randint",
                                  "Unigram", torch.Generator(), torch.device("cpu"))
    keys = ("loss", "acc", "pos_ratio", "count")
    jax_m, port_m = [], []
    for step, batch in enumerate(batches):
        k_corrupt, _ = jax.random.split(jax.random.fold_in(base_rng, step))
        pm = port_step(batch, _map_tpu_rfd_draws(k_corrupt, batch["input_ids"], mask_num,
                                                 "randint", "Unigram"))
        state, m = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_m.append([float(m[k]) for k in keys])
        port_m.append([pm[k].item() for k in keys])
    ref = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
    return (np.array(jax_m), np.array(port_m), ref, port_model.state_dict(),
            _jax_moments(tx, state.opt_state, cfg), opt)


@pytest.mark.parametrize("mode", ["fwd", "bwd_pallas"])
@pytest.mark.parametrize("name", ["dnn", "autoint"])
def test_rfd_steps_match_map_tpu_f32(name, mode, monkeypatch):
    from map_tpu.ops import hybrid_gather as jax_hg
    from map_tpu_torch.ops import hybrid_gather

    for module in (jax_hg, hybrid_gather):
        monkeypatch.setattr(module, "SMALL_FIELD_MAX", 100)
    cfg = _pretrain_cfg(name, "RFD", compute_dtype="float32", packed_tables=True,
                        hybrid_mode=mode)
    _assert_close_steps(*_rfd_runs(cfg))


# ---- (e) the finetune restore ----------------------------------------------------------

@pytest.mark.parametrize("pt_type", ["MFP", "RFD"])
@pytest.mark.parametrize("name", PRETRAIN)
def test_partial_restore_counts_match_map_tpu(name, pt_type, tmp_path):
    pt_cfg = _pretrain_cfg(name, pt_type)
    _, pt_vars = _init(pt_cfg, seed=0)
    ft_cfg = _cfg(name, input_size=pt_cfg.input_size)
    _, ft_vars = _init(ft_cfg, seed=1)
    merged, jax_loaded, jax_skipped = jax_checkpoints.partial_restore(ft_vars, pt_vars)
    # the port restores from map_tpu's msgpack checkpoint, as --finetune does
    jax_checkpoints.save_model_file(pt_vars, str(tmp_path / "5.model"))
    pt_cfg.save(str(tmp_path))
    target = checkpoints.load_any_model_file(str(tmp_path / "5.model"), Config())
    port_ft = models.from_config(Config.from_dict(ft_cfg.to_dict()))
    got, loaded, skipped = checkpoints.partial_restore(port_ft.state_dict(), target)
    # torch's packed in_proj (weight, bias) holds map_tpu's q/k/v kernels and
    # biases: 2 tensors for 6 leaves in each encoder layer
    packed = 4 * ft_cfg.num_hidden_layers if name == "trans" else 0
    assert (loaded + packed, skipped) == (jax_loaded, jax_skipped) and skipped == 4
    port_ft.load_state_dict(got)
    ref = state_dict_from_jax(merged, Config.from_dict(ft_cfg.to_dict()))
    for key in set(ref) & set(target):
        np.testing.assert_array_equal(port_ft.state_dict()[key].numpy(),
                                      ref[key].numpy(), err_msg=key)


# ---- (f) the weight-decay rule ---------------------------------------------------------------

@pytest.mark.parametrize("name,head", [(n, "supervised") for n in ZOO] + [
    (n, h) for n in PRETRAIN for h in ("MFP", "RFD")])
def test_decay_rule_matches_no_decay_mask(name, head):
    cfg = _cfg(name) if head == "supervised" else _pretrain_cfg(name, head)
    _, variables = _init(cfg)
    mask = traverse_util.flatten_dict(no_decay_mask(variables["params"]))
    port_cfg = Config.from_dict(cfg.to_dict())
    port_cfg.feat_count = getattr(cfg, "feat_count", None)
    names = [n for n, _ in models.from_config(port_cfg).named_parameters()]
    rules = model_rules(port_cfg)
    assert sorted(names) == sorted(key for key, _, _ in rules)
    covered = set()
    for key, path, kind in rules:
        if kind.startswith("in_proj"):
            leaf = "kernel" if kind == "in_proj_weight" else "bias"
            paths = [path + (p, "dense", leaf) for p in ("q_proj", "k_proj", "v_proj")]
        else:
            paths = [path]
        for p in paths:
            assert decays(key) == mask[p], key
            covered.add(p)
    assert covered == set(mask)  # every map_tpu leaf has its port parameter


# ---- (g) what the zoo refuses ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["lr", "fm"])
def test_lr_and_fm_refuse_pretraining(name):
    for pt_type in ("MFP", "RFD"):
        cfg = Config.from_dict(_cfg(name, pretrain=True, pt_type=pt_type).to_dict())
        with pytest.raises(NotImplementedError, match="pretrain-capable"):
            models.from_config(cfg)
        with pytest.raises(NotImplementedError, match="pretrain-capable"):
            _init(_cfg(name, pretrain=True, pt_type=pt_type))


def test_trans_refuses_embed_other_than_hidden():
    cfg = _cfg("trans", hidden_size=32)
    with pytest.raises(AssertionError, match="embed_size == hidden_size"):
        jax_models.from_config(cfg).validate_model_config()
    with pytest.raises(ValueError, match="embed_size == hidden_size"):
        models.from_config(Config.from_dict(cfg.to_dict()))
    with pytest.raises(ValueError, match="embed_size == hidden_size"):
        parse_args(["--model_name=trans", "--embed_size=16", "--hidden_size=32"])
    model_args, _ = parse_args(["--model_name=trans", "--embed_size=16",
                                "--hidden_size=16", "--output_reduction=attn,fc"])
    assert model_args.output_reduction == "attn,fc"


def test_unported_models_name_the_roadmap():
    for name in ("fignn", "fgcnn"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            models.from_config(Config.from_dict(_cfg(name).to_dict()))
    assert sorted(models.MODEL_REGISTRY) == sorted(
        ["lr", "fm", "dnn", "deepfm", "xdeepfm", "dcnv2", "autoint", "trans"])


def test_model_flags_take_map_tpus_defaults():
    ours = ModelArguments()
    ref = jax_config.ModelArguments()
    for f in ("num_attn_heads", "attn_probs_dropout_rate", "intermediate_size",
              "norm_first", "layer_norm_eps", "res_conn", "output_reduction",
              "attn_scale", "use_lr", "attn_size", "num_attn_layers", "cin_layer_units",
              "dnn_size", "num_dnn_layers", "dnn_act", "dnn_drop"):
        assert getattr(ours, f) == getattr(ref, f), f
        assert getattr(Config(), f) == getattr(ref, f), f


# ---- (h) AutoInt's attention dropout under the multi-step dispatch ----------------------------

def test_autoint_dropout_k_steps_a_call_equal_k_single_steps():
    rng = np.random.default_rng(31)
    rows = 4 * BATCH + 40
    x = _ids(rng, rows)
    y = rng.integers(0, 2, rows).astype(np.float32)
    cfg = _cfg("autoint", input_size=VOCAB, attn_probs_dropout_rate=0.1,
               compute_dtype="float32", idx_low=IDX_LOW, idx_high=IDX_HIGH)
    args = dict(per_device_train_batch_size=BATCH, learning_rate=LR, weight_decay=0.05,
                lr_sched="cosine", num_train_epochs=2, seed=11, compute_dtype="float32",
                device="cpu", data_dir="")
    runs = []
    for resident, spc in (("off", 1), ("on", 4)):
        trainer = _port_trainer(cfg, dict(args, device_resident_data=resident,
                                          steps_per_call=spc), x, y)
        assert trainer.model.self_attention[0].dropout.rate == 0.1
        runs.append((_run_epochs(trainer), trainer))
    (m1, t1), (m4, t4) = runs
    assert t4._data is not None and t1._data is None and t4.global_step == 10
    for k in m1:
        assert torch.equal(m1[k], m4[k]), k
    for (name, a), b in zip(t1.model.named_parameters(), t4.model.parameters()):
        assert torch.equal(a, b), name
    # the dropout drew: the same run without it ends elsewhere
    t0 = _port_trainer(cfg, dict(args, device_resident_data="off", steps_per_call=1), x, y)
    t0.model.self_attention[0].dropout.rate = 0.0
    t0.model.self_attention[1].dropout.rate = 0.0
    _run_epochs(t0)
    assert not torch.equal(t0.model.attn_out.weight, t1.model.attn_out.weight)
