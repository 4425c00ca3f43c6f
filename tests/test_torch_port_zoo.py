"""map_tpu_torch's model zoo (LR, FM, DNN, DeepFM, xDeepFM, FGCNN, FiGNN,
AutoInt, Transformer) against map_tpu's on the CPU.

The same numpy-made inputs go through map_tpu and the port, with the weights
map_tpu draws carried by `state_dict_from_jax`: the carried keys against
map_tpu's `export_state_dict` (flat and lane-packed tables) and FGCNN's
running statistics against its `batch_stats`, the forward logits (1e-5 in
f32, in eval mode and, for FGCNN and FiGNN, in train mode; a recorded bf16
band), 5 supervised steps for every model, 5 MFP steps for the seven
pretrain-capable ones and 5 RFD steps for the same seven
(losses, parameters, Adam moments and BatchNorm running statistics at 1e-5
in f32), the finetune restore's counts, the weight-decay rule, the
registry, the refusals, the port's BatchNorm against flax's, and K steps a
call against K single steps with AutoInt's attention dropout on and with
FGCNN's running statistics.
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
from map_tpu_torch.nn.layers import BatchNorm
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
    # 2 GNN rounds; FGCNN's two stages of base_model_config (channels 3,4,
    # kernel heights 3,3, pools 2,2, recombined 2,2) from a table of its own
    # (map_tpu's default, share_embedding off)
    "fignn": dict(num_hidden_layers=2),
    "fgcnn": dict(hidden_size=32, num_hidden_layers=2, share_embedding=False),
}
PRETRAIN = ["dnn", "deepfm", "xdeepfm", "autoint", "trans", "fignn", "fgcnn"]
GRAPH_MODELS = ["fignn", "fgcnn"]
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
    "fignn reuse res": ("fignn", dict(num_hidden_layers=2, reuse_graph_layer=True,
                                      res_conn=True)),
    "fignn res": ("fignn", dict(num_hidden_layers=3, res_conn=True)),
    "fgcnn shared": ("fgcnn", dict(hidden_size=32, num_hidden_layers=1,
                                   share_embedding=True)),
    # pools of 3 after an even kernel: map_tpu pads the first pool by
    # 8 mod 3 = 2 rows a side, so 4 rows come out of 7 where its ceil chain
    # says 3 (the new fields), and the second stage starts from those 4
    "fgcnn pool 3": ("fgcnn", dict(num_hidden_layers=0, share_embedding=False,
                                   kernel_heights="2,3", pooling_sizes="3,2")),
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
    """map_tpu's variables of `cfg`, drawn from `seed`, as numpy. FGCNN's
    running statistics are moved off their start (0 and 1) by one train-mode
    forward on random ids, so that eval mode reads statistics of a batch."""
    kwargs = {}
    if cfg.pretrain and cfg.pt_type == "MFP":
        kwargs = dict(masked_index=jnp.zeros((2, 2), jnp.int32),
                      candidates=jnp.zeros((2, 2, 6), jnp.int32))
    model = jax_models.from_config(cfg)
    variables = _np(model.init(jax.random.PRNGKey(seed),
                               jnp.zeros((2, cfg.num_fields), jnp.int32), **kwargs))
    if "batch_stats" in variables:
        ids = jnp.asarray(_ids8(16, cfg.input_size, seed + 100))
        if cfg.pretrain and cfg.pt_type == "MFP":
            kwargs = dict(masked_index=jnp.zeros((16, 2), jnp.int32),
                          candidates=jnp.zeros((16, 2, 6), jnp.int32))
        _, mutated = model.apply(variables, ids, train=True, mutable=["batch_stats"],
                                 **kwargs)
        variables["batch_stats"] = _np(mutated["batch_stats"])
    return model, variables


def _variables(state):
    """A map_tpu TrainState's variables as numpy: params, and batch_stats
    where the model has them."""
    out = {"params": _np(state.params)}
    if state.batch_stats:
        out["batch_stats"] = _np(state.batch_stats)
    return out


def _is_stat(key):
    return ".running_" in key


def _running_stats_agree(ref, got, ref_mom=None):
    """Split BatchNorm's running statistics off both state_dicts, hold them
    at 1e-5 and return the parameters alone. After steps (map_tpu's Adam
    moments `ref_mom` given), one exception with its own bound: a running
    mean follows its convolution's channel bias, whose gradient is zero by
    construction (the BatchNorm after it takes away every shift of a
    channel), so only rounding is left, which Adam normalises in both
    packages, as for the attention's k bias (`_assert_close_steps`). Where
    map_tpu's moments of that bias are at rounding level (sqrt(nu) < 1e-7),
    the bias may move up to lr a step in each package, 2 lr k apart, and
    the running mean, 0.1 of each step's batch mean (the bias among it),
    no farther; the running variance does not see the shift."""
    assert {k for k in ref if _is_stat(k)} == {k for k in got if _is_stat(k)}
    for key in (k for k in ref if _is_stat(k)):
        r, g = ref[key].numpy(), got[key].numpy()
        flat = np.zeros(r.shape, bool)
        if ref_mom is not None and key.endswith("running_mean"):
            bias = key.replace(".1.running_mean", ".0.bias")
            flat = np.sqrt(ref_mom[bias][1].numpy()) < 1e-7
        diff = np.abs(g - r)
        np.testing.assert_array_less(diff[~flat], 1e-5 + 1e-5 * np.abs(r[~flat]),
                                     err_msg=key)
        assert (diff[flat] <= 2 * LR * K_STEPS).all(), key
    return ({k: v for k, v in ref.items() if not _is_stat(k)},
            {k: v for k, v in got.items() if not _is_stat(k)})


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
    assert {k for k in sd if not _is_stat(k)} == set(ref)
    params = variables["params"]
    for key, val in ref.items():
        table = key.split(".")[0]
        if key in ("embed.embedding.weight", "fg_embed.embedding.weight") and packed:
            # export_state_dict passes the packed array through unchanged
            assert params[table]["embedding"].shape == (1024, 128)
            val = np.asarray(unpack_table(jnp.asarray(params[table]["embedding"]),
                                          4100, 16))
        assert sd[key].shape == val.shape, key
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    # FGCNN's running statistics, from map_tpu's batch_stats (two a stage)
    stats = variables.get("batch_stats", {}).get("fgcnn_layer", {})
    assert len([k for k in sd if _is_stat(k)]) == 2 * len(stats)
    for key in (k for k in sd if _is_stat(k)):
        stage = stats[f"bn_{key.split('.')[2]}"]
        mean = key.endswith("running_mean")
        val = stage["mean" if mean else "var"]
        assert not np.allclose(val, 0.0 if mean else 1.0), key  # moved by _init
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    # the carried state_dict loads strictly, and holds every parameter and buffer
    model = models.from_config(port_cfg)
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())


@pytest.mark.parametrize("pt_type", ["MFP", "RFD"])
@pytest.mark.parametrize("name", PRETRAIN)
def test_pretraining_carry_matches_export_state_dict(name, pt_type):
    cfg = _pretrain_cfg(name, pt_type)
    _, variables = _init(cfg)
    port_cfg = Config.from_dict(cfg.to_dict())
    sd = state_dict_from_jax(variables, port_cfg)
    ref = export_state_dict(variables["params"], name, cfg)
    assert {k for k in sd if not _is_stat(k)} == set(ref)
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


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] in GRAPH_MODELS])
def test_train_mode_logits_and_running_stats_match_map_tpu_f32(case):
    """Train mode: FGCNN's BatchNorm normalises by the batch (all 33 rows)
    and moves its running statistics; FiGNN has no state of the kind."""
    name, overrides = CASES[case]
    kw = dict(ZOO[name]) if case == name else {}
    kw.update(overrides)
    cfg = _cfg(name, **kw)
    model, variables = _init(cfg, seed=5)
    ids = _ids8(33, cfg.input_size, 5)
    ref, mutated = model.apply(variables, jnp.asarray(ids), train=True,
                               mutable=["batch_stats"])
    port_cfg, port = _port(cfg, variables)
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    moved = state_dict_from_jax({**variables, "batch_stats": _np(mutated["batch_stats"])},
                                port_cfg) if "batch_stats" in variables else {}
    _running_stats_agree(moved, port.state_dict())
    assert (name == "fgcnn") == bool(moved)


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
    # FGCNN: 8 + 4 * 2 + 2 * 2 = 20 fields, 20 * 19 / 2 products + 20 * 16
    width = {"dnn": 32, "deepfm": 33, "xdeepfm": 6 + 5 + 32, "autoint": 8 * 12,
             "trans": 8 * 16, "fignn": 8 * 16, "fgcnn": 190 + 320}[name]
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
    port_cfg, port_model = _port(cfg, _variables(state))
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
    ref = state_dict_from_jax(_variables(state), port_cfg)
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
    at rounding level on both sides. BatchNorm's running statistics, which
    have no moments, at 1e-5."""
    ref, got = _running_stats_agree(ref, got, ref_mom)
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
    port_cfg, port_model = _port(cfg, _variables(state))
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
    ref = state_dict_from_jax(_variables(state), port_cfg)
    return (np.array(jax_m), np.array(port_m), ref, port_model.state_dict(),
            _jax_moments(tx, state.opt_state, cfg), opt)


@pytest.mark.parametrize("name", PRETRAIN)
def test_mfp_steps_match_map_tpu_f32(name):
    runs = _mfp_runs(_pretrain_cfg(name, "MFP", compute_dtype="float32"))
    if name != "fgcnn":
        _assert_steps_agree(*runs)
        return
    # FGCNN's convolution biases take gradients of rounding only (the
    # BatchNorm after each takes away its shift), whose Adam moments are
    # rounding too: held as its supervised and RFD steps are, with the MFP
    # counts exact
    jax_m, port_m = runs[:2]
    np.testing.assert_array_equal(port_m[:, 1:], jax_m[:, 1:])  # count, acc_count
    _assert_close_steps(*runs)


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
    port_cfg, port_model = _port(cfg, _variables(state))
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
    ref = state_dict_from_jax(_variables(state), port_cfg)
    return (np.array(jax_m), np.array(port_m), ref, port_model.state_dict(),
            _jax_moments(tx, state.opt_state, cfg), opt)


@pytest.mark.parametrize("mode", ["fwd", "bwd_pallas"])
@pytest.mark.parametrize("name", PRETRAIN)
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
    assert (loaded + _packed_leaves(ft_cfg), skipped) == (jax_loaded, jax_skipped)
    assert skipped == 4
    port_ft.load_state_dict(got)
    ref = state_dict_from_jax(merged, Config.from_dict(ft_cfg.to_dict()))
    for key in set(ref) & set(target):
        np.testing.assert_array_equal(port_ft.state_dict()[key].numpy(),
                                      ref[key].numpy(), err_msg=key)


def _packed_leaves(cfg):
    """map_tpu's leaves a restore counts beyond the port's tensors: torch's
    packed in_proj (weight, bias) holds map_tpu's q/k/v kernels and biases,
    2 tensors for 6 leaves in each encoder layer; torch's GRUCell (weight_ih,
    weight_hh, bias_ih, bias_hh) holds flax's 10 (ir, iz, in, hr, hz, hn
    kernels; ir, iz, in, hn biases), 4 tensors for 10. FGCNN's BatchNorm
    counts 2 statistics a stage in both (running_mean / running_var, mean /
    var), its other tensors one for one."""
    return {"trans": 4 * cfg.num_hidden_layers, "fignn": 6}.get(cfg.model_name, 0)


PRETRAIN_HEAD_KEYS = {
    "MFP": ("feat_encoder.weight", "feat_encoder.bias", "mfp_criterion.emb.weight",
            "mfp_criterion.bias.weight"),
    "RFD": ("pred_rfd.0.weight", "pred_rfd.0.bias", "pred_rfd.2.weight",
            "pred_rfd.2.bias")}


@pytest.mark.parametrize("pt_type", ["MFP", "RFD"])
@pytest.mark.parametrize("name", GRAPH_MODELS)
def test_partial_restore_counts_from_a_port_checkpoint(name, pt_type, tmp_path):
    """The same counts from the port's own `{step}.model` (its state_dict,
    buffers included), as a finetune from a port pretraining run gets."""
    pt_cfg = _pretrain_cfg(name, pt_type)
    _, pt_vars = _init(pt_cfg, seed=0)
    ft_cfg = _cfg(name, input_size=pt_cfg.input_size)
    _, ft_vars = _init(ft_cfg, seed=1)
    _, jax_loaded, jax_skipped = jax_checkpoints.partial_restore(ft_vars, pt_vars)
    _, port_pt = _port(pt_cfg, pt_vars)
    path = checkpoints.save_model(port_pt.state_dict(), str(tmp_path), 5)
    target = checkpoints.load_any_model_file(path, Config())
    assert set(target) == set(port_pt.state_dict())
    port_ft = models.from_config(Config.from_dict(ft_cfg.to_dict()))
    got, loaded, skipped = checkpoints.partial_restore(port_ft.state_dict(), target)
    assert (loaded + _packed_leaves(ft_cfg), skipped) == (jax_loaded, jax_skipped)
    assert skipped == 4 and loaded == len(target) - 4
    port_ft.load_state_dict(got)
    for key in set(target) - set(PRETRAIN_HEAD_KEYS[pt_type]):
        assert torch.equal(port_ft.state_dict()[key], target[key]), key



@pytest.mark.parametrize("source", ["jax", "torch"])
@pytest.mark.parametrize("name", GRAPH_MODELS)
def test_predictor_serves_in_eval_mode_from_the_running_stats(name, source, tmp_path):
    """`Predictor` over map_tpu's msgpack checkpoint (its batch_stats carried)
    or the port's `{step}.model`: the logits of map_tpu's eval-mode forward,
    FGCNN's BatchNorm normalising by the checkpoint's running statistics,
    with the last chunk padded."""
    from map_tpu_torch.serve import Predictor

    cfg = _cfg(name)
    model, variables = _init(cfg, seed=7)
    ids = _ids8(70, cfg.input_size, 7)
    ref = np.asarray(model.apply(variables, jnp.asarray(ids))).reshape(-1)
    cfg.save(str(tmp_path))
    if source == "jax":
        jax_checkpoints.save_model_file(variables, str(tmp_path / "3.model"))
    else:
        checkpoints.save_model(_port(cfg, variables)[1].state_dict(), str(tmp_path), 3)
    pred = Predictor(str(tmp_path), 3, batch_size=32, device="cpu", source=source)
    assert not pred.model.training
    np.testing.assert_allclose(pred.predict_logits(ids), ref, rtol=1e-5, atol=1e-5)
    if name == "fgcnn":  # the statistics of a batch, not BatchNorm's start
        bn = pred.model.fgcnn_layer.conv_layers[0][1]
        stats = variables["batch_stats"]["fgcnn_layer"]["bn_0"]
        np.testing.assert_array_equal(bn.running_var.numpy(), stats["var"])
        assert not np.allclose(stats["var"], 1.0)


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
        elif kind.startswith("gru_"):
            paths = [path + leaf for leaf in {
                "gru_weight_ih": [("i" + g, "kernel") for g in "rzn"],
                "gru_weight_hh": [("h" + g, "kernel") for g in "rzn"],
                "gru_bias_ih": [("i" + g, "bias") for g in "rzn"],
                "gru_bias_hh": [("hn", "bias")]}[kind]]
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


def test_registry_names_map_tpus_ten_models():
    assert sorted(models.MODEL_REGISTRY) == sorted(jax_models.MODEL_REGISTRY)
    assert len(models.MODEL_REGISTRY) == 10
    with pytest.raises(NotImplementedError, match="not one of map_tpu's"):
        models.from_config(Config.from_dict(_cfg("fibinet").to_dict()))


def test_model_flags_take_map_tpus_defaults():
    ours = ModelArguments()
    ref = jax_config.ModelArguments()
    for f in ("num_attn_heads", "attn_probs_dropout_rate", "intermediate_size",
              "norm_first", "layer_norm_eps", "res_conn", "output_reduction",
              "attn_scale", "use_lr", "attn_size", "num_attn_layers", "cin_layer_units",
              "dnn_size", "num_dnn_layers", "dnn_act", "dnn_drop", "share_embedding",
              "channels", "kernel_heights", "pooling_sizes", "recombined_channels",
              "conv_act", "reuse_graph_layer"):
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


# ---- (i) FGCNN's BatchNorm: the layer, and its state under the multi-step dispatch -----------

def test_batch_norm_matches_flax():
    """The port's BatchNorm against flax's nn.BatchNorm(momentum=0.9,
    epsilon=1e-5) on a channels-last (NHWC) input: train mode
    normalises by the batch, every row counted (the last two are zero, as
    padding rows may be), and moves the running statistics by 0.1 of the
    batch's mean and biased variance (torch's BatchNorm2d would take the
    unbiased one); eval mode normalises by the running statistics."""
    from flax import linen as flax_nn

    rng = np.random.default_rng(41)
    x = (rng.normal(size=(6, 5, 4, 3)) * 2.0 + 1.0).astype(np.float32)
    x[4:] = 0.0
    scale, bias = rng.normal(size=(2, 3)).astype(np.float32)
    mean0, var0 = rng.normal(size=3).astype(np.float32), rng.uniform(0.5, 2, 3).astype(
        np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    nhwc = jnp.asarray(x)
    train_bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    ref, mutated = train_bn.apply(variables, nhwc, mutable=["batch_stats"])
    port = BatchNorm(3)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0)})
    assert set(port.state_dict()) == {"weight", "bias", "running_mean", "running_var"}
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    stats = _np(mutated["batch_stats"])
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-7)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               0.9 * mean0 + 0.1 * x64.mean(axis=(0, 1, 2)), rtol=1e-5)
    biased = 0.9 * var0 + 0.1 * x64.var(axis=(0, 1, 2))
    unbiased = 0.9 * var0 + 0.1 * x64.var(axis=(0, 1, 2), ddof=1)
    np.testing.assert_allclose(port.running_var.numpy(), biased, rtol=1e-5)
    assert not np.allclose(port.running_var.numpy(), unbiased, rtol=1e-3)
    # without the two zero rows the statistics would differ
    assert not np.allclose(x64[:4].mean(axis=(0, 1, 2)), x64.mean(axis=(0, 1, 2)))
    # eval mode: the running statistics, unchanged by the pass
    port.eval()
    eval_bn = flax_nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    ref = eval_bn.apply({"params": variables["params"], "batch_stats": stats}, nhwc)
    before = port.running_var.clone()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert torch.equal(port.running_var, before)


@pytest.mark.parametrize("kind", ["supervised", "rfd"])
def test_fgcnn_k_steps_a_call_equal_k_single_steps(kind):
    """FGCNN through the Trainer's pipeline, 4 steps a call on the resident
    data against a step a call on host batches: the losses, the parameters
    and the running statistics, bit for bit, and the statistics moved."""
    rng = np.random.default_rng(37)
    rows = 4 * BATCH + 40
    x = _ids(rng, rows)
    y = rng.integers(0, 2, rows).astype(np.float32)
    if kind == "rfd":
        cfg = _pretrain_cfg("fgcnn", "RFD", compute_dtype="float32")
    else:
        cfg = _cfg("fgcnn", input_size=VOCAB, compute_dtype="float32", idx_low=IDX_LOW,
                   idx_high=IDX_HIGH)
    args = dict(per_device_train_batch_size=BATCH, learning_rate=LR, weight_decay=0.05,
                lr_sched="cosine", num_train_epochs=2, seed=11, compute_dtype="float32",
                device="cpu", data_dir="", mask_ratio=MASK_RATIO,
                sampling_method="randint", pretrain=kind == "rfd", pt_type="RFD")
    runs = []
    for resident, spc in (("off", 1), ("on", 4)):
        trainer = _port_trainer(cfg, dict(args, device_resident_data=resident,
                                          steps_per_call=spc), x, y)
        runs.append((_run_epochs(trainer), trainer))
    (m1, t1), (m4, t4) = runs
    assert t4._data is not None and t1._data is None and t4.global_step == 10
    for k in m1:
        assert torch.equal(m1[k], m4[k]), k
    start = models.from_config(t1.config, torch.Generator().manual_seed(0)).state_dict()
    moved = 0
    for (name, a), b in zip(t1.model.state_dict().items(), t4.model.state_dict().values()):
        assert torch.equal(a, b), name
        moved += _is_stat(name) and not torch.equal(a, start[name])
    assert moved == 4  # both stages' mean and var
