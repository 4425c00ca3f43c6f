"""map_tpu_torch's shared and per-field noise MFP, the `full` loss and the
sparse table update (K7) against map_tpu on the CPU.

The same numpy-made inputs go through map_tpu and the port: the per-field
alias tables and the distribution of their draws, K7's plain version against
map_tpu's `sparse_fused_adamw` (interpret mode) on map_tpu-encoded streams,
K8's plain version against `block_cumsum` (interpret mode), and 5 MFP steps
of each mode from carried weights with map_tpu's own draws handed to the
port, at map_tpu's engaging geometry (`tests/test_sparse_step_e2e.py`: proj
32, V = 18,202), where map_tpu's sparse update is asserted to have engaged.
Then the port alone: sparse against dense steps, the handoff's guards, the
engagement rule, and the CLI pretraining with per-field shared noise and
the sparse update, then finetuning from it. On the CPU every port op takes
its plain PyTorch version; `tests/test_torch_port_cuda.py` and
`chip_smoke.py` hold the kernels against those on the card.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu import config as jax_config
from map_tpu import models as jax_models
from map_tpu.objectives import alias as jax_alias
from map_tpu.objectives import corruption as jax_corruption
from map_tpu.ops import sparse_adamw as jax_sa
from map_tpu.train import train_step as jax_ts
from map_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from map_tpu_torch import models
from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.objectives import alias
from map_tpu_torch.objectives.corruption import mfp_corrupt
from map_tpu_torch.ops import fused_adamw, scan, sparse_adamw
from map_tpu_torch.run import main as port_main
from map_tpu_torch.train.train_step import MFPDraws, draw_mfp
from map_tpu_torch.train.trainer import Trainer

from conftest import base_model_config
from test_torch_port_mfp import K_STEPS, LR, _assert_steps_agree
from test_torch_port_train import _jax_moments, _np

# map_tpu's engaging geometry (tests/test_sparse_step_e2e.py:18-27): with
# proj 32 and V = 18,202 its packed decoder has 4,608 rows, room for both
# stream encodings. Its last field of one id becomes 61 ids of the field
# before it: with per-field noise every candidate of such a field's
# positions is the target, the sampled loss's gradient there is exactly 0,
# and what each package computes for it is rounding, which Adam turns into
# steps of +-lr (the per-field-blocked feat_encoder rows of that field too)
FIELD_SIZES = [7, 24, 300, 2000, 8000, 6500, 1300, 61]
IDX_LOW = list(np.cumsum([10] + FIELD_SIZES[:-1]))
IDX_HIGH = IDX_LOW[1:] + [10 + sum(FIELD_SIZES)]
VOCAB = IDX_HIGH[-1]  # 18,202
NUM_FIELDS, BATCH, NEG, MASK_RATIO = 8, 256, 5, 0.4


def _counts(v, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.floor(rng.pareto(1.2, v) * 20).astype(np.float32)
    counts[:10] = 0.0  # the reserved ids never occur
    return counts


# ---- (a) per-field noise tables and draws ------------------------------------------

def test_per_field_alias_tables_equal_map_tpus(monkeypatch):
    from map_tpu import native

    monkeypatch.setattr(native, "build_alias", lambda probs: None)
    counts = _counts(VOCAB)
    got = alias.build_per_field_alias(counts, IDX_LOW, IDX_HIGH)
    ref = jax_alias.build_per_field_alias(counts, np.asarray(IDX_LOW), np.asarray(IDX_HIGH))
    for name, a, b in zip(("prob", "alias", "logq", "lnz"), got, ref):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    logq, lnz = alias.per_field_log_prior(counts, IDX_LOW, IDX_HIGH)
    np.testing.assert_array_equal(logq, ref[2])
    np.testing.assert_array_equal(lnz, ref[3])


@pytest.mark.parametrize("fused", [False, True])
def test_per_field_draws_stay_in_their_field_and_follow_it(fused):
    # three small fields, 60,000 draws each; chi-square goodness of fit
    # within each field's block (statistic below 60 at 19 or fewer degrees
    # of freedom: p < 4e-6 for a right sampler, ruled out by the fixed seed)
    from scipy import stats

    sizes = [20, 7, 13]
    low = [10, 30, 37]
    v = 50
    rng = np.random.default_rng(4)
    counts = (rng.random(v) ** 3 * 100 + 1).astype(np.float32)
    prob, alias_ids, logq, _ = alias.build_per_field_alias(
        counts, low, [a + s for a, s in zip(low, sizes)])
    gen = torch.Generator().manual_seed(0)
    fields = torch.tensor([0, 1, 2]).repeat_interleave(3).reshape(3, 3)  # (B, M)
    n = 20_000
    t_low = torch.tensor(low, dtype=torch.int32)
    t_sizes = torch.tensor(sizes, dtype=torch.int32)
    if fused:
        table = torch.from_numpy(alias.build_fused_alias(prob, alias_ids, logq))
        draws, draw_logq = alias.per_field_alias_draw_logq(gen, table, t_low, t_sizes,
                                                           fields, n)
        np.testing.assert_array_equal(draw_logq.numpy(), logq[draws.numpy()])
    else:
        draws = alias.per_field_alias_draw(gen, torch.from_numpy(prob),
                                           torch.from_numpy(alias_ids), t_low, t_sizes,
                                           fields, n)
    assert draws.dtype == torch.int32 and draws.shape == (3, 3, n)
    for f, (lo, size) in enumerate(zip(low, sizes)):
        got = draws[f].reshape(-1).numpy()
        assert got.min() >= lo and got.max() < lo + size
        q = alias.noise_distribution(counts[lo:lo + size])
        chi2 = stats.chisquare(np.bincount(got - lo, minlength=size), q * got.size).statistic
        assert chi2 < 60.0, (f, chi2)


# ---- (b) K7's plain version against map_tpu's kernel -------------------------------

@pytest.mark.parametrize("pack", [4, 8])
def test_sparse_adamw_plain_matches_map_tpu_kernel(pack):
    # test_sparse_adamw.py's geometry: the streams encoded by map_tpu,
    # compared through unpack_table. The gradient each row receives (read
    # with b1 = 0, where the new mu is g) is bit-equal where one stream
    # names the row, within 1 ulp of g where both do (two adds in another
    # order).
    from map_tpu.ops.fused_adamw import _adamw_math, pack_scalars
    from map_tpu.ops.packed_table import pack_table, unpack_table
    from test_sparse_adamw import _mk_stream

    rows, vocab, e = 16384, 16384 * pack - 7, 128 // pack
    nt, nn = 2048, 2 * 128 * pack
    rng = np.random.default_rng(0)
    t_ids, t_phys, t_sub, t_vals, _ = _mk_stream(rng, rows, pack, nt, vocab)
    n_ids, n_phys, n_sub, n_vals, _ = _mk_stream(rng, rows, pack, nn, vocab)
    flat = [rng.standard_normal((vocab, e)).astype(np.float32) for _ in range(3)]
    flat[2] = np.abs(flat[2])
    packed = [pack_table(jnp.asarray(a), e) for a in flat]
    jax_sa.enable(True)
    try:
        plan = jax_sa.pf_plan(rows, 128, pack, nt, nn)
        enc = (jax_sa.encode_target(t_vals, t_sub, t_phys, plan)
               + jax_sa.encode_noise(n_vals, n_sub, n_phys, plan))
        ref = {b1: [np.asarray(unpack_table(x, vocab, e)) for x in jax_sa.sparse_fused_adamw(
                   *packed, enc, pack_scalars(1e-3, 0.05, b1, 0.999, 1e-8, 3.0),
                   plan.c_enc, plan.n_enc, plan.wblk, interpret=True)]
               for b1 in (0.9, 0.0)}
    finally:
        jax_sa.enable(False)
    streams = [sparse_adamw.Stream(torch.from_numpy(np.array(ids)),
                                   torch.from_numpy(np.array(vals)))
               for ids, vals in ((t_ids, t_vals), (n_ids, n_vals))]
    got = {}
    for b1 in (0.9, 0.0):
        state = [torch.from_numpy(a.copy()) for a in flat]
        before = sparse_adamw.launches
        sparse_adamw.sparse_adamw(*state, *streams,
                                  fused_adamw.scalars(1e-3, 0.05, b1, 0.999, 1e-8, 3))
        assert sparse_adamw.launches == before  # the CPU path launches nothing
        got[b1] = [t.numpy() for t in state]
    named = [np.zeros(vocab, np.int64) for _ in range(2)]
    for count, ids in zip(named, (t_ids, n_ids)):
        ids = np.asarray(ids)
        count[ids[ids < vocab]] += 1
    both = (named[0] > 0) & (named[1] > 0)
    assert both.any() and (~both).any()
    g_got, g_ref = got[0.0][1], ref[0.0][1]  # mu at b1 = 0 is g
    np.testing.assert_array_equal(g_got[~both], g_ref[~both])
    np.testing.assert_array_less(np.abs(g_got[both] - g_ref[both]),
                                 np.spacing(np.abs(g_ref[both])) * 1.0001 + 1e-30)
    # the whole update: at K1's tolerance against map_tpu's AdamW algebra
    # (`_adamw_math`) on the dense sum of the streams; against its kernel at
    # the tolerance of map_tpu's own test of the kernel against that algebra
    # (test_sparse_adamw.py:82: the kernel's mu update rounds once where the
    # algebra rounds twice, 55 elements of 2.1 M here)
    g = np.zeros((vocab + 1, e), np.float32)
    for ids, vals in ((t_ids, t_vals), (n_ids, n_vals)):
        np.add.at(g, np.minimum(np.asarray(ids), vocab), np.asarray(vals))
    want = _adamw_math(*(jnp.asarray(a) for a in flat), jnp.asarray(g[:vocab]),
                       *np.asarray(pack_scalars(1e-3, 0.05, 0.9, 0.999, 1e-8, 3.0))[0, :7])
    for a, b, w in zip(got[0.9], ref[0.9], want):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6)


# ---- (c) K8's plain version against map_tpu's kernel -------------------------------

def test_block_cumsum_plain_matches_map_tpu_kernel():
    # map_tpu's 512-row blocks carry their running sum from block to block;
    # the plain version scans each column in order: the two differ by the
    # rounding of the running prefix, 16 ulps of each column's largest
    # prefix of |x| at most
    from map_tpu.ops.pallas_scan import block_cumsum

    x = np.random.default_rng(5).standard_normal((2048, 128)).astype(np.float32)
    ref = np.asarray(block_cumsum(jnp.asarray(x), interpret=True))
    before = scan.launches
    got = scan.block_cumsum(torch.from_numpy(x))
    assert scan.launches == before
    assert got.shape == (2048, 128) and got.dtype == torch.float32
    ulps = 16 * 2.0 ** -24 * np.abs(x).cumsum(0).max(0)
    err = np.abs(got.numpy() - ref)
    assert (err <= ulps[None]).all(), float((err / ulps[None]).max())
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.astype(np.float64), 0),
                               rtol=0, atol=float(ulps.max()))


# ---- (d) 5 MFP steps of each mode against map_tpu ----------------------------------

MODES = {  # name: (shared noise, per-field noise, loss)
    "pf_shared": (True, True, "nce"),
    "shared": (True, False, "nce"),
    "pf_position": (False, True, "nce"),
    "full": (False, False, "full"),
}


def _configs(mode, loss):
    shared, per_field, _ = MODES[mode]
    cfg = base_model_config(input_size=VOCAB, num_fields=NUM_FIELDS, embed_size=16,
                            hidden_size=64, num_hidden_layers=2, num_cross_layers=2,
                            compute_dtype="float32", packed_tables=True,
                            fused_table_update=True, pretrain=True, pt_type="MFP",
                            nce_loss_type=loss, nce_grad="dedup_bwd", proj_size=32,
                            pt_neg_num=NEG, idx_low=IDX_LOW, idx_high=IDX_HIGH)
    cfg.feat_count = _counts(VOCAB)
    if per_field:
        _, _, cfg.logprob_noise, cfg.norm_term = jax_alias.build_per_field_alias(
            cfg.feat_count, np.asarray(IDX_LOW), np.asarray(IDX_HIGH))
    else:
        probs = jax_alias.noise_distribution(cfg.feat_count)
        cfg.logprob_noise = np.log(probs).astype(np.float32)
        cfg.norm_term = float(np.log(VOCAB))
    port_cfg = Config.from_dict({**cfg.to_dict(), "pt_per_field_noise": per_field})
    port_cfg.feat_count = cfg.feat_count
    args = TrainingArguments(learning_rate=LR, weight_decay=0.05, lr_sched="cosine",
                             warmup_ratio=0.2, num_train_epochs=1, mask_ratio=MASK_RATIO,
                             sampling_method="randint", pretrain=True,
                             pt_shared_noise=shared, pt_per_field_noise=per_field)
    return cfg, port_cfg, args


def _map_tpu_draws(mode, base_rng, step, input_ids, tables):
    """map_tpu's draws of `step` (train_step.py:452-453 and :306-316,
    :376-380, :412-419, :467)."""
    shared, per_field, loss = MODES[mode]
    mask_num = jax_corruption.mask_num_of(NUM_FIELDS, MASK_RATIO)
    rng = jax.random.fold_in(base_rng, step)
    if shared:
        k_mask, k_noise, _ = jax.random.split(rng, 3)
    else:
        k_mask, k_noise = jax.random.split(jax.random.split(rng)[0])
    _, _, masked_index = jax_corruption.mfp_corrupt(
        k_mask, jnp.asarray(input_ids), mask_num, "randint", input_size=VOCAB)
    fused, prob, alias_ids, logq, low, sizes = tables
    if loss == "full":
        return MFPDraws(torch.from_numpy(np.array(masked_index)))
    if per_field:
        fields = jnp.arange(NUM_FIELDS, dtype=jnp.int32) if shared else masked_index
        noise, noise_logq = jax_alias.per_field_alias_draw_logq(
            k_noise, jnp.asarray(fused), jnp.asarray(low), jnp.asarray(sizes), fields, NEG)
    elif shared:
        noise = jax_alias.alias_draw(k_noise, jnp.asarray(prob), jnp.asarray(alias_ids),
                                     (NEG,))
        noise_logq = jnp.take(jnp.asarray(logq), noise)
    else:
        raise AssertionError(mode)
    return MFPDraws(*(torch.from_numpy(np.array(a))
                      for a in (masked_index, noise, noise_logq)))


def _k_mode_runs(mode, loss, sparse):
    """K MFP steps of `mode` through map_tpu and through the port's Trainer,
    from the same carried weights, on the same batches, with map_tpu's draws."""
    shared, per_field, _ = MODES[mode]
    cfg, port_cfg, args = _configs(mode, loss)
    args.sparse_table_update = sparse
    if per_field:
        prob, alias_ids, logq, _ = jax_alias.build_per_field_alias(
            cfg.feat_count, np.asarray(IDX_LOW), np.asarray(IDX_HIGH))
    else:
        prob, alias_ids = jax_alias.build_alias_table(
            jax_alias.noise_distribution(cfg.feat_count))
        logq = cfg.logprob_noise
    low = np.asarray(IDX_LOW, np.int32)
    tables = (jax_alias.build_fused_alias(prob, alias_ids, logq), prob, alias_ids, logq,
              low, np.asarray(IDX_HIGH, np.int32) - low)
    rng = np.random.default_rng(21)
    batches = []
    for i in range(K_STEPS):
        weight = np.ones(BATCH, np.float32)
        if i == K_STEPS - 1:
            weight[160:] = 0.0  # a padded last batch
        ids = np.stack([rng.integers(a, b, BATCH) for a, b in zip(IDX_LOW, IDX_HIGH)], 1)
        batches.append({"input_ids": ids.astype(np.int32),
                        "labels": np.zeros(BATCH, np.float32), "weight": weight})
    jargs = jax_config.TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine", mask_ratio=MASK_RATIO,
        sampling_method="randint", pretrain=True, pt_type="MFP",
        compute_dtype="float32", packed_tables=True, pt_shared_noise=shared,
        pt_per_field_noise=per_field, sparse_table_update=sparse)
    per_field_arg = ((prob, alias_ids, low, tables[5], cfg.norm_term)
                     if per_field else None)
    base_rng = jax.random.PRNGKey(5)
    jax_sa.enable(sparse)
    try:
        tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
        model = jax_models.from_config(cfg)
        state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                          {"input_ids": batches[0]["input_ids"]})
        train_step, _ = jax_ts.make_mfp_steps(model, cfg, jargs, tx, base_rng, prob,
                                              alias_ids, logq, per_field=per_field_arg)
        port_model = models.from_config(port_cfg)
        port_model.load_state_dict(state_dict_from_jax({"params": _np(state.params)},
                                                       port_cfg))
        trainer = Trainer(port_model, port_cfg, args, dataset=None, device="cpu")
        trainer.build_steps(10)
        assert (trainer.model.mfp_criterion.handoff is not None) == (sparse and shared)
        jax_m, port_m, ties = [], [], []
        for step, batch in enumerate(batches):
            draws = _map_tpu_draws(mode, base_rng, step, batch["input_ids"], tables)
            ties.append(_target_ties(mode, batch, draws))
            state, m = train_step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            if step == 0:  # map_tpu engaged its sparse update exactly when asked
                emb_shape = state.params["mfp_decoder"]["emb"].shape
                assert (jax_sa.lookup(emb_shape) is not None) == sparse
            jax_m.append([float(m[k]) for k in ("loss", "count", "acc_count")])
            pm = trainer.train_step(batch, draws)
            port_m.append([pm[k].item() for k in ("loss", "count", "acc_count")])
        moments = _jax_moments(tx, state.opt_state, cfg)
    finally:
        jax_sa.enable(False)
    ref_params = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
    return (np.array(ties), np.array(jax_m), np.array(port_m), ref_params,
            trainer.model.state_dict(), moments, trainer.optimizer)


def _target_ties(mode, batch, draws):
    """The weight of the masked positions whose target is among their own
    noise ids. In a shared mode the target's score and the noise scores come
    from different products (map_tpu's and the port's alike), so such a
    tie is broken by rounding, and each package may break it its own way."""
    if not MODES[mode][0]:
        return 0.0  # every candidate scored by the same product: ties exact
    mi = draws.masked_index.numpy()
    labels = np.take_along_axis(batch["input_ids"], mi, 1)
    noise = draws.noise.numpy()
    noise = noise[mi] if noise.ndim == 2 else np.broadcast_to(noise, (*mi.shape, NEG))
    tie = (noise == labels[..., None]).any(-1)
    return float((tie * batch["weight"][:, None]).sum())


@pytest.mark.parametrize("mode,loss,sparse", [
    ("pf_shared", "nce", True), ("pf_shared", "sampled", True),
    ("pf_shared", "nce", False), ("shared", "nce", True), ("shared", "sampled", False),
    ("pf_position", "nce", False), ("pf_position", "sampled", False),
    ("full", "full", False)])
def test_mfp_mode_steps_match_map_tpu(mode, loss, sparse):
    ties, jax_m, port_m, *rest = _k_mode_runs(mode, loss, sparse)
    # the accuracy counts agree but where a target ties one of its noise ids
    assert (np.abs(port_m[:, 2] - jax_m[:, 2]) <= ties).all(), (port_m, jax_m, ties)
    port_m[:, 2] = jax_m[:, 2]
    _assert_steps_agree(jax_m, port_m, *rest)


# ---- (e) the port alone: sparse against dense ---------------------------------------

def _port_run(mode, sparse, steps=K_STEPS, seed=0):
    _, port_cfg, args = _configs(mode, "nce")
    args.sparse_table_update = sparse
    trainer = Trainer(models.from_config(port_cfg, torch.Generator().manual_seed(seed)),
                      port_cfg, args, dataset=None, device="cpu")
    trainer.build_steps(10)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        ids = np.stack([rng.integers(a, b, BATCH) for a, b in zip(IDX_LOW, IDX_HIGH)], 1)
        batch = {"input_ids": ids.astype(np.int32), "labels": np.zeros(BATCH, np.float32),
                 "weight": np.ones(BATCH, np.float32)}
        draws = draw_mfp(gen, trainer.noise, BATCH, NUM_FIELDS,
                         jax_corruption.mask_num_of(NUM_FIELDS, MASK_RATIO), NEG,
                         "randint", shared_noise=args.pt_shared_noise)
        trainer.train_step(batch, draws)
    return trainer


@pytest.mark.parametrize("mode", ["pf_shared", "shared"])
def test_sparse_steps_equal_dense_steps(mode):
    # target + noise is one float32 add either way: bit-equal parameters
    # and moments after 5 steps
    dense, sparse = _port_run(mode, False), _port_run(mode, True)
    assert dense.model.mfp_criterion.handoff is None
    assert sparse.model.mfp_criterion.handoff is not None
    for name, p in dense.model.state_dict().items():
        assert torch.equal(sparse.model.state_dict()[name], p), name
    for name, (mu, nu) in dense.optimizer.state().items():
        s_mu, s_nu = sparse.optimizer.state()[name]
        assert torch.equal(s_mu, mu) and torch.equal(s_nu, nu), name


# ---- (f) the handoff's guards and the engagement rule --------------------------------

def _one_backward(trainer):
    """A shared-noise forward and backward, no optimizer step."""
    rng = np.random.default_rng(1)
    ids = np.stack([rng.integers(a, b, BATCH) for a, b in zip(IDX_LOW, IDX_HIGH)], 1)
    draws = draw_mfp(torch.Generator().manual_seed(1), trainer.noise, BATCH, NUM_FIELDS,
                     3, NEG, "randint", shared_noise=True)
    model = trainer.model.train()
    corrupted, labels = mfp_corrupt(torch.from_numpy(ids.astype(np.int32)),
                                    draws.masked_index)
    logits = model.mfp_per_field_shared_logits(corrupted, draws.masked_index, labels,
                                               draws.noise)
    logits.square().mean().backward()
    return corrupted, draws


def test_handoff_guards_raise():
    trainer = _port_run("pf_shared", True, steps=0)
    opt, handoff = trainer.optimizer, trainer.model.mfp_criterion.handoff
    emb = trainer.model.mfp_criterion.emb.weight
    # a dense emb gradient beside pending streams
    _one_backward(trainer)
    assert handoff.pending() and emb.grad is None
    emb.grad = torch.zeros_like(emb)
    with pytest.raises(RuntimeError, match="dense gradient"):
        opt.step()
    # a stale stream: a second backward before the optimizer took the first
    emb.grad = None
    with pytest.raises(RuntimeError, match="stale"):
        _one_backward(trainer)
    # one stream of the two
    trainer.model.zero_grad()
    handoff._pending.pop("noise")
    with pytest.raises(RuntimeError, match="noise stream .* never arrived"):
        opt.step()
    # streams stamped at another step than the optimizer's
    handoff._pending.clear()
    _one_backward(trainer)
    opt.count += 1
    with pytest.raises(RuntimeError, match="stale at step 1"):
        opt.step()
    with pytest.raises(ValueError, match="kind"):
        handoff.put("bias", None)


@pytest.mark.parametrize("mode,clip,engages", [
    ("pf_shared", 0.0, True), ("shared", 0.0, True), ("pf_shared", 1.0, False),
    ("shared", 1.0, False), ("pf_position", 0.0, False), ("full", 0.0, False)])
def test_sparse_flag_engages_only_in_shared_modes_without_a_clip(mode, clip, engages):
    _, port_cfg, args = _configs(mode, MODES[mode][2])
    args.sparse_table_update, args.max_grad_norm = True, clip
    trainer = Trainer(models.from_config(port_cfg), port_cfg, args, dataset=None,
                      device="cpu")
    trainer.build_steps(10)
    assert (trainer.model.mfp_criterion.handoff is not None) == engages
    assert bool(trainer.optimizer.sparse) == engages
    assert sparse_adamw.engages(True, MODES[mode][0], clip) == engages


def test_per_field_decoder_bias_starts_at_the_per_field_prior():
    # map_tpu's trainer sets logprob_noise = per-field log q and norm_term =
    # log(field size) before the decoder's init reads them
    for per_field in (True, False):
        cfg, port_cfg, _ = _configs("pf_position" if per_field else "shared", "nce")
        params = jax_models.from_config(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((2, NUM_FIELDS), jnp.int32),
            masked_index=jnp.zeros((2, 3), jnp.int32),
            candidates=jnp.zeros((2, 3, 1 + NEG), jnp.int32))["params"]
        ref = np.asarray(params["mfp_decoder"]["bias"]).reshape(-1)[:VOCAB]
        got = models.from_config(port_cfg).mfp_criterion.bias.weight.detach().numpy()
        np.testing.assert_array_equal(got[:, 0], ref)


# ---- the CLI: per-field shared pretraining with the sparse update, then finetune ------

def test_cli_pretrains_per_field_shared_sparse_and_finetunes(synth_dir, tmp_path):
    common = ["--model_name=dcnv2", "--dataset_name=synth", f"--data_dir={synth_dir}",
              "--embed_size=8", "--hidden_size=32", "--num_hidden_layers=3",
              "--num_cross_layers=3", "--compute_dtype", "float32", "--logging_steps=5",
              "--weight_decay=5e-2", "--per_device_train_batch_size=256",
              "--per_device_eval_batch_size=200", "--device", "cpu"]
    pt_dir, ft_dir = tmp_path / "pt", tmp_path / "ft"
    assert port_main(common + [
        "--pretrain", "--pt_type=MFP", "--pt_shared_noise", "--pt_per_field_noise",
        "--sparse_table_update", "--sampling_method=randint", "--mask_ratio=0.3",
        "--pt_neg_num=5", "--proj_size=8", "--learning_rate=1e-3", "--lr_sched=cosine",
        "--num_train_epochs=2", f"--output_dir={pt_dir}"]) == 0
    log = open(pt_dir / "train.log").read()
    assert "noise = per-field, shared" in log and "sparse table update = True" in log
    evals = [float(a) for a in re.findall(r"'eval_mfp_acc': ([\d.]+)", log)]
    assert len(evals) == 2 and min(evals) > 1 / 6  # above chance, 1 / (1 + k)
    (ckpt,) = list(pt_dir.glob("*.model"))
    assert port_main(common + ["--learning_rate=1e-2", "--lr_sched=const",
                               "--num_train_epochs=1", f"--output_dir={ft_dir}",
                               "--finetune", f"--pretrained_model_path={ckpt}"]) == 0
    log = open(ft_dir / "train.log").read()
    assert "finetune restore: 13 tensors loaded, 4 skipped" in log
