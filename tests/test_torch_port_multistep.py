"""map_tpu_torch's multi-step dispatch and the step scalars on the device,
against map_tpu on the CPU.

- 5 supervised, RFD-Unigram and MFP steps of the port's Trainer with the
  train data on the device and `steps_per_call` 4 (a group of 4, then the
  padded last batch alone), against map_tpu's resident multi-step and
  single step (`make_resident_multi_step`, `make_resident_step`) on the same
  index batches, from carried weights, with map_tpu's draws handed to the
  port: losses, parameters and Adam moments at 1e-5 in f32.
- On the CPU a call of K steps is K eager steps: the Trainer with the
  resident data and `steps_per_call` 4 gives the bits of the one with host
  batches and one step a call, with the port's own draws, in every mode.
- K1's and K7's plain versions reading the scalars from a (K, 8) buffer
  give the bits of the by-value form; the optimizer writes the rows the
  host's count gives.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu import config as jax_config
from map_tpu import models as jax_models
from map_tpu.data.loader import Batcher as JaxBatcher
from map_tpu.objectives import alias as jax_alias
from map_tpu.objectives import corruption as jax_corruption
from map_tpu.train import train_step as jax_ts
from map_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from map_tpu_torch import models
from map_tpu_torch.config import Config, TrainingArguments
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.ops import fused_adamw, sparse_adamw
from map_tpu_torch.train.optimizer import AdamW
from map_tpu_torch.train.schedules import make_schedule
from map_tpu_torch.train.train_step import MFPDraws
from map_tpu_torch.train.trainer import Trainer

from conftest import base_model_config
from test_torch_port_mfp import _assert_steps_agree, _mfp_config
from test_torch_port_rfd import IDX_HIGH, IDX_LOW, VOCAB, _ids, _map_tpu_rfd_draws
from test_torch_port_train import _jax_moments, _np

K_STEPS = 5
SPC = 4
BATCH = 64
ROWS = 4 * BATCH + 40  # a group of 4 full batches, then a padded one
LR = 1e-3
MASK_RATIO = 0.3
SEED = 11


def _dataset(x, y):
    return SimpleNamespace(X={"train": x, "valid": x[:BATCH], "test": x[:BATCH]},
                           Y={"train": y, "valid": y[:BATCH], "test": y[:BATCH]})


def _case(kind):
    """map_tpu's config and flags, the port's flags and the train arrays."""
    rng = np.random.default_rng(31)
    y = rng.integers(0, 2, ROWS).astype(np.float32)
    pretrain = kind != "supervised"
    if kind == "mfp":
        cfg, _ = _mfp_config("nce", False, "dedup_pallas")
        x = rng.integers(10, cfg.input_size, (ROWS, 8)).astype(np.int32)
    else:
        cfg = base_model_config(
            input_size=VOCAB, num_fields=8, embed_size=16, hidden_size=32,
            num_hidden_layers=2, num_cross_layers=2, compute_dtype="float32",
            packed_tables=True, idx_low=IDX_LOW, idx_high=IDX_HIGH, pretrain=pretrain,
            pt_type="RFD", RFD_replace="Unigram", proj_size=8)
        x = _ids(rng, ROWS)
    pt = dict(pretrain=pretrain, pt_type="MFP" if kind == "mfp" else "RFD",
              RFD_replace="Unigram", mask_ratio=MASK_RATIO, sampling_method="randint")
    jargs = jax_config.TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine", compute_dtype="float32",
        packed_tables=kind != "mfp", **pt)
    args = dict(per_device_train_batch_size=BATCH, learning_rate=LR, weight_decay=0.05,
                lr_sched="cosine", warmup_ratio=0.4, num_train_epochs=1, seed=SEED,
                compute_dtype="float32", device="cpu", data_dir="", **pt)
    return cfg, jargs, args, x, y


def _port_trainer(cfg, args, x, y, params=None, seed=0):
    port_cfg = Config.from_dict(cfg.to_dict())
    port_cfg.feat_count = getattr(cfg, "feat_count", None)
    model = models.from_config(port_cfg, torch.Generator().manual_seed(seed))
    if params is not None:
        model.load_state_dict(state_dict_from_jax({"params": params}, port_cfg))
    return Trainer(model, port_cfg, TrainingArguments(**args), _dataset(x, y))


def _map_tpu_run(kind, cfg, jargs, x, y):
    """5 steps through map_tpu's resident multi-step (4) and single step (the
    padded tail), stream v2 without noise rows, index batches with them."""
    rfd = kind == "rfd"
    mask_num = jax_corruption.mask_num_of(8, MASK_RATIO)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=K_STEPS, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": x[:BATCH]})
    params = _np(state.params)
    base_rng = jax.random.PRNGKey(5)
    extra = ()
    if kind == "mfp":
        prob, alias_ids = jax_alias.build_alias_table(
            jax_alias.noise_distribution(cfg.feat_count))
        extra = (prob, alias_ids, cfg.logprob_noise)
    make = {"supervised": jax_ts.make_supervised_steps, "rfd": jax_ts.make_rfd_steps,
            "mfp": jax_ts.make_mfp_steps}[kind]
    step, _ = make(model, cfg, jargs, tx, base_rng, *extra)
    multi = jax_ts.make_resident_multi_step(step, SPC, batch_size=BATCH)
    single = jax_ts.make_resident_step(step, batch_size=BATCH)
    batcher = JaxBatcher(x, y, batch_size=BATCH, shuffle=True, seed=SEED,
                         noise_source=x if rfd else None,
                         noise_rows_per_example=mask_num if rfd else 0)
    batcher.emit_indices, batcher.emit_start_only = True, not rfd
    order = np.random.default_rng(np.random.SeedSequence([SEED, 0])).permutation(ROWS)
    perm = np.zeros(K_STEPS * BATCH, np.int32)
    perm[:ROWS] = order
    data = {"x": jnp.asarray(x), "y": jnp.asarray(y), "perm": jnp.asarray(perm)}
    keys = {"supervised": ("loss",), "rfd": ("loss", "acc", "pos_ratio", "count"),
            "mfp": ("loss", "count", "acc_count")}[kind]
    out = []
    for n, payload, _ in batcher.epoch_stacked(SPC, 0):
        dev = {k: jnp.asarray(v) for k, v in payload.items() if k not in ("labels", "weight")}
        state, m = (multi if n > 1 else single)(state, dev, data)
        out += np.stack([np.atleast_1d(np.asarray(m[k])) for k in keys], -1).tolist()
    return params, state, tx, np.array(out), keys


def _map_tpu_draws(kind, cfg, x, y):
    """map_tpu's draws of steps 0..4 (train_step.py:452-453, :565-566), from
    the host batches of the same stream."""
    mask_num = jax_corruption.mask_num_of(8, MASK_RATIO)
    base_rng = jax.random.PRNGKey(5)
    batches = Batcher(x, y, BATCH, shuffle=True, seed=SEED).epoch(0)
    draws = []
    for step, batch in enumerate(batches):
        k_corrupt, _ = jax.random.split(jax.random.fold_in(base_rng, step))
        ids = jnp.asarray(batch["input_ids"])
        if kind == "rfd":
            draws.append(_map_tpu_rfd_draws(k_corrupt, batch["input_ids"], mask_num,
                                            "randint", "Unigram"))
            continue
        k_mask, k_noise = jax.random.split(k_corrupt)
        _, _, masked_index = jax_corruption.mfp_corrupt(
            k_mask, ids, mask_num, "randint", input_size=cfg.input_size)
        prob, alias_ids = jax_alias.build_alias_table(
            jax_alias.noise_distribution(cfg.feat_count))
        fused = jax_alias.build_fused_alias(prob, alias_ids, cfg.logprob_noise)
        noise, noise_logq = jax_alias.alias_draw_logq(k_noise, jnp.asarray(fused),
                                                      (BATCH, mask_num, 5))
        draws.append(MFPDraws(*(torch.from_numpy(np.array(a))
                                for a in (masked_index, noise, noise_logq))))
    return draws


@pytest.mark.parametrize("kind", ["supervised", "rfd", "mfp"])
def test_resident_multi_steps_match_map_tpu_f32(kind):
    cfg, jargs, args, x, y = _case(kind)
    params, state, tx, jax_m, keys = _map_tpu_run(kind, cfg, jargs, x, y)
    trainer = _port_trainer(cfg, dict(args, device_resident_data="on", steps_per_call=SPC),
                            x, y, params)
    batcher = trainer._prepare_training()
    assert trainer._data is not None and trainer._stream_v2 == (kind != "rfd")
    if kind != "supervised":
        draws = iter(_map_tpu_draws(kind, cfg, x, y))
        step = trainer.train_step
        trainer.multi.step = lambda b: step(b, next(draws))
    calls = list(trainer.train_epoch(batcher, 0))
    assert [n for n, _, _ in calls] == [SPC, 1] and trainer.global_step == K_STEPS
    port_m = np.concatenate([np.stack([m[k].reshape(n).numpy() for k in keys], -1)
                             for n, m, _ in calls])
    opt = trainer.optimizer
    ref = state_dict_from_jax({"params": _np(state.params)}, trainer.config)
    got = trainer.model.state_dict()
    ref_mom = _jax_moments(tx, state.opt_state, cfg)
    if kind == "mfp":
        _assert_steps_agree(jax_m, port_m, ref, got, ref_mom, opt)
        return
    assert opt.count == K_STEPS
    np.testing.assert_allclose(port_m, jax_m, rtol=1e-5, atol=1e-5)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        for part, g, r in zip(("mu", "nu"), opt.state()[key], ref_mom[key]):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-8,
                                       err_msg=f"{key} {part}")


def _run_epochs(trainer):
    """Two epochs through the Trainer's pipeline: each step's metrics."""
    batcher = trainer._prepare_training()
    out = []
    for epoch in range(2):
        for n, metrics, _ in trainer.train_epoch(batcher, epoch):
            out.append({k: v.reshape(n, -1) for k, v in metrics.items()})
    return {k: torch.cat([m[k] for m in out]) for k in out[0]}


@pytest.mark.parametrize("kind", ["supervised", "rfd", "mfp", "mfp_pf_shared_sparse"])
def test_k_steps_a_call_equal_k_single_steps(kind):
    cfg, _, args, x, y = _case("mfp" if kind.startswith("mfp") else kind)
    if kind == "mfp_pf_shared_sparse":
        lo = [10 + 70 * i for i in range(8)]
        cfg.idx_low, cfg.idx_high = lo, [a + 70 for a in lo]
        x = np.stack([np.random.default_rng(i).integers(a, a + 70, ROWS)
                      for i, a in enumerate(lo)], 1).astype(np.int32)
        args = dict(args, pt_shared_noise=True, pt_per_field_noise=True,
                    sparse_table_update=True)
    args = dict(args, num_train_epochs=2)
    runs = []
    for resident, spc in (("off", 1), ("on", SPC)):
        trainer = _port_trainer(cfg, dict(args, device_resident_data=resident,
                                          steps_per_call=spc), x, y)
        metrics = _run_epochs(trainer)
        assert trainer.global_step == 2 * K_STEPS
        if kind == "mfp_pf_shared_sparse":
            assert trainer.model.mfp_criterion.handoff is not None
            assert trainer.model.mfp_criterion.handoff.step == 2 * K_STEPS
        runs.append((metrics, trainer))
    (m1, t1), (m4, t4) = runs
    assert t4._data is not None and t1._data is None
    assert sorted(m1) == sorted(m4)
    for k in m1:
        assert torch.equal(m1[k], m4[k]), k
    for (name, a), b in zip(t1.model.named_parameters(), t4.model.parameters()):
        assert torch.equal(a, b), name
    for name, (mu, nu) in t1.optimizer.state().items():
        assert torch.equal(mu, t4.optimizer.state()[name][0]), name
        assert torch.equal(nu, t4.optimizer.state()[name][1]), name


# ---- the step scalars on the device --------------------------------------------------

def _adam_state(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g), torch.randn(shape, generator=g) * 1e-2,
            torch.rand(shape, generator=g) * 1e-4, torch.randn(shape, generator=g) * 1e-2)


@pytest.mark.parametrize("slot", [0, 2])
@pytest.mark.parametrize("wd", [0.1, 0.0])
def test_k1_plain_from_the_scalar_buffer_equals_by_value(slot, wd):
    s = fused_adamw.scalars(1e-3, wd, 0.9, 0.999, 1e-8, 3)
    scal = torch.zeros(4, fused_adamw.SCALAR_WIDTH)
    scal[slot] = torch.tensor(fused_adamw.scalar_row(s))
    scal[slot, 1] = 7.0  # the row's wd is not read: each leaf has its own
    leaves = [_adam_state((37, 12), 1), _adam_state((5,), 2)]
    ref = [[t.clone() for t in leaf[:3]] for leaf in leaves]
    for (p, mu, nu), leaf in zip(ref, leaves):
        fused_adamw.fused_adamw_plain(p, mu, nu, leaf[3], s)
    got = [[t.clone() for t in leaf[:3]] for leaf in leaves]
    fused_adamw.fused_adamw_leaves(*([leaf[j] for leaf in got] for j in range(3)),
                                   [leaf[3] for leaf in leaves], [s.wd, s.wd], scal, slot)
    for a, b in zip(got, ref):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("wd", [5e-2, 0.0])
def test_k7_plain_from_the_scalar_buffer_equals_by_value(wd):
    from map_tpu_torch.ops import dedup_scatter

    g = torch.Generator().manual_seed(4)
    vocab, e = 500, 8

    def stream(n):
        ids = (torch.rand(n, generator=g) ** 2 * vocab).int()
        uids, vals, _ = dedup_scatter.sort_and_fold(ids, torch.randn(n, e, generator=g),
                                                    vocab)
        return sparse_adamw.Stream(uids, vals)

    target, noise = stream(300), stream(40)
    s = fused_adamw.scalars(2e-3, wd, 0.9, 0.999, 1e-8, 5)
    scal = torch.tensor([fused_adamw.scalar_row(s)] * 3)
    p, mu, nu, _ = _adam_state((vocab, e), 5)
    ref = [t.clone() for t in (p, mu, nu)]
    sparse_adamw.sparse_adamw_plain(*ref, target, noise, s)
    got = [t.clone() for t in (p, mu, nu)]
    sparse_adamw.sparse_adamw_step(*got, target, noise, wd, scal, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_optimizer_rows_follow_the_count():
    p = torch.nn.Parameter(torch.zeros(3, 4))
    opt = AdamW([("w", p)], make_schedule("cosine", 1e-3, 2, 10), 0.9, 0.999, 1e-8, 0.1,
                slots=4)
    opt.count = 3
    opt.begin(4)
    for j in range(4):
        assert opt.scal[j].tolist() == list(fused_adamw.scalar_row(fused_adamw.scalars(
            opt.schedule(3 + j), 0.1, 0.9, 0.999, 1e-8, 4 + j)))
    # a capture reads the slots as they stand and puts the count back
    opt.reserve(2)
    for _ in range(2):
        opt.step([torch.ones(3, 4)])
    assert opt.count == 5
    opt.rewind(3)
    opt.advance(4)
    assert opt.count == 7
    with pytest.raises(ValueError):
        opt.begin(5)
