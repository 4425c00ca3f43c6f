"""map_tpu_torch's eval dispatch (`Trainer._eval_calls`, `graph.MultiEval`)
against map_tpu's (`_eval_dispatch`, `make_multi_eval`) on the CPU.

- Grouped (`steps_per_call` 4: a group of 4 eval batches, then the tail one
  by one) and eager (1) eval passes of the port from the same weights give
  the same bits, in all four kinds: the exact supervised eval, the
  streaming one (its bins escalated and the pass run again), MFP and RFD.
- The port's grouped pass against map_tpu's grouped one (`make_multi_eval`
  over its groups of 4, `fold_in(rng, absolute batch index)`), from carried
  weights, with map_tpu's draws handed to the port (`draws`): the exact
  eval's AUC and log loss, MFP's loss and accuracy, RFD's loss and accuracy
  at 1e-5 in f32.
- `Batcher.alloc`: batches written to the arrays it gives are the stream's
  bits.
On the CPU a MultiEval call runs its batches one by one; the card's graphs
are held to the eager pass by `tests/test_torch_port_cuda.py` and
`chip_smoke.py`.
"""

import tempfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu import models as jax_models
from map_tpu.data.loader import Batcher as JaxBatcher
from map_tpu.objectives import alias as jax_alias
from map_tpu.objectives import corruption as jax_corruption
from map_tpu.train import train_step as jax_ts
from map_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.train.train_step import MFPDraws
from map_tpu_torch.utils.metrics import binary_log_loss, roc_auc

from test_torch_port_multistep import BATCH, MASK_RATIO, SEED, _case, _port_trainer
from test_torch_port_rfd import _map_tpu_rfd_draws
from test_torch_port_train import _np

EVAL_BATCH = 24
SPC = 4
VALID_ROWS = 5 * EVAL_BATCH + 7  # a group of 4, then a full and a padded batch alone


def _trainer(kind, spc, params=None, **extra):
    cfg, jargs, args, x, y = _case(kind)
    args = dict(args, steps_per_call=spc, per_device_eval_batch_size=EVAL_BATCH,
                output_dir=tempfile.mkdtemp(prefix="eval_dispatch_"), **extra)
    t = _port_trainer(cfg, args, x, y, params, seed=3)
    valid = np.random.default_rng(8).permutation(len(y))[:VALID_ROWS]
    t.dataset = SimpleNamespace(X={"train": x, "valid": x[valid], "test": x[valid]},
                                Y={"train": y, "valid": y[valid], "test": y[valid]})
    return t, cfg, jargs


def _run_eval(t, kind):
    if kind == "mfp":
        out = t.MFP_pretrain_eval()
    elif kind == "rfd":
        out = t.RFD_pretrain_eval()
    else:
        out = t.eval("valid", test_eval=True)
    return {k: v for k, v in out.items() if k != "eval_time_cost"}


@pytest.mark.parametrize("kind", ["supervised", "streaming", "mfp", "rfd"])
def test_grouped_eval_is_the_eager_pass_bit_for_bit(kind):
    extra = dict(streaming_auc=True, auc_bins=64) if kind == "streaming" else {}
    base = "supervised" if kind == "streaming" else kind
    grouped, _, _ = _trainer(base, SPC, **extra)
    eager, _, _ = _trainer(base, 1, **extra)
    calls = []
    orig = grouped._eval_calls

    def spy(*a, **kw):
        for n, m, views in orig(*a, **kw):
            calls.append(n)
            yield n, m, views

    grouped._eval_calls = spy
    got, ref = _run_eval(grouped, base), _run_eval(eager, base)
    assert got == ref
    assert calls[:3] == [SPC, 1, 1]  # a group, then the tail one by one
    if kind == "streaming":  # 64 bins do not bound the AUC: escalated, run again
        assert grouped._streaming_bins > 64 and len(grouped._retired) >= 1
        assert grouped._streaming_bins == eager._streaming_bins
    if kind in ("mfp", "rfd"):  # a second pass draws what the first did
        assert _run_eval(grouped, base) == got


def _map_tpu_grouped(kind, cfg, jargs, t):
    """map_tpu's grouped eval pass over the port Trainer's valid split (its
    `_eval_dispatch`: groups of SPC, then the tail) -> (per-batch metrics,
    the draws it made, its params)."""
    mask_num = jax_corruption.mask_num_of(8, MASK_RATIO)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    x_train = t.dataset.X["train"]
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": x_train[:BATCH]})
    extra = ()
    fused = None
    if kind == "mfp":
        prob, alias_ids = jax_alias.build_alias_table(
            jax_alias.noise_distribution(cfg.feat_count))
        extra = (prob, alias_ids, cfg.logprob_noise)
        fused = jnp.asarray(jax_alias.build_fused_alias(prob, alias_ids, cfg.logprob_noise))
    make = {"supervised": jax_ts.make_supervised_steps, "rfd": jax_ts.make_rfd_steps,
            "mfp": jax_ts.make_mfp_steps}[kind]
    _, eval_step = make(model, cfg, jargs, tx, jax.random.PRNGKey(5), *extra)
    has_rng = kind != "supervised"
    multi = jax_ts.make_multi_eval(eval_step, has_rng)
    rfd = kind == "rfd"
    batches = list(JaxBatcher(t.dataset.X["valid"], t.dataset.Y["valid"],
                              batch_size=EVAL_BATCH, shuffle=False, seed=SEED,
                              noise_source=x_train if rfd else None,
                              noise_rows_per_example=mask_num if rfd else 0).epoch(0))
    rng_base = jax.random.PRNGKey(9)
    groups = [batches[i:i + SPC] for i in range(0, len(batches) // SPC * SPC, SPC)]
    groups += [[b] for b in batches[len(batches) // SPC * SPC:]]
    metrics, idx = [], 0
    for g in groups:
        dev = [{k: jnp.asarray(v) for k, v in b.items()} for b in g]
        if len(g) > 1:
            stacked = {k: jnp.stack([b[k] for b in dev]) for k in dev[0]}
            m = multi(state, stacked, rng_base, idx) if has_rng else multi(state, stacked)
            metrics += [{k: np.asarray(v)[j] for k, v in m.items()} for j in range(len(g))]
        else:
            m = (eval_step(state, dev[0], jax.random.fold_in(rng_base, idx)) if has_rng
                 else eval_step(state, dev[0]))
            metrics.append({k: np.asarray(v) for k, v in m.items()})
        idx += len(g)
    draws = []
    for i, b in enumerate(batches):  # the draws inside map_tpu's eval steps
        key = jax.random.fold_in(rng_base, i)
        if rfd:
            draws.append(_map_tpu_rfd_draws(key, b["input_ids"], mask_num, "randint",
                                            "Unigram"))
        elif kind == "mfp":
            k_mask, k_noise = jax.random.split(key)
            _, _, mi = jax_corruption.mfp_corrupt(k_mask, jnp.asarray(b["input_ids"]),
                                                  mask_num, "randint",
                                                  input_size=cfg.input_size)
            noise, logq = jax_alias.alias_draw_logq(k_noise, fused,
                                                    (EVAL_BATCH, mask_num, 5))
            draws.append(MFPDraws(*(torch.from_numpy(np.array(a))
                                    for a in (mi, noise, logq))))
    return metrics, draws, _np(state.params), batches


@pytest.mark.parametrize("kind", ["supervised", "mfp", "rfd"])
def test_grouped_eval_matches_map_tpus_multi_eval_f32(kind):
    t0, cfg, jargs = _trainer(kind, SPC)
    metrics, draws, params, batches = _map_tpu_grouped(kind, cfg, jargs, t0)
    t, _, _ = _trainer(kind, SPC, params=params)
    t.dataset = t0.dataset
    if kind == "supervised":
        got = t.eval("valid", test_eval=True)
        w = np.concatenate([b["weight"] for b in batches]) > 0
        labels = np.concatenate([b["labels"] for b in batches])[w]
        probs = np.concatenate([m["probs"] for m in metrics]).astype(np.float64)[w]
        np.testing.assert_allclose([got["eval_auc"], got["eval_loss"]],
                                   [roc_auc(labels, probs), binary_log_loss(labels, probs)],
                                   rtol=1e-5, atol=1e-5)
        return
    count = np.array([float(m["count"]) for m in metrics], np.float64)
    loss = np.array([float(m["loss"]) for m in metrics], np.float64)
    if kind == "mfp":
        got = t.MFP_pretrain_eval(draws=draws)
        acc = sum(float(m["acc_count"]) for m in metrics) / count.sum()
        assert got["eval_mfp_acc"] * count.sum() == pytest.approx(acc * count.sum(),
                                                                  abs=1e-6)
        np.testing.assert_allclose(got["eval_mfp_loss"], (loss * count).sum() / count.sum(),
                                   rtol=1e-5, atol=1e-5)
    else:
        got = t.RFD_pretrain_eval(draws=draws)
        acc = np.array([float(m["acc"]) for m in metrics], np.float64)
        np.testing.assert_allclose([got["eval_rfd_loss"], got["eval_rfd_acc"]],
                                   [(loss * count).sum() / count.sum(),
                                    (acc * count).sum() / count.sum()],
                                   rtol=1e-5, atol=1e-5)


def test_mfp_eval_step_takes_draws_as_an_argument_or_as_batch_keys():
    t, _, _ = _trainer("mfp", 1)
    t.build_steps(4)
    batch = next(t.get_batcher("valid", False).epoch(0))
    gen = torch.Generator().manual_seed(1)
    d = MFPDraws(torch.randint(0, 8, (EVAL_BATCH, 2), generator=gen),
                 torch.randint(10, 600, (EVAL_BATCH, 2, 5), generator=gen, dtype=torch.int32),
                 torch.rand(EVAL_BATCH, 2, 5, generator=gen))
    a = t.eval_step(batch, None, d)
    b = t.eval_step(dict(batch, **d._asdict()), None)
    c = t.eval_step(batch, torch.Generator().manual_seed(2))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_batcher_alloc_gives_the_streams_bits():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 50, (101, 5)).astype(np.int32)
    y = rng.integers(0, 2, 101).astype(np.float32)
    made = []

    def alloc(shape, dtype):
        a = np.full(shape, 7, dtype)
        made.append(a)
        return a

    for stacked in (False, True):
        ref = Batcher(x, y, 16, shuffle=True, seed=3, noise_source=x,
                      noise_rows_per_example=2)
        got = Batcher(x, y, 16, shuffle=True, seed=3, noise_source=x,
                      noise_rows_per_example=2)
        got.alloc = alloc
        if stacked:
            a, b = list(ref.epoch_stacked(3, 1)), list(got.epoch_stacked(3, 1))
            assert [n for n, _, _ in a] == [n for n, _, _ in b]
            pairs = [(p, q) for (_, p, _), (_, q, _) in zip(a, b)]
        else:
            pairs = list(zip(ref.epoch(1), got.epoch(1)))
        for p, q in pairs:
            assert sorted(p) == sorted(q)
            for k in p:
                np.testing.assert_array_equal(p[k], q[k], err_msg=k)
                assert p[k].dtype == q[k].dtype, k
    assert made
