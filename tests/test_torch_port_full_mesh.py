"""The `full` MFP loss under a table mesh, and the run's generator seeds.

- `parallel/vocab_ce.sharded_full_ce` over 2 and 4 gloo ranks (each a
  process of `tests/torch_port_full_mesh_rank.py`, the row blocks of the
  decoder's emb and bias on the ranks) against the unsharded `full_ce_loss`
  and its gradients by autograd, at 1e-6 in float32; the accuracy's ties
  (small integer weights, whose scores are exact) go to the lowest id.
- 5 `full` MFP steps of the port's Trainer on a 1 x 2 psum mesh (two gloo
  ranks) against map_tpu's `full` steps on its 8-device CPU mesh (4 x 2,
  what `--mock_devices=8 --num_model_shards=2` builds) from the same
  carried weights, on the same batches, with map_tpu's draws handed to the
  port; and against the port's one-rank steps: losses, counts and every
  parameter at 1e-5.
- `python -m map_tpu_torch.run --nce_loss_type=full --num_model_shards=2`
  under the launcher, 2 gloo ranks, against one rank.
- `validate.py`'s second comparison, map_tpu's band rerun on the CPU.
- `utils/seeds.py`: the four streams of seeds 42-73 are 128 distinct
  seeds (and distinct in the low 32 bits a CPU generator keeps), and two
  runs of one seed are bit-equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from map_tpu import config as jax_config
from map_tpu import models as jax_models
from map_tpu.objectives import alias as jax_alias
from map_tpu.parallel import sharding as jax_sh
from map_tpu.parallel.context import set_table_exchange, set_table_mesh
from map_tpu.parallel.mesh import build_mesh as jax_build_mesh
from map_tpu.train import train_step as jax_ts
from map_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from map_tpu_torch import models
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.objectives.nce import full_ce_loss
from map_tpu_torch.parallel.launch import free_port, rank_env
from map_tpu_torch.train.trainer import Trainer
from map_tpu_torch.utils.seeds import STREAMS, stream_generator, stream_seed

from test_torch_port_mfp import K_STEPS, LR
from test_torch_port_multiprocess import (  # noqa: F401  (data_dirs: a fixture)
    _agree,
    batch_flags,
    data_dirs,
    model_flags,
    run_ranks,
)
from test_torch_port_shared_noise import BATCH, IDX_HIGH, IDX_LOW, VOCAB, _configs, _map_tpu_draws
from test_torch_port_train import _jax_moments, _np

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_SCRIPT = os.path.join(HERE, "torch_port_full_mesh_rank.py")


def _ranks(mode: str, nprocs: int, job: dict, tmp_path, timeout: float = 240):
    """Each rank's results, in rank order."""
    src, out = tmp_path / f"{mode}_job.pt", tmp_path / f"{mode}_out"
    torch.save(job, src)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, RANK_SCRIPT, mode, str(src), str(out)],
                              env=rank_env(r, nprocs, port, "gloo"), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(nprocs)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(nprocs)]


# ---- sharded_full_ce against the unsharded loss -----------------------------------

def _ce_inputs(kind: str, v: int, seed: int):
    rng = np.random.default_rng(seed)
    b, m, e = 6, 3, 8
    if kind == "ties":  # quarters of small integers: every score exact, ties common
        x, emb, bias = (rng.integers(-2, 3, shape).astype(np.float32) / 4
                        for shape in ((b, m, e), (v, e), (v, 1)))
    else:
        x = rng.standard_normal((b, m, e)).astype(np.float32)
        emb = (rng.standard_normal((v, e)) * 0.5).astype(np.float32)
        bias = (rng.standard_normal((v, 1)) * 0.1).astype(np.float32)
    target = rng.integers(0, v, (b, m))
    cot = rng.standard_normal((b, m)).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in dict(
        inputs=x, emb=emb, bias=bias, target=target, cot=cot).items()}


@pytest.mark.parametrize("nprocs,v,kind", [(2, 601, "normal"), (4, 603, "normal"),
                                           (2, 40, "ties"), (4, 41, "ties")])
def test_sharded_full_ce_matches_unsharded(nprocs, v, kind, tmp_path):
    job = _ce_inputs(kind, v, seed=v)
    if kind == "ties":  # the top score, 3, at two ids of two blocks: the lower one wins
        job["target"][0, 0] = 3
        job["emb"][3] = job["emb"][v - 2] = 0.0
        job["bias"][3] = job["bias"][v - 2] = 3.0
    x = job["inputs"].clone().requires_grad_()
    emb = job["emb"].clone().requires_grad_()
    bias = job["bias"].clone().requires_grad_()
    scores = torch.einsum("bme,ve->bmv", x, emb) + bias[:, 0]
    loss = full_ce_loss(scores, job["target"])
    (loss * job["cot"]).sum().backward()
    hit = (torch.argmax(scores.detach(), -1) == job["target"]).float()
    got = _ranks("ce", nprocs, job, tmp_path)
    tol = dict(rtol=1e-6, atol=1e-6)
    for r in got:
        np.testing.assert_allclose(r["loss"], loss.detach(), **tol)
        np.testing.assert_allclose(r["eval_loss"], loss.detach(), **tol)
        np.testing.assert_allclose(r["d_x"], x.grad, **tol)
        np.testing.assert_array_equal(r["hit"], hit)
        np.testing.assert_array_equal(r["eval_hit"], hit)
        np.testing.assert_allclose(r["scores"], scores.detach(), **tol)
    np.testing.assert_allclose(torch.cat([r["d_emb"] for r in got]), emb.grad, **tol)
    np.testing.assert_allclose(torch.cat([r["d_bias"] for r in got]), bias.grad, **tol)
    if kind == "ties":
        top = scores.detach().amax(-1, keepdim=True)
        assert int(((scores == top).sum(-1) > 1).sum()) > 0  # ties occurred
        assert hit[0, 0] == 1.0


# ---- 5 full MFP steps on a 1 x 2 mesh against map_tpu's 4 x 2 -----------------------

def _full_mesh_steps(tmp_path):
    cfg, port_cfg, args = _configs("full", "full")
    prob, alias_ids = jax_alias.build_alias_table(jax_alias.noise_distribution(cfg.feat_count))
    logq = cfg.logprob_noise
    low = np.asarray(IDX_LOW, np.int32)
    tables = (jax_alias.build_fused_alias(prob, alias_ids, logq), prob, alias_ids, logq,
              low, np.asarray(IDX_HIGH, np.int32) - low)
    rng = np.random.default_rng(31)
    batches = []
    for i in range(K_STEPS):
        weight = np.ones(BATCH, np.float32)
        if i == K_STEPS - 1:
            weight[160:] = 0.0  # a padded last batch
        ids = np.stack([rng.integers(a, b, BATCH) for a, b in zip(IDX_LOW, IDX_HIGH)], 1)
        batches.append({"input_ids": ids.astype(np.int32),
                        "labels": np.zeros(BATCH, np.float32), "weight": weight})
    jargs = jax_config.TrainingArguments(
        learning_rate=LR, weight_decay=0.05, lr_sched="cosine", mask_ratio=args.mask_ratio,
        sampling_method="randint", pretrain=True, pt_type="MFP", compute_dtype="float32",
        packed_tables=True, num_model_shards=2)
    base_rng = jax.random.PRNGKey(5)
    tx, _ = jax_build_optimizer(jargs, num_training_steps=10, num_warmup_steps=2)
    model = jax_models.from_config(cfg)
    state = jax_ts.create_train_state(model, cfg, jargs, tx, jax.random.PRNGKey(4),
                                      {"input_ids": batches[0]["input_ids"]})
    carried = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
    draws = [_map_tpu_draws("full", base_rng, s, b["input_ids"], tables)
             for s, b in enumerate(batches)]
    mesh = jax_build_mesh(-1, 2)  # the CLI's mesh on 8 devices: data 4 x model 2
    assert mesh.devices.shape == (4, 2)
    set_table_mesh(mesh)
    set_table_exchange("psum")
    try:
        state = jax_sh.shard_state(state, mesh, "rows")
        assert len(state.params["mfp_decoder"]["emb"].sharding.device_set) == 8
        train_step, _ = jax_ts.make_mfp_steps(model, cfg, jargs, tx, base_rng, prob,
                                              alias_ids, logq)
        spec = NamedSharding(mesh, P("data"))
        jax_m = []
        for b in batches:
            state, m = train_step(state, {k: jax.device_put(jnp.asarray(v), spec)
                                          for k, v in b.items()})
            jax_m.append([float(m[k]) for k in ("loss", "count", "acc_count")])
        ref = state_dict_from_jax({"params": _np(state.params)}, port_cfg)
        nu = {k: v[1] for k, v in _jax_moments(tx, state.opt_state, cfg).items()}
    finally:
        set_table_mesh(None)
    # the port: one rank in this process, two ranks on a (1, 2) mesh
    one = models.from_config(port_cfg)
    one.load_state_dict(carried)
    trainer = Trainer(one, port_cfg, args, dataset=None, device="cpu")
    trainer.build_steps(10)
    one_m = [[m[k].item() for k in ("loss", "count", "acc_count")]
             for m in (trainer.train_step(b, d) for b, d in zip(batches, draws))]
    args.num_model_shards = 2
    two = _ranks("steps", 2, dict(config=port_cfg, args=args, state=carried,
                                  batches=batches, draws=draws, total_steps=10), tmp_path)
    return (np.array(jax_m), ref, nu, np.array(one_m), trainer.model.state_dict(), two)


def _params_agree(got, ref, nu=None):
    """Every parameter at 1e-5 + 1e-5 |ref|; with map_tpu's second moments
    `nu`, `_assert_steps_agree`'s one exception: an element whose every
    gradient so far lies within rounding of 0 moves by at most 2 lr k."""
    assert set(got) == set(ref)
    for key in ref:
        r, g = ref[key].numpy(), got[key].numpy()
        diff = np.abs(g - r)
        flat = (np.zeros(r.shape, bool) if nu is None
                else np.sqrt(nu[key].numpy()) < 1e-7)
        np.testing.assert_array_less(diff[~flat], 1e-5 + 1e-5 * np.abs(r[~flat]), err_msg=key)
        assert (diff[flat] <= 2 * LR * K_STEPS).all(), key


def test_full_loss_steps_on_a_table_mesh_match_map_tpu_and_one_rank(tmp_path):
    jax_m, ref, nu, one_m, one_state, two = _full_mesh_steps(tmp_path)
    assert all(r["mesh"] == [1, 2] for r in two)
    assert {"mfp_criterion.emb.weight", "mfp_criterion.bias.weight"} <= set(two[0]["shards"])
    for r in two:
        m = np.array(r["metrics"])
        np.testing.assert_allclose(m[:, 0], jax_m[:, 0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(m[:, 1:], jax_m[:, 1:])  # count, acc_count
        np.testing.assert_allclose(m[:, 0], one_m[:, 0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(m[:, 1:], one_m[:, 1:])
        _params_agree(r["state"], ref, nu)
        _params_agree(r["state"], one_state)
    for k, v in two[0]["state"].items():  # the ranks agree exactly
        assert torch.equal(v, two[1]["state"][k]), k


def test_full_loss_cli_two_ranks_matches_one_rank(data_dirs, tmp_path):
    """`map_tpu_torch.run --nce_loss_type=full --num_model_shards=2` under
    the launcher (2 gloo ranks): the eval loss within 1e-5 of one rank's,
    the accuracy within 2e-3 (a near-tie may break the other way); the
    ranks agree exactly."""
    mfp = model_flags(data_dirs["mfp"], "dnn") + [
        "--pretrain", "--pt_type=MFP", "--sampling_method=randint", "--mask_ratio=0.3",
        "--nce_loss_type=full", "--proj_size=8", "--logging_steps=1000",
        "--per_device_train_batch_size=128", "--per_device_eval_batch_size=64"]
    one = run_ranks(1, mfp, tmp_path / "one")[0]
    two = run_ranks(2, mfp + ["--num_model_shards=2"], tmp_path / "two")
    assert all(r["mesh"] == [1, 2] for r in two)
    _agree(two)
    (loss1, acc1), (loss2, acc2) = one["eval_metrics"][-1], two[0]["eval_metrics"][-1]
    assert abs(loss1 - loss2) < 1e-5 and abs(acc1 - acc2) < 2e-3
    assert np.isfinite(loss1) and one["global_step"] == two[0]["global_step"] > 0
    log = open(tmp_path / "two" / "train.log").read()
    assert "table sharding: rows over mesh {'data': 1, 'model': 2}" in log
    assert "loss = full" in log


def test_global_norm_clip_on_a_table_mesh_matches_one_rank(data_dirs, tmp_path):
    """`--max_grad_norm` under a 1 x 2 table mesh: every rank clips by the
    norm of the whole gradient (its table blocks' squares summed over the
    model group), so the run follows one rank's: eval loss within 2e-5, the
    ranks agree exactly. The clip engages (the norm is far above 1e-3)."""
    flags = model_flags(data_dirs["mfp"], "dnn") + [
        "--pretrain", "--pt_type=MFP", "--sampling_method=randint", "--mask_ratio=0.3",
        "--pt_neg_num=5", "--proj_size=8", "--logging_steps=1000", "--max_grad_norm=1e-3",
        "--per_device_train_batch_size=128", "--per_device_eval_batch_size=64"]
    one = run_ranks(1, flags, tmp_path / "one")[0]
    two = run_ranks(2, flags + ["--num_model_shards=2"], tmp_path / "two")
    _agree(two)
    assert abs(one["eval_metrics"][-1][0] - two[0]["eval_metrics"][-1][0]) < 2e-5


def test_map_tpu_cpu_band_is_a_second_comparison():
    """validate.py holds the mfp stage to MAP_TPU_BAND as before and, beside
    it, to map_tpu's CPU rerun (MAP_TPU_CPU_BAND), which has the mfp row
    only."""
    from map_tpu_torch import validate

    st = validate.STAGES
    assert validate.reference_rows(st["mfp"]) == [
        (0.728718, 0.002796, 8, 1e-3), (1.376592, 0.007622, 8, 5e-4)]
    assert validate.reference_rows(st["mfp"], validate.MAP_TPU_CPU_BAND) == [
        (0.728742, 0.002274, 16, 1e-3), (1.378617, 0.007748, 16, 5e-4)]
    assert validate.reference_rows(st["scratch"], validate.MAP_TPU_CPU_BAND) == []
    results = [{"stage": "mfp", "metric": 0.729, "loss": 1.3843 + 0.001 * i}
               for i in range(-2, 3)]
    old, cpu = (validate.table(results, [st["mfp"]], bands)
                for bands in (validate.MAP_TPU_BAND, validate.MAP_TPU_CPU_BAND))
    assert [r["map_tpu_mean"] for r in old] == [0.728718, 1.376592]
    assert [r["map_tpu_mean"] for r in cpu] == [0.728742, 1.378617]
    assert abs(cpu[1]["delta"] - (1.3843 - 1.378617)) < 1e-9


# ---- the run's generator seeds --------------------------------------------------------

def test_stream_seeds_never_meet():
    seeds = {(s, name, i): stream_seed(s, name, i)
             for s in range(42, 74) for name in STREAMS for i in ((0, 1) if name == "dropout"
                                                                  else (0,))}
    values = list(seeds.values())
    assert len(set(values)) == len(values) == 32 * 5
    assert len({v & 0xFFFFFFFF for v in values}) == len(values)  # the CPU generator's part
    assert all(0 <= v < 2 ** 63 for v in values)
    # the first draws of every stream differ, within a run and across seeds
    firsts = {k: tuple(torch.rand(4, generator=stream_generator(*k)).tolist())
              for k in seeds}
    assert len(set(firsts.values())) == len(firsts)
    assert stream_seed(42, "step") == stream_seed(42, "step")


def test_two_runs_of_one_seed_are_bit_equal(data_dirs, tmp_path):
    """Two CLI runs of MFP with dropout at one seed (init, dropout, step and
    eval draws from the derived seeds) end bit-equal: eval metrics and the
    parameters' sum; another seed does not."""
    flags = model_flags(data_dirs["mfp"], "dcnv2") + [
        "--pretrain", "--pt_type=MFP", "--sampling_method=randint", "--mask_ratio=0.3",
        "--pt_neg_num=5", "--proj_size=8", "--hidden_dropout_rate=0.1",
        "--logging_steps=1000"] + batch_flags(1)
    runs = [run_ranks(1, flags + [f"--seed={seed}"], tmp_path / f"run{i}")[0]
            for i, seed in enumerate((42, 42, 43))]
    assert runs[0]["global_step"] > 0
    for key in ("eval_metrics", "param_sum"):
        assert runs[0][key] == runs[1][key], key
        assert runs[0][key] != runs[2][key], key
