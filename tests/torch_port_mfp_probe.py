"""MFP's eval loss in both packages over many seeds, on the CPU: the probe
behind ROADMAP's Queue C item on MFP's eval-loss offset.

    JAX_PLATFORMS=cpu python tests/torch_port_mfp_probe.py step0 \\
        --seeds 42-73 --rows 400000 --data_root /tmp/mfp_probe
    JAX_PLATFORMS=cpu python tests/torch_port_mfp_probe.py runs \\
        --seeds 42-57 --rows 60000 --data_root /tmp/mfp_probe
    JAX_PLATFORMS=cpu python tests/torch_port_mfp_probe.py runs --package map_tpu \\
        --seeds 42-49 --rows 400000 --data_root /tmp/mfp_probe > map_tpu_42-49.log
    python tests/torch_port_mfp_probe.py runs --pool map_tpu_42-49.log,port_42-49.log
    JAX_PLATFORMS=cpu python tests/torch_port_mfp_probe.py carried \\
        --seeds 42-57 --rows 60000 --data_root /tmp/mfp_probe

The data is synthazu (`validation/gen_data.py`'s generator, data seed 7)
at `--rows`, written once under `--data_root`. The model is the `mfp`
stage's (`validation/run_tpu.sh:31-37`): DCNv2, embed 16, MLP 3 x 1000, 3
cross layers, batch 4096, `--pt_neg_num=25 --proj_size=32 --mask_ratio=0.3
--sampling_method=randint`, lr 1e-3, wd 5e-2, cosine, in float32.

- `step0`: each package builds the model from the seed with its own init
  and takes its MFP eval over the valid split with its own eval draws,
  before any step;
- `runs`: each package's CLI (`map_tpu.run`, `map_tpu_torch.run --device
  cpu`) runs the stage (3 epochs) at the seed; the last `mfp_eval` record
  of its metrics.jsonl; `--package map_tpu|port` runs one side (the sides
  as separate background jobs), and `--pool a.log,b.log,...` prints the
  SUMMARY and the paired Δ of such jobs' lines;
- `carried`: the port's run from map_tpu's initial weights at the seed
  (carried by `interop/from_jax.py`), then its final eval taken twice,
  with its own draws and with map_tpu's (`MFP_pretrain_eval(draws)`);
- `lockstep`: as `carried`, but every train step takes map_tpu's draws of
  that step (one eager step a call);
- `draws`: `--draws` noise ids from each package's alias draw on the train
  split's unigram: chi-square against q, the mean log q;
- `init`: each package's initial weights, every leaf's mean, std, min and
  max over the seeds, by the port's names;
- `reverse`: map_tpu trained from the port's initial weights (carried by
  `interop/to_jax.py`) beside map_tpu from its own.

Each prints one JSON line a run and a summary line: the means, the sample
stds, Δ and 2σ(Δ). Imports both packages, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODEL = ["--model_name=dcnv2", "--embed_size=16", "--hidden_size=1000",
         "--num_hidden_layers=3", "--num_cross_layers=3", "--hidden_dropout_rate=0.0"]
TRAIN = ["--dataset_name=synthazu", "--per_device_train_batch_size=4096",
         "--per_device_eval_batch_size=4096", "--learning_rate=1e-3",
         "--adam_epsilon=1e-8", "--max_grad_norm=0", "--weight_decay=5e-2",
         "--lr_sched=cosine", "--num_train_epochs=3", "--pretrain", "--pt_type=MFP",
         "--sampling_method=randint", "--mask_ratio=0.3", "--pt_neg_num=25",
         "--proj_size=32", "--logging_steps=100", "--compute_dtype=float32"]


def seeds_of(text: str):
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in text.split(",")]


def data_dir(root: str, rows: int) -> str:
    from map_tpu_torch.data import synth

    d = os.path.join(root, f"synthazu_{rows}")
    if not os.path.exists(os.path.join(d, "synthazu.h5")):
        os.makedirs(d, exist_ok=True)
        synth.generate_realistic(d, name="synthazu", num_rows=rows, seed=7)
    return d


def jax_trainer(argv):
    from map_tpu import models as jmodels
    from map_tpu.config import build_config, parse_args
    from map_tpu.data.dataset import CTRDataset
    from map_tpu.train.trainer import Trainer

    margs, targs = parse_args(argv)
    ds = CTRDataset(targs)
    cfg = build_config(margs, targs, ds)
    t = Trainer(jmodels.from_config(cfg), cfg, targs, ds)
    t._build_steps(len(t.get_batcher("train", True)))
    return t


def torch_trainer(argv):
    from map_tpu_torch import models as tmodels
    from map_tpu_torch.config import build_config, parse_args
    from map_tpu_torch.data.dataset import CTRDataset
    from map_tpu_torch.train.trainer import Trainer
    from map_tpu_torch.utils.seeds import stream_generator

    margs, targs = parse_args(argv)
    ds = CTRDataset(targs.data_dir, targs.dataset_name, pretrain=True)
    cfg = build_config(margs, targs, ds)
    model = tmodels.from_config(cfg, stream_generator(targs.seed, "init"))
    return Trainer(model, cfg, targs, ds)


def last_eval(run_dir: str):
    rec = None
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r.get("kind") == "mfp_eval" or "eval_mfp_loss" in r:
                rec = r
    return rec["eval_mfp_loss"], rec["eval_mfp_acc"]


def summary(tag, port, ref):
    def ms(v):
        v = np.asarray(v, np.float64)
        return float(v.mean()), float(v.std(ddof=1)) if len(v) > 1 else 0.0

    (mp, sp), (mr, sr) = ms(port), ms(ref)
    two_sigma = 2 * math.sqrt(sp ** 2 / len(port) + sr ** 2 / len(ref))
    print("SUMMARY " + json.dumps({"what": tag, "port_mean": mp, "port_std": sp,
                                   "n_port": len(port), "map_tpu_mean": mr,
                                   "map_tpu_std": sr, "n_map_tpu": len(ref),
                                   "delta": mp - mr, "two_sigma": two_sigma}), flush=True)


def step0(args, d):
    port, ref = [], []
    for seed in seeds_of(args.seeds):
        with tempfile.TemporaryDirectory() as out:
            argv = MODEL + TRAIN + [f"--data_dir={d}", f"--output_dir={out}",
                                    f"--seed={seed}"]
            lj = jax_trainer(argv).MFP_pretrain_eval()["eval_mfp_loss"]
            lt = torch_trainer(argv + ["--device=cpu"]).MFP_pretrain_eval()["eval_mfp_loss"]
        port.append(lt)
        ref.append(lj)
        print(json.dumps({"mode": "step0", "seed": seed, "port": lt, "map_tpu": lj}),
              flush=True)
    summary("step0 eval loss", port, ref)


def runs(args, d):
    from map_tpu import run as jrun
    from map_tpu_torch import run as trun

    port, ref = [], []
    for seed in seeds_of(args.seeds):
        rec = {"mode": "runs", "seed": seed}
        with tempfile.TemporaryDirectory() as out:
            argv = MODEL + TRAIN + [f"--data_dir={d}", f"--seed={seed}"]
            if args.package in ("both", "map_tpu"):
                jrun.main(argv + [f"--output_dir={out}/jax"])
                rec["map_tpu"], rec["map_tpu_acc"] = last_eval(f"{out}/jax")
                ref.append(rec["map_tpu"])
            if args.package in ("both", "port"):
                trun.main(argv + [f"--output_dir={out}/torch", "--device=cpu"])
                rec["port"], rec["port_acc"] = last_eval(f"{out}/torch")
                port.append(rec["port"])
        print(json.dumps(rec), flush=True)
    if port and ref:
        summary("whole-run eval loss", port, ref)


def pool(args):
    """The SUMMARY of the `runs` JSON lines in `--pool` files, each side
    taken from whichever file holds it (runs of one package each)."""
    port, ref = {}, {}
    for path in args.pool.split(","):
        with open(path) as f:
            for line in f:
                if not line.startswith('{"mode": "runs"'):
                    continue
                r = json.loads(line)
                if "port" in r:
                    port[r["seed"]] = r["port"]
                if "map_tpu" in r:
                    ref[r["seed"]] = r["map_tpu"]
    print(json.dumps({"seeds_port": sorted(port), "seeds_map_tpu": sorted(ref)}))
    summary("whole-run eval loss", [port[s] for s in sorted(port)],
            [ref[s] for s in sorted(ref)])
    both = sorted(set(port) & set(ref))
    if len(both) > 1:
        dv = np.asarray([port[s] - ref[s] for s in both])
        print("PAIRED " + json.dumps({"n": len(both), "delta": float(dv.mean()),
                                      "se": float(dv.std(ddof=1) / math.sqrt(len(dv)))}))


def carried(args, d, lockstep: bool = False):
    """The port from map_tpu's initial weights at each seed, trained with
    its own draws (or, `lockstep`, with map_tpu's draws of every step, one
    eager step a call); its final eval taken with its own draws and with
    map_tpu's; map_tpu's run beside it."""
    import jax
    import torch

    from map_tpu_torch.interop.from_jax import state_dict_from_jax

    own, handed, ref = [], [], []
    for seed in seeds_of(args.seeds):
        with tempfile.TemporaryDirectory() as out:
            argv = MODEL + TRAIN + [f"--data_dir={d}", f"--seed={seed}"]
            jt = jax_trainer(argv + [f"--output_dir={out}/jax"])
            params = jax.device_get(jt.state.params)
            extra = ["--steps_per_call=1", "--device_resident_data=off"] if lockstep else []
            tt = torch_trainer(argv + [f"--output_dir={out}/torch", "--device=cpu"] + extra)
            tt.model.load_state_dict(state_dict_from_jax({"params": params}, tt.config))
            if lockstep:
                lockstep_train(jt, tt)
            else:
                tt.MFP_pretrain()
            lo = tt.MFP_pretrain_eval()["eval_mfp_loss"]
            lh = tt.MFP_pretrain_eval(jax_eval_draws(jt, tt))["eval_mfp_loss"]
            jt.MFP_pretrain()
            lj = jt.eval_metrics[-1][0]
        own.append(lo)
        handed.append(lh)
        ref.append(lj)
        print(json.dumps({"mode": "lockstep" if lockstep else "carried", "seed": seed,
                          "port_own_draws": lo, "port_map_tpu_draws": lh, "map_tpu": lj}),
              flush=True)
    tag = "lockstep (map_tpu's train draws)" if lockstep else "carried init"
    summary(f"{tag}, own eval draws", own, ref)
    summary(f"{tag}, map_tpu's eval draws", handed, ref)


def _map_tpu_draws(jt, rng, batch):
    """map_tpu's `_corrupt_and_sample` draws for `batch` from `rng`."""
    import jax
    import jax.numpy as jnp
    import torch

    from map_tpu.objectives import alias as jalias
    from map_tpu.objectives import corruption as jcorr
    from map_tpu_torch.train.train_step import MFPDraws

    cfg, args = jt.config, jt.args
    mask_num = jcorr.mask_num_of(cfg.num_fields, args.mask_ratio)
    k_mask, k_noise = jax.random.split(rng)
    ids = jnp.asarray(batch["input_ids"])
    _, _, masked = jcorr.mfp_corrupt(k_mask, ids, mask_num, args.sampling_method,
                                     input_size=int(cfg.input_size))
    fused = jnp.asarray(jalias.build_fused_alias(jt._alias_prob, jt._alias_alias,
                                                 cfg.logprob_noise))
    noise, logq = jalias.alias_draw_logq(k_noise, fused,
                                         (ids.shape[0], mask_num, int(cfg.pt_neg_num)))
    return MFPDraws(*(torch.from_numpy(np.array(a)) for a in (masked, noise, logq)))


def jax_eval_draws(jt, tt):
    """map_tpu's eval draws, batch i from fold_in(its eval key, i)."""
    import jax

    batches = tt.get_batcher("valid", False).epoch(0)
    return [_map_tpu_draws(jt, jax.random.fold_in(jt._eval_rng_base, i), b)
            for i, b in enumerate(batches)]


def lockstep_train(jt, tt):
    """The port's MFP run, step s with map_tpu's draws from its corruption key
    split(fold_in(its step key, s))[0] (map_tpu/train/train_step.py:452-453),
    on the Batcher's host batches."""
    import jax

    batcher = tt._prepare_training()
    step = 0
    for epoch in range(int(tt.args.num_train_epochs)):
        for batch in batcher.epoch(epoch):
            k_corrupt, _ = jax.random.split(jax.random.fold_in(jt._step_rng, step))
            tt.train_step(batch, _map_tpu_draws(jt, k_corrupt, batch))
            tt.global_step += 1
            step += 1


def draws(args, d):
    """`--draws` noise ids from each package's alias draw (`alias_draw_logq`
    on the fused table of the train split's unigram, in chunks of 10^6):
    Pearson's chi-square against q and the mean log q of the draws."""
    import jax
    import jax.numpy as jnp
    import torch

    from map_tpu.objectives import alias as jalias
    from map_tpu_torch.data.dataset import CTRDataset
    from map_tpu_torch.objectives import alias as talias

    ds = CTRDataset(d, "synthazu", pretrain=True)
    probs, logq, _ = talias.noise_log_prior(ds.feat_count)
    prob, al = talias.build_alias_table(probs)
    fused = talias.build_fused_alias(prob, al, logq)
    chunk = 1_000_000
    n = args.draws // chunk
    gen = torch.Generator().manual_seed(0)
    tfused, jfused = torch.from_numpy(fused), jnp.asarray(fused)
    key = jax.random.PRNGKey(0)
    for pkg in ("port", "map_tpu"):
        counts = np.zeros(len(probs), np.int64)
        sums = np.zeros(2)
        for c in range(n):
            if pkg == "port":
                ids, lq = talias.alias_draw_logq(gen, tfused, (chunk,))
                ids, lq = ids.numpy(), lq.numpy()
            else:
                ids, lq = jalias.alias_draw_logq(jax.random.fold_in(key, c), jfused, (chunk,))
                ids, lq = np.asarray(ids), np.asarray(lq)
            counts += np.bincount(ids, minlength=len(probs))
            sums += (lq.astype(np.float64).sum(), (lq.astype(np.float64) ** 2).sum())
        stat, dof = talias.chi_square(counts, probs)
        mean = sums[0] / (n * chunk)
        se = math.sqrt((sums[1] / (n * chunk) - mean ** 2) / (n * chunk))
        print(json.dumps({"mode": "draws", "package": pkg, "draws": n * chunk,
                          "chi_square": stat, "dof": dof,
                          "p": talias.chi_square_p(stat, dof), "mean_logq": mean,
                          "se_logq": se, "expected_logq": float((probs * logq).sum())}),
              flush=True)


def init(args, d):
    """Each package's initial weights at each seed, side by side by the
    port's names (map_tpu's carried by `interop/from_jax.py`): every leaf's
    mean, std, min and max, pooled over the seeds."""
    import jax
    import torch

    from map_tpu_torch.interop.from_jax import state_dict_from_jax

    stats = {}
    for seed in seeds_of(args.seeds):
        with tempfile.TemporaryDirectory() as out:
            argv = MODEL + TRAIN + [f"--data_dir={d}", f"--seed={seed}", f"--output_dir={out}"]
            jt = jax_trainer(argv)
            tt = torch_trainer(argv + ["--device=cpu"])
            ref = state_dict_from_jax({"params": jax.device_get(jt.state.params)}, tt.config)
            own = tt.model.state_dict()
            for name in own:
                for pkg, t in (("port", own[name]), ("map_tpu", ref[name])):
                    x = t.double().reshape(-1)
                    acc = stats.setdefault(name, {}).setdefault(pkg, [0, 0.0, 0.0, np.inf, -np.inf])
                    acc[0] += x.numel()
                    acc[1] += float(x.sum())
                    acc[2] += float((x * x).sum())
                    acc[3] = min(acc[3], float(x.min()))
                    acc[4] = max(acc[4], float(x.max()))
    for name, by in stats.items():
        row = {"mode": "init", "leaf": name}
        for pkg, (n, s1, s2, lo, hi) in by.items():
            mean = s1 / n
            row[pkg] = {"n": n, "mean": mean, "std": math.sqrt(max(s2 / n - mean * mean, 0.0)),
                        "min": lo, "max": hi}
        print(json.dumps(row), flush=True)


def reverse(args, d):
    """map_tpu trained from the port's initial weights at each seed (carried
    by `interop/to_jax.py`), beside map_tpu from its own: whether the
    port's initialisation, not its training, moves the final eval loss."""
    import jax
    import jax.numpy as jnp

    from map_tpu_torch.interop.to_jax import variables_from_state_dict

    got, ref = [], []
    for seed in seeds_of(args.seeds):
        with tempfile.TemporaryDirectory() as out:
            argv = MODEL + TRAIN + [f"--data_dir={d}", f"--seed={seed}"]
            tt = torch_trainer(argv + [f"--output_dir={out}/torch", "--device=cpu"])
            jt = jax_trainer(argv + [f"--output_dir={out}/jax"])
            own = jax.tree.structure(jt.state.params)
            params = jax.tree.map(jnp.asarray, variables_from_state_dict(
                tt.model.state_dict(), tt.config, packed=True)["params"])
            assert jax.tree.structure(params) == own
            build = jt._build_steps

            def carried_build(n, build=build, jt=jt, params=params):
                build(n)  # MFP_pretrain builds the state anew from its init key
                jt.state = jt.state.replace(params=params)

            jt._build_steps = carried_build
            jt.MFP_pretrain()
            lp = jt.eval_metrics[-1][0]
            jt2 = jax_trainer(argv + [f"--output_dir={out}/jax2"])
            jt2.MFP_pretrain()
            lj = jt2.eval_metrics[-1][0]
        got.append(lp)
        ref.append(lj)
        print(json.dumps({"mode": "reverse", "seed": seed, "map_tpu_from_port_init": lp,
                          "map_tpu": lj}), flush=True)
    summary("map_tpu from the port's init against its own", got, ref)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("step0", "runs", "carried", "lockstep", "draws", "init",
                                      "reverse"))
    p.add_argument("--draws", type=int, default=50_000_000)
    p.add_argument("--seeds", default="42-73")
    p.add_argument("--rows", type=int, default=400000)
    p.add_argument("--data_root", default=os.path.join(tempfile.gettempdir(), "mfp_probe"))
    p.add_argument("--package", choices=("both", "port", "map_tpu"), default="both",
                   help="`runs`: which package's CLI runs (the two sides as separate jobs)")
    p.add_argument("--pool", default="",
                   help="comma-separated files of `runs` lines: print their SUMMARY and stop")
    args = p.parse_args()
    if args.pool:
        pool(args)
        return 0
    d = data_dir(args.data_root, args.rows)
    if args.mode == "lockstep":
        carried(args, d, lockstep=True)
    else:
        {"step0": step0, "runs": runs, "carried": carried, "draws": draws,
         "init": init, "reverse": reverse}[args.mode](args, d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
