"""map_tpu's zoo through both Trainers on the CPU: the probe behind the
zoo's validation bands and its lockstep check.

    JAX_PLATFORMS=cpu python tests/torch_port_zoo_probe.py runs --package map_tpu \\
        --model fgcnn --seeds 42-45 --rows 120000 --data_root /tmp/zoo_probe > fgcnn.log
    python tests/torch_port_zoo_probe.py bands --pool fgcnn.log,dnn.log,...
    JAX_PLATFORMS=cpu python tests/torch_port_zoo_probe.py lockstep --model autoint \\
        --seeds 42 --rows 40000 --data_root /tmp/zoo_probe
    JAX_PLATFORMS=cpu python tests/torch_port_zoo_probe.py init --model trans --seeds 42-44

The data is synthazu (`validation/gen_data.py`'s generator, data seed 7)
at `--rows`, written once under `--data_root` (generate it before starting
parallel jobs: they would race to write it). A model's flags are
`map_tpu_torch/validate.py`'s (`model_flags`, `ZOO_KNOBS`), its stages
`validate.STAGES` (`validation/run_tpu.sh`'s flags), in float32.

- `runs`: each package's CLI (`map_tpu.run`, `map_tpu_torch.run --device
  cpu`) runs the model's stages at each seed, a finetune from its own
  side's newest checkpoint of the source stage; one JSON line a stage and
  seed with the stage's metric and loss (`validate.stage_result`);
  `--package map_tpu|port` runs one side (the sides as separate
  background jobs);
- `bands --pool a.log,b.log,...`: map_tpu's (mean, std, n) a model and
  stage from such lines, as `validate.MAP_TPU_ZOO_CPU_BAND` holds them, and
  the verdict of the port's lines against them where a file has both;
- `lockstep`: both Trainers from map_tpu's initial weights (carried by
  `interop/from_jax.py`), on the same host batches, the port handed
  map_tpu's draws of every train step (MFP noise and positions, RFD
  replacements) and of every eval batch, dropout 0 (AutoInt's attention
  dropout too); a finetune starts, in both, from map_tpu's lockstep
  checkpoint of its source stage. One JSON line a stage: the final eval's
  metric and loss on each side, every train window's loss on each side,
  the largest gap, and the first step at which the per-step losses part by
  more than 1e-5; `--self_ulp` runs map_tpu once more from its initial
  parameters moved one float32 ulp, its gaps to map_tpu beside the port's
  (how far map_tpu's own rounding carries); `--trace N` prints each leaf's
  gap after each of the first N steps (and, after step 0, the gradients'
  gap where the parameters part);
- `init`: each package's initial weights of the model (with the MFP and RFD
  heads), every leaf's mean, std, min and max, pooled over the seeds.

Imports both packages, as the tests do.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_mfp_probe import (  # noqa: E402
    _map_tpu_draws,
    data_dir,
    jax_trainer,
    seeds_of,
    torch_trainer,
)

from map_tpu_torch import validate as V  # noqa: E402

PART = 1e-5  # per-step losses parting by more than this mark the first step to look at
BOUND = 1e-4  # a stage's final eval metric and loss, and each train window's loss


def stage_flags(model: str, stage: str, seed: int, d: str, out: str,
                lockstep: bool = False, overrides: dict = None) -> dict:
    """The stage's flags as `validate.stage_args` sets them, in float32, on
    the data in `d`, the run in `{out}/{stage}`, then `overrides`; a
    finetune reads the newest checkpoint of `{out}/{source}`. `lockstep`:
    every dropout 0, windows of 4 steps."""
    st = V.STAGES[stage]
    flags = {**V.model_flags(model), **st.model, **V.COMMON_TRAIN, **st.train,
             "data_dir": d, "seed": seed, "compute_dtype": "float32",
             "output_dir": os.path.join(out, stage), **(overrides or {})}
    if st.source:
        flags.update(finetune=True, pretrained_model_path=V.newest_checkpoint(
            os.path.join(out, st.source)))
    if lockstep:
        flags.update(attn_probs_dropout_rate=0.0, logging_steps=4)
    return flags


def argv_of(flags: dict) -> list:
    """CLI flags of both packages: a bool only where it is set."""
    return ([f"--{k}={v}" for k, v in flags.items() if not isinstance(v, bool)]
            + [f"--{k}" for k, v in flags.items() if v is True])


def runs(args, d):
    from map_tpu import run as jrun
    from map_tpu_torch import run as trun

    stages = [s.name for s in V.plan([s for s in args.stages.split(",") if s]
                                     or V.model_stages(args.model), model=args.model)]
    for seed in seeds_of(args.seeds):
        with tempfile.TemporaryDirectory() as out:
            for pkg in ("map_tpu", "port"):
                if args.package not in ("both", pkg):
                    continue
                for name in stages:
                    flags = stage_flags(args.model, name, seed, d, os.path.join(out, pkg))
                    if args.one_step_calls:
                        flags.update(steps_per_call=1, device_resident_data="off")
                    if pkg == "map_tpu":
                        jrun.main(argv_of(flags))
                    else:
                        trun.main(argv_of(flags) + ["--device=cpu"])
                    metric, loss = V.stage_result(flags["output_dir"], V.STAGES[name].kind)
                    print(json.dumps({"mode": "runs", "package": pkg, "model": args.model,
                                      "stage": name, "seed": seed, "metric": metric,
                                      "loss": loss, "rows": args.rows}), flush=True)


def bands(args):
    """map_tpu's band a model and stage from `runs` lines, and the port's
    lines against it (the rule of `validate.verdict`)."""
    got = {}
    for path in args.pool.split(","):
        with open(path) as f:
            for line in f:
                if line.startswith('{"mode": "runs"'):
                    r = json.loads(line)
                    got.setdefault((r["package"], r["model"], r["stage"]), {})[r["seed"]] = r
    band = {}
    for (pkg, model, stage), by_seed in sorted(got.items()):
        if pkg != "map_tpu":
            continue
        seeds = sorted(by_seed)
        rows = [V.mean_std([by_seed[s][k] for s in seeds]) + (len(seeds),)
                for k in ("metric", "loss")]
        band.setdefault(model, {})[stage] = tuple(rows)
        print(json.dumps({"band": model, "stage": stage, "seeds": seeds, "metric": rows[0],
                          "loss": rows[1]}), flush=True)
    for (pkg, model, stage), by_seed in sorted(got.items()):
        if pkg != "port" or stage not in band.get(model, {}):
            continue
        vals = [by_seed[s] for s in sorted(by_seed)]
        for ref, key in zip(V.reference_rows(V.STAGES[stage], band[model]), ("metric", "loss")):
            print(json.dumps({"verdict": model, "stage": stage, "what": key,
                              **V.verdict([v[key] for v in vals], *ref)}), flush=True)
    print("MAP_TPU_ZOO_CPU_BAND = " + json.dumps(band))


def carry(jt, tt, only: str = "") -> None:
    """map_tpu's current parameters and batch statistics into the port's
    model; `only`: comma-separated name prefixes, the rest left as the
    port's."""
    import jax

    from map_tpu_torch.interop.from_jax import state_dict_from_jax

    variables = {"params": jax.device_get(jt.state.params)}
    if jt.state.batch_stats:
        variables["batch_stats"] = jax.device_get(jt.state.batch_stats)
    sd = state_dict_from_jax(variables, tt.config)
    if only:
        prefixes = tuple(only.split(","))
        sd = {k: (v if k.startswith(prefixes) else tt.model.state_dict()[k])
              for k, v in sd.items()}
    tt.model.load_state_dict(sd)


def rfd_draws(jt, rng, batch):
    """map_tpu's draws inside `rfd_corrupt` from `rng`
    (map_tpu/objectives/corruption.py, `make_rfd_steps._corrupt`)."""
    import jax
    import torch

    from map_tpu.objectives import corruption as jcorr
    from map_tpu_torch.objectives import corruption

    targs = jt.args
    ids = np.asarray(batch["input_ids"])
    b, f = ids.shape
    mask_num = jcorr.mask_num_of(f, targs.mask_ratio)
    k_idx, _ = jax.random.split(rng)
    if targs.RFD_replace != "Unigram":
        raise ValueError("the lockstep hands in Unigram's draws only")
    masked = jcorr.sample_masked_index(k_idx, b, f, mask_num, targs.sampling_method)
    return corruption.RFDDraws(torch.from_numpy(np.array(masked)), None)


def train_draws(jt, kind):
    """draws(step, batch) -> map_tpu's draws of that train step: the
    corruption key `split(fold_in(step key, step))[0]`
    (map_tpu/train/train_step.py:452-453, 561-563)."""
    import jax

    make = {"mfp": _map_tpu_draws, "rfd": rfd_draws}[kind]

    def draws(step, batch):
        k_corrupt, _ = jax.random.split(jax.random.fold_in(jt._step_rng, step))
        return make(jt, k_corrupt, batch)

    return draws


def eval_draws(jt, tt, kind):
    """map_tpu's eval draws, batch i from fold_in(its eval key, i)
    (map_tpu/train/train_step.py:123-128)."""
    import jax

    make = {"mfp": _map_tpu_draws, "rfd": rfd_draws}[kind]
    return [make(jt, jax.random.fold_in(jt._eval_rng_base, i), b)
            for i, b in enumerate(tt.get_batcher("valid", False).epoch(0))]


def hand_in_train_draws(tt, draws, losses, states=()):
    """Make the port's train steps take `draws(step, batch)` (none where
    `draws` is None: a supervised step) and record each step's loss in
    `losses` (one eager step a call); after step s < len(states), print
    each leaf's largest gap to map_tpu's `states[s]` and how many of its
    elements part by more than 1e-5."""
    from map_tpu_torch.train.graph import MultiStep

    build = tt.build_steps

    def build_steps(n):
        build(n)
        step = tt.train_step
        counter = [0]

        def handed(batch):
            host = {k: v.numpy() for k, v in batch.items()}
            m = step(batch) if draws is None else step(batch, draws(counter[0], host))
            counter[0] += 1
            losses.append(float(m["loss"]))
            if counter[0] <= len(states):
                ref = states[counter[0] - 1]
                gaps = {}
                names = {id(p): n for n, p in tt.model.named_parameters()}
                mus = {names[id(p)]: mu for p, mu in zip(tt.optimizer.params, tt.optimizer.mu)
                       if id(p) in names}
                for name, t in tt.model.state_dict().items():
                    d = (t.detach().double() - ref[name].double()).abs()
                    gaps[name] = [float(d.max()), int((d > PART).sum()), d.numel()]
                    if "_mu" in ref and name in mus and name in ref["_mu"]:
                        # the gradients of step 0 where the parameters part:
                        # their largest |g| against the leaf's, and the
                        # largest relative gap of the leaf's gradients above
                        # 1e-3 of its largest
                        g_ref = ref["_mu"][name].double().abs()
                        g_gap = (mus[name].double() - ref["_mu"][name].double()).abs()
                        top = float(g_ref.max())
                        parted = d > PART
                        big = g_ref > 1e-3 * top
                        gaps[name] += [float(g_ref[parted].max()) / top if parted.any()
                                       else 0.0,
                                       float((g_gap[big] / g_ref[big]).max()) if big.any()
                                       else 0.0]
                print(json.dumps({"mode": "trace", "step": counter[0] - 1,
                                  "leaves": gaps}), flush=True)
            return m

        tt.multi = MultiStep(handed, 1, tt.optimizer, tt.device)

    tt.build_steps = build_steps


def hand_in_eval_draws(jt, tt, kind):
    """Make the port's MFP / RFD evals take map_tpu's eval draws."""
    name = {"mfp": "MFP_pretrain_eval", "rfd": "RFD_pretrain_eval"}[kind]
    own = getattr(tt, name)
    setattr(tt, name, lambda draws=None: own(eval_draws(jt, tt, kind)))


def record_jax_losses(jt, losses, tt=None, states=None, trace: int = 0):
    """Record each of map_tpu's train steps' loss in `losses` and, for its
    first `trace` steps, its parameters after the step (by the port's names,
    carried to `tt`'s config) in `states`."""
    import jax

    from map_tpu_torch.interop.from_jax import state_dict_from_jax

    build = jt._build_steps

    def build_steps(n):
        build(n)
        step = jt._train_step

        def recorded(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if len(losses) <= trace:
                variables = {"params": jax.device_get(state.params)}
                if state.batch_stats:
                    variables["batch_stats"] = jax.device_get(state.batch_stats)
                sd = state_dict_from_jax(variables, tt.config)
                if len(losses) == 1:  # Adam's first moment after step 0: 0.1 g
                    from test_torch_port_train import _jax_moments

                    sd["_mu"] = {k: m for k, (m, _) in _jax_moments(
                        jt._tx, state.opt_state, jt.config).items()}
                states.append(sd)
            return state, m

        jt._train_step = recorded

    jt._build_steps = build_steps


def windows(run_dir: str):
    """The train windows' (step, loss) of a run's metrics.jsonl."""
    out = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["kind"].endswith("_window"):
                key = [k for k in r if k.startswith("window_") and k.endswith("loss")][0]
                out.append((r.get("step"), r[key]))
    return out


def nudged_by_one_ulp(jt) -> None:
    """Make map_tpu's Trainer start from its initial parameters moved one
    float32 ulp up: the yardstick of how far its own rounding carries."""
    import jax

    build = jt._build_steps

    def build_steps(n):
        build(n)
        params = jax.tree.map(lambda x: np.nextafter(np.asarray(x), np.float32(np.inf)),
                              jax.device_get(jt.state.params))
        jt.state = jt.state.replace(params=params)

    jt._build_steps = build_steps


def lockstep_stage(model: str, stage: str, seed: int, d: str, out: str,
                   overrides: dict = None, trace: int = 0, self_ulp: bool = False,
                   own: str = "", carry_only: str = "") -> dict:
    """One stage of `model` through both Trainers in lockstep (see the module
    docstring), `overrides` on its flags (the tests' narrow widths) -> its
    JSON line. `self_ulp`: map_tpu's run once more from its initial
    parameters moved one ulp, its gaps to map_tpu's beside the port's.
    `own`: what the port keeps of its own, to tell apart where two bands
    part: "init" (no carry), "draws" (its own train and eval draws), and
    "port_only" (map_tpu's run skipped: its Trainer gives the init and the
    draws alone). `carry_only`: the prefixes of the leaves map_tpu's
    initial values are carried to (default all)."""
    st = V.STAGES[stage]
    flags = stage_flags(model, stage, seed, d, os.path.join(out, "map_tpu"), lockstep=True,
                        overrides=overrides)
    # map_tpu's batch flags are per device (the tests run 8 virtual ones):
    # the same global batch as the port's one rank
    import jax

    n = jax.device_count()
    jflags = dict(flags, steps_per_call=1, device_resident_data="off",
                  **{k: flags[k] // n for k in ("per_device_train_batch_size",
                                                "per_device_eval_batch_size")})
    jt = jax_trainer(argv_of(jflags))
    os.makedirs(flags["output_dir"], exist_ok=True)
    jt.config.save(flags["output_dir"])  # as map_tpu.run does: a finetune reads it
    tflags = dict(flags, output_dir=os.path.join(out, "port", stage), steps_per_call=1,
                  device_resident_data="off")
    tt = torch_trainer(argv_of(tflags) + ["--device=cpu"])
    restored = tt.finetune_counts
    if "init" not in own:
        carry(jt, tt, carry_only)
    jl, tl, states = [], [], []
    record_jax_losses(jt, jl, tt, states, trace)
    if st.kind != "supervised" and "draws" not in own:
        hand_in_train_draws(tt, train_draws(jt, st.kind), tl, states)
        hand_in_eval_draws(jt, tt, st.kind)
    else:
        own_draws = lambda step, batch: None  # noqa: E731 (the step draws its own)
        hand_in_train_draws(tt, None if st.kind == "supervised" else own_draws, tl, states)
    run = {"supervised": ("train", "test"), "mfp": ("MFP_pretrain",),
           "rfd": ("RFD_pretrain",)}[st.kind]
    for name in run:
        if "port_only" not in own:
            getattr(jt, name)()
        getattr(tt, name)()
    tm, tloss = V.stage_result(tflags["output_dir"], st.kind)
    if "port_only" in own:
        return {"mode": "lockstep", "model": model, "stage": stage, "seed": seed,
                "own": own, "port": [tm, tloss], "losses_port": tl}
    jm, jloss = V.stage_result(flags["output_dir"], st.kind)
    jw, tw = windows(flags["output_dir"]), windows(tflags["output_dir"])
    gaps = np.abs(np.asarray(jl) - np.asarray(tl)) if len(jl) == len(tl) else None
    part = None if gaps is None else next((i for i, g in enumerate(gaps) if g > PART), None)
    wgap = max((abs(a[1] - b[1]) for a, b in zip(jw, tw)), default=0.0)
    ulp = {}
    if self_ulp:
        uflags = dict(jflags, output_dir=flags["output_dir"] + "_ulp")
        ju = jax_trainer(argv_of(uflags))
        ul = []
        record_jax_losses(ju, ul)
        nudged_by_one_ulp(ju)
        for name in run:
            getattr(ju, name)()
        um, uloss = V.stage_result(uflags["output_dir"], st.kind)
        uw = windows(uflags["output_dir"])
        ulp = {"ulp": [um, uloss], "ulp_d_metric": um - jm, "ulp_d_loss": uloss - jloss,
               "ulp_max_step_gap": float(np.abs(np.asarray(ul) - np.asarray(jl)).max()),
               "ulp_max_window_gap": max((abs(a[1] - b[1]) for a, b in zip(jw, uw)),
                                         default=0.0)}
    return {"mode": "lockstep", "model": model, "stage": stage, "seed": seed,
            "steps": [len(jl), len(tl)], "finetune_counts": restored,
            "map_tpu": [jm, jloss], "port": [tm, tloss],
            "d_metric": tm - jm, "d_loss": tloss - jloss,
            "windows_map_tpu": [w[1] for w in jw], "windows_port": [w[1] for w in tw],
            "max_window_gap": wgap, "losses_map_tpu": jl, "losses_port": tl,
            "max_step_gap": None if gaps is None else float(gaps.max()),
            "first_parting_step": part,
            "within": bool(max(abs(tm - jm), abs(tloss - jloss), wgap) <= BOUND), **ulp}


def lockstep(args, d):
    for seed in seeds_of(args.seeds):
        with tempfile.TemporaryDirectory() as out:
            stages = [s for s in args.stages.split(",") if s] or V.model_stages(args.model)
            for stage in V.plan(stages, model=args.model):
                print(json.dumps(lockstep_stage(args.model, stage.name, seed, d, out,
                                                trace=args.trace, self_ulp=args.self_ulp,
                                                own=args.own, carry_only=args.carry_only)),
                      flush=True)


def init(args, d):
    """Each package's initial weights of the model at each seed, with the
    MFP head and with the RFD head, by the port's names."""
    import jax

    from map_tpu_torch.interop.from_jax import state_dict_from_jax

    stats = {}
    for seed in seeds_of(args.seeds):
        for stage in V.model_stages(args.model)[:3]:
            with tempfile.TemporaryDirectory() as out:
                flags = stage_flags(args.model, stage, seed, d, out)
                jt = jax_trainer(argv_of(flags))
                tt = torch_trainer(argv_of(flags) + ["--device=cpu"])
                variables = {"params": jax.device_get(jt.state.params)}
                if jt.state.batch_stats:
                    variables["batch_stats"] = jax.device_get(jt.state.batch_stats)
                ref = state_dict_from_jax(variables, tt.config)
                for name, t in tt.model.state_dict().items():
                    for pkg, x in (("port", t), ("map_tpu", ref[name])):
                        x = x.double().reshape(-1)
                        acc = stats.setdefault(f"{stage}:{name}", {}).setdefault(
                            pkg, [0, 0.0, 0.0, np.inf, -np.inf])
                        acc[0] += x.numel()
                        acc[1] += float(x.sum())
                        acc[2] += float((x * x).sum())
                        acc[3] = min(acc[3], float(x.min()))
                        acc[4] = max(acc[4], float(x.max()))
    for name, by in stats.items():
        row = {"mode": "init", "model": args.model, "leaf": name}
        for pkg, (n, s1, s2, lo, hi) in by.items():
            mean = s1 / n
            row[pkg] = {"n": n, "mean": mean, "std": math.sqrt(max(s2 / n - mean * mean, 0.0)),
                        "min": lo, "max": hi}
        print(json.dumps(row), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("runs", "bands", "lockstep", "init"))
    p.add_argument("--model", default="dcnv2", choices=V.MODELS)
    p.add_argument("--stages", default="", help="`runs`, `lockstep`: default the model's stages")
    p.add_argument("--seeds", default="42-45")
    p.add_argument("--rows", type=int, default=V.ZOO_ROWS)
    p.add_argument("--data_root", default=os.path.join(tempfile.gettempdir(), "zoo_probe"))
    p.add_argument("--package", choices=("both", "port", "map_tpu"), default="both",
                   help="`runs`: which package's CLI runs (the two sides as separate jobs)")
    p.add_argument("--pool", default="", help="`bands`: comma-separated files of `runs` lines")
    p.add_argument("--one_step_calls", action="store_true",
                   help="`runs`: one step a call from host batches (the same math; map_tpu's "
                   "FGCNN evals in groups of 8 crawl on the CPU)")
    p.add_argument("--self_ulp", action="store_true",
                   help="`lockstep`: map_tpu again from its init moved one ulp, as a yardstick")
    p.add_argument("--own", default="", help="`lockstep`: what the port keeps of its own, "
                   "comma-separated: init, draws, port_only (map_tpu's run skipped)")
    p.add_argument("--carry_only", default="", help="`lockstep`: carry map_tpu's initial "
                   "values to the leaves of these comma-separated name prefixes only")
    p.add_argument("--trace", type=int, default=0,
                   help="`lockstep`: each leaf's gap to map_tpu's after each of the first N steps")
    args = p.parse_args()
    if args.mode == "bands":
        bands(args)
        return 0
    d = data_dir(args.data_root, args.rows)
    {"runs": runs, "lockstep": lockstep, "init": init}[args.mode](args, d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
