#!/usr/bin/env python3
"""Smoke run of map_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0] [--rows 200000] [--batch 10000]

Drives the port only (no JAX, nothing of map_tpu), in phases, one JSON line
each; any failure ends the run with a nonzero exit code.

1. device: the card's name and, as nvidia-smi prints them, name and power limit;
2. build: the CUDA kernels from map_tpu_torch/csrc, timed;
3. K4 (embedding gather) against its plain version at the serving shape:
   a 1,013,519 x 16 f32 table, 10000 x 24 field-blocked ids; exact, f32 and
   bf16 out;
4. K2 (cross net) against its plain version: (10000, 384) x 3 layers in f32
   and bf16, (10000, 624) in f32, and once with the residuals X_l, U_l;
5. serving: DCNv2 at full width (embed 16, 24 fields, MLP 3 x 1000, 3 cross
   layers) from --seed, saved with save_model and scored by Predictor over
   --rows field-blocked rows in bf16 and in f32, three timed passes each;
   logits held against the same weights run through the plain versions on
   the card; both launch counts must have moved; then one bf16 pass under
   torch.profiler: device-busy time, idle share and the costliest kernels;
6. times: median ms of each kernel (CUDA events, L2 flushed before each
   launch), its bound on an H100 SXM, its plain version and one-call
   library yardstick;
7. the `kernels` line, nvidia-smi's line, and last
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Exits 2 without a result when there is no CUDA device or the map_tpu_torch
sources are not beside this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# bench.py's 5-core-Avazu-shaped field cardinalities: 24 fields, 1,013,519 ids
# with the 10 reserved ones
FIELD_SIZES = [7, 7, 24, 26, 4100, 7600, 26, 8500, 560, 36, 8200, 5, 4, 2600,
               8, 450, 70, 170, 60, 101_000, 380_000, 500_000, 30, 26]
NUM_RESERVED = 10
EMBED = 16

# H100 SXM published peaks (NVIDIA data sheet), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# tolerances: |kernel - plain| <= atol + rtol * |plain|
TOL_CROSS = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
TOL_LOGITS = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}

SERVING_PASSES = 3  # timed passes over --rows per dtype; rows_per_s is the best


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def field_blocks():
    lo = np.cumsum([NUM_RESERVED] + FIELD_SIZES[:-1]).astype(np.int64)
    return lo, lo + np.asarray(FIELD_SIZES, np.int64), int(NUM_RESERVED + sum(FIELD_SIZES))


def draw_ids(rng: np.random.Generator, rows: int) -> np.ndarray:
    lo, hi, _ = field_blocks()
    return np.stack([rng.integers(a, b, rows) for a, b in zip(lo, hi)],
                    axis=1).astype(np.int32)


def compare(name: str, got, ref, atol: float, rtol: float) -> float:
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    max_err = float(err.max())
    ok = bool(err.le(atol + rtol * ref.abs()).all()) and bool(got.isfinite().all())
    emit("check", name=name, max_abs_err=max_err, atol=atol, rtol=rtol, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {max_err})")
    return max_err


def time_ms(fn, reps: int = 20) -> float:
    """Median ms of one call, CUDA events around each call, the 50 MB L2
    flushed before each."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=10_000)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "map_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: map_tpu_torch sources not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch.nn.functional as F

    from map_tpu_torch import models
    from map_tpu_torch.config import Config
    from map_tpu_torch.kernels import build
    from map_tpu_torch.nn import init
    from map_tpu_torch.ops import cross, embedding
    from map_tpu_torch.serve import Predictor
    from map_tpu_torch.train import checkpoints

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smi_line()

    # 1. device
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    build_s = build.timed_build()
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, library=str(build.library_path().name),
         ptxas=ptxas)
    build.library()

    # 3. K4 vs plain at the serving shape
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    lo, hi, vocab = field_blocks()
    table_cpu = torch.empty(vocab, EMBED)
    init.embedding_(table_cpu, len(FIELD_SIZES), EMBED, gen)
    table = table_cpu.to(dev)
    ids = torch.from_numpy(draw_ids(rng, args.batch)).to(dev)
    with torch.inference_mode():
        emb_f32 = embedding.embedding_lookup(table, ids)
        emb_bf16 = embedding.embedding_lookup(table, ids, torch.bfloat16)
        torch.cuda.synchronize()
        k4_err = compare("K4 f32 out, table 1013519x16, ids 10000x24", emb_f32,
                         embedding.embedding_lookup_plain(table, ids), 0.0, 0.0)
        compare("K4 bf16 out", emb_bf16,
                embedding.embedding_lookup_plain(table, ids, torch.bfloat16), 0.0, 0.0)

        # 4. K2 vs plain
        def cross_inputs(d, dtype, x0=None):
            w = torch.empty(3, d, d)
            b = torch.empty(3, d)
            for layer in range(3):
                init.linear_(w[layer], b[layer], gen)
            if x0 is None:
                x0 = torch.randn(args.batch, d, generator=gen) * (2.0 / 40) ** 0.5
            return (x0.to(dev, dtype).contiguous(), w.to(dev, dtype),
                    b.to(dev, dtype))

        x384 = emb_f32.reshape(args.batch, -1)
        k2_inputs = {}
        k2_err = {}
        for dtype, dname in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
            k2_inputs[dname] = cross_inputs(384, dtype, x384)
            got = cross.cross_net(*k2_inputs[dname])
            torch.cuda.synchronize()
            k2_err[dname] = compare(f"K2 {dname} (10000, 384) L=3", got,
                                    cross.cross_net_plain(*k2_inputs[dname]),
                                    *TOL_CROSS[dname])
        k2_inputs["ragged"] = cross_inputs(624, torch.float32)
        got = cross.cross_net(*k2_inputs["ragged"])
        torch.cuda.synchronize()
        compare("K2 float32 (10000, 624) L=3, ragged D", got,
                cross.cross_net_plain(*k2_inputs["ragged"]), *TOL_CROSS["float32"])
        got = cross.cross_net(*k2_inputs["bfloat16"], save_residuals=True)
        ref = cross.cross_net_plain(*k2_inputs["bfloat16"], save_residuals=True)
        torch.cuda.synchronize()
        for part, g, r in zip(("Y", "X_l", "U_l"), got, ref):
            compare(f"K2 bfloat16 save_residuals {part}", g, r, *TOL_CROSS["bfloat16"])

    # 5. serving through Predictor
    cfg = Config(model_name="dcnv2", input_size=vocab, num_fields=len(FIELD_SIZES),
                 embed_size=EMBED, hidden_size=1000, num_hidden_layers=3,
                 hidden_act="relu", num_cross_layers=3,
                 idx_low=[int(x) for x in lo], idx_high=[int(x) for x in hi])
    model = models.from_config(cfg, torch.Generator().manual_seed(args.seed))
    score_ids = draw_ids(rng, args.rows)
    launches = {}
    serving = {}
    with tempfile.TemporaryDirectory() as model_dir:
        checkpoints.save_model(model.state_dict(), model_dir, 1)
        embedding.launches = cross.launches = 0
        for dname in ("bfloat16", "float32"):
            cfg_d = dataclasses.replace(cfg, compute_dtype=dname)
            with open(os.path.join(model_dir, "config.json"), "w") as f:
                json.dump({k: v for k, v in dataclasses.asdict(cfg_d).items()
                           if k != "extra"}, f)
            pred = Predictor(model_dir, 1, batch_size=args.batch)
            pred.predict_logits(score_ids[:args.batch])  # warm-up: one chunk
            seconds = []
            for _ in range(SERVING_PASSES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = pred.predict_logits(score_ids)
                seconds.append(time.perf_counter() - t0)
            serving[dname] = (pred, logits, seconds)
        launches = {"embedding_gather": embedding.launches,
                    "cross_net": cross.launches}
    # both dtypes, the warm-up chunk and every timed pass
    expected = 2 * (1 + SERVING_PASSES * -(-args.rows // args.batch))
    emit("serving_launches", launches=launches, expected_each=expected)
    for name, count in launches.items():
        if count != expected:
            raise AssertionError(f"{name} launched {count} times on the serving "
                                 f"path, expected {expected}")

    def plain_forward(m, ids_t):
        """The Predictor's DCNv2 with both kernels swapped for their plain versions."""
        emb = embedding.embedding_lookup_plain(m.embed.embedding.weight, ids_t,
                                               m.embed.dtype)
        x = emb.reshape(ids_t.shape[0], -1)
        cn = m.cross_net
        dt = cn.dtype or x.dtype
        w = torch.stack([layer.weight for layer in cn.cross_layers]).to(dt)
        b = torch.stack([layer.bias for layer in cn.cross_layers]).to(dt)
        out = torch.cat([cross.cross_net_plain(x.to(dt), w, b),
                         m.parallel_dnn(x)], dim=-1)
        return m.fc_out(out).reshape(-1).float()

    for dname, (pred, logits, seconds) in serving.items():
        with torch.inference_mode():
            ref = torch.cat([
                plain_forward(pred.model, torch.from_numpy(
                    score_ids[i:i + args.batch]).to(dev))
                for i in range(0, args.rows, args.batch)]).cpu()
        got = torch.from_numpy(logits)
        if got.shape != (args.rows,):
            raise AssertionError(f"logits shape {tuple(got.shape)}")
        err = compare(f"serving logits {dname}, {args.rows} rows", got, ref,
                      *TOL_LOGITS[dname])
        best = min(seconds)
        emit("serving", compute_dtype=dname, rows=args.rows, batch=args.batch,
             seconds=seconds, rows_per_s=args.rows / best, max_abs_err=err,
             logit_mean=float(got.mean()), logit_std=float(got.std()))

    # 5b. where one bf16 serving pass spends its time on the card
    pred = serving["bfloat16"][0]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pred.predict_logits(score_ids)
        wall_us = (time.perf_counter() - t0) * 1e6
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_card)
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:8]
    emit("serving_profile", compute_dtype="bfloat16", rows=args.rows,
         wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
         idle_share=1.0 - busy_us / wall_us,
         top=[dict(name=e.key[:80], calls=e.count,
                   device_ms=e.self_device_time_total / 1e3) for e in top])

    # 6. times at the serving shapes
    n_ids = ids.numel()
    unique_rows = int(torch.unique(ids).numel())
    k4_bytes = n_ids * 4 + unique_rows * EMBED * 4 + n_ids * EMBED * 4
    times = {}
    with torch.inference_mode():
        ids_long = ids.long()
        times["K4 f32"] = dict(
            ms=time_ms(lambda: embedding.embedding_lookup(table, ids)),
            plain_ms=time_ms(lambda: embedding.embedding_lookup_plain(table, ids)),
            library_ms=time_ms(lambda: F.embedding(ids_long, table)),
            bound_ms=k4_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        k4_bf16_bytes = k4_bytes - n_ids * EMBED * 2
        times["K4 bf16 out"] = dict(
            ms=time_ms(lambda: embedding.embedding_lookup(table, ids, torch.bfloat16)),
            plain_ms=time_ms(lambda: embedding.embedding_lookup_plain(
                table, ids, torch.bfloat16)),
            library_ms=None,
            bound_ms=k4_bf16_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")

        def library_cross(x0, w, b):
            xi = x0
            for layer in range(w.shape[0]):
                xi = xi + x0 * torch.addmm(b[layer], xi, w[layer].t())
            return xi

        for key, inputs in (("K2 bf16", k2_inputs["bfloat16"]),
                            ("K2 f32", k2_inputs["float32"]),
                            ("K2 f32 D=624", k2_inputs["ragged"])):
            x0, w, b = inputs
            bsz, d = x0.shape
            num_layers = w.shape[0]
            dname = "bfloat16" if x0.dtype == torch.bfloat16 else "float32"
            flops = 2 * num_layers * bsz * d * d
            nbytes = (2 * bsz * d + num_layers * d * d + num_layers * d) * x0.element_size()
            op_ms = flops / PEAK_FLOPS[dname] * 1e3
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            times[key] = dict(
                ms=time_ms(lambda: cross.cross_net(x0, w, b)),
                plain_ms=time_ms(lambda: cross.cross_net_plain(x0, w, b)),
                library_ms=time_ms(lambda: library_cross(x0, w, b)),
                bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                gflops=flops / 1e9)
    emit("times", card=smi, unique_rows=unique_rows, kernels=times)

    # 7. summary
    src = "map_tpu_torch/csrc"
    kernels = [
        dict(name="embedding_gather", route="cuda",
             source=f"{src}/embedding_gather.cu",
             replaces="map_tpu/ops/pallas_embedding.py:55",
             launches=launches["embedding_gather"], max_abs_err=k4_err,
             **times["K4 f32"]),
        dict(name="cross_net", route="cuda", source=f"{src}/cross_net.cu",
             replaces="map_tpu/ops/pallas_cross.py:98",
             launches=launches["cross_net"], max_abs_err=k2_err["bfloat16"],
             **{k: v for k, v in times["K2 bf16"].items() if k != "gflops"}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
