#!/usr/bin/env python3
"""Smoke run of map_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed 0] [--rows 200000] [--batch 10000]
                          [--train_steps 55]

Drives the port only (no JAX, nothing of map_tpu), in phases, one JSON line
each; any failure ends the run with a nonzero exit code.

1. device: the card's name and, as nvidia-smi prints them, name and power limit;
2. build: the CUDA kernels from map_tpu_torch/csrc, timed;
3. K4 (embedding gather) against its plain version at the serving shape:
   a 1,013,519 x 16 f32 table, 10000 x 24 field-blocked ids; exact, f32 and
   bf16 out;
4. K2 (cross net) against its plain version: (10000, 384) x 3 layers in f32
   and bf16, (10000, 624) in both, and once with the residuals X_l, U_l; the
   training call (4096, 384) with the residuals in both, the same bits twice;
   then K2's backward under autograd at the training shape against the plain
   chain (plain forward's residuals + the same backward);
5. K1 (AdamW update) against its plain version on the 1,013,519 x 16 table
   and a (1000, 384) leaf; K3 (gradient scatter-add) against `index_add_`
   onto zeros at the training shape (4096 x 24 ids), bf16 and f32 gradients;
   (after phase 7's bf16 run) K1's list launch over one real training
   step's leaves (the model's parameters, moments and gradients, both wd
   values) against the plain version, bit for bit, leaf by leaf;
5b. K6 (field-block kernels of the hybrid lookup) against their plain
   versions: K6b (the 21 small fields' gradient tiles, 32,509 ids in 65
   512-row tiles, the last one running past the table) at the training
   shape, bf16 and f32 gradients, exact and the same bits twice; the
   `bwd_pallas` dense gradient (K3 on the big fields, K6b on the small ones)
   against the flat K3 one on the same ids and cotangent, the small fields'
   rows bit-equal; K6a (their rows) at the serving shape, exact;
6. serving: DCNv2 at full width (embed 16, 24 fields, MLP 3 x 1000, 3 cross
   layers) from --seed, saved with save_model and scored by the pipelined
   Predictor (byte-packed ids, a captured forward, the producer, device and
   drainer stages) over --rows field-blocked rows in bf16 and in f32, three timed
   passes each; logits held against the plain versions on the card and
   bit-equal to an eager forward of the same padded chunks; K4 and K2
   launch counts checked (a replay counted as its capture's launches);
   one pass in each dtype under torch.profiler (rows/s, idle share);
7. training, in bf16 and in f32: the port's Trainer on an in-memory 24-field
   dataset drawn from --seed, labels from a fixed random teacher on the ids,
   batch 4096, lr 1e-3 const, wd 0.1 (run_script/run_DCNv2_scratch.sh), one
   epoch of --train_steps steps, eval, best-step checkpoint and test. Checks:
   loss finite and falling, eval AUC > 0.6, the launches of K1-K4 equal to
   what the step and batch counts give (K1: one a step, all dense
   parameters in one launch), the best checkpoint scored by
   Predictor to the Trainer's test AUC. Then 5 steps from the same weights
   through the kernels and through the plain versions on the card, losses
   and parameters compared; step time and examples/s; a few steps under
   torch.profiler;
7b. RFD pretraining (run_script/run_DCNv2_RFD.sh: Unigram, mask ratio 0.3,
   randint, proj 32, lr 1e-3 cosine, wd 5e-2) in bf16 under the K6b
   backward (`--hybrid_mode=bwd_pallas`) through the Trainer: one epoch of
   --train_steps steps and one eval. Checks: window loss finite and falling,
   eval accuracy at least 1 - eval pos_ratio - 0.01, the launches (K6b and
   K3 once a step, K3 on the big fields only). Then 5 steps through the
   kernels against the plain versions in bf16 and f32; 5 f32 steps under
   bwd_pallas against 5 under fwd from the same weights and draws,
   bit-equal; the step time and a profile in both modes; and the finetune
   of phase 9 from its checkpoint;
8. MFP pretraining in bf16 (run_script/run_DCNv2_MFP.sh: mask ratio 0.3,
   randint, 25 negatives, proj 32, lr 1e-3 cosine, wd 5e-2) through the
   Trainer on the same train split, whose unigram is the noise: one epoch of
   --train_steps steps and one masked eval. Checks: window loss finite and
   falling, eval accuracy above chance 1/(1+k), the launches of K1-K5 and
   K8 equal to what the step and batch counts give; the distinct candidate
   ids of every step beside the capacity. K5 (sorted-unique scatter)
   against its plain version on one step's folded candidate stream, both
   modes, exact and deterministic. Then 5 MFP steps from the same weights
   and draws through the kernels and through the plain versions, in bf16
   and f32; the step time and a few steps under torch.profiler, with K3's
   rows and share under map_tpu's MFP default, the `matmul` hybrid backward
   (every MFP phase runs it). Then the three backward modes of the table
   gradient, one function: 5 f32 steps under `bwd_pallas` (K3 + K6b)
   against 5 under `matmul` from the same weights and draws, and the bf16
   step (20 timed, 5 profiled) under `matmul`, `fwd` and `bwd_pallas`;
8b. MFP with per-field shared noise at k = 100 and the sparse table update
   (bench_pretrain.py's fast configuration; otherwise as phase 8), through
   the Trainer in bf16: one epoch, one masked eval. Checks: window loss
   finite and falling, eval accuracy above 1/(1+k), the launches of every
   kernel, K7 (sparse-stream decoder AdamW) and K8 (block scan) included.
   K7 against its plain version on one step's real streams (exact, the same
   bits twice); K8 against its plain version and a float64 scan on the
   per-position fold's (745,472, 33) stream and this path's target fold
   (28,672, 33) and noise fold, and a random (2,236,417, 33) input of many
   rounds, each also bit-equal to the kernel's association computed in
   PyTorch ops (`scan.block_cumsum_order`); 5 f32 steps with K7 against 5 on the dense
   route (K5 + K1 on the decoder emb), bit-equal; 5 steps through the
   kernels against the plain versions in bf16 and f32; step time and a few
   steps under torch.profiler;
8c. the other noise modes, 5 steps each through the kernels against the
   plain versions in bf16: global shared noise (k = 25, sparse update),
   per-field per-position noise (k = 25) and the `full` loss (batch 64);
8d. the two paths of each training cell (supervised bf16 and f32, RFD
   under bwd_pallas and fwd, MFP per-position under matmul, fwd and
   bwd_pallas, per-field shared k = 100 with the sparse update; phase
   `path_time`): today's path (steps_per_call=1, device_resident_data=off:
   a host batch copied a step, a step a host call) and the new default (the
   train data on the card, the prefetch thread, steps_per_call=8 as
   captured CUDA graphs), a Trainer each from the same weights on the same
   batches: the parameters and buffers after 16 steps (two calls of the
   graph path) bit-equal across the paths (MFP on a pair drawing masked positions
   without repeats, 'normal', since the masked-position gather's backward
   adds through atomics), then an epoch timed (wall ms a step, the graph
   path's host us a step), an epoch profiled (busy ms a step, idle share,
   host ms a step by family of CPU event), the launches each path ran
   (equal), the bytes copied to the card a step; K1's launch plan and
   descriptor block, host us a step (`k1_plan_host`). The `*_profile`
   phases also give the host ms a step by family. The Trainer runs of 7-9
   take the new default: their launch checks count a graph's replay as
   its captured launches, the eval passes' graphs too
   (`Trainer.launches_run`);
9. finetune: supervised DCNv2 from the RFD checkpoint (run_DCNv2_finetune.sh's
   default) and from the MFP one (13 tensors loaded, 4 skipped each), one
   epoch, eval AUC > 0.6, launches checked;
9b. the rest of the zoo (`zoo_phase`): LR, FM, DNN, DeepFM, xDeepFM (CIN
   50,50), AutoInt (2 layers of 40, 1 head, attention dropout 0.1), the
   Transformer (hidden = embed = 16, 3 layers, 2 heads, FFN 128, `attn,fc`),
   FiGNN (3 GNN rounds) and FGCNN (channels 14,16,18,20, kernels 7, pools 2,
   recombined 3, tanh, its own fg_embed table, BatchNorm) at map_tpu's
   defaults on the widths above (MLP 3 x 1000), each: 5 supervised steps
   through the kernels against the plain versions in bf16 and f32 (K1,
   K3, K4; LR's (V, 1) table through K4 and K3 at E = 1; FGCNN's two
   tables twice a step; FGCNN's running statistics held beside the
   parameters); for the seven pretrain-capable ones 5 MFP per-position
   steps the same way and the finetune restore's counts from an MFP
   checkpoint (FGCNN's running statistics restored) and 5 RFD steps under
   bwd_pallas (K6b a field-blocked table a step: DeepFM's LR table goes
   through K3 whole); its supervised
   bf16 cell on both paths (`path_time`, the 16-step bit check over
   parameters and buffers, the launches counted from 0 before it);
   `Predictor` rows/s at batch 10000 in bf16 (FGCNN from its running
   statistics), the first chunk's logits against the plain versions', the
   pipelined Predictor's logits in bf16 and f32 bit-equal to an eager
   forward of the same chunks; FGCNN trained an epoch on the graph path and
   its state_dict carried to map_tpu's tree (`interop/to_jax.py`, packed and
   plain tables) and back, bit-equal (the bf16 DCNv2 training run's weights
   too, in phase 7);
10. times: median ms of each kernel (CUDA events, L2 flushed and a spin of
   about 1 ms queued on the card before each launch, so that the card, not
   the host's launch pace, sets the time), its bound on an H100 SXM, its
   plain version and one-call library yardstick; K4 at every shape the main
   path launches it (serving in f32 and bf16, the training input, the MFP
   per-position candidates, per-field shared targets and noise, LR's
   (V, 1) table; the phases' own ids), each bit-equal to its plain version
   twice, beside
   F.embedding and `copy_` of its output, with its launches by shape in each
   training run (checked against the run's count) and its wrapper's host
   time a call; K2 at (10000, 384) and
   (10000, 624) in both dtypes and at the training call with the residuals,
   timed in turns with the chain of 9 PyTorch calls (addmm, multiply, add a
   layer) and its 3 products alone (`products_ms`), the kernel and the chain
   once more with no spin (`*_no_spin`), with its launch plan; K3 also with uniform ids and on
   the MFP step's corrupted ids, each K3 row with its stable sort and its kernel timed
   apart as well, its longest segment, and its result bit-equal to the
   plain version's; K7 beside
   two yardsticks (index_add_ x 2 + torch._fused_adamw_, and the dense
   route K5 x 2 + K1), K1 over a training step's leaves beside the two
   torch._fused_adamw_ calls of the decay and the no-decay group, K8 beside
   torch.cumsum over dim 0, K6b beside
   index_add_ onto a zero tile stack and its order floor (the longest row's
   chain of adds at 4 cycles each), also with one row hit by a whole field
   (bit-equal to its plain version), K6a beside F.embedding and a mask (and
   its plan's rows of b a block); the
   MFP step's matmul backward in its parts;
10b. same-data validation (`validation_phase`): synthazu in memory (400,000
   rows from data seed 7, 101,178 ids, 24 fields), the five stages of
   validation/run_tpu.sh at seed 42 through `map_tpu_torch.validate`
   (scratch, MFP 3 epochs, RFD 3 epochs, the finetunes from the newest MFP
   and RFD checkpoints; bf16, the graph path): each stage's metric and loss
   beside map_tpu's mean, failing only outside twice the single-run band
   2 sqrt(s² + s²/n) + eps (s map_tpu's std); each stage's launches, from 0
   before it; the finetune counts (13, 4); 5 steps of each stage's mode on
   this data (supervised, MFP under `matmul` and `bwd_pallas`, K6b among
   its kernels, RFD) through the kernels against the plain versions;
10b'. the zoo's validation (`zoo_validation_phase`): synthazu in memory
   (120,000 rows from data seed 7), each of the nine other models' stages
   (`validate.model_stages`: the five, or `scratch` alone for LR and FM) at
   seed 42 at `validate.ZOO_KNOBS`' widths through `validate.run_stage`
   (bf16, the graph path): each stage's metric and loss beside map_tpu's
   mean rerun on the CPU (`validate.MAP_TPU_ZOO_CPU_BAND`, seeds 42-45 or
   more where a pair was taken further),
   failing only outside twice the single-run band; each stage's launches,
   from 0 before it: K1 once a step, K4 at least once a batch (twice in
   MFP: the decoder's candidates), K2 never, K5 and K8 once an MFP step;
   the finetunes' counts (4 skipped: the pretraining head); the phase's
   seconds;
10c. resume (`resume_phase`), on the graph path in bf16, supervised DCNv2
   and MFP per-position (the stages' flags, 2 epochs; MFP's positions
   'randint'): for MFP two straight runs from one seed, parameters,
   moments, generator states and eval metrics bit-equal; a straight run,
   and a run stopped after its first epoch with save_steps 20 (async
   checkpoints; MFP's fetched from a snapshot on the card) resumed with
   --resume: parameters, buffers, moments, count and generator states
   bit-equal;
10d. the streaming eval (`streaming_phase`): `--streaming_auc` on the
   scratch stage's weights against the exact eval, within its error bound;
   metrics.jsonl's seven kinds among the runs; a `--profile_steps 2` run's
   trace, with the card's kernels in it;
10e. the eval dispatch (`grouped_eval_phase`): the validation stages'
   weights at DCNv2's full width, eval batch 10000 over 85,000 synthazu
   rows (a group of 8 and a padded tail), bf16 and f32, the exact
   supervised eval, the streaming one, MFP ('randint') and RFD: graphs of
   8 (steps_per_call 8) against eager passes (1), every pass's metrics
   bit-equal; eval rows/s in turns and host us a batch with the card idle;
   the launches the graphs ran; MFP and RFD also with their draws made
   outside and handed in, bit-equal;
10f. the alias draws against q (`chi_square_phase`): 10^7 draws of the
   global and of the per-field draw on synthazu's unigram, chi-square p
   above 1e-3, each draw's log q the table's;
10g. the parallel layer (`parallel_phase`, after 10f): (a) one rank under
   NCCL on a 1 x 1 mesh, supervised bf16 DCNv2 at full width, 16 steps on
   the graph path (the loss's global count, the metrics and the flat
   gradient all_reduce captured in the graphs of 8 steps) and its eval,
   bit-equal to the run without a process group; (b) two ranks sharing the
   card under gloo (this script with --parallel_rank, spawned after the
   kernels are built): data-parallel 2 x 1 supervised (the plain lookup,
   and the hybrid one under `bwd_pallas`, K6b under the gradient
   all_reduce), row-sharded 1 x 2 under psum (supervised, MFP per-position
   k = 25, RFD Unigram) and under hotcold (supervised), each in f32 and
   bf16, 8 eager steps of the same global batches as one rank: the
   row-sharded runs in f32 within 1e-5 of one rank (loss and every
   parameter); the data-parallel runs in f32 bit-equal to the same steps in
   one process with each gradient summed over the batch's two row blocks
   (`dp_witness`: that loop reproduces the one-rank run bit for bit at one
   block, and its first two-block gradient lies within 1e-4 of each leaf's
   largest one-rank gradient), their first loss within 1e-5 of one rank,
   every loss within 1e-4 and the eval AUC within 2e-5, the parameters'
   distance to one rank recorded by leaf and by step; bf16's band
   recorded; the ranks' bits equal; hotcold's overflow 0 with each rank's
   cold segment; the (1, 2) mesh's checkpoint equal to one rank's; the
   `full` MFP loss row-sharded 1 x 2 under psum (`parallel/vocab_ce.py`)
   on synthazu's V = 101,178 at batch 4096 in f32, 8 eager steps and an
   eval: every loss and the eval loss within 1e-5 of one rank, the eval
   accuracy within 1e-3, the first step's gradient within 1e-4 of each
   leaf's largest one-rank gradient, the parameters' distance after the
   first step and after the eighth recorded (AdamW amplifies the input
   gradient's rounding, a sum of two blocks' parts), K4, K3 and K1 on
   every step of each rank, each rank's peak memory (`parallel_full`); each
   rank's launches; and the data-parallel f32 run once more from the
   memmap mode, both ranks materializing the phase's data into one empty
   directory at once (one writes, the other waits), bit-equal to the run
   in RAM (`parallel_memmap`);
10h. the >RAM memmap mode and the native batch gather (`memmap_phase`):
   the supervised data of phase 7 written through the memmap writer core
   from memory (chunks of 40,000 rows scattered over the three splits) and
   opened by CTRDataset under a 1 MB host budget; supervised bf16 and MFP
   per-position k = 25 at full width, resident data `auto` (uploaded from
   the memmap) and `off` (every batch gathered by the native gather from
   the memmap): 16 graph-path steps, 32 more timed, then an eval, bit-equal
   to the in-RAM run from the same weights; every host gather of those
   runs by the native gather; K4, K3, K1, K2 (K5, K8) launched; host ms to
   gather a batch of 4096 x 24 and a group of 8, native against np.take,
   from RAM and the warm memmap; the alias table by the host library
   against the loop at V = 1,013,519;
10i. the layers no model calls (`layers_phase`: `nn/extras.py` and the five
   of `nn/layers.py`) at 24 fields, embed 16, batch 4096: forward and
   backward in f32 on the card and on the CPU against the same module in
   f64 on the CPU, the card's error within 8 times the CPU's f32 error
   plus 1e-5 of the largest value;
10j. the preprocessing CLIs' modules import without pandas, h5py and
   sklearn, and the legacy StratifiedKFold gives map_tpu's pin
   (`preprocess_phase`);
11. the `kernels` line (launches from the RFD run of 7b for K1-K4 and K6,
   from the per-field shared run of 8b for K5, K7 and K8, plus each zoo
   model's graph path, the validation's five stages, the grouped eval
   phase, the serving phase, the parallel phase's runs and the memmap
   phase's;
   `launches_by_path` gives each), nvidia-smi's line, and last
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Exits 2 without a result when there is no CUDA device or the map_tpu_torch
sources are not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

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
# K1 rounds after every operation in the plain version's order: bit-equal
# expected, held to one float32 ulp
TOL_ADAMW = (1e-9, 1e-6)

SERVING_PASSES = 3  # timed passes over --rows per dtype; rows_per_s is the best

# training: run_script/run_DCNv2_scratch.sh
TRAIN_BATCH = 4096
EVAL_BATCH = 10_000
EVAL_ROWS = 20_000  # valid and test each
LR, WEIGHT_DECAY = 1e-3, 0.1
PARITY_STEPS = 5
# the 5-step comparison, kernels vs plain versions on the card, from the same
# weights: losses within a relative tolerance; a parameter moves at most
# about lr per Adam step, so the two runs' parameters differ by at most
# 2 lr k anywhere; and the two runs' updates p_k - p_0 differ, summed over all
# parameters, by at most a share of the updates' own L1 norm. The two do
# not differ elementwise by rounding alone: where a gradient is within
# rounding of 0, Adam's step lr * g / |g| may flip its sign, so a share of
# the elements (0.6 % in f32, 10 % in bf16 on an H100, seed 0) differ by more
# than 1e-5; the L1 share counts how much.
TOL_PARITY_LOSS = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_PARITY_UPDATE_L1 = {"float32": 1e-2, "bfloat16": 0.25}

# MFP pretraining: run_script/run_DCNv2_MFP.sh
MFP_LR, MFP_WD = 1e-3, 5e-2
MFP_MASK_RATIO, MFP_NEG, MFP_PROJ = 0.3, 25, 32
MAP_TPU_CAPACITY = 1 << 17  # map_tpu's static decoder capacity (dedup_scatter.py:161)
# per-field shared noise, bench_pretrain.py:123,142-143 (validation/README.md)
PFS_NEG = 100
FULL_BATCH = 64  # the full loss's (B, M, V) scores: 116 GB at batch 4096
# K8 against a float64 scan: within this share of the largest prefix of |x|
TOL_SCAN = 1e-6


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


def check(name: str, ok: bool, **fields) -> None:
    emit("check", name=name, ok=bool(ok), **fields)
    if not ok:
        raise AssertionError(f"{name} failed: {fields}")


# Cycles of the spin queued ahead of each timed call: about 1 ms at the
# H100's 1.98 GHz, longer than the host takes to queue a chain of calls
SPIN_CYCLES = 2_000_000


def time_ms_each(fns: dict, reps: int = 20, spin: bool = True) -> dict:
    """Median ms of one call of each fn, CUDA events around each call, the
    50 MB L2 flushed before each. The fns take turns rep by rep, so a drift
    of the card's clock or of the host touches them alike. With `spin`, a
    spin on the card is queued ahead of the start event, so the host has
    queued the whole call before the card reaches it: a chain of calls is
    timed by the card, not by the pace of the host's launches."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for fn in fns.values():
        for _ in range(3):
            fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            flush.zero_()
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: float(np.median(t)) for name, t in times.items()}


def time_ms(fn, reps: int = 20) -> float:
    """time_ms_each of one fn."""
    return time_ms_each({"fn": fn}, reps)["fn"]


# The host's time by family of profiled CPU event (self time, every thread):
# the CUDA runtime's launches (a graph's replay is one), its copies and the
# pinned staging of the H2D path, waits, the dtype casts' dispatch, autograd's
# nodes, and every other ATen op's dispatch; what no event covers (Python,
# mostly) is the wall time less all of them (none when threads overlap)
HOST_FAMILIES = (
    ("launch", ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch")),
    ("h2d", ("cudaMemcpyAsync", "cudaMemcpy", "aten::pin_memory", "aten::_pin_memory",
             "cudaHostAlloc")),
    ("sync", ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaStreamWaitEvent")),
    ("casts", ("aten::to", "aten::_to_copy")),
)


def host_family(name: str) -> str:
    for family, names in HOST_FAMILIES:
        if name in names:
            return family
    if name.startswith("autograd::") or "Backward" in name:
        return "autograd"
    return "other_ops" if name.startswith("aten::") else "other_events"


def profile(fn, top_n: int = 10) -> dict:
    """Wall, device-busy ms, idle share, K1's, K2's, K3's, K4's, K6b's and
    K8's device ms over every kernel of theirs (named adamw_leaves,
    cross_net*, scatter_rows*, gather_rows*, field_block_scatter* and
    block_cumsum_rounds), the costliest kernels of fn(), and the host's
    ms by family of CPU event (`host_family`; `python_and_rest` the wall
    time no event covers)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    on_card = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_card)
    host_us = {}
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0:
            family = host_family(e.key)
            host_us[family] = host_us.get(family, 0.0) + e.self_cpu_time_total
    host_us["python_and_rest"] = max(0.0, wall_us - sum(host_us.values()))
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:top_n]
    k3_us = sum(e.self_device_time_total for e in on_card if "scatter_rows" in e.key)
    k6b_us = sum(e.self_device_time_total for e in on_card
                 if "field_block_scatter" in e.key)
    k2_us = sum(e.self_device_time_total for e in on_card if "cross_net" in e.key)
    k4_us = sum(e.self_device_time_total for e in on_card if "gather_rows" in e.key)
    k1_us = sum(e.self_device_time_total for e in on_card if "adamw_leaves" in e.key)
    k8_us = sum(e.self_device_time_total for e in on_card if "block_cumsum_rounds" in e.key)
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                idle_share=1.0 - busy_us / wall_us, k1_device_ms=k1_us / 1e3,
                k2_device_ms=k2_us / 1e3, k3_device_ms=k3_us / 1e3,
                k4_device_ms=k4_us / 1e3, k6b_device_ms=k6b_us / 1e3, k8_device_ms=k8_us / 1e3,
                host_ms={k: v / 1e3 for k, v in sorted(host_us.items())},
                top=[dict(name=e.key[:80], calls=e.count,
                          device_ms=e.self_device_time_total / 1e3) for e in top])


def k1_launches_a_step(optimizer) -> int:
    """K1 launches of one optimizer step: its dense parameters in launches
    of at most fused_adamw.MAX_LEAVES (`fused_adamw.plan`)."""
    from map_tpu_torch.ops import fused_adamw

    return len(fused_adamw.plan([p.numel() for i, p in enumerate(optimizer.params)
                                 if i not in optimizer.sparse]))


def graph_replays(trainer) -> dict:
    """{steps a graph: its replays} of a Trainer's multi-step dispatch."""
    return {n: g.replays for n, g in trainer.multi.graphs.items()}


def k1_plan_host_us(optimizer) -> float:
    """Host us of K1's launch plan and descriptor block for one step of
    `optimizer` (`fused_adamw.plan` + `descriptor`, rebuilt every step)."""
    from map_tpu_torch.ops import fused_adamw

    leaves = [i for i in range(len(optimizer.params)) if i not in optimizer.sparse]
    tensors = [(optimizer.params[i], optimizer.mu[i], optimizer.nu[i], optimizer.mu[i])
               for i in leaves]
    numels = [t[0].numel() for t in tensors]
    ptrs = [tuple(x.data_ptr() for x in t) for t in tensors]
    wds = [optimizer.wds[i] for i in leaves]
    aligned = [all(p % 16 == 0 for p in ptr) for ptr in ptrs]

    def plan_and_descriptor():
        for launch in fused_adamw.plan(numels):
            fused_adamw.descriptor(launch, ptrs, numels, wds, aligned)

    return host_us_per_call(plan_and_descriptor, calls=200)


def step_scalars(scal, slot: int, wd: float):
    """Row `slot` of an optimizer's scalar buffer, with wd, as the by-value
    AdamScalars the kernels' by-value forms take."""
    from map_tpu_torch.ops import fused_adamw

    row = scal[slot].tolist()
    return fused_adamw.AdamScalars(row[0], wd, *row[2:7])


def kernel_ms_per_step(prof: dict, steps: int) -> dict:
    """K1's, K2's, K3's, K4's, K6b's and K8's device ms a step of a profile,
    and the host's ms a step by family."""
    out = {f"{k}_ms_per_step": prof[f"{k}_device_ms"] / steps
           for k in ("k1", "k2", "k3", "k4", "k6b", "k8")}
    out["host_ms_per_step"] = {k: v / steps for k, v in prof["host_ms"].items()}
    return out


def host_us_per_call(fn, calls: int = 1000, repeats: int = 5) -> float:
    """Host microseconds a call of fn, over `calls` calls with no
    synchronize in between (the launch queue absorbs them): the median of
    `repeats` runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(runs))


def k4_times(table, ids, out_dtype, reps: int = 20) -> dict:
    """K4 at one shape, timed in turns (`time_ms_each`) with its plain
    version, `F.embedding` on int64 ids (f32 out; bf16 out has no one-call
    equivalent: None), `Tensor.copy_` of a tensor of the output's size and
    dtype (`copy_ms`, the floor of a pass over the output's bytes in this
    harness) and a one-element `zero_()` (`launch_ms`, the floor of any
    launch in it). Bound: the ids, the distinct rows and the output, each
    once, over the card's memory rate. The kernel is held to its plain
    version bit for bit, twice."""
    import torch
    import torch.nn.functional as F

    from map_tpu_torch.ops import embedding

    n, e = ids.numel(), table.shape[1]
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    ref = embedding.embedding_lookup_plain(table, ids, out_dtype)
    bit_equal = all(torch.equal(embedding.embedding_lookup(table, ids, out_dtype), ref)
                    for _ in range(2))
    src = torch.empty_like(ref)
    dst = torch.empty_like(ref)
    tiny = torch.empty(1, device=ids.device)
    fns = dict(ms=lambda: embedding.embedding_lookup(table, ids, out_dtype),
               plain_ms=lambda: embedding.embedding_lookup_plain(table, ids, out_dtype),
               copy_ms=lambda: dst.copy_(src), launch_ms=tiny.zero_)
    if out_dtype == torch.float32:
        ids_long = ids.long()
        fns["library_ms"] = lambda: F.embedding(ids_long, table)
    t = time_ms_each(fns, reps)
    t.setdefault("library_ms", None)
    distinct = int(torch.unique(ids).numel())
    nbytes = n * 4 + distinct * e * 4 + ref.numel() * ref.element_size()
    t.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
             ids=list(ids.shape), table=list(table.shape),
             out_dtype=str(out_dtype).replace("torch.", ""), distinct_rows=distinct,
             bit_equal_twice=bit_equal, ms_over_bound=t["ms"] / (nbytes / HBM_BYTES_PER_S * 1e3),
             ms_over_copy=t["ms"] / t["copy_ms"])
    return t


def k4_launches_by_shape(steps: int) -> dict:
    """K4's launches by shape in each training run of the smoke, as its
    expected counts give them: a training step gathers the (4096, 24) input
    rows in bf16 and, in MFP, the decoder rows of its candidates
    (per-position) or of its targets and its (F, k) noise (per-field
    shared); an eval batch of 10000 rows the same, the input rows at the
    serving shape. Keys name `times` rows, or the eval shape no row times."""
    ev = -(-EVAL_ROWS // EVAL_BATCH)  # batches of one eval
    return {
        "rfd": {"K4 training input": steps, "K4 bf16 out": ev},
        "pf-shared": {"K4 training input": steps, "K4 pf-shared targets": steps,
                      "K4 pf-shared noise": steps + ev, "K4 bf16 out": ev,
                      "eval targets (10000, 7)": ev},
        "per-position": {"K4 training input": steps, "K4 MFP decoder": steps,
                         "K4 bf16 out": ev, "eval candidates (10000, 7, 26)": ev},
        "supervised bf16": {"K4 training input": steps, "K4 bf16 out": 2 * ev},
    }


def parity_check(name, dname, lr, k_loss, p_loss, k_params, p_params, p0) -> None:
    """PARITY_STEPS steps through the kernels against the same through the
    plain versions: losses within TOL_PARITY_LOSS relative, parameters at
    most 2 lr k apart, and the L1 norm of their difference a share of the
    updates' own L1 norm (see TOL_PARITY_UPDATE_L1). The buffers among
    k_params / p_params (the names p0, the parameters at the start, lacks:
    FGCNN's BatchNorm running statistics) at most 2 lr k plus
    TOL_PARITY_LOSS of their size apart: a running mean follows its
    convolution's bias, whose gradient is rounding only, so that bias may
    move apart as a flat parameter does."""
    loss_rel = float(((k_loss - p_loss).abs() / p_loss.abs()).max())
    max_d = diff_l1 = update_l1 = buffer_d = 0.0
    close = total = 0
    buffers_ok = True
    for n, ref in p_params.items():
        d = (k_params[n] - ref).abs()
        if n not in p0:
            buffer_d = max(buffer_d, float(d.max()))
            buffers_ok &= bool((d <= 2 * lr * PARITY_STEPS * 1.01
                                + TOL_PARITY_LOSS[dname] * ref.abs()).all())
            continue
        max_d = max(max_d, float(d.max()))
        diff_l1 += float(d.double().sum())
        update_l1 += float((ref - p0[n].detach().to(ref.device)).abs().double().sum())
        close += int((d <= 1e-5 + 1e-5 * ref.abs()).sum())
        total += d.numel()
    check(name, loss_rel <= TOL_PARITY_LOSS[dname]
          and max_d <= 2 * lr * PARITY_STEPS * 1.01
          and diff_l1 <= TOL_PARITY_UPDATE_L1[dname] * update_l1 and buffers_ok,
          losses_kernels=k_loss.tolist(), losses_plain=p_loss.tolist(),
          loss_max_rel=loss_rel, param_max_abs=max_d,
          update_l1_share=diff_l1 / update_l1,
          param_share_within_1e5=close / total, buffer_max_abs=buffer_d)


# map_tpu's steps_per_call; the first two calls of the graph path
def eager_bits_check(name: str, pred, ids: np.ndarray, logits: np.ndarray) -> None:
    """The Predictor's logits (its packed transfer, captured forward and
    pipeline) against an eager forward of the same padded chunks by its
    model outside inference mode (the layers cast their weights on the
    call): bit-equal."""
    import torch

    ref = []
    with torch.no_grad():
        for lo in range(0, len(ids), pred.batch_size):
            chunk = pred._check_and_pad(ids[lo:lo + pred.batch_size], lo)
            ref.append(pred.model(torch.from_numpy(chunk).to(pred.device))
                       .reshape(-1).float().cpu())
    ref = torch.cat(ref)[:len(ids)]
    got = torch.from_numpy(logits)
    check(f"{name}: pipelined Predictor logits bit-equal to an eager forward of the "
          "same chunks", torch.equal(got, ref), rows=len(ids),
          max_abs_diff=float((got - ref).abs().max()))


GRAPH_SPC = 8
BITS_STEPS = 2 * GRAPH_SPC


def sent_bytes(batcher, spc: int, epoch: int, resident) -> int:
    """The bytes the input pipeline copies to the card in one epoch: each
    call's device keys (an index batch's INDEX_KEYS, else every array), the
    optimizer's scalar row a step, and with stream v2 the epoch's order."""
    from map_tpu_torch.ops import fused_adamw
    from map_tpu_torch.train.train_step import INDEX_KEYS, is_index_batch

    stream = (batcher.epoch_stacked(spc, epoch) if spc > 1
              else ((1, b, [b]) for b in batcher.epoch(epoch)))
    total = steps = 0
    for n, payload, _ in stream:
        steps += n
        total += sum(np.asarray(v).nbytes for k, v in payload.items()
                     if not is_index_batch(payload) or k in INDEX_KEYS)
    total += steps * fused_adamw.SCALAR_WIDTH * 4
    if resident is not None and resident.perm is not None:
        total += resident.perm.numel() * resident.perm.element_size()
    return total


def path_phase(name: str, make, bits_make=None, count_fold: bool = False) -> dict:
    """One training cell on today's path (steps_per_call=1,
    device_resident_data=off: a host batch copied a step, a step a host
    call) and on the new default (the train data on the card, prefetch,
    steps_per_call=8 as captured CUDA graphs): a Trainer each from
    make(resident, spc), from the same weights, on the same batches (epochs
    0, 1 and 2 of the Batcher's stream):
    - the first 16 steps, the graph path's first two calls (its eager
      warm-up, then a capture and a replay): every parameter and buffer bit-equal
      across the paths then (on a pair from bits_make, when given);
    - epoch 1 timed (host clock, a synchronize at its end): wall ms a step;
    - epoch 2 profiled: device-busy ms a step, idle share, host ms a step by
      family;
    - 32 steps of epoch 3, a host call at a time after a synchronize (the
      card idle, so nothing waits): the host us a step, the median;
    - the launches each path ran (a replay counted as its graph's launches),
      equal across the paths; the bytes copied to the card a step;
    - count_fold: every step's distinct candidate ids in today's path's
      epoch 0.
    Returns the emitted fields."""
    import torch

    from map_tpu_torch.ops import dedup_scatter
    from map_tpu_torch.train.graph import launch_counts

    def params(trainer):
        """Every parameter and buffer (FGCNN's running statistics), so that a
        graph that froze the statistics cannot pass the bit check."""
        return {n: t.detach().clone() for n, t in trainer.model.state_dict().items()}

    def epoch0(trainer, batcher, stop: bool):
        """Epoch 0 (its first BITS_STEPS steps when `stop`) -> (steps, the
        parameters after BITS_STEPS steps)."""
        it = trainer.train_epoch(batcher, 0)
        done, snap = 0, None
        for n, _, _ in it:
            done += n
            if done == BITS_STEPS:
                snap = params(trainer)
                if stop:
                    break
        it.close()
        torch.cuda.synchronize()
        return done, snap

    paths = (("today", "off", 1), ("graph", "auto", GRAPH_SPC))
    snaps = {}
    if bits_make is not None:
        for path, resident, spc in paths:
            trainer = bits_make(resident, spc)
            snaps[path] = epoch0(trainer, trainer._prepare_training(), stop=True)
            del trainer
    out = {"cell": name, "card": smi_line()}
    distinct = []
    for path, resident, spc in paths:
        trainer = make(resident, spc)
        batcher = trainer._prepare_training()
        before = launch_counts()
        fold = dedup_scatter.sort_and_fold

        def counting_fold(*fold_args):
            folded = fold(*fold_args)
            distinct.append(folded[2])
            return folded

        if count_fold and path == "today":
            dedup_scatter.sort_and_fold = counting_fold
        try:
            steps0, snap = epoch0(trainer, batcher, stop=False)
        finally:
            dedup_scatter.sort_and_fold = fold
        if bits_make is None:
            snaps[path] = (BITS_STEPS if snap is not None else 0, snap)
        multi = trainer.multi
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps1 = sum(n for n, _, _ in trainer.train_epoch(batcher, 1))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps1 * 1e3
        prof = profile(lambda: sum(n for n, _, _ in trainer.train_epoch(batcher, 2)),
                       top_n=8)
        steps2 = len(batcher)
        # the host's time a step with the card idle: 32 steps of epoch 3,
        # their groups copied first, a synchronize before each call
        stream = (batcher.epoch_stacked(spc, 3) if spc > 1
                  else ((1, b, [b]) for b in batcher.epoch(3)))
        groups, steps3 = [], 0
        for n, payload, _ in stream:
            groups.append((n, trainer._put(payload)[0]))
            steps3 += n
            if steps3 >= 4 * GRAPH_SPC:
                break
        host_us = []
        for n, dev_batch in groups:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._run_train_step(n, dev_batch)
            host_us.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
        counts = launch_counts()
        ran = multi.launches_run({k: v - before[k] for k, v in counts.items()})
        out[path] = dict(
            steps_per_call=spc, device_resident_data=resident,
            resident=trainer._data is not None, stream_v2=trainer._stream_v2,
            steps=[steps0, steps1, steps2, steps3], wall_ms_per_step=wall_ms,
            busy_ms_per_step=prof["device_busy_ms"] / steps2,
            idle_share=prof["idle_share"], profiled_wall_ms_per_step=prof["wall_ms"] / steps2,
            host_us_per_step=float(np.median(host_us)),
            graphs={n: g.replays for n, g in multi.graphs.items()},
            h2d_bytes_per_step=sent_bytes(batcher, spc, 1, trainer._data) / steps1,
            launches=ran, **kernel_ms_per_step(prof, steps2),
            top=prof["top"])
        del trainer, prof
        torch.cuda.empty_cache()
    emit("path_time", **out)
    today, graph = out["today"], out["graph"]
    check(f"{name}: the graph path ran captured graphs of 8 and 1 steps, on the train "
          "data on the card", graph["resident"] and sorted(graph["graphs"]) == [1, 8]
          and all(graph["graphs"].values()) and not today["resident"]
          and not today["graphs"], graphs=graph["graphs"])
    check(f"{name}: the same launches on both paths (replays counted), K1 once a step",
          today["launches"] == graph["launches"]
          and graph["launches"]["fused_adamw"] == sum(graph["steps"]),
          today=today["launches"], graph=graph["launches"])
    (done_t, p_t), (done_g, p_g) = snaps["today"], snaps["graph"]
    differ = ([n for n, p in p_t.items() if not torch.equal(p, p_g[n])]
              if p_t is not None and p_g is not None else ["(no snapshot)"])
    check(f"{name}: parameters and buffers after {BITS_STEPS} steps (two calls), graph "
          "path bit-equal to today's", done_t == done_g == BITS_STEPS and not differ,
          differ=differ, on_own_pair=bits_make is not None, tensors=len(p_t or {}))
    if count_fold:
        out["distinct"] = torch.stack(distinct).cpu().tolist()
    return out


def smi_line(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def teacher_dataset(rng: np.random.Generator, train_rows: int):
    """In-memory train / valid / test splits: field-blocked ids, labels drawn
    from a fixed random teacher, logit = sum of a per-id weight over the
    fields of at most 10,000 ids (the larger fields' ids recur too rarely in
    one epoch to be learnt) minus its mean."""
    lo, hi, vocab = field_blocks()
    weight = rng.normal(0.0, 0.5, vocab)
    for a, b, size in zip(lo, hi, FIELD_SIZES):
        if size > 10_000:
            weight[a:b] = 0.0
    X, Y = {}, {}
    for split, rows in (("train", train_rows), ("valid", EVAL_ROWS),
                        ("test", EVAL_ROWS)):
        ids = draw_ids(rng, rows)
        logit = weight[ids].sum(axis=1)
        X[split] = ids
        Y[split] = (rng.random(rows) < 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
                    ).astype(np.float32)
    return SimpleNamespace(X=X, Y=Y)


@contextlib.contextmanager
def plain_layers():
    """The layers with the gather (the table's and LR's, `layers.embedding_lookup`)
    and the cross net swapped for their plain versions (differentiated by
    autograd), the hybrid lookup's K4, K3 and K6b, and the MFP decoder's
    gather, K8 and K5 for theirs, for the comparison runs. The zoo's other
    layers run no kernel."""
    from map_tpu_torch.nn import layers
    from map_tpu_torch.ops import (
        cross,
        dedup_scatter,
        embedding,
        field_gather,
        hybrid_gather,
        scan,
        scatter,
        scatter_unique,
    )

    swaps = [(layers, "embedding_lookup", embedding.embedding_lookup_plain),
             (layers, "cross_net", cross.cross_net_plain),
             (hybrid_gather, "embedding_lookup", embedding.embedding_lookup_plain),
             (hybrid_gather, "scatter_add", scatter.scatter_add_plain),
             (hybrid_gather, "field_block_scatter_add",
              field_gather.field_block_scatter_add_plain),
             (dedup_scatter, "embedding_lookup", embedding.embedding_lookup_plain),
             (dedup_scatter, "block_cumsum", scan.block_cumsum_plain),
             (dedup_scatter, "scatter_unique_sorted",
              scatter_unique.scatter_unique_sorted_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def seeded_model(dev, cfg, seed: int):
    """The model of `cfg` from the weights of `seed` on `dev`, its dropout
    drawing from a generator on `dev` seeded from `seed` too (AutoInt's
    attention dropout), so that two runs from one seed draw alike."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.nn.layers import set_dropout_generator

    m = models.from_config(cfg, torch.Generator().manual_seed(seed)).to(dev)
    set_dropout_generator(m, torch.Generator(device=dev).manual_seed(seed + 7))
    return m


def model_state(m) -> dict:
    """{name: tensor} of every parameter and buffer of `m`, detached."""
    return {n: t.detach() for n, t in [*m.named_parameters(), *m.named_buffers()]}


def launched_during(read_counts, fn, plain: bool):
    """fn() -> (its result, the launches during it); a plain run (every
    kernel swapped for its plain version) must launch none."""
    before = read_counts()
    with plain_layers() if plain else contextlib.nullcontext():
        result = fn()
    after = read_counts()
    launched = {k: after[k] - before[k] for k in after}
    if plain and any(launched.values()):
        raise AssertionError(f"the plain run launched kernels: {launched}")
    return result, launched


def supervised_steps(dev, cfg, targs, batches, read_counts, *, seed: int, steps: int,
                     plain: bool):
    """Supervised steps of `cfg` from the weights of `seed`, one per batch,
    through the kernels or (plain) through their plain versions, a schedule
    of `steps` -> (losses (n,), {name: parameter or buffer}, launches during
    the steps)."""
    import torch

    from map_tpu_torch.ops import fused_adamw
    from map_tpu_torch.train.optimizer import build_optimizer
    from map_tpu_torch.train.train_step import make_supervised_steps

    m = seeded_model(dev, cfg, seed)
    opt, _ = build_optimizer(
        m, targs, steps, 0,
        update=fused_adamw.fused_adamw_leaves_plain if plain else fused_adamw.fused_adamw_leaves)
    step, _ = make_supervised_steps(m, opt, dev)
    losses, launched = launched_during(
        read_counts, lambda: torch.stack([step(b)["loss"] for b in batches]).cpu(), plain)
    return losses, model_state(m), launched


def mfp_args(output_dir: str, seed: int, **kw):
    """run_script/run_DCNv2_MFP.sh's flags, bf16, batch TRAIN_BATCH."""
    from map_tpu_torch.config import TrainingArguments

    return TrainingArguments(
        output_dir=output_dir, dataset_name="in-memory", data_dir=output_dir,
        per_device_train_batch_size=TRAIN_BATCH, per_device_eval_batch_size=EVAL_BATCH,
        learning_rate=MFP_LR, weight_decay=MFP_WD, lr_sched="cosine", num_train_epochs=1,
        logging_steps=10, mask_ratio=MFP_MASK_RATIO, sampling_method="randint",
        pretrain=True, pt_type="MFP", compute_dtype="bfloat16", seed=seed, **kw)


def mfp_step_fn(dev, cfg, targs, tables, *, seed: int, steps: int, shared: bool = False,
                sparse: bool = False, plain: bool = False):
    """An MFP train step(batch, draws) of `cfg`'s mode from the weights of
    `seed`, a schedule of `steps`, its updates through K1 (K7) or (plain)
    their plain versions; sparse: the decoder emb updated from its streams.
    -> (model, step)."""
    import torch

    from map_tpu_torch.ops import fused_adamw, sparse_adamw
    from map_tpu_torch.train.optimizer import build_optimizer
    from map_tpu_torch.train.train_step import make_mfp_steps

    m = seeded_model(dev, cfg, seed)
    handoff = sparse_adamw.StreamHandoff() if sparse else None
    m.mfp_criterion.handoff = handoff
    opt, _ = build_optimizer(
        m, targs, steps, 0,
        update=fused_adamw.fused_adamw_leaves_plain if plain else fused_adamw.fused_adamw_leaves,
        sparse={"mfp_criterion.emb.weight": handoff} if sparse else None,
        sparse_update=(sparse_adamw.sparse_adamw_step_plain if plain
                       else sparse_adamw.sparse_adamw_step))
    step, _ = make_mfp_steps(m, opt, cfg, MFP_MASK_RATIO, "randint", tables,
                             torch.Generator(device=dev), dev, shared_noise=shared)
    return m, step


def mfp_steps(dev, cfg, targs, tables, batches, draws, read_counts, *, seed: int,
              shared: bool, sparse: bool, plain: bool):
    """MFP steps of `cfg`'s mode from the weights of `seed`, one per (batch,
    draws), through the kernels or (plain) through their plain versions;
    sparse: the decoder emb updated from its streams (K7 or its plain
    version). -> (losses (n,), {name: parameter or buffer}, launches during
    the steps)."""
    import torch

    m, step = mfp_step_fn(dev, cfg, targs, tables, seed=seed, steps=len(batches),
                          shared=shared, sparse=sparse, plain=plain)
    losses, launched = launched_during(read_counts, lambda: torch.stack(
        [step(b, d)["loss"] for b, d in zip(batches, draws)]).cpu(), plain)
    return losses, model_state(m), launched


def mfp_phase(args, dev, cfg, data, reset_counts, read_counts) -> dict:
    """8. MFP pretraining through the Trainer in bf16, K5 on one step's
    candidate stream, kernels-vs-plain parity, step time and profile.
    Returns what the finetune, times and summary phases read."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.data.dataset import compute_feat_count
    from map_tpu_torch.data.loader import Batcher
    from map_tpu_torch.objectives.corruption import mask_num_of, mfp_corrupt
    from map_tpu_torch.ops import dedup_scatter, hybrid_gather, scatter_unique
    from map_tpu_torch.train.train_step import draw_mfp
    from map_tpu_torch.train.trainer import Trainer

    _, _, vocab = field_blocks()
    num_fields = len(FIELD_SIZES)
    feat_count = compute_feat_count(data.X["train"], vocab)
    mask_num = mask_num_of(num_fields, MFP_MASK_RATIO)
    n_cand = TRAIN_BATCH * mask_num * (1 + MFP_NEG)  # the port's capacity
    work = tempfile.mkdtemp(prefix="chip_smoke_mfp_")

    def mfp_cfg(dname, mode="matmul"):  # map_tpu's MFP default: the matmul backward
        return dataclasses.replace(cfg, compute_dtype=dname, pretrain=True,
                                   pt_type="MFP", proj_size=MFP_PROJ,
                                   pt_neg_num=MFP_NEG, nce_loss_type="nce",
                                   feat_count=feat_count, hybrid_mode=mode)

    def fresh(c):
        return models.from_config(c, torch.Generator().manual_seed(args.seed))

    cfg_m = mfp_cfg("bfloat16")
    targs = mfp_args(os.path.join(work, "pretrain"), args.seed)
    t0 = time.perf_counter()
    trainer = Trainer(fresh(cfg_m), cfg_m, targs, data)  # builds the alias table
    setup_s = time.perf_counter() - t0
    num_params = len(list(trainer.model.parameters()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.MFP_pretrain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = trainer.launches_run(read_counts())
    steps = trainer.global_step
    eval_batches = -(-EVAL_ROWS // EVAL_BATCH)
    expected = {"embedding_gather": 2 * (steps + eval_batches),
                "cross_net": steps + eval_batches, "scatter_add": steps,
                "fused_adamw": steps * k1_launches_a_step(trainer.optimizer),
                "scatter_unique_sorted": steps,
                "block_cumsum": steps, "sparse_adamw": 0, "field_block_gather": 0,
                "field_block_scatter": 0}
    losses = [w["window_loss"] for w in trainer.train_windows]
    eval_loss, eval_acc = trainer.eval_metrics[-1]
    emit("mfp_training", compute_dtype="bfloat16", steps=steps, batch=TRAIN_BATCH,
         setup_s=setup_s, wall_s=wall, windows=trainer.train_windows,
         eval_mfp_loss=eval_loss, eval_mfp_acc=eval_acc, launches=launches,
         expected_launches=expected, graphs=graph_replays(trainer), num_params=num_params,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(f"mfp: {args.train_steps} steps", steps == args.train_steps)
    check("mfp: 17 parameters", num_params == 17)
    check("mfp: window loss finite and falling",
          all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          first_window_loss=losses[0], last_window_loss=losses[-1])
    check("mfp: eval accuracy above chance", eval_acc > 1.0 / (1 + MFP_NEG),
          eval_mfp_acc=eval_acc, chance=1.0 / (1 + MFP_NEG))
    check("mfp: launches", launches == expected)
    ckpt = os.path.join(targs.output_dir, f"{steps}.model")
    check("mfp: checkpoint at the last step", os.path.exists(ckpt))

    # K5 on one step's folded candidate stream, at the path's shape
    batches = list(Batcher(data.X["train"], data.Y["train"], TRAIN_BATCH,
                           shuffle=True, seed=args.seed).epoch(0))[:PARITY_STEPS]
    draw_gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    draws = [draw_mfp(draw_gen, trainer.noise, TRAIN_BATCH, num_fields, mask_num,
                      MFP_NEG, "randint") for _ in batches]
    ids0 = torch.from_numpy(batches[0]["input_ids"]).to(dev)
    corrupted, labels = mfp_corrupt(ids0, draws[0].masked_index)
    cand = torch.cat([labels[..., None], draws[0].noise], -1).reshape(-1)
    gen = torch.Generator().manual_seed(args.seed)
    g = (torch.randn(cand.numel(), MFP_PROJ + 1, generator=gen) * 1e-3).to(dev)
    uids, vals, num_unique = dedup_scatter.sort_and_fold(cand, g, vocab)
    num_unique = int(num_unique)
    k5_err = 0.0
    for mode in scatter_unique.MODES:
        got = scatter_unique.scatter_unique_sorted(uids, vals, vocab, (MFP_PROJ, 1), mode)
        ref = scatter_unique.scatter_unique_sorted_plain(uids, vals, vocab,
                                                         (MFP_PROJ, 1), mode)
        torch.cuda.synchronize()
        for part, a, r in zip(("emb", "bias"), got, ref):
            k5_err = max(k5_err, compare(
                f"K5 {mode} {part}, {n_cand} candidates ({num_unique} distinct) "
                f"-> {vocab} x {MFP_PROJ + 1}", a, r, 0.0, 0.0))
        again = scatter_unique.scatter_unique_sorted(uids, vals, vocab, (MFP_PROJ, 1), mode)
        check(f"K5 {mode} deterministic", all(torch.equal(a, b) for a, b in zip(got, again)))

    # 5 MFP steps from the same weights and draws, kernels vs plain versions
    for dname in ("bfloat16", "float32"):
        (k_loss, k_params, _), (p_loss, p_params, _) = (
            mfp_steps(dev, mfp_cfg(dname), targs, trainer.noise, batches, draws,
                      read_counts, seed=args.seed, shared=False, sparse=False,
                      plain=plain) for plain in (False, True))
        parity_check(f"mfp {dname}: {PARITY_STEPS} steps, kernels vs plain versions",
                     dname, MFP_LR, k_loss, p_loss, k_params, p_params,
                     dict(fresh(mfp_cfg(dname)).named_parameters()))
        del k_params, p_params

    # step time and where it goes
    step = trainer.train_step
    for b in batches[:3]:
        step(b)
    torch.cuda.synchronize()
    timed = 20
    t0 = time.perf_counter()
    for i in range(timed):
        step(batches[i % PARITY_STEPS])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    emit("mfp_training_time", compute_dtype="bfloat16", batch=TRAIN_BATCH,
         step_ms=step_ms, examples_per_s=TRAIN_BATCH / step_ms * 1e3,
         trainer_window_time_cost=[w["time_cost"] for w in trainer.train_windows])
    prof_steps = 5
    prof = profile(lambda: [step(batches[i]) for i in range(prof_steps)], top_n=14)
    k3_ms = prof["k3_device_ms"]
    # under the matmul backward K3 takes the big fields' rows only
    big = list(hybrid_gather.field_groups(tuple(zip(cfg.idx_low, cfg.idx_high)))[1])
    emit("mfp_training_profile", compute_dtype="bfloat16", steps=prof_steps,
         hybrid_mode="matmul", busy_ms_per_step=prof["device_busy_ms"] / prof_steps,
         k3_rows=TRAIN_BATCH * len(big),
         k3_mask_rows=int((corrupted[:, big] == 3).sum()),
         **kernel_ms_per_step(prof, prof_steps),
         k3_share_of_busy=k3_ms / prof["device_busy_ms"], **prof)

    # the three backward modes of the table gradient, one function: 5 f32
    # steps under bwd_pallas (K3 on the big fields, K6b on the small) against
    # 5 under matmul from the same weights and draws; then the bf16 step
    # (20 timed, 5 profiled) under each, from the same batches and draws
    (k_loss, k_params, launched), (m_loss, m_params, _) = (
        mfp_steps(dev, mfp_cfg("float32", mode), targs, trainer.noise, batches, draws,
                  read_counts, seed=args.seed, shared=False, sparse=False, plain=False)
        for mode in ("bwd_pallas", "matmul"))
    check("mfp f32: K6b launched once a step under bwd_pallas",
          launched["field_block_scatter"] == PARITY_STEPS, launched=launched)
    parity_check(f"mfp f32: {PARITY_STEPS} steps, bwd_pallas (K3 + K6b) vs matmul",
                 "float32", MFP_LR, k_loss, m_loss, k_params, m_params,
                 dict(fresh(mfp_cfg("float32")).named_parameters()))
    del k_params, m_params
    for mode in ("matmul", "fwd", "bwd_pallas"):
        _, mode_step = mfp_step_fn(dev, mfp_cfg("bfloat16", mode), targs, trainer.noise,
                                   seed=args.seed, steps=100)
        for i in range(3):
            mode_step(batches[i], draws[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(timed):
            mode_step(batches[i % PARITY_STEPS], draws[i % PARITY_STEPS])
        torch.cuda.synchronize()
        mode_ms = (time.perf_counter() - t0) / timed * 1e3
        prof = profile(lambda: [mode_step(batches[i], draws[i]) for i in range(prof_steps)],
                       top_n=14)
        emit("mfp_mode_time", compute_dtype="bfloat16", hybrid_mode=mode, batch=TRAIN_BATCH,
             step_ms=mode_ms, examples_per_s=TRAIN_BATCH / mode_ms * 1e3, steps=prof_steps,
             busy_ms_per_step=prof["device_busy_ms"] / prof_steps,
             **kernel_ms_per_step(prof, prof_steps), **prof)
        del mode_step
    noise = trainer.noise
    del trainer

    # today's path against the new default, on the same batches, under the
    # three backward modes; parameters compared on a pair drawing masked
    # positions without repeats ('normal'): the encoder's masked-position
    # gather adds into one element through atomics in its backward where a
    # row repeats a position, in any order. Today's path counts each step's
    # distinct candidate ids (the decoder's backward folds once a step)
    for mode in ("matmul", "fwd", "bwd_pallas"):
        def make(resident, spc, sampling="randint", mode=mode):
            c = mfp_cfg("bfloat16", mode)
            return Trainer(fresh(c), c, dataclasses.replace(
                targs, num_train_epochs=3, device_resident_data=resident,
                steps_per_call=spc, sampling_method=sampling), data)

        path = path_phase(f"mfp per-position bfloat16 {mode}", make,
                          bits_make=lambda resident, spc, make=make: make(resident, spc,
                                                                          "normal"),
                          count_fold=mode == "matmul")
        if mode == "matmul":
            distinct = path["distinct"]
            emit("mfp_distinct_candidates", steps=len(distinct), min=min(distinct),
                 max=max(distinct), mean=sum(distinct) / len(distinct), capacity=n_cand,
                 map_tpu_capacity=MAP_TPU_CAPACITY,
                 steps_over_map_tpu_capacity=sum(d > MAP_TPU_CAPACITY for d in distinct))
            check("mfp: every step's distinct candidates within the capacity",
                  len(distinct) == path["today"]["steps"][0] and max(distinct) <= n_cand)

    # the per-position fold's scan input: the candidates' gradient rows in
    # sorted order, as sort_and_fold hands it to K8
    fold_scan = g.index_select(0, torch.sort(cand.int(), stable=True)[1])
    return dict(launches=launches, ckpt=ckpt, work=work, k5_err=k5_err,
                k5_stream=(uids, vals, num_unique), fold_inputs=(cand, g),
                fold_scan=fold_scan, corrupted=corrupted, feat_count=feat_count,
                noise=noise)


def mfp_shared_phase(args, dev, cfg, data, mfp, reset_counts, read_counts) -> dict:
    """8b. Per-field shared noise, k = PFS_NEG, with the sparse table update,
    through the Trainer in bf16; K7 and K8 on the path's data; K7 against
    the dense route; kernels-vs-plain parity; step time and profile. 8c.
    The other noise modes' parity. Returns what the times and summary
    phases read."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.data.loader import Batcher
    from map_tpu_torch.objectives.corruption import mask_num_of, mfp_corrupt
    from map_tpu_torch.ops import dedup_scatter, scan, sparse_adamw
    from map_tpu_torch.train.train_step import draw_mfp
    from map_tpu_torch.train.trainer import Trainer

    num_fields = len(FIELD_SIZES)
    mask_num = mask_num_of(num_fields, MFP_MASK_RATIO)
    work = tempfile.mkdtemp(prefix="chip_smoke_pfs_")

    def mode_cfg(dname, k=PFS_NEG, per_field=True, loss="nce"):
        return dataclasses.replace(cfg, compute_dtype=dname, pretrain=True,
                                   pt_type="MFP", proj_size=MFP_PROJ, pt_neg_num=k,
                                   nce_loss_type=loss, pt_per_field_noise=per_field,
                                   feat_count=mfp["feat_count"], hybrid_mode="matmul")

    cfg_s = mode_cfg("bfloat16")
    targs = mfp_args(os.path.join(work, "pretrain"), args.seed, pt_shared_noise=True,
                     pt_per_field_noise=True, sparse_table_update=True)
    t0 = time.perf_counter()
    trainer = Trainer(models.from_config(cfg_s, torch.Generator().manual_seed(args.seed)),
                      cfg_s, targs, data)  # builds the per-field alias tables
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.MFP_pretrain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = trainer.launches_run(read_counts())
    steps = trainer.global_step
    eval_batches = -(-EVAL_ROWS // EVAL_BATCH)
    # a train step gathers the input rows, the targets and the (F, k) noise
    # rows (K4 x 3, as the eval step); folds the targets' and the noise's
    # gradients (K8 x 2), writes their bias gradients (K5 x 2) and hands
    # their emb streams to K7; one K1 launch updates the 16 other parameters
    expected = {"embedding_gather": 3 * (steps + eval_batches),
                "cross_net": steps + eval_batches, "scatter_add": steps,
                "fused_adamw": steps * k1_launches_a_step(trainer.optimizer),
                "scatter_unique_sorted": 2 * steps,
                "block_cumsum": 2 * steps, "sparse_adamw": steps, "field_block_gather": 0,
                "field_block_scatter": 0}
    losses = [w["window_loss"] for w in trainer.train_windows]
    eval_loss, eval_acc = trainer.eval_metrics[-1]
    emit("mfp_pf_shared_training", compute_dtype="bfloat16", steps=steps,
         batch=TRAIN_BATCH, k=PFS_NEG, setup_s=setup_s, wall_s=wall,
         windows=trainer.train_windows, eval_mfp_loss=eval_loss, eval_mfp_acc=eval_acc,
         launches=launches, expected_launches=expected, graphs=graph_replays(trainer),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check("pf-shared: sparse table update engaged",
          trainer.model.mfp_criterion.handoff is not None and bool(trainer.optimizer.sparse))
    check(f"pf-shared: {args.train_steps} steps", steps == args.train_steps)
    check("pf-shared: window loss finite and falling",
          all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          first_window_loss=losses[0], last_window_loss=losses[-1])
    check("pf-shared: eval accuracy above chance", eval_acc > 1.0 / (1 + PFS_NEG),
          eval_mfp_acc=eval_acc, chance=1.0 / (1 + PFS_NEG))
    check("pf-shared: launches", launches == expected)

    # one step's real K7 streams and K8 inputs
    batches = list(Batcher(data.X["train"], data.Y["train"], TRAIN_BATCH,
                           shuffle=True, seed=args.seed).epoch(0))[:PARITY_STEPS]

    def draws_of(tables, method, seed, k=PFS_NEG, shared=True, full=False, batch=TRAIN_BATCH):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [draw_mfp(gen, tables, batch, num_fields, mask_num, k, method,
                         shared_noise=shared, full=full) for _ in batches]

    draws = draws_of(trainer.noise, "randint", args.seed + 4)
    captured = {"scan": []}
    opt, k7, k8 = trainer.optimizer, trainer.optimizer.sparse_update, dedup_scatter.block_cumsum

    def capture_update(p, mu, nu, target, noise, wd, scal, slot):
        captured["k7"] = (target, noise, step_scalars(scal, slot, wd), p.clone(), mu.clone(),
                          nu.clone())
        k7(p, mu, nu, target, noise, wd, scal, slot)

    def capture_scan(x):
        captured["scan"].append(x.clone())
        return k8(x)

    opt.sparse_update, dedup_scatter.block_cumsum = capture_update, capture_scan
    # the decoder rows K4 gathers in that step: the targets and the noise
    targets = mfp_corrupt(torch.from_numpy(batches[0]["input_ids"]).to(dev),
                          draws[0].masked_index)[1]
    try:
        trainer.train_step(batches[0], draws[0])
    finally:
        opt.sparse_update, dedup_scatter.block_cumsum = k7, k8
    target, noise, s, p0, mu0, nu0 = captured["k7"]
    vocab, e = p0.shape
    valid = [int((st.uids < vocab).sum()) for st in (target, noise)]
    ref = [t.clone() for t in (p0, mu0, nu0)]
    sparse_adamw.sparse_adamw_plain(*ref, target, noise, s)
    got, again = ([t.clone() for t in (p0, mu0, nu0)] for _ in range(2))
    sparse_adamw.sparse_adamw(*got, target, noise, s)
    sparse_adamw.sparse_adamw(*again, target, noise, s)
    torch.cuda.synchronize()
    label = (f"{vocab} x {e}, target stream {target.uids.numel()} ({valid[0]} distinct), "
             f"noise stream {noise.uids.numel()} ({valid[1]} distinct)")
    k7_err = max(compare(f"K7 {part}, {label}", a, r, 0.0, 0.0)
                 for part, a, r in zip(("p", "mu", "nu"), got, ref))
    check("K7 deterministic", all(torch.equal(a, b) for a, b in zip(got, again)))
    del ref, got, again

    # autograd runs the noise rows' backward first; the folds differ in length
    folds = {x.shape[0]: x for x in captured["scan"]}
    k8_inputs = {"per-position fold": mfp["fold_scan"],
                 "target fold": folds.get(TRAIN_BATCH * mask_num),
                 "noise fold": folds.get(num_fields * PFS_NEG)}
    check("K8 inputs: a step scans the target fold's (B * M, E + 1) and the noise "
          "fold's (F * k, E + 1)", len(captured["scan"]) == 2
          and all(x is not None and x.shape[1] == MFP_PROJ + 1 for x in k8_inputs.values()),
          shapes=[list(x.shape) for x in captured["scan"]])
    # and an input of many rounds: three per-position folds' rows and one
    k8_inputs["several rounds"] = (torch.randn(
        3 * mfp["fold_scan"].shape[0] + 1, MFP_PROJ + 1,
        generator=torch.Generator().manual_seed(args.seed)) * 1e-3).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k8_err = {}
    for key, x in k8_inputs.items():
        out, out2 = scan.block_cumsum(x), scan.block_cumsum(x)
        k8_plan = scan.plan(*x.shape, sms)
        check(f"K8 {key}: bit-equal to its association in PyTorch ops "
              f"(block_cumsum_order), {k8_plan.rounds} rounds of {k8_plan.grid} tiles",
              torch.equal(out, scan.block_cumsum_order(x, k8_plan)), plan=k8_plan._asdict())
        plain = scan.block_cumsum_plain(x)
        exact = x.double().cumsum(0)
        tol = TOL_SCAN * float(x.double().abs().cumsum(0).max())
        err64 = float((out.double() - exact).abs().max())
        k8_err[key] = float((out - plain).abs().max())
        plain64 = float((plain.double() - exact).abs().max())
        check(f"K8 {key} {tuple(x.shape)}: within {TOL_SCAN} max cumsum|x| of float64, "
              "and of the plain version", err64 <= tol and k8_err[key] <= 2 * tol
              and bool(out.isfinite().all()), max_abs_err_f64=err64, tol=tol,
              max_abs_err_plain=k8_err[key], plain_max_abs_err_f64=plain64)
        check(f"K8 {key} deterministic", torch.equal(out, out2))

    # 5 f32 steps with K7 against the dense route, from the same weights and
    # draws. Masked positions without repeats ('normal'), so that no step
    # adds into one element twice through atomics (the encoder gather's
    # backward): then every op of both runs is deterministic, and target +
    # noise is one float32 add either way, so the runs are bit-equal.
    det_draws = draws_of(trainer.noise, "normal", args.seed + 5)
    runs = {sparse: mfp_steps(dev, mode_cfg("float32"), targs, trainer.noise, batches,
                              det_draws, read_counts, seed=args.seed, shared=True,
                              sparse=sparse, plain=False) for sparse in (True, False)}
    max_d = max(float((runs[True][1][n] - p).abs().max()) for n, p in runs[False][1].items())
    check(f"pf-shared f32: {PARITY_STEPS} steps, K7 vs the dense route (K5 + K1 on emb)",
          max_d == 0.0 and torch.equal(runs[True][0], runs[False][0])
          and runs[True][2]["sparse_adamw"] == PARITY_STEPS
          and runs[False][2]["sparse_adamw"] == 0,
          param_max_abs=max_d, losses_k7=runs[True][0].tolist(),
          losses_dense=runs[False][0].tolist(), launches_k7=runs[True][2],
          launches_dense=runs[False][2])
    del runs

    # 5 steps through the kernels against the plain versions: this path in
    # bf16 and f32; then the other modes in bf16
    base = dict(read_counts=read_counts, seed=args.seed)
    small = [{k: v[:FULL_BATCH] for k, v in b.items()} for b in batches]
    cases = [
        ("pf-shared bfloat16", mode_cfg("bfloat16"), trainer.noise, batches, draws, True, True),
        ("pf-shared float32", mode_cfg("float32"), trainer.noise, batches, draws, True, True),
        ("global shared k=25 bfloat16", mode_cfg("bfloat16", MFP_NEG, False), mfp["noise"],
         batches, draws_of(mfp["noise"], "randint", args.seed + 6, MFP_NEG), True, True),
        ("per-field per-position k=25 bfloat16", mode_cfg("bfloat16", MFP_NEG),
         trainer.noise, batches,
         draws_of(trainer.noise, "randint", args.seed + 7, MFP_NEG, shared=False),
         False, False),
        (f"full loss batch {FULL_BATCH} bfloat16",
         mode_cfg("bfloat16", MFP_NEG, False, "full"), mfp["noise"], small,
         draws_of(mfp["noise"], "randint", args.seed + 8, shared=False, full=True,
                  batch=FULL_BATCH), False, False),
    ]
    for name, c, tables, bs, ds, shared, sparse in cases:
        (k_loss, k_params, launched), (p_loss, p_params, _) = (
            mfp_steps(dev, c, targs, tables, bs, ds, shared=shared, sparse=sparse,
                      plain=plain, **base) for plain in (False, True))
        check(f"{name}: K7 launched in every step of a sparse run only",
              launched["sparse_adamw"] == (len(bs) if sparse else 0), launched=launched)
        parity_check(f"{name}: {PARITY_STEPS} steps, kernels vs plain versions",
                     c.compute_dtype, MFP_LR, k_loss, p_loss, k_params, p_params,
                     dict(models.from_config(c, torch.Generator().manual_seed(args.seed))
                          .named_parameters()))
        del k_params, p_params

    # step time and where it goes
    step = trainer.train_step
    for b in batches[:3]:
        step(b)
    torch.cuda.synchronize()
    timed = 20
    t0 = time.perf_counter()
    for i in range(timed):
        step(batches[i % PARITY_STEPS])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    emit("mfp_pf_shared_time", compute_dtype="bfloat16", batch=TRAIN_BATCH, k=PFS_NEG,
         step_ms=step_ms, examples_per_s=TRAIN_BATCH / step_ms * 1e3,
         trainer_window_time_cost=[w["time_cost"] for w in trainer.train_windows])
    prof_steps = 5
    prof = profile(lambda: [step(batches[i]) for i in range(prof_steps)], top_n=16)
    emit("mfp_pf_shared_profile", compute_dtype="bfloat16", steps=prof_steps,
         busy_ms_per_step=prof["device_busy_ms"] / prof_steps,
         **kernel_ms_per_step(prof, prof_steps), **prof)
    del trainer

    # today's path against the new default, on the same batches; parameters
    # compared on a pair drawing masked positions without repeats ('normal'):
    # the encoder's masked-position gather adds into one element through
    # atomics in its backward where a row repeats a position, in any order
    def make(resident, spc, sampling="randint"):
        return Trainer(models.from_config(cfg_s, torch.Generator().manual_seed(args.seed)),
                       cfg_s, dataclasses.replace(
                           targs, num_train_epochs=3, device_resident_data=resident,
                           steps_per_call=spc, sampling_method=sampling), data)

    path_phase(f"mfp pf-shared k={PFS_NEG} bfloat16", make,
               bits_make=lambda resident, spc: make(resident, spc, "normal"))
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, k7_err=k7_err, k8_err=k8_err["target fold"],
                k7_inputs=captured["k7"], k7_valid=valid, k8_inputs=k8_inputs,
                k4_ids=dict(targets=targets, noise=draws[0].noise))


def finetune_phase(args, dev, cfg, data, ckpt, source, reset_counts, read_counts) -> None:
    """9. Supervised DCNv2 (run_script/run_DCNv2_finetune.sh) from the
    `source` (MFP or RFD) checkpoint: the backbone's 13 tensors loaded, the
    pretraining head's 4 skipped."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.config import TrainingArguments
    from map_tpu_torch.train.trainer import Trainer

    cfg_f = dataclasses.replace(cfg, compute_dtype="bfloat16")
    targs = TrainingArguments(
        output_dir=os.path.join(os.path.dirname(os.path.dirname(ckpt)), "finetune"),
        dataset_name="in-memory", data_dir="", per_device_train_batch_size=TRAIN_BATCH,
        per_device_eval_batch_size=EVAL_BATCH, learning_rate=LR,
        weight_decay=WEIGHT_DECAY, lr_sched="const", num_train_epochs=1,
        logging_steps=10, compute_dtype="bfloat16", seed=args.seed, finetune=True,
        pretrained_model_path=ckpt)
    trainer = Trainer(models.from_config(cfg_f, torch.Generator().manual_seed(args.seed)),
                      cfg_f, targs, data)
    check(f"finetune from {source}: 13 tensors loaded, 4 skipped",
          trainer.finetune_counts == (13, 4), loaded_skipped=trainer.finetune_counts)
    reset_counts()
    t0 = time.perf_counter()
    trainer.train()
    test = trainer.test()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = trainer.launches_run(read_counts())
    steps = trainer.global_step
    eval_batches = 2 * -(-EVAL_ROWS // EVAL_BATCH)
    expected = {"embedding_gather": steps + eval_batches,
                "cross_net": steps + eval_batches, "scatter_add": steps,
                "fused_adamw": steps * k1_launches_a_step(trainer.optimizer),
                "scatter_unique_sorted": 0, "block_cumsum": 0, "sparse_adamw": 0,
                "field_block_gather": 0, "field_block_scatter": 0}
    emit("finetune", source=source, compute_dtype="bfloat16", steps=steps, wall_s=wall,
         loaded_skipped=trainer.finetune_counts, windows=trainer.train_windows,
         eval_auc_logloss=trainer.eval_metrics, test=test, launches=launches,
         expected_launches=expected, graphs=graph_replays(trainer))
    check(f"finetune from {source}: eval AUC > 0.6", trainer.eval_metrics[0][0] > 0.6,
          eval_auc=trainer.eval_metrics[0][0])
    check(f"finetune from {source}: launches", launches == expected)


def rfd_args(output_dir: str, seed: int, **kw):
    """run_script/run_DCNv2_RFD.sh's flags, bf16, batch TRAIN_BATCH, the
    K6b backward."""
    from map_tpu_torch.config import TrainingArguments

    return TrainingArguments(
        output_dir=output_dir, dataset_name="in-memory", data_dir=output_dir,
        per_device_train_batch_size=TRAIN_BATCH, per_device_eval_batch_size=EVAL_BATCH,
        learning_rate=MFP_LR, weight_decay=MFP_WD, lr_sched="cosine", num_train_epochs=1,
        logging_steps=10, mask_ratio=MFP_MASK_RATIO, sampling_method="randint",
        pretrain=True, pt_type="RFD", RFD_replace="Unigram", hybrid_mode="bwd_pallas",
        compute_dtype="bfloat16", seed=seed, **kw)


def rfd_step_fn(dev, cfg, targs, seed: int, plain: bool = False):
    """An RFD train step of `cfg` from the weights of `seed`, its AdamW
    through K1 or (plain) its plain version -> (model, step)."""
    import torch

    from map_tpu_torch.ops import fused_adamw
    from map_tpu_torch.train.optimizer import build_optimizer
    from map_tpu_torch.train.train_step import make_rfd_steps

    m = seeded_model(dev, cfg, seed)
    opt, _ = build_optimizer(
        m, targs, 100, 0,
        update=fused_adamw.fused_adamw_leaves_plain if plain else fused_adamw.fused_adamw_leaves)
    step, _ = make_rfd_steps(m, opt, cfg, MFP_MASK_RATIO, "randint", "Unigram",
                             torch.Generator(device=dev), dev)
    return m, step


def rfd_steps(dev, cfg, targs, batches, draws, read_counts, *, seed: int, plain: bool):
    """RFD steps of `cfg` from the weights of `seed`, one per (batch, draws),
    through the kernels or (plain) through their plain versions -> (losses
    (n,), {name: parameter or buffer}, launches during the steps)."""
    import torch

    m, step = rfd_step_fn(dev, cfg, targs, seed, plain)
    losses, launched = launched_during(read_counts, lambda: torch.stack(
        [step(b, d)["loss"] for b, d in zip(batches, draws)]).cpu(), plain)
    return losses, model_state(m), launched


def rfd_phase(args, dev, cfg, data, reset_counts, read_counts) -> dict:
    """7b. RFD pretraining (Unigram) in bf16 under the K6b backward
    (`--hybrid_mode=bwd_pallas`) through the Trainer; kernels-vs-plain
    parity; bwd_pallas against fwd, bit-equal in f32; step times in both
    modes and profiles. Returns what the finetune, times and summary phases
    read."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.data.loader import Batcher
    from map_tpu_torch.objectives.corruption import draw_rfd, mask_num_of
    from map_tpu_torch.train.trainer import Trainer

    _, _, vocab = field_blocks()
    num_fields = len(FIELD_SIZES)
    mask_num = mask_num_of(num_fields, MFP_MASK_RATIO)
    work = tempfile.mkdtemp(prefix="chip_smoke_rfd_")

    def rfd_cfg(dname, mode="bwd_pallas"):
        return dataclasses.replace(cfg, compute_dtype=dname, pretrain=True, pt_type="RFD",
                                   RFD_replace="Unigram", proj_size=MFP_PROJ,
                                   hybrid_mode=mode)

    cfg_r = rfd_cfg("bfloat16")
    targs = rfd_args(os.path.join(work, "pretrain"), args.seed)
    trainer = Trainer(models.from_config(cfg_r, torch.Generator().manual_seed(args.seed)),
                      cfg_r, targs, data)
    num_params = len(list(trainer.model.parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.RFD_pretrain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = trainer.launches_run(read_counts())
    steps = trainer.global_step
    eval_batches = -(-EVAL_ROWS // EVAL_BATCH)
    # a train step: K4 and K2 forward, K3 on the 3 big fields' rows and K6b
    # on the 21 small fields' rows backward, one K1 launch for every parameter
    expected = {"embedding_gather": steps + eval_batches,
                "cross_net": steps + eval_batches, "scatter_add": steps,
                "fused_adamw": steps * k1_launches_a_step(trainer.optimizer),
                "scatter_unique_sorted": 0, "block_cumsum": 0, "sparse_adamw": 0,
                "field_block_gather": 0, "field_block_scatter": steps}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = trainer.RFD_pretrain_eval()  # the last eval again: its pos_ratio
    losses = [w["window_rfd_loss"] for w in trainer.train_windows]
    emit("rfd_training", compute_dtype="bfloat16", hybrid_mode="bwd_pallas", steps=steps,
         batch=TRAIN_BATCH, wall_s=wall, windows=trainer.train_windows, eval=ev,
         launches=launches, expected_launches=expected, graphs=graph_replays(trainer),
         num_params=num_params,
         peak_mem_gb=peak_gb)
    check(f"rfd: {args.train_steps} steps", steps == args.train_steps)
    check("rfd: 17 parameters", num_params == 17)
    check("rfd: window loss finite and falling",
          all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          first_window_loss=losses[0], last_window_loss=losses[-1])
    # the drawn ids are independent, so only each field's prior is learnable:
    # the all-"original" guess scores 1 - pos_ratio
    floor = 1.0 - ev["eval_pos_ratio"] - 0.01
    check("rfd: eval accuracy at least 1 - pos_ratio - 0.01", ev["eval_rfd_acc"] >= floor,
          eval_rfd_acc=ev["eval_rfd_acc"], floor=floor)
    check("rfd: launches, K6b, K3 and K1 once a step", launches == expected
          and k1_launches_a_step(trainer.optimizer) == 1)
    ckpt = os.path.join(targs.output_dir, f"{steps}.model")
    check("rfd: checkpoint at the last step", os.path.exists(ckpt))

    batches = list(Batcher(data.X["train"], data.Y["train"], TRAIN_BATCH, shuffle=True,
                           seed=args.seed, noise_source=data.X["train"],
                           noise_rows_per_example=mask_num).epoch(0))[:PARITY_STEPS]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    draws = [draw_rfd(gen, TRAIN_BATCH, num_fields, mask_num, "randint", "Unigram",
                      vocab, dev) for _ in batches]
    # 5 steps through the kernels against the plain versions
    for dname in ("bfloat16", "float32"):
        (k_loss, k_params, launched), (p_loss, p_params, _) = (
            rfd_steps(dev, rfd_cfg(dname), targs, batches, draws, read_counts,
                      seed=args.seed, plain=plain) for plain in (False, True))
        check(f"rfd {dname}: K6b launched once a step", launched["field_block_scatter"]
              == PARITY_STEPS, launched=launched)
        parity_check(f"rfd {dname}: {PARITY_STEPS} steps, kernels vs plain versions",
                     dname, MFP_LR, k_loss, p_loss, k_params, p_params,
                     dict(models.from_config(rfd_cfg(dname), torch.Generator().manual_seed(
                         args.seed)).named_parameters()))
        del k_params, p_params
    # 5 f32 steps under bwd_pallas against 5 under fwd, from the same weights
    # and draws: the drawn ids hold no reserved id, so every table row is
    # summed in the same order either way
    runs = {mode: rfd_steps(dev, rfd_cfg("float32", mode), targs, batches, draws,
                            read_counts, seed=args.seed, plain=False)
            for mode in ("bwd_pallas", "fwd")}
    max_d = max(float((runs["bwd_pallas"][1][n] - p).abs().max())
                for n, p in runs["fwd"][1].items())
    check(f"rfd f32: {PARITY_STEPS} steps, bwd_pallas (K3 + K6b) vs fwd (flat K3)",
          max_d == 0.0 and torch.equal(runs["bwd_pallas"][0], runs["fwd"][0])
          and runs["bwd_pallas"][2]["field_block_scatter"] == PARITY_STEPS
          and runs["fwd"][2]["field_block_scatter"] == 0,
          param_max_abs=max_d, losses_bwd_pallas=runs["bwd_pallas"][0].tolist(),
          losses_fwd=runs["fwd"][0].tolist(), launches_bwd_pallas=runs["bwd_pallas"][2],
          launches_fwd=runs["fwd"][2])
    del runs

    # step time and where it goes, in both modes (bf16)
    for mode in ("bwd_pallas", "fwd"):
        step = (trainer.train_step if mode == "bwd_pallas"
                else rfd_step_fn(dev, rfd_cfg("bfloat16", mode), targs, args.seed)[1])
        for i in range(3):
            step(batches[i], draws[i])
        torch.cuda.synchronize()
        timed = 20
        t0 = time.perf_counter()
        for i in range(timed):
            step(batches[i % PARITY_STEPS], draws[i % PARITY_STEPS])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / timed * 1e3
        prof_steps = 5
        prof = profile(lambda: [step(batches[i], draws[i]) for i in range(prof_steps)],
                       top_n=14)
        emit("rfd_training_time", compute_dtype="bfloat16", hybrid_mode=mode,
             batch=TRAIN_BATCH, step_ms=step_ms, examples_per_s=TRAIN_BATCH / step_ms * 1e3,
             busy_ms_per_step=prof["device_busy_ms"] / prof_steps,
             **kernel_ms_per_step(prof, prof_steps), **prof)
    del trainer

    # today's path against the new default, on the same batches, both modes
    for mode in ("bwd_pallas", "fwd"):
        def make(resident, spc, mode=mode):
            c = rfd_cfg("bfloat16", mode)
            return Trainer(models.from_config(c, torch.Generator().manual_seed(args.seed)),
                           c, dataclasses.replace(
                               targs, hybrid_mode=mode, num_train_epochs=3,
                               device_resident_data=resident, steps_per_call=spc), data)

        path_phase(f"rfd bfloat16 {mode}", make)
    return dict(launches=launches, ckpt=ckpt, work=work)


# tables a model gathers from and scatters into a step: FM's and DeepFM's
# LR table beside the embedding, FGCNN's fg_embed beside it (K4, K3 and,
# under bwd_pallas, K6b once a table)
ZOO_TABLES = {"fm": 2, "deepfm": 2, "fgcnn": 2}
# the field-blocked tables (E = 16) among them, whose gradient K6b takes
# under bwd_pallas: FGCNN's two; the LR table (E = 1) of FM and DeepFM goes
# through K3 whole, as map_tpu's LRLayer takes its rows with `jnp.take`
ZOO_BLOCKED_TABLES = {"fgcnn": 2}


def zoo_phase(args, dev, cfg, data, mfp, reset_counts, read_counts) -> dict:
    """8e. The rest of the zoo (LR, FM, DNN, DeepFM, xDeepFM, AutoInt,
    Transformer, FiGNN, FGCNN) at full width, each model in turn:
    - 5 supervised steps through the kernels against the plain versions
      (`parity_check`, FGCNN's BatchNorm running statistics among what it
      holds), bf16 and f32, with K1, K3 and K4 launched (K3 and K4 once a
      table a step in FiGNN and FGCNN);
    - the seven pretrain-capable ones: 5 MFP per-position steps the same
      way (phase 8's noise, batches and draws), and the finetune restore's
      loaded / skipped counts from an MFP checkpoint of the model;
    - the seven pretrain-capable ones: 5 RFD steps under bwd_pallas the
      same way, K6b once a field-blocked table a step;
    - the two paths of its supervised bf16 cell (`path_phase`: wall, busy
      and idle a step, the 16-step bit check over parameters and buffers,
      the launches, counted from 0 before it);
    - `Predictor` over --rows rows at batch 10000 in bf16: rows/s, its first
      chunk's logits against the plain versions'.
    The models' knobs are `validate.ZOO_KNOBS`, which the zoo's validation
    runs too. Returns {model: its graph path's launches} for the kernels
    line."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.validate import SUPERVISED_ONLY, ZOO_KNOBS
    from map_tpu_torch.config import TrainingArguments
    from map_tpu_torch.data.loader import Batcher
    from map_tpu_torch.objectives.corruption import draw_rfd, mask_num_of
    from map_tpu_torch.serve import Predictor
    from map_tpu_torch.train import checkpoints
    from map_tpu_torch.train.train_step import draw_mfp
    from map_tpu_torch.train.trainer import Trainer

    _, _, vocab = field_blocks()
    num_fields = len(FIELD_SIZES)
    mask_num = mask_num_of(num_fields, MFP_MASK_RATIO)
    work = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    batches = list(Batcher(data.X["train"], data.Y["train"], TRAIN_BATCH, shuffle=True,
                           seed=args.seed).epoch(0))[:PARITY_STEPS]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    mfp_draws = [draw_mfp(gen, mfp["noise"], TRAIN_BATCH, num_fields, mask_num, MFP_NEG,
                          "randint") for _ in batches]
    rfd_batches = list(Batcher(data.X["train"], data.Y["train"], TRAIN_BATCH, shuffle=True,
                               seed=args.seed, noise_source=data.X["train"],
                               noise_rows_per_example=mask_num).epoch(0))[:PARITY_STEPS]
    rfd_draws = [draw_rfd(gen, TRAIN_BATCH, num_fields, mask_num, "randint", "Unigram",
                          vocab, dev) for _ in rfd_batches]
    score_ids = draw_ids(np.random.default_rng(args.seed + 5), args.rows)
    sup_args = TrainingArguments(
        output_dir=work, dataset_name="in-memory", data_dir="",
        per_device_train_batch_size=TRAIN_BATCH, per_device_eval_batch_size=EVAL_BATCH,
        learning_rate=LR, weight_decay=WEIGHT_DECAY, lr_sched="const", num_train_epochs=1,
        logging_steps=10, compute_dtype="bfloat16", seed=args.seed)
    mfp_targs = mfp_args(work, args.seed)
    rfd_targs = rfd_args(work, args.seed)
    graph_launches = {}
    for name, knobs in ZOO_KNOBS.items():
        zc = dataclasses.replace(cfg, model_name=name, **knobs)

        def fresh(c):
            return dict(models.from_config(c, torch.Generator().manual_seed(
                args.seed)).named_parameters())

        # 5 supervised steps, kernels against plain versions
        for dname in ("bfloat16", "float32"):
            c = dataclasses.replace(zc, compute_dtype=dname)
            (k_loss, k_params, launched), (p_loss, p_params, _) = (
                supervised_steps(dev, c, sup_args, batches, read_counts, seed=args.seed,
                                 steps=args.train_steps, plain=plain)
                for plain in (False, True))
            check(f"zoo {name} {dname}: K1 once a step, K3 and K4 at least once a step",
                  launched["fused_adamw"] == PARITY_STEPS
                  and launched["scatter_add"] >= PARITY_STEPS
                  and launched["embedding_gather"] >= PARITY_STEPS, launched=launched)
            if name in ("fignn", "fgcnn"):
                tables = ZOO_TABLES.get(name, 1)
                check(f"zoo {name} {dname}: K3 and K4 {tables}x a step (a table each)",
                      launched["scatter_add"] == tables * PARITY_STEPS
                      and launched["embedding_gather"] == tables * PARITY_STEPS,
                      launched=launched)
            parity_check(f"zoo {name} {dname}: {PARITY_STEPS} steps, kernels vs plain "
                         "versions", dname, LR, k_loss, p_loss, k_params, p_params, fresh(c))
            del k_params, p_params

        if name not in SUPERVISED_ONLY:
            # 5 MFP steps, kernels against plain versions
            for dname in ("bfloat16", "float32"):
                c = dataclasses.replace(
                    zc, compute_dtype=dname, pretrain=True, pt_type="MFP",
                    proj_size=MFP_PROJ, pt_neg_num=MFP_NEG, nce_loss_type="nce",
                    feat_count=mfp["feat_count"], hybrid_mode="matmul")
                (k_loss, k_params, launched), (p_loss, p_params, _) = (
                    mfp_steps(dev, c, mfp_targs, mfp["noise"], batches, mfp_draws,
                              read_counts, seed=args.seed, shared=False, sparse=False,
                              plain=plain) for plain in (False, True))
                check(f"zoo {name} mfp {dname}: K5 and K8 once a step",
                      launched["scatter_unique_sorted"] == PARITY_STEPS
                      and launched["block_cumsum"] == PARITY_STEPS, launched=launched)
                parity_check(f"zoo {name} mfp {dname}: {PARITY_STEPS} steps, kernels vs "
                             "plain versions", dname, MFP_LR, k_loss, p_loss, k_params,
                             p_params, fresh(c))
                mfp_state = k_params
                del p_params
            # the finetune restore from an MFP checkpoint of the model: the
            # f32 run's weights (FGCNN's running statistics moved by its steps)
            ckpt_dir = os.path.join(work, f"{name}_mfp")
            sd = {n: t.cpu() for n, t in mfp_state.items()}
            del k_params, mfp_state
            ckpt = checkpoints.save_model(sd, ckpt_dir, 1)
            c_ft = dataclasses.replace(zc, compute_dtype="bfloat16")
            ft = Trainer(models.from_config(c_ft, torch.Generator().manual_seed(args.seed + 1)),
                         c_ft, dataclasses.replace(sup_args, finetune=True,
                                                   pretrained_model_path=ckpt), data)
            expected = (len(sd) - 4, 4)
            emit("zoo_finetune_restore", model=name, loaded_skipped=ft.finetune_counts,
                 checkpoint_tensors=len(sd))
            check(f"zoo {name}: finetune from MFP, {expected[0]} tensors loaded, "
                  f"{expected[1]} skipped", ft.finetune_counts == expected,
                  loaded_skipped=ft.finetune_counts)
            restored = ft.model.state_dict()
            stats = [n for n in sd if ".running_" in n]
            check(f"zoo {name}: the finetuned model holds the checkpoint's backbone, "
                  f"{len(stats)} running statistics among it",
                  all(torch.equal(restored[n].cpu(), t) for n, t in sd.items()
                      if n in restored)
                  and all(not torch.equal(sd[n], torch.zeros_like(sd[n]))
                          and not torch.equal(sd[n], torch.ones_like(sd[n]))
                          for n in stats), running_statistics=len(stats))
            del ft, sd, restored
            shutil.rmtree(ckpt_dir, ignore_errors=True)

        if name not in SUPERVISED_ONLY:
            for dname in ("bfloat16", "float32"):
                c = dataclasses.replace(zc, compute_dtype=dname, pretrain=True,
                                        pt_type="RFD", RFD_replace="Unigram",
                                        proj_size=MFP_PROJ, hybrid_mode="bwd_pallas")
                (k_loss, k_params, launched), (p_loss, p_params, _) = (
                    rfd_steps(dev, c, rfd_targs, rfd_batches, rfd_draws, read_counts,
                              seed=args.seed, plain=plain) for plain in (False, True))
                tables = ZOO_BLOCKED_TABLES.get(name, 1)
                check(f"zoo {name} rfd {dname}: K6b launched {tables}x a step (a "
                      "field-blocked table each)",
                      launched["field_block_scatter"] == tables * PARITY_STEPS,
                      launched=launched)
                parity_check(f"zoo {name} rfd {dname}: {PARITY_STEPS} steps, kernels vs "
                             "plain versions", dname, MFP_LR, k_loss, p_loss, k_params,
                             p_params, fresh(c))
                del k_params, p_params

        # today's path against the graph path, supervised bf16
        c_sup = dataclasses.replace(zc, compute_dtype="bfloat16")

        def make(resident, spc, c_sup=c_sup):
            return Trainer(models.from_config(c_sup, torch.Generator().manual_seed(args.seed)),
                           c_sup, dataclasses.replace(
                               sup_args, num_train_epochs=3, device_resident_data=resident,
                               steps_per_call=spc), data)

        reset_counts()
        path = path_phase(f"zoo {name} bfloat16", make)
        graph = path["graph"]
        graph_launches[name] = graph["launches"]
        steps = sum(graph["steps"])
        check(f"zoo {name}: the graph path launched K1 once a step, K3 and K4 at least "
              "once a step", graph["launches"]["fused_adamw"] == steps
              and graph["launches"]["scatter_add"] >= steps
              and graph["launches"]["embedding_gather"] >= steps,
              launches=graph["launches"], steps=steps)
        if name == "fgcnn":  # an epoch on the graph path, its running statistics moved
            t = make("auto", GRAPH_SPC)
            b = t._prepare_training()
            for _ in t.train_epoch(b, 0):
                pass
            torch.cuda.synchronize()
            carry_check("fgcnn (one epoch on the graph path)", t.model.state_dict(), t.config)
            del t, b
        if name in ("fignn", "fgcnn"):
            tables = ZOO_TABLES.get(name, 1)
            check(f"zoo {name}: the graph path launched K3 and K4 {tables}x a step",
                  graph["launches"]["scatter_add"] == tables * steps
                  and graph["launches"]["embedding_gather"] == tables * steps,
                  launches=graph["launches"], steps=steps)

        # serving: the pipelined Predictor, bf16 timed, both dtypes bit-equal
        # to an eager forward of the same chunks
        model_dir = os.path.join(work, f"{name}_serve")
        m = models.from_config(c_sup, torch.Generator().manual_seed(args.seed))
        checkpoints.save_model(m.state_dict(), model_dir, 1)
        for dname in ("bfloat16", "float32"):
            dataclasses.replace(c_sup, compute_dtype=dname).save(model_dir)
            pred = Predictor(model_dir, 1, batch_size=args.batch)
            first = score_ids[:args.batch]
            logits0 = pred.predict_logits(first)  # the warm-up chunk
            with torch.inference_mode(), plain_layers():
                ref = pred.model(torch.from_numpy(first).to(dev)).reshape(-1).float().cpu()
            err = compare(f"zoo {name} serving logits {dname}, {args.batch} rows",
                          torch.from_numpy(logits0), ref, *TOL_LOGITS[dname])
            seconds, logits = [], None
            for _ in range(SERVING_PASSES if dname == "bfloat16" else 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = pred.predict_logits(score_ids)
                seconds.append(time.perf_counter() - t0)
            eager_bits_check(f"zoo {name} serving {dname}", pred, score_ids, logits)
            emit("zoo_serving", model=name, compute_dtype=dname, rows=args.rows,
                 batch=args.batch, seconds=seconds, rows_per_s=args.rows / min(seconds),
                 max_abs_err=err, num_params=len(list(m.parameters())), card=smi_line())
            del pred
        del m
        shutil.rmtree(model_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return graph_launches


# same-data validation (map_tpu_torch/validate.py): validation/run_tpu.sh's
# five stages on the 400,000-row synthazu set, one seed
VALIDATION_SEED = 42
VALIDATION_ROWS = 400_000
RESUME_SAVE_STEPS = 20  # crossed inside an 8-step call (the call ending at 24)


def validation_launches(kind: str, steps: int, evals: int, k1_per_step: int) -> dict:
    """The launches of a validation stage of `steps` train steps and `evals`
    eval batches: K4 and K2 on every batch (K4 twice in MFP: the input and
    the decoder's candidates), K3 and K1 once a step (the default `fwd`
    lookup, or MFP's `matmul` with K3 on the big fields), K5 and K8 once an
    MFP step."""
    mfp = kind == "mfp"
    return {"embedding_gather": (2 if mfp else 1) * (steps + evals),
            "cross_net": steps + evals, "scatter_add": steps,
            "fused_adamw": steps * k1_per_step,
            "scatter_unique_sorted": steps if mfp else 0,
            "block_cumsum": steps if mfp else 0, "sparse_adamw": 0,
            "field_block_gather": 0, "field_block_scatter": 0}


def validation_phase(args, dev, reset_counts, read_counts) -> dict:
    """10b. The five stages of validation/run_tpu.sh (scratch, MFP, RFD, and
    the finetunes from MFP and RFD) at seed 42 on synthazu, through
    `validate.run_stage` (the Trainer, bf16, the graph path): each stage's
    metric and loss beside map_tpu's mean and its single-run band
    2 sqrt(s² + s²/n) + eps, failing only outside twice that band; the
    launches of each stage (from 0 before it); the finetune counts; then 5
    steps of each stage's mode (supervised `fwd`, MFP `matmul` and
    `bwd_pallas`, RFD `fwd`) on this data through the kernels against the
    plain versions. Returns the path's launches, the data and the stages'
    Trainers."""
    import torch

    from map_tpu_torch import validate
    from map_tpu_torch.data import synth
    from map_tpu_torch.data.loader import Batcher
    from map_tpu_torch.objectives.corruption import draw_rfd, mask_num_of
    from map_tpu_torch.train.train_step import draw_mfp

    t0 = time.perf_counter()
    data = synth.in_memory(synth.generate_realistic_arrays(
        num_rows=VALIDATION_ROWS, seed=validate.DATA_SEED), pretrain=True)
    emit("validation_data", rows=VALIDATION_ROWS, seed=validate.DATA_SEED,
         input_size=data.input_size, num_fields=data.num_fields,
         train_rows=len(data.Y["train"]), seconds=time.perf_counter() - t0)
    check("validation: synthazu has 101,178 ids in 24 fields",
          (data.input_size, data.num_fields) == (101_178, 24))
    work = tempfile.mkdtemp(prefix="chip_smoke_validation_")
    total = {}
    trainers = {}
    for stage in validate.plan(validate.BASE_STAGES):
        reset_counts()
        line, trainer = validate.run_stage(stage, VALIDATION_SEED, data, work, None, {})
        launches = trainer.launches_run(read_counts())
        epochs = trainer.args.num_train_epochs
        evals = sum(-(-len(data.Y[s]) // trainer.args.eval_batch_size)
                    for s in (["valid"] * epochs + (["test"] if stage.kind == "supervised"
                                                    else [])))
        expected = validation_launches(stage.kind, line["steps"], evals,
                                       k1_launches_a_step(trainer.optimizer))
        bands = []
        for name, value, (mean, std, n, eps) in zip(
                validate.METRICS[stage.kind], (line["metric"], line["loss"]),
                validate.reference_rows(stage)):
            band = validate.single_run_band(std, n, eps)
            bands.append(dict(metric=name, port=value, map_tpu_mean=mean, map_tpu_std=std,
                              delta=value - mean, band=band,
                              within_band=abs(value - mean) <= band))
        emit("validation", card=smi_line(), **line, bands=bands, launches=launches,
             expected_launches=expected, graphs=graph_replays(trainer))
        for b in bands:
            check(f"validation {stage.name}: {b['metric']} within twice the single-run "
                  f"band of map_tpu's mean", abs(b["delta"]) <= 2 * b["band"], **b)
        check(f"validation {stage.name}: launches", launches == expected)
        if stage.source:
            check(f"validation {stage.name}: 13 tensors loaded, 4 skipped",
                  tuple(trainer.finetune_counts) == (13, 4),
                  loaded_skipped=trainer.finetune_counts)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if stage.name in ("scratch", "mfp", "rfd"):  # what the later checks read
            trainers[stage.name] = trainer
        del trainer

    # 5 steps of each stage's mode on this data, kernels vs plain versions
    num_fields, vocab = data.num_fields, data.input_size
    mask_num = mask_num_of(num_fields, MFP_MASK_RATIO)
    batches = list(Batcher(data.X["train"], data.Y["train"], TRAIN_BATCH, shuffle=True,
                           seed=VALIDATION_SEED, noise_source=data.X["train"],
                           noise_rows_per_example=mask_num).epoch(0))[:PARITY_STEPS]
    seed = VALIDATION_SEED

    def p0(cfg_):
        return dict(seeded_model(dev, cfg_, seed).named_parameters())

    sup = trainers["scratch"]
    (k_loss, k_params, _), (p_loss, p_params, _) = (
        supervised_steps(dev, sup.config, sup.args, batches, read_counts, seed=seed,
                         steps=PARITY_STEPS, plain=plain) for plain in (False, True))
    parity_check(f"validation scratch: {PARITY_STEPS} steps on synthazu, kernels vs plain",
                 "bfloat16", LR, k_loss, p_loss, k_params, p_params, p0(sup.config))
    mfp = trainers["mfp"]
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    draws = [draw_mfp(gen, mfp.noise, TRAIN_BATCH, num_fields, mask_num, MFP_NEG, "randint")
             for _ in batches]
    for mode in ("matmul", "bwd_pallas"):
        cfg_m = dataclasses.replace(mfp.config, hybrid_mode=mode)
        (k_loss, k_params, launched), (p_loss, p_params, _) = (
            mfp_steps(dev, cfg_m, mfp.args, mfp.noise, batches, draws, read_counts,
                      seed=seed, shared=False, sparse=False, plain=plain)
            for plain in (False, True))
        check(f"validation mfp {mode}: K5 and K8 once a step"
              + (", K6b once a step" if mode == "bwd_pallas" else ""),
              launched["scatter_unique_sorted"] == PARITY_STEPS
              and launched["block_cumsum"] == PARITY_STEPS
              and launched["field_block_scatter"] == (PARITY_STEPS if mode == "bwd_pallas"
                                                       else 0), launched=launched)
        parity_check(f"validation mfp {mode}: {PARITY_STEPS} steps on synthazu, kernels "
                     "vs plain", "bfloat16", MFP_LR, k_loss, p_loss, k_params, p_params,
                     p0(cfg_m))
        del k_params, p_params
    rfd = trainers["rfd"]
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    draws = [draw_rfd(gen, TRAIN_BATCH, num_fields, mask_num, "randint", "Unigram", vocab,
                      dev) for _ in batches]
    (k_loss, k_params, _), (p_loss, p_params, _) = (
        rfd_steps(dev, rfd.config, rfd.args, batches, draws, read_counts, seed=seed,
                  plain=plain) for plain in (False, True))
    parity_check(f"validation rfd: {PARITY_STEPS} steps on synthazu, kernels vs plain",
                 "bfloat16", MFP_LR, k_loss, p_loss, k_params, p_params, p0(rfd.config))
    return {"launches": total, "data": data, "trainers": trainers, "work": work}


def zoo_stage_launches_ok(kind: str, launches: dict, steps: int, batches: int,
                          k1_per_step: int) -> bool:
    """A zoo validation stage's launches: K1 once a step, K4 at least once a
    batch (twice in MFP), K2 never (DCNv2's alone), K5 and K8 once an MFP
    step and never otherwise."""
    mfp = kind == "mfp"
    return (launches["fused_adamw"] == steps * k1_per_step
            and launches["embedding_gather"] >= (2 if mfp else 1) * batches
            and launches["cross_net"] == 0
            and launches["scatter_unique_sorted"] == (steps if mfp else 0)
            and launches["block_cumsum"] == (steps if mfp else 0))


def zoo_validation_phase(args, dev, reset_counts, read_counts) -> dict:
    """10b'. Each zoo model's validation stages at seed 42 on 120,000
    synthazu rows through `validate.run_stage` (bf16, the graph path): each
    stage's metric and loss beside map_tpu's CPU band
    (`validate.MAP_TPU_ZOO_CPU_BAND`), failing only outside twice the
    single-run band; its launches (`zoo_stage_launches_ok`); the finetune
    counts. Returns the launches summed over the stages."""
    import torch

    from map_tpu_torch import validate
    from map_tpu_torch.data import synth

    t0 = time.perf_counter()
    data = synth.in_memory(synth.generate_realistic_arrays(
        num_rows=validate.ZOO_ROWS, seed=validate.DATA_SEED), pretrain=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_zoo_validation_")
    total, stages_run = {}, 0
    for model in validate.ZOO_KNOBS:
        bands_of = validate.MAP_TPU_ZOO_CPU_BAND[model]
        for stage in validate.plan(validate.model_stages(model), model=model):
            reset_counts()
            line, trainer = validate.run_stage(stage, VALIDATION_SEED, data, work, None, {},
                                               model)
            launches = trainer.launches_run(read_counts())
            epochs = trainer.args.num_train_epochs
            evals = sum(-(-len(data.Y[s]) // trainer.args.eval_batch_size)
                        for s in (["valid"] * epochs + (["test"] if stage.kind == "supervised"
                                                        else [])))
            k1 = k1_launches_a_step(trainer.optimizer)
            bands = []
            for name, value, (mean, std, n, eps) in zip(
                    validate.METRICS[stage.kind], (line["metric"], line["loss"]),
                    validate.reference_rows(stage, bands_of)):
                band = validate.single_run_band(std, n, eps)
                bands.append(dict(metric=name, port=value, map_tpu_mean=mean,
                                  map_tpu_std=std, map_tpu_n=n, delta=value - mean,
                                  band=band, within_band=abs(value - mean) <= band))
            emit("zoo_validation", card=smi_line(), **line, bands=bands, launches=launches,
                 evals=evals, k1_per_step=k1, graphs=graph_replays(trainer))
            check(f"zoo validation {model} {stage.name}: metric and loss beside map_tpu's "
                  "CPU band", len(bands) == 2, bands=bands)
            for b in bands:
                check(f"zoo validation {model} {stage.name}: {b['metric']} within twice the "
                      "single-run band of map_tpu's mean", abs(b["delta"]) <= 2 * b["band"],
                      **b)
            check(f"zoo validation {model} {stage.name}: launches (K1 once a step, K4 at "
                  "least once a batch, no K2, K5 and K8 once an MFP step)",
                  zoo_stage_launches_ok(stage.kind, launches, line["steps"],
                                        line["steps"] + evals, k1),
                  launches=launches, steps=line["steps"], evals=evals)
            if stage.source:
                check(f"zoo validation {model} {stage.name}: the finetune restored the "
                      "backbone, the pretraining head's 4 tensors skipped",
                      trainer.finetune_counts[0] > 0 and trainer.finetune_counts[1] == 4,
                      loaded_skipped=trainer.finetune_counts)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            stages_run += 1
            del trainer
        shutil.rmtree(os.path.join(work, f"s{VALIDATION_SEED}"), ignore_errors=True)
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    emit("zoo_validation_phase", models=len(validate.ZOO_KNOBS), stages=stages_run,
         rows=validate.ZOO_ROWS, seconds=seconds, launches=total, card=smi_line())
    check("zoo validation: 37 stages of the nine models", stages_run == 37,
          stages=stages_run)
    return total


class FirstEpochOnly:
    """Mixed into a Trainer: the run stops after its first epoch, as if
    killed there (its schedule still spans all its epochs)."""

    def _epochs_with_skip(self, batcher):
        yield next(super()._epochs_with_skip(batcher))


def train_state(trainer) -> dict:
    """A Trainer's parameters, buffers, moments, count and generator states."""
    return {"model": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            "mu": [m.clone() for m in trainer.optimizer.mu],
            "nu": [v.clone() for v in trainer.optimizer.nu],
            "count": trainer.optimizer.count, "step": trainer.global_step,
            "generators": [g.get_state() for g in (trainer._dropout_generator,
                                                  trainer._step_generator)
                           if g is not None]}


def resume_phase(args, dev, val) -> None:
    """10c. Resume on the graph path in bf16 (steps_per_call 8), supervised
    DCNv2 (validation/run_tpu.sh's scratch flags) and MFP per-position (its
    mfp flags: 'randint' positions, 7 masked of 24 fields), 2 epochs on
    synthazu: for MFP first two straight runs from one seed, bit-equal
    (the masked-position selection's backward adds slot by slot:
    `models/base.py:SelectMasked`); a straight run, and a run stopped after its first
    epoch with save_steps 20 (first crossed inside the call that ends at
    step 24; async checkpoints, the MFP run's fetched from a snapshot on the
    card) then resumed with --resume to 2 epochs: the parameters, buffers,
    moments, count and generator states bit-equal."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.config import build_config
    from map_tpu_torch.objectives.corruption import mask_num_of
    from map_tpu_torch.train import checkpoints
    from map_tpu_torch.train.trainer import Trainer

    from map_tpu_torch import validate

    data = val["data"]

    class Killed(FirstEpochOnly, Trainer):
        pass

    for name, stage_name, extra in (("supervised", "scratch", {}),
                                    ("mfp per-position", "mfp",
                                     dict(async_checkpoint_fetch=True))):
        stage = validate.STAGES[stage_name]
        out = os.path.join(val["work"], "resume", stage_name)

        def make(cls, sub, **kw):
            margs, targs = validate.stage_args(stage, VALIDATION_SEED, out)
            targs = dataclasses.replace(targs, output_dir=os.path.join(out, sub),
                                        num_train_epochs=2, save_steps=RESUME_SAVE_STEPS,
                                        **extra, **kw)
            cfg_ = build_config(margs, targs, data)
            return cls(models.from_config(cfg_, torch.Generator().manual_seed(
                VALIDATION_SEED)), cfg_, targs, data)

        def run(t):
            if t.config.mfp:
                t.MFP_pretrain()
            else:
                t.train()
            torch.cuda.synchronize()
            return t

        t0 = time.perf_counter()
        straight = run(make(Trainer, "straight"))
        if stage.kind == "mfp":
            # a second straight run from the same seed: 'randint' positions
            # (a field masked up to 7 times in a row), every bit the first's
            again = run(make(Trainer, "again"))
            first, second = train_state(straight), train_state(again)
            differ = [k for k in first["model"]
                      if not torch.equal(first["model"][k], second["model"][k])]
            differ += [f"{part} {i}" for part in ("mu", "nu", "generators")
                       for i, (a, b) in enumerate(zip(first[part], second[part]))
                       if not torch.equal(a, b)]
            emit("mfp_randint_two_runs", steps=straight.global_step,
                 sampling_method=straight.args.sampling_method, mask_num=mask_num_of(
                     straight.config.num_fields, straight.args.mask_ratio),
                 eval_metrics=[straight.eval_metrics, again.eval_metrics], differ=differ)
            check("mfp randint: two graph-path runs from one seed bit-equal (parameters, "
                  "moments, generator states, eval loss and accuracy)",
                  straight.args.sampling_method == "randint" and not differ
                  and straight.eval_metrics == again.eval_metrics, differ=differ)
            del again
        killed = run(make(Killed, "part"))
        saved = checkpoints.load_train_state(os.path.join(out, "part"))[1]["global_step"]
        resumed = run(make(Trainer, "part", resume=True))
        wall = time.perf_counter() - t0
        ref, got = train_state(straight), train_state(resumed)
        differ = [k for k in ref["model"] if not torch.equal(got["model"][k], ref["model"][k])]
        differ += [f"{part} {i}" for part in ("mu", "nu", "generators")
                   for i, (a, b) in enumerate(zip(got[part], ref[part]))
                   if not torch.equal(a, b)]
        emit("resume", model=name, steps=straight.global_step,
             stopped_at=killed.global_step, saved_at=saved, resumed_from=saved,
             graphs_straight=graph_replays(straight), graphs_resumed=graph_replays(resumed),
             flags=extra, wall_s=wall, differ=differ)
        check(f"resume {name}: saved at the end of a call of {GRAPH_SPC} that crossed a "
              f"multiple of {RESUME_SAVE_STEPS}, before the stop",
              saved % GRAPH_SPC == 0 and saved < killed.global_step
              and (saved - GRAPH_SPC) // RESUME_SAVE_STEPS != saved // RESUME_SAVE_STEPS,
              saved_at=saved)
        check(f"resume {name}: graph path, captured after the restore",
              resumed.multi.graphed and GRAPH_SPC in resumed.multi.graphs)
        check(f"resume {name}: parameters, buffers, moments, count and generator states "
              "bit-equal to the straight run", not differ and got["count"] == ref["count"]
              and got["step"] == ref["step"], differ=differ)
        del straight, killed, resumed


def streaming_phase(args, dev, val) -> None:
    """10d. `--streaming_auc` against the exact eval on the same weights (the
    scratch stage's), within the streaming AUC's error bound; the seven
    kinds of metrics.jsonl among the validation and resume runs; a
    `--profile_steps 2` run's trace under {output_dir}/profile."""
    import glob as glob_

    import torch

    from map_tpu_torch import models
    from map_tpu_torch.train.trainer import Trainer

    data = val["data"]
    scratch = val["trainers"]["scratch"]
    targs = dataclasses.replace(scratch.args, streaming_auc=True, finetune=False,
                                output_dir=os.path.join(val["work"], "streaming"))
    stream = Trainer(models.from_config(scratch.config), scratch.config, targs, data)
    stream.model.load_state_dict(scratch.model.state_dict())
    for split in ("valid", "test"):
        exact = scratch.eval(split, test_eval=True)
        t0 = time.perf_counter()
        got = stream.eval(split, test_eval=True)
        torch.cuda.synchronize()
        bound = stream.streaming_auc_bound
        emit("streaming", split=split, bins=stream._streaming_bins, exact=exact,
             streaming=got, bound=bound, seconds=time.perf_counter() - t0)
        check(f"streaming {split}: AUC within its error bound of the exact eval's",
              abs(got["eval_auc"] - exact["eval_auc"]) <= bound + 1e-12 and bound <= 5e-5,
              streaming=got["eval_auc"], exact=exact["eval_auc"], bound=bound)
        check(f"streaming {split}: log loss, mean logit and probability within 1e-5",
              all(abs(got[k] - exact[k]) <= 1e-5 for k in ("eval_loss", "avg_logits",
                                                           "avg_probs")))
    kinds = set()
    for path in glob_.glob(os.path.join(val["work"], "**", "metrics.jsonl"), recursive=True):
        with open(path) as f:
            kinds |= {json.loads(line)["kind"] for line in f}
    want = {"train_window", "eval", "test", "mfp_window", "mfp_eval", "rfd_window", "rfd_eval"}
    check("metrics.jsonl: the seven kinds", want <= kinds, kinds=sorted(kinds))
    targs = dataclasses.replace(scratch.args, profile_steps=2, steps_per_call=1,
                                output_dir=os.path.join(val["work"], "profiled"))
    t = Trainer(models.from_config(scratch.config, torch.Generator().manual_seed(
        VALIDATION_SEED)), scratch.config, targs, data)
    t.train()
    traces = sorted(glob_.glob(os.path.join(targs.output_dir, "profile", "*.json")))
    events = []
    if traces:
        with open(traces[0]) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    emit("profile_steps", traces=[os.path.basename(p) for p in traces], events=len(events),
         kernel_events=kernels)
    check("profile_steps 2: a trace under {output_dir}/profile with the card's kernels",
          traces == [os.path.join(targs.output_dir, "profile", "trace_4.json")]
          and kernels > 0, events=len(events), kernel_events=kernels)


GROUPED_EVAL_ROWS = 85_000  # 8 eval batches of 10000 (one group) and a padded tail
CHI_DRAWS = 10_000_000


def carry_check(name: str, state_dict, config) -> None:
    """The reverse carry of a trained model: its state_dict to map_tpu's
    variables tree (`interop/to_jax.py`), lane-packed and plain, and back
    through `state_dict_from_jax`, bit-equal."""
    import torch

    from map_tpu_torch.interop.from_jax import state_dict_from_jax
    from map_tpu_torch.interop.to_jax import variables_from_state_dict

    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    for packed in (True, False):
        tree = variables_from_state_dict(sd, config, packed=packed)
        back = state_dict_from_jax(tree, config)
        differ = [k for k in sd if k not in back or not torch.equal(back[k], sd[k])]
        leaves = {c: sum(1 for _ in _leaves(tree[c])) for c in tree}
        emit("reverse_carry", model=name, packed=packed, tensors=len(sd), leaves=leaves,
             differ=differ)
        check(f"reverse carry {name} ({'packed' if packed else 'plain'} tables): the "
              "state_dict to map_tpu's tree and back, bit-equal",
              not differ and set(back) == set(sd), differ=differ)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def grouped_eval_phase(args, dev, val, reset_counts, read_counts) -> dict:
    """10e. The eval dispatch at DCNv2's full width (the validation stages'
    trained weights: scratch, MFP per-position 'randint', RFD) on synthazu:
    eval batch 10000 over GROUPED_EVAL_ROWS rows of its train split (8
    batches, one group of 8, and a padded tail), in bf16 and f32, for the
    exact supervised eval, the streaming one, MFP and RFD: a Trainer with
    steps_per_call 8 (graphs) and one with 1 (eager), the same weights;
    after two passes each (the warm-up call and the captures), passes in
    turns (eager, grouped, grouped, eager; wall clock, rows/s), then one each with a
    synchronize before every call (host us a batch with the card idle):
    every pass's metrics bit-equal across the two; the launches that ran
    (K4 a batch, twice in MFP, K2 a batch); MFP and RFD also with their
    draws made outside and handed in (`draws`), bit-equal to the pass that
    draws them itself. Returns the phase's launches."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.objectives.corruption import draw_rfd, mask_num_of
    from map_tpu_torch.train.graph import launches_run
    from map_tpu_torch.train.train_step import draw_mfp
    from map_tpu_torch.train.trainer import Trainer
    from map_tpu_torch.utils.seeds import stream_generator

    d = val["data"]
    rows = GROUPED_EVAL_ROWS
    data = SimpleNamespace(X={"train": d.X["train"], "valid": d.X["train"][:rows]},
                           Y={"train": d.Y["train"], "valid": d.Y["train"][:rows]})
    batches = -(-rows // EVAL_BATCH)
    total = {}

    def dispatch_stats(t):
        """Wrap the Trainer's eval dispatch: the batches it ran and, while
        `sync` is set, each call's host seconds with the card idle."""
        stats = {"batches": 0, "sync": False, "host": []}
        of = t._eval_dispatch_of

        def wrapped(kind):
            call = of(kind)

            def run(n, batch):
                if stats["sync"]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = call(n, batch)
                    stats["host"].append((time.perf_counter() - t0, n))
                else:
                    out = call(n, batch)
                stats["batches"] += n
                return out
            return run

        t._eval_dispatch_of = wrapped
        return stats

    for dname in ("bfloat16", "float32"):
        for kind, stage in (("supervised", "scratch"), ("streaming", "scratch"),
                            ("mfp", "mfp"), ("rfd", "rfd")):
            src = val["trainers"][stage]
            cfg = dataclasses.replace(src.config, compute_dtype=dname)
            reset_counts()
            pair, stats = {}, {}
            for spc in (GRAPH_SPC, 1):
                targs = dataclasses.replace(
                    src.args, steps_per_call=spc, per_device_eval_batch_size=EVAL_BATCH,
                    compute_dtype=dname, streaming_auc=kind == "streaming",
                    output_dir=os.path.join(val["work"], "grouped_eval",
                                            f"{kind}_{dname}_{spc}"))
                t = Trainer(models.from_config(cfg), cfg, targs, data)
                t.model.load_state_dict(src.model.state_dict())
                pair[spc], stats[spc] = t, dispatch_stats(t)

            def run_pass(t, draws=None):
                if kind == "mfp":
                    out = t.MFP_pretrain_eval(draws)
                elif kind == "rfd":
                    out = t.RFD_pretrain_eval(draws)
                else:
                    out = t.eval("valid", test_eval=True)
                torch.cuda.synchronize()
                return {k: v for k, v in out.items() if k != "eval_time_cost"}

            # two passes each first: the warm-up call and the graph of 1, then
            # the graph of 8, captured
            results = {spc: [run_pass(t), run_pass(t)] for spc, t in pair.items()}
            wall = {spc: [] for spc in pair}
            for spc in (1, GRAPH_SPC, GRAPH_SPC, 1):
                t0 = time.perf_counter()
                results[spc].append(run_pass(pair[spc]))
                wall[spc].append(time.perf_counter() - t0)
            for spc in pair:
                stats[spc]["sync"] = True
                results[spc].append(run_pass(pair[spc]))
                stats[spc]["sync"] = False
            handed = None
            if kind in ("mfp", "rfd"):  # the eval's own draws, made outside
                t = pair[GRAPH_SPC]
                gen = stream_generator(t.args.seed, "eval", device=dev)
                f = cfg.num_fields
                mask_num = mask_num_of(f, t.args.mask_ratio)
                draws = [draw_mfp(gen, t.noise, EVAL_BATCH, f, mask_num, cfg.pt_neg_num,
                                  t.args.sampling_method) if kind == "mfp" else
                         draw_rfd(gen, EVAL_BATCH, f, mask_num, t.args.sampling_method,
                                  t.args.RFD_replace, cfg.input_size, dev)
                         for _ in range(batches)]
                handed = run_pass(t, draws)
            ran = launches_run(read_counts(), pair[GRAPH_SPC].graphs() + pair[1].graphs())
            dispatched = stats[GRAPH_SPC]["batches"] + stats[1]["batches"]
            per = 2 if kind == "mfp" else 1
            expected = {"embedding_gather": per * dispatched, "cross_net": dispatched}
            key = {"supervised": "eval"}.get(kind, kind)
            graphs = {n: g.replays for n, g in pair[GRAPH_SPC]._evals[key].graphs.items()}
            host_us = {spc: sum(h for h, _ in st["host"]) / sum(n for _, n in st["host"]) * 1e6
                       for spc, st in stats.items()}
            emit("grouped_eval", kind=kind, compute_dtype=dname, rows=rows, batch=EVAL_BATCH,
                 batches=batches, card=smi_line(),
                 rows_per_s={"grouped": [rows / w for w in wall[GRAPH_SPC]],
                             "eager": [rows / w for w in wall[1]]},
                 wall_s={"grouped": wall[GRAPH_SPC], "eager": wall[1]},
                 host_us_per_batch={"grouped": host_us[GRAPH_SPC], "eager": host_us[1]},
                 metrics=results[GRAPH_SPC][0], graphs=graphs, launches=ran,
                 expected_launches=expected, handed_in=handed)
            ref = results[1][0]
            check(f"grouped eval {kind} {dname}: every pass's metrics bit-equal to the "
                  "eager pass's (steps_per_call=1)",
                  all(r == ref for r in results[GRAPH_SPC] + results[1])
                  and (handed is None or handed == ref),
                  grouped=results[GRAPH_SPC], eager=results[1], handed_in=handed)
            check(f"grouped eval {kind} {dname}: graphs of {GRAPH_SPC} and 1 replayed",
                  sorted(graphs) == [1, GRAPH_SPC] and all(graphs.values()), graphs=graphs)
            check(f"grouped eval {kind} {dname}: launches (K4 {per}x and K2 once a batch, "
                  "replays counted)", all(ran[k] == v for k, v in expected.items())
                  and all(ran[k] == 0 for k in ran if k not in expected), launches=ran)
            for k, v in ran.items():
                total[k] = total.get(k, 0) + v
            del pair, t
            torch.cuda.empty_cache()
    return total


def chi_square_phase(args, dev, val) -> None:
    """10f. The port's alias draws on the card against q (the MFP eval-loss
    band item's first diagnostic): CHI_DRAWS draws of the global draw
    (`alias.alias_draw_logq`, synthazu's unigram: the validation MFP
    stage's table) and of the per-field one (`per_field_alias_draw_logq`,
    each field's unigram), Pearson's statistic with the buckets expected
    below 5 draws pooled; p above 1e-3; every draw's log q the table's."""
    import torch

    from map_tpu_torch.objectives import alias

    d = val["data"]
    mfp = val["trainers"]["mfp"]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(VALIDATION_SEED)
    ids, logq = alias.alias_draw_logq(gen, mfp.noise.fused, (CHI_DRAWS,))
    logq_ok = torch.equal(logq, mfp.noise.logprob[ids.long()])
    probs, _, _ = alias.noise_log_prior(d.feat_count)
    counts = torch.bincount(ids.long(), minlength=len(probs)).cpu().numpy()
    stat, dof = alias.chi_square(counts, probs)
    p = alias.chi_square_p(stat, dof)
    emit("chi_square", draw="global alias_draw_logq", draws=CHI_DRAWS, vocab=len(probs),
         statistic=stat, dof=dof, p=p, logq_equal=logq_ok,
         seconds=time.perf_counter() - t0)
    check("chi-square: the global alias draws follow q (p > 1e-3), log q the table's",
          p > 1e-3 and logq_ok, statistic=stat, dof=dof, p=p)

    t0 = time.perf_counter()
    prob, alias_ids, logprob, _ = alias.build_per_field_alias(d.feat_count, d.idx_low,
                                                             d.idx_high)
    fused = torch.from_numpy(alias.build_fused_alias(prob, alias_ids, logprob)).to(dev)
    low = torch.tensor(d.idx_low, dtype=torch.int32, device=dev)
    sizes = torch.tensor(d.idx_high, dtype=torch.int32, device=dev) - low
    nf, k = d.num_fields, 100
    fields = torch.arange(nf, device=dev).repeat_interleave(CHI_DRAWS // nf // k)
    ids, logq = alias.per_field_alias_draw_logq(gen, fused, low, sizes, fields, k)
    logq_ok = torch.equal(logq, torch.from_numpy(logprob).to(dev)[ids.long()])
    stat = dof = 0
    per_field = []
    for f in range(nf):
        lo, hi = int(d.idx_low[f]), int(d.idx_high[f])
        got = ids[fields == f].reshape(-1).long() - lo
        inside = bool(((got >= 0) & (got < hi - lo)).all())
        s_, k_ = alias.chi_square(torch.bincount(got.clamp(0, hi - lo - 1),
                                                 minlength=hi - lo).cpu().numpy(),
                                  alias.noise_distribution(d.feat_count[lo:hi]))
        per_field.append(dict(field=f, size=hi - lo, statistic=s_, dof=k_, inside=inside))
        stat, dof = stat + s_, dof + k_
    p = alias.chi_square_p(stat, dof)
    emit("chi_square", draw="per-field per_field_alias_draw_logq",
         draws=int(fields.numel()) * k, statistic=stat, dof=dof, p=p, logq_equal=logq_ok,
         fields=per_field, seconds=time.perf_counter() - t0)
    check("chi-square: the per-field alias draws follow each field's q (p > 1e-3), inside "
          "their field's block, log q the table's",
          p > 1e-3 and logq_ok and all(x["inside"] for x in per_field),
          statistic=stat, dof=dof, p=p)


# ---- 10g. the parallel layer: a 1 x 1 NCCL mesh on the graph path, and two
# gloo ranks sharing the card (data-parallel, row-sharded psum and hotcold)

PARALLEL_STEPS = 8  # eager steps of each two-rank run (8 global batches)
PARALLEL_GRAPH_STEPS = 16  # the 1 x 1 NCCL run: a warm-up call and a replay
# (name, data axis, model axis, exchange, objective, hybrid lookup) of the
# two-rank runs; the hybrid lookup (K6b's backward, `bwd_pallas`) is off
# under a table mesh, so only a data-parallel run can take it
PARALLEL_RUNS = (("dp 2x1 supervised", 2, 1, "psum", "sup", False),
                 ("dp 2x1 supervised hybrid bwd_pallas", 2, 1, "psum", "sup", True),
                 ("rows 1x2 psum supervised", 1, 2, "psum", "sup", False),
                 ("rows 1x2 psum mfp", 1, 2, "psum", "mfp", False),
                 ("rows 1x2 psum rfd", 1, 2, "psum", "rfd", False),
                 ("rows 1x2 hotcold supervised", 1, 2, "hotcold", "sup", False),
                 ("rows 1x2 psum mfp full", 1, 2, "psum", "mfp_full", False))
PARALLEL_DTYPES = ("float32", "bfloat16")
# the `full` loss's run: synthazu's V = 101,178 (its (B, M, V) f32 scores
# are 11.6 GB on one rank at batch 4096, 116 GB at the canonical V), f32,
# 8 steps of 4096 rows (40,960 rows: 32,768 train, one eval batch of 4096)
PARALLEL_FULL_KIND, PARALLEL_FULL_ROWS = "mfp_full", 40_960
TOL_PARALLEL_F32 = 1e-5  # loss and every parameter, two ranks against one
# the full loss's eval accuracy, two ranks against one: a target whose
# score ties its best rival within rounding may go either way (one
# position of 4096 x 7 is 3.5e-5)
TOL_PARALLEL_FULL_ACC = 1e-3
# data-parallel f32 against one rank: every step's loss, the eval AUC
# (map_tpu's tests/test_multiprocess.py: 2e-5), and the first step's
# gradient within this share of each leaf's largest |gradient| (a loss over
# a rank's own count, or a block left out, moves a gradient by a factor;
# rounding moved fc_out.bias, one sum of 4096 terms that cancel, by 1.02e-5)
TOL_PARALLEL_DP_LOSS, TOL_PARALLEL_DP_AUC, TOL_PARALLEL_DP_GRAD = 1e-4, 2e-5, 1e-4
PARALLEL_CKPT_RUN = "rows 1x2 psum supervised float32"  # saved, against one rank's
PARALLEL_MEMMAP_RUN = "dp 2x1 supervised float32"  # again, from the memmap mode
PARALLEL_TIMEOUT_S = 300


def parallel_data(seed: int, steps: int):
    """The phase's in-memory dataset (its own generator, so that every rank
    and the parent draw the same): `steps` global batches of TRAIN_BATCH."""
    return teacher_dataset(np.random.default_rng(seed + 17), steps * TRAIN_BATCH)


def parallel_dtypes(kind: str):
    return ("float32",) if kind == PARALLEL_FULL_KIND else PARALLEL_DTYPES


PARALLEL_RUN_COUNT = sum(len(parallel_dtypes(r[4])) for r in PARALLEL_RUNS)


def parallel_full_data():
    """The full loss's data: synthazu in memory (data seed 7)."""
    from map_tpu_torch import validate
    from map_tpu_torch.data import synth

    return synth.in_memory(synth.generate_realistic_arrays(
        num_rows=PARALLEL_FULL_ROWS, seed=validate.DATA_SEED), pretrain=True)


def parallel_inputs(kind: str, cfg, data, full_data):
    """(base config, data) of a run's objective: the full loss's on synthazu."""
    if kind != PARALLEL_FULL_KIND:
        return cfg, data
    lo, hi = full_data.idx_low, full_data.idx_high
    return base_cfg(full_data.input_size, lo, hi), full_data


def parallel_variant(kind: str, hybrid: bool, dname: str) -> str:
    """The name of a one-rank reference (objective, lookup, dtype)."""
    return f"{kind}{'_hybrid' if hybrid else ''}_{dname}"


def parallel_cfg(cfg, kind: str, dname: str, data, hybrid: bool = False):
    """The phase's DCNv2 config: supervised, MFP per-position (k = 25; the
    nce loss, or with `mfp_full` the full one) or RFD (Unigram); the hybrid
    lookup under `bwd_pallas` with `hybrid`, else off (as under a table
    mesh)."""
    from map_tpu_torch.data.dataset import compute_feat_count

    c = dataclasses.replace(cfg, compute_dtype=dname, field_blocked_lookup=hybrid,
                            hybrid_mode="bwd_pallas" if hybrid else "")
    if kind in ("mfp", PARALLEL_FULL_KIND):
        c = dataclasses.replace(c, pretrain=True, pt_type="MFP", proj_size=MFP_PROJ,
                                pt_neg_num=MFP_NEG,
                                nce_loss_type="nce" if kind == "mfp" else "full",
                                feat_count=compute_feat_count(data.X["train"],
                                                              cfg.input_size))
    elif kind == "rfd":
        c = dataclasses.replace(c, pretrain=True, pt_type="RFD", RFD_replace="Unigram",
                                proj_size=MFP_PROJ)
    return c


def parallel_targs(out_dir: str, kind: str, dname: str, seed: int, data_axis: int = 1,
                   model_axis: int = 1, exchange: str = "psum", spc: int = 1,
                   resident: str = "off", hybrid: bool = False):
    from map_tpu_torch.config import TrainingArguments

    extra = {}
    if kind in ("mfp", PARALLEL_FULL_KIND):
        extra = dict(pretrain=True, pt_type="MFP", mask_ratio=MFP_MASK_RATIO,
                     sampling_method="randint")
    elif kind == "rfd":
        extra = dict(pretrain=True, pt_type="RFD", RFD_replace="Unigram",
                     mask_ratio=MFP_MASK_RATIO, sampling_method="randint")
    # the full loss's (B, M, V) scores: an eval batch of the train step's size
    eval_batch = TRAIN_BATCH if kind == PARALLEL_FULL_KIND else EVAL_BATCH
    if hybrid:
        extra["hybrid_mode"] = "bwd_pallas"
    return TrainingArguments(
        output_dir=out_dir, dataset_name="in-memory", data_dir=out_dir,
        per_device_train_batch_size=TRAIN_BATCH // data_axis,
        per_device_eval_batch_size=eval_batch // data_axis,
        learning_rate=LR, weight_decay=WEIGHT_DECAY, lr_sched="const",
        num_train_epochs=1, logging_steps=PARALLEL_GRAPH_STEPS // 2, compute_dtype=dname,
        seed=seed, steps_per_call=spc, device_resident_data=resident,
        num_model_shards=model_axis, table_exchange=exchange,
        exact_eval_allgather=True, **extra)


def parallel_steps(trainer, first=None):
    """One epoch of the trainer's steps, driven as `train` drives them ->
    the steps' losses (n,) on the host. With a dict `first`, the first
    step's gradients ("grads") and the parameters after it ("params"), by
    name, row blocks gathered over the model group, on the host."""
    import torch

    from map_tpu_torch.parallel.sharding import gather_rows

    batcher = trainer._prepare_training()
    if first is not None:
        opt, step = trainer.optimizer, trainer.optimizer.step

        def whole(tensors):
            shards, group = trainer._shards, trainer.mesh.model_group
            return {n: (gather_rows(t, shards[n], group) if n in shards else t).cpu()
                    for n, t in zip(opt.names, tensors)}

        def first_step(grads=None):
            if not first:
                first["grads"] = whole([torch.zeros_like(p) if p.grad is None else p.grad
                                        for p in opt.params])
                step(grads)
                first["params"] = whole([p.detach() for p in opt.params])
                return None
            return step(grads)

        opt.step = first_step
    losses = [m["loss"].reshape(-1) for _, m, _ in trainer.train_epoch(batcher, 0)]
    return torch.cat(losses).cpu()


def first_step_errors(got: dict, ref: dict) -> dict:
    """Two runs' first steps (`parallel_steps`' `first`): each leaf's
    gradient distance over its largest |gradient|, and the parameters'
    largest distance after the step and the count past TOL_PARALLEL_F32."""
    grad_rel = {}
    for n, g in ref["grads"].items():
        scale = float(g.abs().max())
        d = float((got["grads"][n] - g).abs().max())
        grad_rel[n] = d / scale if scale > 0 else d
    dp = [(got["params"][n] - p).abs() for n, p in ref["params"].items()]
    return dict(grad_rel=grad_rel, params_max=max(float(x.max()) for x in dp),
                params_over_tol=sum(int((x > TOL_PARALLEL_F32).sum()) for x in dp))


def bits_digest(t) -> int:
    """A hash of a float32 tensor's bits (two tensors of one shape whose
    digests differ differ; equal digests: equal, but for a collision)."""
    import torch

    x = t.detach().contiguous().view(-1).view(torch.int32).long()
    w = torch.arange(x.numel(), device=x.device) % 65521 + 1
    return int((x * w).sum())


def split_batch_steps(trainers, halves) -> dict:
    """The data-parallel witness: in one process, without a process group,
    `trainers[i]` takes PARALLEL_STEPS supervised steps whose gradient is
    summed over `halves[i]` row blocks of each global batch, every block's
    loss over the global weight, as `halves[i]` data-parallel ranks compute
    it (gloo adds two ranks' tensors as a + b, which is b + a), then one
    AdamW (K1) update. halves 1 is the one-rank step. The trainers step in
    lockstep -> each one's losses and final state, the first step's
    gradients, and after every step the largest distance between the first
    two trainers' parameters and the count past TOL_PARALLEL_F32."""
    import torch

    from map_tpu_torch.objectives.supervised import bce_loss
    from map_tpu_torch.train.train_step import device_batch

    epochs = [t._prepare_training().epoch(0) for t in trainers]
    losses = [[] for _ in trainers]
    first, growth = [None] * len(trainers), []
    for batches in zip(*epochs):
        for i, (t, batch, k) in enumerate(zip(trainers, batches, halves)):
            b = device_batch(batch, t.device)
            n = b["labels"].shape[0] // k
            blocks = [slice(j * n, (j + 1) * n) for j in range(k)]
            count = b["weight"][blocks[0]].sum()
            for s in blocks[1:]:
                count = count + b["weight"][s].sum()
            total = loss_sum = None
            for s in blocks:
                t.model.train()
                logits = t.model(b["input_ids"][s]).reshape(-1)
                loss = bce_loss(logits, b["labels"][s], b["weight"][s], count)
                t.optimizer.zero_grad()
                loss.backward()
                g = [torch.zeros_like(p) if p.grad is None else p.grad.float().contiguous()
                     for p in t.optimizer.params]
                total = g if total is None else [a + c for a, c in zip(total, g)]
                loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            if first[i] is None:
                first[i] = [x.clone() for x in total]
            t.optimizer.zero_grad()
            t.optimizer.step(total)
            losses[i].append(loss_sum.float().reshape(1))
        d = [(p - q).abs() for p, q in zip(trainers[0].optimizer.params,
                                            trainers[1].optimizer.params)]
        growth.append(dict(max=max(float(x.max()) for x in d),
                           over_tol=sum(int((x > TOL_PARALLEL_F32).sum()) for x in d)))
    torch.cuda.synchronize()
    states = [{k: v.detach().clone() for k, v in t.model.state_dict().items()}
              for t in trainers]
    return dict(losses=[torch.cat(x).cpu() for x in losses], states=states,
                first=first, growth=growth, names=list(trainers[0].optimizer.names))


def dp_witness(args, cfg, work, variant: str, hybrid: bool) -> dict:
    """The data-parallel f32 run's witness (`split_batch_steps`): one rank's
    steps and the two-block steps side by side. The one-block loop must
    reproduce the Trainer's one-rank run bit for bit (so the loop is the
    Trainer's step), and the first step's two-block gradient must lie
    within TOL_PARALLEL_DP_GRAD of each leaf's largest one-block gradient
    (a normalisation or a dropped block would show there, which AdamW's
    update, invariant to a gradient's scale, hides). The two-block state
    and losses are saved for the ranks, which must equal them bit for bit;
    the distance to one rank's parameters after each step is recorded."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.train.trainer import Trainer

    data = parallel_data(args.seed, PARALLEL_STEPS)
    trainers = []
    for k in (1, 2):
        targs = parallel_targs(os.path.join(work, f"split{k} {variant}"), "sup", "float32",
                               args.seed, hybrid=hybrid)
        trainers.append(Trainer(models.from_config(cfg, torch.Generator().manual_seed(
            args.seed)), cfg, targs, data))
    res = split_batch_steps(trainers, (1, 2))
    del trainers
    ref = torch.load(os.path.join(work, f"ref_{variant}.pt"), weights_only=True)
    one, two = res["states"]
    loop_equal = (torch.equal(res["losses"][0], ref["losses"].reshape(-1))
                  and all(torch.equal(one[k].cpu(), ref["state"][k]) for k in ref["state"]))
    grad_rel = {}
    for name, a, b in zip(res["names"], *res["first"]):
        scale = float(a.abs().max())
        grad_rel[name] = float((b - a).abs().max()) / scale if scale > 0 else float(
            (b - a).abs().max())
    torch.save({"state": {k: v.cpu() for k, v in two.items()}, "losses": res["losses"][1]},
               os.path.join(work, f"split_{variant}.pt"))
    emit("parallel_dp_witness", variant=variant, loop_equals_one_rank=loop_equal,
         first_grad_rel_err=grad_rel, growth=res["growth"],
         loss_errs=(res["losses"][1] - res["losses"][0]).abs().tolist())
    check(f"parallel (b) dp witness {variant}: the one-block loop is the one-rank run, "
          "bit for bit", loop_equal)
    check(f"parallel (b) dp witness {variant}: the first step's two-block gradient within "
          f"{TOL_PARALLEL_DP_GRAD} of each leaf's largest one-rank gradient",
          all(v <= TOL_PARALLEL_DP_GRAD for v in grad_rel.values()),
          worst=max(grad_rel.items(), key=lambda kv: kv[1]))
    del res, one, two, ref
    torch.cuda.empty_cache()
    return grad_rel


def parallel_worker(args) -> int:
    """One of the two ranks on the card (spawned by `parallel_phase`): each
    run of PARALLEL_RUNS in each dtype, PARALLEL_STEPS eager steps through
    the Trainer; the result held against the one-rank run the parent saved,
    the ranks' bits compared through a gathered digest; one line of results."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.kernels import build
    from map_tpu_torch.parallel import embedding as pe
    from map_tpu_torch.parallel.mesh import maybe_init_distributed
    from map_tpu_torch.train.graph import launch_counts
    from map_tpu_torch.train.trainer import Trainer

    world = maybe_init_distributed()
    build.library()  # built by the parent: loaded, not compiled
    lo, hi, vocab = field_blocks()
    cfg = base_cfg(vocab, lo, hi)
    data = parallel_data(args.seed, PARALLEL_STEPS)
    full_data = parallel_full_data()
    work = args.parallel_work
    out, ram_ref = {}, None
    for name, d, m, exch, kind, hybrid in PARALLEL_RUNS:
        for dname in parallel_dtypes(kind):
            run = f"{name} {dname}"
            variant = parallel_variant(kind, hybrid, dname)
            base, run_data = parallel_inputs(kind, cfg, data, full_data)
            c = parallel_cfg(base, kind, dname, run_data, hybrid)
            targs = parallel_targs(os.path.join(work, "rank_runs", run), kind, dname,
                                   args.seed, d, m, exch, hybrid=hybrid)
            before = launch_counts()
            pe.hotcold_stats.clear()
            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(models.from_config(c, torch.Generator().manual_seed(args.seed)),
                              c, targs, run_data)
            first = {} if kind == PARALLEL_FULL_KIND else None
            t0 = time.perf_counter()
            losses = parallel_steps(trainer, first)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mfp_eval, eval_s = None, None
            if kind == PARALLEL_FULL_KIND:
                t1 = time.perf_counter()
                mfp_eval = trainer.MFP_pretrain_eval()
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t1
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            after = launch_counts()
            launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
            full = trainer._full_state_dict()
            ref = torch.load(os.path.join(work, f"ref_{variant}.pt"), weights_only=True)
            diffs = {k: (full[k] - ref["state"][k].to(full[k].device)).float().abs()
                     for k in ref["state"]}
            param_err = max(float(x.max()) for x in diffs.values())
            over = {k: int((x > TOL_PARALLEL_F32).sum()) for k, x in diffs.items()}
            loss_errs = (losses - ref["losses"]).abs().tolist()
            split_equal = None  # data-parallel f32: bit-equal to `dp_witness`'s two blocks
            if d > 1 and dname == "float32":
                split = torch.load(os.path.join(work, f"split_{variant}.pt"),
                                   weights_only=True)
                split_equal = (torch.equal(losses, split["losses"])
                               and all(torch.equal(full[k].cpu(), split["state"][k])
                                       for k in split["state"]))
            auc = (trainer.eval("valid", test_eval=True)["eval_auc"] if kind == "sup"
                   else None)
            digest = torch.tensor([bits_digest(losses)] + [bits_digest(full[k]) for k in
                                                           sorted(full)], device=trainer.device)
            digests = trainer.mesh.world.all_gather(digest)
            agree = bool((digests == digests[0]).all())
            stats = {k: int(v) for k, v in pe.hotcold_stats.items()}
            if run == PARALLEL_CKPT_RUN:
                trainer.save_model(os.path.join(work, "ckpt_rows"))
                trainer._join_ckpt_writer()
            if run == PARALLEL_MEMMAP_RUN:
                ram_ref = (losses.clone(), {k: v.cpu() for k, v in full.items()})
            eval_err = first_err = None
            if mfp_eval is not None:
                eval_err = dict(loss=abs(mfp_eval["eval_mfp_loss"] - ref["eval"]["eval_mfp_loss"]),
                                acc=abs(mfp_eval["eval_mfp_acc"] - ref["eval"]["eval_mfp_acc"]),
                                loss_value=mfp_eval["eval_mfp_loss"],
                                acc_value=mfp_eval["eval_mfp_acc"])
                first_err = first_step_errors(first, ref["first"])
            out[run] = dict(mesh=[d, m], exchange=exch, steps=len(losses),
                            wall_s=wall, eval_s=eval_s, eval_err=eval_err, peak_gb=peak_gb,
                            first_err=first_err,
                            loss_err=max(loss_errs), loss_errs=loss_errs,
                            param_err=param_err, split_equal=split_equal,
                            elements=sum(x.numel() for x in diffs.values()),
                            over_tol={k: v for k, v in over.items() if v},
                            auc_err=None if auc is None else abs(auc - ref["auc"]),
                            ranks_agree=agree, launches=launches, hotcold=stats,
                            shards={k: list(s) for k, s in trainer._shards.items()},
                            finite=bool(torch.isfinite(losses).all()))
            del trainer, full, ref, diffs
            torch.cuda.empty_cache()
    memmap = parallel_memmap_run(args, cfg, data, work, ram_ref)
    print("PARALLEL_RANK " + json.dumps({"rank": int(os.environ["RANK"]), "world": world,
                                         "runs": out, "memmap": memmap}), flush=True)
    torch.distributed.destroy_process_group()
    return 0



def parallel_memmap_run(args, cfg, data, work, ram_ref) -> dict:
    """A rank's PARALLEL_MEMMAP_RUN from the memmap mode: both ranks
    materialize the phase's data into `work/memmap` at once (its meta and
    split written by the parent), open it under a 1 MB host budget, and run
    the same steps as in RAM; their batches gathered by the native gather
    from the memmap -> whether this rank wrote, and the run equal to
    `ram_ref` (losses, the whole state) bit for bit."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.data import artifacts, native
    from map_tpu_torch.data.dataset import CTRDataset
    from map_tpu_torch.train.trainer import Trainer

    d = os.path.join(work, "memmap")
    x, y, splits = memmap_layout(data, args.seed)
    t0 = time.perf_counter()
    wrote = artifacts.materialize_split_memmaps(d, MEMMAP_NAME, splits,
                                                source=memmap_source(x, y)) is not None
    materialize_s = time.perf_counter() - t0
    ds = CTRDataset(d, MEMMAP_NAME, host_data_budget_mb=1)
    name, dp, mp, exch, kind, hybrid = next(r for r in PARALLEL_RUNS
                                            if f"{r[0]} float32" == PARALLEL_MEMMAP_RUN)
    c = parallel_cfg(cfg, kind, "float32", data, hybrid)
    targs = parallel_targs(os.path.join(work, "rank_runs", "memmap " + PARALLEL_MEMMAP_RUN),
                           kind, "float32", args.seed, dp, mp, exch, hybrid=hybrid)
    trainer = Trainer(models.from_config(c, torch.Generator().manual_seed(args.seed)), c,
                      targs, ds)
    calls = native.calls()
    losses = parallel_steps(trainer)
    full = trainer._full_state_dict()
    equal = (ram_ref is not None and torch.equal(losses, ram_ref[0])
             and all(torch.equal(full[k].cpu(), ram_ref[1][k]) for k in ram_ref[1]))
    out = dict(wrote=wrote, materialize_s=materialize_s, memory_mapped=ds.memory_mapped,
               steps=len(losses), native_gathers=native.calls() - calls,
               equal_to_ram=bool(equal))
    del trainer, full
    torch.cuda.empty_cache()
    return out

def base_cfg(vocab, lo, hi):
    """The smoke's full-width DCNv2 (phase 6's)."""
    from map_tpu_torch.config import Config

    return Config(model_name="dcnv2", input_size=vocab, num_fields=len(FIELD_SIZES),
                  embed_size=EMBED, hidden_size=1000, num_hidden_layers=3,
                  hidden_act="relu", num_cross_layers=3,
                  idx_low=[int(x) for x in lo], idx_high=[int(x) for x in hi])


def parallel_phase(args, dev, cfg, reset_counts, read_counts) -> dict:
    """10g. (a) `parallel_nccl_1x1`, (b) `parallel_two_ranks`."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        nccl = parallel_nccl_1x1(args, cfg, work, reset_counts, read_counts)
        out = parallel_two_ranks(args, cfg, work)
        out["launches_nccl_1x1"] = nccl
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    emit("parallel", bf16_band=out["bf16_band"], wall_s=out["wall_s"], card=smi_line())
    return out


def parallel_nccl_1x1(args, cfg, work, reset_counts, read_counts) -> dict:
    """10g (a). One rank under NCCL on a 1 x 1 mesh: supervised bf16 DCNv2,
    PARALLEL_GRAPH_STEPS steps on the graph path (the collectives captured
    in the graphs of 8 steps) and its eval, bit-equal to the same run
    without a process group."""
    import torch
    import torch.distributed as dist

    from map_tpu_torch import models
    from map_tpu_torch.parallel.launch import free_port
    from map_tpu_torch.train.trainer import Trainer

    data16 = parallel_data(args.seed + 1, PARALLEL_GRAPH_STEPS)
    c = dataclasses.replace(cfg, compute_dtype="bfloat16")
    runs = {}
    for label in ("no process group", "nccl 1x1"):
        if label == "nccl 1x1":
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                    world_size=1, rank=0)
        targs = parallel_targs(os.path.join(work, label), "sup", "bfloat16", args.seed,
                               spc=GRAPH_SPC, resident="auto")
        trainer = Trainer(models.from_config(c, torch.Generator().manual_seed(args.seed)),
                          c, targs, data16)
        reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        runs[label] = dict(
            wall_s=time.perf_counter() - t0, windows=trainer.train_windows,
            evals=trainer.eval_metrics, steps=trainer.global_step,
            state={k: v.clone() for k, v in trainer.model.state_dict().items()},
            graphs=graph_replays(trainer), launches=trainer.launches_run(read_counts()),
            backend=trainer.mesh.world.backend, spc=trainer._spc)
        del trainer
        if label == "nccl 1x1":
            dist.destroy_process_group()
    a, b = runs["no process group"], runs["nccl 1x1"]
    same = ([(w["window_loss"], w["window_auc"]) for w in a["windows"]]
            == [(w["window_loss"], w["window_auc"]) for w in b["windows"]])
    bits = all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    emit("parallel_nccl_1x1", steps=b["steps"], backend=b["backend"], steps_per_call=b["spc"],
         graphs=b["graphs"], launches=b["launches"], wall_s=b["wall_s"],
         wall_s_no_pg=a["wall_s"], windows=[w["window_loss"] for w in b["windows"]],
         evals=b["evals"], card=smi_line())
    check("parallel (a): nccl 1x1, collectives captured in the graphs of 8 steps",
          b["backend"] == "nccl" and b["spc"] == GRAPH_SPC and b["steps"] == PARALLEL_GRAPH_STEPS
          and sum(b["graphs"].values()) >= 1, graphs=b["graphs"])
    check("parallel (a): nccl 1x1 bit-equal to no process group (losses, evals, "
          "every parameter and buffer)", same and bits and a["evals"] == b["evals"])
    launches = b["launches"]
    del runs, a, b
    torch.cuda.empty_cache()
    return launches


def parallel_two_ranks(args, cfg, work) -> dict:
    """10g (b). Two ranks sharing the card under gloo (NCCL refuses two ranks
    on one device), each run of PARALLEL_RUNS in float32 and bfloat16,
    PARALLEL_STEPS eager steps on the same global batches as one rank
    (whose runs this process makes first, with `dp_witness`'s): the
    row-sharded runs in float32 within TOL_PARALLEL_F32 (loss and every
    parameter), the data-parallel ones bit-equal to the witness's two-block
    steps and held to one rank by their losses and eval AUC; bfloat16's
    band recorded, the ranks' bits equal, hotcold's overflow 0; the (1, 2)
    mesh's checkpoint equal to one rank's."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.parallel.launch import free_port, rank_env
    from map_tpu_torch.train import checkpoints
    from map_tpu_torch.train.trainer import Trainer

    # references: one rank, no process group, the same global batches
    data = parallel_data(args.seed, PARALLEL_STEPS)
    full_data = parallel_full_data()
    variants = {(kind, hybrid) for _, _, _, _, kind, hybrid in PARALLEL_RUNS}
    ref_runs = {}
    for kind, hybrid in sorted(variants):
        for dname in parallel_dtypes(kind):
            variant = parallel_variant(kind, hybrid, dname)
            base, run_data = parallel_inputs(kind, cfg, data, full_data)
            ck = parallel_cfg(base, kind, dname, run_data, hybrid)
            targs = parallel_targs(os.path.join(work, f"ref {variant}"), kind, dname,
                                   args.seed, hybrid=hybrid)
            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(models.from_config(ck, torch.Generator().manual_seed(args.seed)),
                              ck, targs, run_data)
            first = {} if kind == PARALLEL_FULL_KIND else None
            t0 = time.perf_counter()
            losses = parallel_steps(trainer, first)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            auc = (trainer.eval("valid", test_eval=True)["eval_auc"] if kind == "sup"
                   else None)
            mfp_eval = (trainer.MFP_pretrain_eval() if kind == PARALLEL_FULL_KIND else None)
            ref_runs[variant] = dict(wall_s=wall, steps=len(losses),
                                     peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                                     eval=mfp_eval)
            torch.save({"state": {k: v.cpu() for k, v in trainer.model.state_dict().items()},
                        "losses": losses, "auc": auc, "eval": mfp_eval, "first": first},
                       os.path.join(work, f"ref_{variant}.pt"))
            if variant == "sup_float32":
                trainer.save_model(os.path.join(work, "ckpt_ref"))
                trainer._join_ckpt_writer()
            del trainer
            torch.cuda.empty_cache()
    # the data-parallel f32 runs' witness: their steps in one process
    for _, d, _, _, kind, hybrid in PARALLEL_RUNS:
        if d > 1:
            dp_witness(args, parallel_cfg(cfg, kind, "float32", data, hybrid), work,
                       parallel_variant(kind, hybrid, "float32"), hybrid)

    # the memmap run's directory: its meta and split only; both ranks write
    # the split files into it at once (one writes, the other waits)
    _, _, mm_splits = memmap_layout(data, args.seed)
    write_memmap_meta(os.path.join(work, "memmap"), cfg.input_size, mm_splits)

    # two ranks on the card, gloo; the kernels were built above, so no
    # rank runs nvcc; a rank that fails fails the phase
    port = free_port()
    cmd = [sys.executable, str(Path(__file__).resolve()), "--parallel_rank",
           "--parallel_work", work, "--seed", str(args.seed)]
    procs = [subprocess.Popen(cmd, env=rank_env(r, 2, port, "gloo"), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PARALLEL_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        line = [ln for ln in so.splitlines() if ln.startswith("PARALLEL_RANK ")]
        check(f"parallel (b): rank {r} ran to its end", p.returncode == 0 and bool(line),
              rc=p.returncode, stderr=se[-3000:], stdout=so[-1500:])
        reports.append(json.loads(line[0][len("PARALLEL_RANK "):]))
    for rep in reports:
        for run, res in rep["runs"].items():
            emit("parallel_rank", rank=rep["rank"], run=run, **res)
    mm = [rep["memmap"] for rep in reports]
    emit("parallel_memmap", run=PARALLEL_MEMMAP_RUN, ranks=mm)
    check(f"parallel (b) {PARALLEL_MEMMAP_RUN} on the memmap: both ranks materialized into "
          "one empty directory at once, one wrote, the other waited",
          sorted(x["wrote"] for x in mm) == [False, True] and all(x["memory_mapped"] for x in mm),
          ranks=mm)
    check(f"parallel (b) {PARALLEL_MEMMAP_RUN} on the memmap: bit-equal to the run in RAM "
          "(losses, every parameter)", all(x["equal_to_ram"] for x in mm))
    bands = {}
    for run in reports[0]["runs"]:
        rs = [rep["runs"][run] for rep in reports]
        f32 = run.endswith("float32")
        check(f"parallel (b) {run}: the ranks' bits agree, losses finite",
              all(x["ranks_agree"] and x["finite"] for x in rs))
        data_parallel = rs[0]["mesh"][0] > 1
        if rs[0]["eval_err"] is not None:
            # the full loss: the input gradient is the sum of the blocks' two
            # parts, one rank's one product, so it rounds apart, and AdamW
            # amplifies that from its second step on (ROADMAP Queue C's
            # data-parallel entry): held by every loss, the eval and the
            # first step's gradient; the parameters' distance recorded
            check(f"parallel (b) {run}: every loss within {TOL_PARALLEL_F32} of one rank",
                  all(x["loss_err"] <= TOL_PARALLEL_F32 for x in rs),
                  loss_errs=rs[0]["loss_errs"])
            check(f"parallel (b) {run}: the first step's gradient within "
                  f"{TOL_PARALLEL_DP_GRAD} of each leaf's largest one-rank gradient",
                  all(v <= TOL_PARALLEL_DP_GRAD for x in rs
                      for v in x["first_err"]["grad_rel"].values()),
                  worst=max(rs[0]["first_err"]["grad_rel"].items(), key=lambda kv: kv[1]))
            check(f"parallel (b) {run}: eval loss within {TOL_PARALLEL_F32} and eval "
                  f"accuracy within {TOL_PARALLEL_FULL_ACC} of one rank",
                  all(x["eval_err"]["loss"] <= TOL_PARALLEL_F32
                      and x["eval_err"]["acc"] <= TOL_PARALLEL_FULL_ACC for x in rs),
                  eval_err=[x["eval_err"] for x in rs])
            check(f"parallel (b) {run}: K4, K3 and K1 on every step of each rank",
                  all(x["launches"].get(k, 0) >= x["steps"] for x in rs
                      for k in ("embedding_gather", "scatter_add", "fused_adamw")),
                  launches=[x["launches"] for x in rs])
            ref = ref_runs[parallel_variant(PARALLEL_FULL_KIND, False, "float32")]
            emit("parallel_full", run=run, card=smi_line(), vocab=full_data.input_size,
                 batch=TRAIN_BATCH, steps=rs[0]["steps"],
                 ranks=[{k: x[k] for k in ("wall_s", "eval_s", "peak_gb", "loss_errs",
                                           "eval_err", "first_err", "param_err", "over_tol",
                                           "elements", "launches")}
                        for x in rs],
                 one_rank=dict(wall_s=ref["wall_s"], peak_gb=ref["peak_gb"],
                               eval_loss=ref["eval"]["eval_mfp_loss"],
                               eval_acc=ref["eval"]["eval_mfp_acc"]))
        elif f32 and not data_parallel:
            check(f"parallel (b) {run}: loss and every parameter within "
                  f"{TOL_PARALLEL_F32} of one rank",
                  all(x["loss_err"] <= TOL_PARALLEL_F32 and x["param_err"] <= TOL_PARALLEL_F32
                      for x in rs), loss_err=rs[0]["loss_err"], param_err=rs[0]["param_err"])
        elif f32:
            # data parallelism sums each gradient over two blocks of the batch,
            # one rank over one: held bit for bit to those steps in one process
            # (`dp_witness`, whose first gradient agrees with one rank's), and
            # to one rank by its losses and eval AUC; the parameters' distance
            # to one rank is recorded, by leaf
            x = rs[0]
            emit("parallel_dp_f32", run=run, loss_errs=x["loss_errs"],
                 param_err=x["param_err"], over_tol=x["over_tol"],
                 elements=x["elements"], auc_err=x["auc_err"], split_equal=x["split_equal"])
            check(f"parallel (b) {run}: bit-equal to the same steps in one process with "
                  "each gradient summed over the batch's two blocks (losses, every parameter)",
                  all(y["split_equal"] for y in rs))
            check(f"parallel (b) {run}: first loss within {TOL_PARALLEL_F32}, every loss "
                  f"within {TOL_PARALLEL_DP_LOSS}, eval AUC within {TOL_PARALLEL_DP_AUC} of "
                  "one rank", all(y["loss_errs"][0] <= TOL_PARALLEL_F32
                                  and y["loss_err"] <= TOL_PARALLEL_DP_LOSS
                                  and y["auc_err"] <= TOL_PARALLEL_DP_AUC for y in rs),
                  loss_errs=x["loss_errs"], auc_err=x["auc_err"])
        else:
            bands[run] = dict(loss_err=rs[0]["loss_err"], param_err=rs[0]["param_err"],
                              auc_err=rs[0]["auc_err"], over_tol=rs[0]["over_tol"])
        if "hybrid" in run:
            check(f"parallel (b) {run}: K6b ran on every step of each rank",
                  all(x["launches"].get("field_block_scatter", 0) >= x["steps"] for x in rs),
                  launches=[x["launches"] for x in rs])
        if "hotcold" in run:
            check(f"parallel (b) {run}: hotcold overflow 0",
                  all(x["hotcold"].get("overflow", -1) == 0 and x["hotcold"]["lookups"] > 0
                      for x in rs), cold_counts=[x["hotcold"] for x in rs])
    ref_ckpt = checkpoints.load_model(os.path.join(work, "ckpt_ref"), PARALLEL_STEPS)
    rows_ckpt = checkpoints.load_model(os.path.join(work, "ckpt_rows"), PARALLEL_STEPS)
    check("parallel (b): the (1, 2) mesh's checkpoint equals one rank's",
          ref_ckpt.keys() == rows_ckpt.keys()
          and all(torch.equal(ref_ckpt[k], rows_ckpt[k]) for k in ref_ckpt))
    totals: dict = {}
    full: dict = {}
    for rep in reports:
        for res in rep["runs"].values():
            into = full if res["eval_err"] is not None else totals
            for k, v in res["launches"].items():
                into[k] = into.get(k, 0) + v
    return {"bf16_band": bands, "launches_two_ranks": totals, "launches_full": full,
            "launches": {rep["rank"]: {run: res["launches"] for run, res in rep["runs"].items()}
                         for rep in reports}}


MEMMAP_NAME = "smoke"
MEMMAP_CHUNK_ROWS = 40_000  # several chunks, each scattered over the three splits
MEMMAP_STEPS = 2 * GRAPH_SPC  # a warm-up call and a captured replay
MEMMAP_TIMED_STEPS = 4 * GRAPH_SPC  # then timed, on the host clock
MEMMAP_GATHER_REPS = 50
# the zoo-less layers: the card's f32 error against the same module in f64
# on the CPU within TOL_LAYERS times the CPU's own f32 error plus
# TOL_LAYERS_REL of the tensor's largest value: the gradients are sums of
# 4096 x 24 terms, some of which cancel, so their rounding follows the
# order of the sum (the card's and the CPU's differ), not the result's size
TOL_LAYERS, TOL_LAYERS_REL = 8.0, 1e-5


def memmap_layout(data, seed: int):
    """The smoke's three splits as one (N, F) matrix in a shuffled file
    order -> (x, y, splits): file row r holds row perm[r] of the splits'
    concatenation; `splits` gives each split's rows in the file, in its
    order, so the memmap writer scatters every chunk over all three."""
    names = ("train", "valid", "test")
    x = np.concatenate([np.asarray(data.X[s]) for s in names])
    y = np.concatenate([np.asarray(data.Y[s]) for s in names])
    perm = np.random.default_rng(seed + 29).permutation(len(y))
    at = np.empty_like(perm)
    at[perm] = np.arange(len(perm))  # the file row of each concatenated row
    ends = np.cumsum([len(data.Y[s]) for s in names])
    splits = {s: at[a:b] for s, a, b in zip(names, np.r_[0, ends[:-1]], ends)}
    return x[perm], y[perm], splits


def write_memmap_meta(directory: str, vocab: int, splits) -> None:
    """The meta JSON (a feat_map of `vocab` ids, the smoke's fields) and
    split.pkl of a dataset whose rows come from memory, not an h5."""
    from map_tpu_torch.data import artifacts

    os.makedirs(directory, exist_ok=True)
    fields = [f"f{i}" for i in range(len(FIELD_SIZES))]
    artifacts.write_meta(directory, MEMMAP_NAME, fields, {str(i): i for i in range(vocab)},
                         {"<rsv>": 0, **{f: i + 1 for i, f in enumerate(fields)}})
    artifacts.write_split(directory, splits)


def memmap_source(x, y, chunk_rows: int = MEMMAP_CHUNK_ROWS):
    """(total, fields, chunks) for `artifacts.materialize_split_memmaps`."""
    return len(y), x.shape[1], ((x[i:i + chunk_rows], y[i:i + chunk_rows])
                                for i in range(0, len(y), chunk_rows))


@contextlib.contextmanager
def counting_takes():
    """Counts the Batcher's gathers (`Batcher._take`) while it is open ->
    a dict whose 'takes' grows."""
    from map_tpu_torch.data.loader import Batcher

    seen = {"takes": 0}
    take = Batcher._take
    lock = threading.Lock()  # the prefetch thread gathers too

    def counted(self, src, idx):
        with lock:
            seen["takes"] += 1
        return take(self, src, idx)

    Batcher._take = counted
    try:
        yield seen
    finally:
        Batcher._take = take


def memmap_phase(args, dev, cfg, data, reset_counts, read_counts) -> dict:
    """10h. The >RAM memmap mode: the smoke's supervised data written
    through the memmap writer core (`artifacts.materialize_split_memmaps`
    from rows in memory, MEMMAP_CHUNK_ROWS a chunk, scattered over the
    splits) and opened by CTRDataset under a 1 MB host budget; then, for
    supervised bf16 and MFP per-position k = 25 DCNv2 at full width, under
    `device_resident_data` auto (the train matrix uploaded from the memmap)
    and off (every batch gathered on the host by the native gather from
    the memmap): MEMMAP_STEPS graph-path steps, MEMMAP_TIMED_STEPS more
    on the host clock, then an eval, bit-equal to the same run from the
    in-RAM dataset with the same weights; the native
    gather serving every host batch of those runs (a call count); its rows
    bit-equal to np.take; the launches of K4, K3, K1, K2 (K5, K8 in MFP);
    host ms to gather a TRAIN_BATCH x 24 batch and a group of GRAPH_SPC,
    native against np.take, from RAM and from the warm memmap; wall ms a
    step, memmap against RAM;
    the alias build by the host library against map_tpu's loop at V."""
    import torch

    from map_tpu_torch import models
    from map_tpu_torch.data import artifacts, native
    from map_tpu_torch.data.dataset import CTRDataset, compute_feat_count
    from map_tpu_torch.objectives import alias
    from map_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_memmap_")
    lo, hi, vocab = field_blocks()
    d = os.path.join(work, "data")
    x, y, splits = memmap_layout(data, args.seed)
    write_memmap_meta(d, vocab, splits)
    t0 = time.perf_counter()
    ranges = artifacts.materialize_split_memmaps(d, MEMMAP_NAME, splits,
                                                 source=memmap_source(x, y))
    materialize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = CTRDataset(d, MEMMAP_NAME, pretrain=True, host_data_budget_mb=1)
    open_s = time.perf_counter() - t0
    same = all(np.array_equal(np.asarray(ds.X[s]), data.X[s])
               and np.array_equal(np.asarray(ds.Y[s]), data.Y[s]) for s in splits)
    check("memmap: the written splits are the in-RAM arrays, bit for bit, opened "
          "memory-mapped", ds.memory_mapped and isinstance(ds.X["train"], np.memmap)
          and same and ranges is not None and np.array_equal(ds.idx_low, x.min(0))
          and np.array_equal(ds.idx_high, x.max(0) + 1)
          and np.array_equal(ds.feat_count, compute_feat_count(data.X["train"], vocab)),
          rows=len(y), chunks=-(-len(y) // MEMMAP_CHUNK_ROWS))

    # the native gather against np.take, from RAM and from the warm memmap:
    # a batch of TRAIN_BATCH rows, and a graph call's group of GRAPH_SPC
    # batches (`Batcher.epoch_stacked`), each into an array made once
    gather = {}
    draw = np.random.default_rng(args.seed + 31)
    for shape_name, shape in (("batch", (TRAIN_BATCH,)), ("group", (GRAPH_SPC, TRAIN_BATCH))):
        idx = draw.integers(0, len(data.Y["train"]), shape)
        out = np.empty(shape + (len(FIELD_SIZES),), np.int32)
        for src_name, src in (("ram", data.X["train"]), ("memmap", ds.X["train"])):
            want = np.take(np.asarray(data.X["train"]), idx, axis=0)
            check(f"memmap: native rows from {src_name} ({shape_name}) bit-equal to np.take",
                  np.array_equal(native.take(src, idx), want)
                  and np.array_equal(np.take(src, idx, axis=0, mode="clip"), want))
            for how, fn in (("native", lambda s=src: native.take(s, idx, out)),
                            ("np_take", lambda s=src: np.take(s, idx, axis=0, mode="clip",
                                                              out=out))):
                fn()
                ts = []
                for _ in range(MEMMAP_GATHER_REPS):
                    t0 = time.perf_counter()
                    fn()
                    ts.append((time.perf_counter() - t0) * 1e3)
                gather[f"{how}_{src_name}_{shape_name}_ms"] = float(np.median(ts))
    probs = alias.noise_distribution(ds.feat_count)
    t0 = time.perf_counter()
    loop = alias.build_alias_table(probs)
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = alias.build_alias_table(probs, native=True)
    native_s = time.perf_counter() - t0
    check("memmap: the host library's alias table bit-equal to the loop's, V = "
          f"{vocab}", all(np.array_equal(a, b) for a, b in zip(loop, built)),
          loop_s=loop_s, native_s=native_s)

    runs, launches, walls = {}, {}, {}
    for kind in ("supervised", "mfp"):
        for resident in ("auto", "off"):
            for src_name in ("ram", "memmap"):
                ds_k = data if src_name == "ram" else ds
                fc = (compute_feat_count(data.X["train"], vocab) if src_name == "ram"
                      else ds.feat_count)
                c = dataclasses.replace(cfg, compute_dtype="bfloat16")
                out_dir = os.path.join(work, f"{kind} {resident} {src_name}")
                if kind == "mfp":
                    c = dataclasses.replace(c, pretrain=True, pt_type="MFP", proj_size=MFP_PROJ,
                                            pt_neg_num=MFP_NEG, nce_loss_type="nce",
                                            feat_count=fc, hybrid_mode="matmul")
                    targs = dataclasses.replace(
                        mfp_args(out_dir, args.seed, device_resident_data=resident),
                        data_dir=d if src_name == "memmap" else out_dir)
                else:
                    from map_tpu_torch.config import TrainingArguments

                    targs = TrainingArguments(
                        output_dir=out_dir, dataset_name=MEMMAP_NAME,
                        data_dir=d if src_name == "memmap" else "",
                        per_device_train_batch_size=TRAIN_BATCH,
                        per_device_eval_batch_size=EVAL_BATCH, learning_rate=LR,
                        weight_decay=WEIGHT_DECAY, lr_sched="const", num_train_epochs=1,
                        compute_dtype="bfloat16", seed=args.seed,
                        device_resident_data=resident)
                trainer = Trainer(models.from_config(c, torch.Generator().manual_seed(
                    args.seed)), c, targs, ds_k)
                reset_counts()
                calls = native.calls()
                with counting_takes() as seen:
                    # MEMMAP_STEPS steps (a warm-up call, a captured replay),
                    # the next MEMMAP_TIMED_STEPS timed, then the eval
                    batcher = trainer._prepare_training()
                    it = trainer.train_epoch(batcher, 0)
                    for _ in it:
                        if trainer.global_step >= MEMMAP_STEPS:
                            break
                    torch.cuda.synchronize()
                    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
                    t0 = time.perf_counter()
                    timed = 0
                    for n, _, _ in it:
                        timed += n
                        if timed >= MEMMAP_TIMED_STEPS:
                            break
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) / max(timed, 1) * 1e3
                    it.close()
                    ev = (trainer.MFP_pretrain_eval() if kind == "mfp"
                          else trainer.eval("valid"))
                    ev = {k: v for k, v in ev.items() if "time" not in k}
                    torch.cuda.synchronize()
                served = native.calls() - calls
                key = f"{kind} {resident}"
                runs.setdefault(key, {})[src_name] = (state, ev, trainer.global_step)
                walls[f"{key} {src_name}"] = wall_ms
                if src_name == "memmap":
                    launches[key] = trainer.launches_run(read_counts())
                    check(f"memmap {key}: every host gather by the native gather",
                          seen["takes"] > 0 and served == seen["takes"]
                          and trainer._native and (trainer._data is None) == (resident == "off"),
                          takes=seen["takes"], native_calls=served)
                del trainer, state
                torch.cuda.empty_cache()
            a, b = runs[key]["ram"], runs[key]["memmap"]
            differ = [k for k in a[0] if not torch.equal(a[0][k], b[0][k])]
            check(f"memmap {key}: {MEMMAP_STEPS} graph-path steps, then after "
                  f"{MEMMAP_TIMED_STEPS} more the eval, bit-equal to the in-RAM run", not differ and a[1] == b[1] and a[2] == b[2] >= MEMMAP_STEPS,
                  differ=differ[:5], eval_ram=a[1], eval_memmap=b[1])
            want = ["embedding_gather", "scatter_add", "fused_adamw", "cross_net"] + (
                ["scatter_unique_sorted", "block_cumsum"] if kind == "mfp" else [])
            check(f"memmap {key}: K4, K3, K1, K2{', K5, K8' if kind == 'mfp' else ''} "
                  "launched", all(launches[key].get(k, 0) > 0 for k in want),
                  launches=launches[key])
            del runs[key]
    shutil.rmtree(work, ignore_errors=True)
    total = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    out = dict(materialize_s=materialize_s, open_s=open_s, rows=len(y),
               chunk_rows=MEMMAP_CHUNK_ROWS,
               gather_rows={"batch": TRAIN_BATCH, "group": GRAPH_SPC * TRAIN_BATCH},
               gather_ms=gather, alias_s={"loop": loop_s, "native": native_s},
               wall_ms_per_step=walls, launches=launches,
               wall_s=time.perf_counter() - t_phase, card=smi_line())
    emit("memmap", **out)
    out["launches_total"] = total
    return out


def layers_phase(args, dev) -> dict:
    """10i. The layers no model calls (`nn/extras.py`, the five of
    `nn/layers.py`) at 24 fields, embed 16, batch TRAIN_BATCH: forward and
    backward (a seeded normal cotangent) on the card in f32, in f32 on the
    CPU and in f64 on the CPU; the card's error against f64 within
    TOL_LAYERS times the CPU f32 one's plus TOL_LAYERS_REL of the largest
    value, for the output and every gradient. OuterProductLayer's 'mat' kernel
    is map_tpu's einsum, defined only where the pairs equal the width (276
    != 16 here): its 'vec' and 'num' kernels run."""
    import copy

    import torch

    from map_tpu_torch.nn import extras as tx
    from map_tpu_torch.nn import layers as tl

    t0 = time.perf_counter()
    f, e, b = len(FIELD_SIZES), EMBED, TRAIN_BATCH
    cases = {
        "InterHAtAttentionalAggregation": (tx.InterHAtAttentionalAggregation(e), [(b, f, e)]),
        "InterHAtMultiHeadSelfAttention": (tx.InterHAtMultiHeadSelfAttention(
            e, None, 2, use_scale=True, layer_norm=True), [(b, f, e)]),
        "InterHAtFeedForward": (tx.InterHAtFeedForward(e), [(b, f, e)]),
        "PairwiseKeyAttention": (tx.PairwiseKeyAttention(e, 2), [(b, f, e), (b, f, f, e)]),
        "ProductLayer attn": (tx.ProductLayer(f, e, 1, 2, "attn", True, True,
                                              num_attn_heads=2), [(b, f, 1, e)]),
        "ProductLayer mean": (tx.ProductLayer(f, e, 2, 2, "mean", True, True, True),
                              [(b, f, 2, e)]),
        "MultiChannelOutputHead sum,max,sum": (tx.MultiChannelOutputHead(f, 2, e),
                                               [(b, f, 2, e)]),
        "MultiChannelOutputHead fc": (tx.MultiChannelOutputHead(f, 2, e, "fc"),
                                      [(b, f, 2, e)]),
        "OuterProductLayer vec": (tl.OuterProductLayer(f, e, "vec"), [(b, f, e)]),
        "OuterProductLayer num": (tl.OuterProductLayer(f, e, "num"), [(b, f, e)]),
        "SqueezeExtractionLayer": (tl.SqueezeExtractionLayer(f, 3), [(b, f, e)]),
        "BilinearInteractionLayer field_all": (tl.BilinearInteractionLayer(
            f, e, "field_all"), [(b, f, e)]),
        "BilinearInteractionLayer field_each": (tl.BilinearInteractionLayer(
            f, e, "field_each"), [(b, f, e)]),
        "BilinearInteractionLayer field_interaction": (tl.BilinearInteractionLayer(
            f, e, "field_interaction"), [(b, f, e)]),
        "SelfAttention": (tl.SelfAttention(e, 2), [(b, f, e)]),
        "IntermediateLayer": (tl.IntermediateLayer(e, 64, "relu", 0.0, True, True), [(b, f, e)]),
    }
    errs = {}
    gen = torch.Generator().manual_seed(args.seed + 37)
    for name, (mod, shapes) in cases.items():
        mod.reset_parameters(gen)
        mod.eval()
        xs = [torch.randn(s, generator=gen) for s in shapes]
        runs = ((copy.deepcopy(mod).double(), "cpu", torch.float64), (mod, "cpu", torch.float32),
                (copy.deepcopy(mod).to(dev), dev, torch.float32))
        outs, cot = [], None
        for m, place, dt in runs:
            inp = [t.detach().to(place, dt).requires_grad_(True) for t in xs]
            y_ = m(*inp)
            if cot is None:
                cot = torch.randn(y_.shape, generator=gen, dtype=torch.float64)
            y_.backward(cot.to(place, y_.dtype))
            outs.append([y_.detach().cpu().double()] + [t.grad.cpu().double() for t in inp]
                        + [p.grad.cpu().double() for p in m.parameters()])
        parts = ["out"] + [f"d input {i}" for i in range(len(xs))] + [
            f"d {n}" for n, _ in mod.named_parameters()]
        worst = 0.0
        for part, exact, cpu32, card32 in zip(parts, *outs):
            err, cpu_err = float((card32 - exact).abs().max()), float((cpu32 - exact).abs().max())
            bound = TOL_LAYERS * cpu_err + TOL_LAYERS_REL * float(exact.abs().max())
            check(f"layers {name}: {part}, the card (f32) within {TOL_LAYERS:g}x the CPU's "
                  f"own f32 error + {TOL_LAYERS_REL:g} of the largest value, against f64",
                  err <= bound and math.isfinite(err),
                  max_abs_err=err, cpu_f32_err=cpu_err, bound=bound)
            worst = max(worst, err)
        errs[name] = worst
        del runs
    torch.cuda.empty_cache()
    out = dict(batch=b, fields=f, embed=e, max_abs_err_vs_f64=errs,
               tol=[TOL_LAYERS, TOL_LAYERS_REL], wall_s=time.perf_counter() - t0)
    emit("layers", **out)
    return out


def preprocess_phase() -> dict:
    """10j. The preprocessing CLIs import on this machine (a host job that
    needs pandas and h5py when it runs: with both, and sklearn, hidden here
    too), and the vendored legacy StratifiedKFold gives map_tpu's pin."""
    import hashlib

    code = ("import sys\n"
            "for m in ('pandas', 'h5py', 'sklearn'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np\n"
            "from map_tpu_torch.data.preprocess import avazu, common, criteo, split_x4\n"
            "print(avazu.VALID_FIELDS[0], criteo.COLS[1], split_x4.RANDOM_SEED)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=str(HERE), timeout=120)
    from map_tpu_torch.data.preprocess import split_x4

    y = (np.random.default_rng(11).random(5000) < 0.2).astype(np.int64)
    digest = hashlib.md5(split_x4.stratified_kfold_legacy(y, 10, 2018).astype(
        np.int64).tobytes()).hexdigest()
    check("preprocess: the CLIs' modules import without pandas, h5py or sklearn",
          r.returncode == 0, stdout=r.stdout.strip(), stderr=r.stderr[-2000:])
    check("preprocess: the legacy StratifiedKFold at map_tpu's pin",
          digest == split_x4.LEGACY_PIN, digest=digest)
    out = dict(imported=r.stdout.strip(), legacy_digest=digest)
    emit("preprocess", **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--train_steps", type=int, default=55)
    # a rank of phase 10g's two-rank runs (started by the phase itself)
    ap.add_argument("--parallel_rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parallel_work", default="", help=argparse.SUPPRESS)
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
    if args.parallel_rank:
        return parallel_worker(args)
    import torch.nn.functional as F

    from map_tpu_torch import models
    from map_tpu_torch.config import Config, TrainingArguments
    from map_tpu_torch.data.loader import Batcher
    from map_tpu_torch.kernels import build
    from map_tpu_torch.nn import init
    from map_tpu_torch.ops import (
        cross,
        dedup_scatter,
        embedding,
        field_gather,
        fused_adamw,
        hybrid_gather,
        scatter,
        scan,
        scatter_unique,
        sparse_adamw,
    )
    from map_tpu_torch.serve import Predictor
    from map_tpu_torch.train import checkpoints
    from map_tpu_torch.train.trainer import Trainer
    from map_tpu_torch.utils.metrics import roc_auc

    # each kernel's launch counter: (module, attribute)
    counters = {"embedding_gather": (embedding, "launches"),
                "cross_net": (cross, "launches"),
                "fused_adamw": (fused_adamw, "launches"),
                "scatter_add": (scatter, "launches"),
                "scatter_unique_sorted": (scatter_unique, "launches"),
                "block_cumsum": (scan, "launches"),
                "sparse_adamw": (sparse_adamw, "launches"),
                "field_block_gather": (field_gather, "gather_launches"),
                "field_block_scatter": (field_gather, "scatter_launches")}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}

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
        k2_inputs["ragged bf16"] = cross_inputs(624, torch.bfloat16)
        got = cross.cross_net(*k2_inputs["ragged bf16"])
        torch.cuda.synchronize()
        compare("K2 bfloat16 (10000, 624) L=3, ragged D", got,
                cross.cross_net_plain(*k2_inputs["ragged bf16"]), *TOL_CROSS["bfloat16"])
        got = cross.cross_net(*k2_inputs["bfloat16"], save_residuals=True)
        ref = cross.cross_net_plain(*k2_inputs["bfloat16"], save_residuals=True)
        torch.cuda.synchronize()
        for part, g, r in zip(("Y", "X_l", "U_l"), got, ref):
            compare(f"K2 bfloat16 save_residuals {part}", g, r, *TOL_CROSS["bfloat16"])
        # the training call: (4096, 384) with the residuals, the same bits twice
        for dname in ("float32", "bfloat16"):
            x0, w, b = k2_inputs[dname]
            k2_inputs[f"train {dname}"] = (x0[:TRAIN_BATCH].contiguous(), w, b)
            got = cross.cross_net(*k2_inputs[f"train {dname}"], save_residuals=True)
            ref = cross.cross_net_plain(*k2_inputs[f"train {dname}"], save_residuals=True)
            again = cross.cross_net(*k2_inputs[f"train {dname}"], save_residuals=True)
            torch.cuda.synchronize()
            for part, g, r, a in zip(("Y", "X_l", "U_l"), got, ref, again):
                compare(f"K2 {dname} training call (4096, 384) L=3 {part}", g, r,
                        *TOL_CROSS[dname])
                check(f"K2 {dname} training call {part}: the same bits twice",
                      torch.equal(g, a))

    # 4b. K2 backward under autograd at the training shape
    for dname in ("float32", "bfloat16"):
        # clones: the inputs above are inference tensors, which autograd refuses
        x0, w, b = (t[:TRAIN_BATCH].clone() if i == 0 else t.clone()
                    for i, t in enumerate(k2_inputs[dname]))
        cot = (torch.randn(x0.shape, generator=gen) * 0.1).to(dev, x0.dtype)
        leaves = [t.clone().requires_grad_() for t in (x0, w, b)]
        before = cross.launches
        cross.cross_net(*leaves).backward(cot)
        torch.cuda.synchronize()
        check(f"K2 {dname} backward: one K2 launch under autograd",
              cross.launches == before + 1)
        with torch.no_grad():
            _, xs, us = cross.cross_net_plain(x0, w, b, save_residuals=True)
            ref = cross.cross_net_backward(x0, w, xs, us, cot)
        for part, leaf, r in zip(("dX0", "dW", "db"), leaves, ref):
            compare(f"K2 {dname} backward {part}, (4096, 384) L=3", leaf.grad, r,
                    *TOL_CROSS[dname])

    # 5. K1 and K3 vs plain
    def adam_inputs(shape):
        p = torch.randn(shape, generator=gen)
        mu = torch.randn(shape, generator=gen) * 1e-3
        nu = torch.rand(shape, generator=gen) * 1e-6
        g = torch.randn(shape, generator=gen) * 1e-3
        return [t.to(dev) for t in (p, mu, nu, g)]

    adam_s = fused_adamw.scalars(LR, WEIGHT_DECAY, 0.9, 0.999, 1e-8, 7)
    k1_inputs = {"table": adam_inputs((vocab, EMBED)), "leaf": adam_inputs((1000, 384))}
    k1_err = {}
    for key, (p, mu, nu, g) in k1_inputs.items():
        ref = [t.clone() for t in (p, mu, nu)]
        fused_adamw.fused_adamw_plain(*ref, g, adam_s)
        got = [t.clone() for t in (p, mu, nu)]
        fused_adamw.fused_adamw(*got, g, adam_s)
        torch.cuda.synchronize()
        k1_err[key] = max(compare(f"K1 {key} {tuple(p.shape)} {part}", a, r, *TOL_ADAMW)
                          for part, a, r in zip(("p", "mu", "nu"), got, ref))

    train_ids = torch.from_numpy(draw_ids(rng, TRAIN_BATCH)).to(dev)
    k3_grads = {}
    k3_err = {}
    for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        g = (torch.randn(TRAIN_BATCH, len(FIELD_SIZES), EMBED, generator=gen) * 1e-3
             ).to(dev, dtype)
        k3_grads[dname] = g
        got = scatter.scatter_add(train_ids, g, vocab)
        plain = scatter.scatter_add_plain(train_ids, g, vocab)
        # each side's f32 sum of a row's n gradients is within (n - 1) u sum|g|
        # of the exact sum, u = 2**-24
        flat = train_ids.reshape(-1).long()
        abs_sum = torch.zeros_like(plain).index_add_(0, flat, g.reshape(-1, EMBED).float().abs())
        count = torch.bincount(flat, minlength=vocab).float()[:, None]
        bound = 2 * (count - 1).clamp(min=0) * 2.0 ** -24 * abs_sum
        torch.cuda.synchronize()
        err = (got - plain).abs()
        k3_err[dname] = float(err.max())
        check(f"K3 {dname} grads, ids 4096x24 -> 1013519x16",
              bool((err <= bound).all()) and bool(got.isfinite().all()),
              max_abs_err=k3_err[dname], tolerance="2 (n - 1) 2**-24 sum|g| per row",
              max_duplicates=int(count.max()))
        check(f"K3 {dname} deterministic", torch.equal(
            got, scatter.scatter_add(train_ids, g, vocab)))

    # 5b. K6 against its plain versions: K6b (the small fields' gradient
    # tiles) at the training shape, K6a (their rows) at the serving shape;
    # and the bwd_pallas dense gradient against the flat K3 one
    bounds = tuple((int(a), int(b)) for a, b in zip(lo, hi))
    small, _ = hybrid_gather.field_groups(bounds)
    plan = tuple((pos, plo, pe) for pos, (_, _, _, plo, pe) in enumerate(small))
    small_cols = [fi for fi, *_ in small]
    utiles, _ = field_gather.plan_pairs(plan, vocab)
    small_ids = sum(b - a for _, a, b, _, _ in small)
    small_rows = torch.cat([torch.arange(a, b) for _, a, b, _, _ in small]).to(dev)
    lo_s = torch.tensor([a for _, a, _, _, _ in small], dtype=torch.int32, device=dev)
    hi_s = torch.tensor([b for _, _, b, _, _ in small], dtype=torch.int32, device=dev)

    def phys_of(id_t):
        sub = id_t[:, small_cols]
        return torch.where((sub >= lo_s) & (sub < hi_s), sub, -1).t().contiguous()

    k6_phys = phys_of(train_ids)
    k6b_inputs = {}
    k6b_err = 0.0
    label = (f"{TRAIN_BATCH} rows x {len(small)} small fields ({small_ids} ids, "
             f"{len(utiles)} tiles, the last ragged)")
    for dname, g in k3_grads.items():
        g_small = g[:, small_cols].reshape(TRAIN_BATCH, -1).contiguous()
        k6b_inputs[dname] = g_small
        got = field_gather.field_block_scatter(g_small, k6_phys, plan, vocab)
        again = field_gather.field_block_scatter(g_small, k6_phys, plan, vocab)
        ref = field_gather.field_block_scatter_plain(g_small, k6_phys, plan, vocab)
        torch.cuda.synchronize()
        k6b_err = max(k6b_err, compare(f"K6b {dname} g, {label}", got, ref, 0.0, 0.0))
        check(f"K6b {dname} deterministic", torch.equal(got, again))
        flat = hybrid_gather.table_grad(train_ids, g, vocab, bounds, NUM_RESERVED, "fwd")
        blocked = hybrid_gather.table_grad(train_ids, g, vocab, bounds, NUM_RESERVED,
                                           "bwd_pallas")
        torch.cuda.synchronize()
        check(f"bwd_pallas {dname} dense gradient: the small fields' rows bit-equal to "
              "the flat K3 route's", torch.equal(blocked[small_rows], flat[small_rows]),
              small_rows_max_abs=float((blocked[small_rows] - flat[small_rows]).abs().max()),
              all_rows_max_abs=float((blocked - flat).abs().max()),
              all_rows_bit_equal=torch.equal(blocked, flat))
        del flat, blocked
    serve_phys = phys_of(ids)
    with torch.inference_mode():
        got = field_gather.field_block_gather(table, serve_phys, plan, vocab)
        again = field_gather.field_block_gather(table, serve_phys, plan, vocab)
        ref = field_gather.field_block_gather_plain(table, serve_phys, plan, vocab)
        torch.cuda.synchronize()
        k6a_err = compare(f"K6a, ids {args.batch} x {len(small)} small fields -> "
                          f"{tuple(got.shape)}", got, ref, 0.0, 0.0)
        check("K6a deterministic", torch.equal(got, again))

    # 6. serving through Predictor
    cfg = Config(model_name="dcnv2", input_size=vocab, num_fields=len(FIELD_SIZES),
                 embed_size=EMBED, hidden_size=1000, num_hidden_layers=3,
                 hidden_act="relu", num_cross_layers=3,
                 idx_low=[int(x) for x in lo], idx_high=[int(x) for x in hi])
    model = models.from_config(cfg, torch.Generator().manual_seed(args.seed))
    score_ids = draw_ids(rng, args.rows)
    serving = {}
    serving_launches = {}
    with tempfile.TemporaryDirectory() as model_dir:
        checkpoints.save_model(model.state_dict(), model_dir, 1)
        for dname in ("bfloat16", "float32"):
            dataclasses.replace(cfg, compute_dtype=dname).save(model_dir)
            reset_counts()
            t0 = time.perf_counter()
            pred = Predictor(model_dir, 1, batch_size=args.batch)
            pred.predict_logits(score_ids[:args.batch])  # warm-up: one chunk
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            seconds = []
            for _ in range(SERVING_PASSES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = pred.predict_logits(score_ids)
                seconds.append(time.perf_counter() - t0)
            serving_launches[dname] = pred.launches_run(read_counts())
            serving[dname] = (pred, logits, seconds, setup_s)
    # each dtype: the construction's eager warm-up call, the warm-up chunk
    # and every timed pass (a replay counts the launches of its capture)
    chunks = -(-args.rows // args.batch)
    expected = 2 + SERVING_PASSES * chunks
    emit("serving_launches", launches=serving_launches, expected_each=expected,
         replays={d: v[0].replays for d, v in serving.items()})
    for dname, launched in serving_launches.items():
        check(f"serving {dname} launches: K4 and K2 once a chunk, replays counted",
              launched == {"embedding_gather": expected, "cross_net": expected,
                           "fused_adamw": 0, "scatter_add": 0, "scatter_unique_sorted": 0,
                           "block_cumsum": 0, "sparse_adamw": 0, "field_block_gather": 0,
                           "field_block_scatter": 0}
              and serving[dname][0].replays == expected - 1, launched=launched)

    def plain_forward(m, ids_t):
        """The Predictor's DCNv2 with both kernels swapped for their plain versions."""
        with plain_layers():
            return m(ids_t).reshape(-1).float()

    for dname, (pred, logits, seconds, setup_s) in serving.items():
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
        eager_bits_check(f"serving {dname}", pred, score_ids, logits)
        best = min(seconds)
        emit("serving", compute_dtype=dname, rows=args.rows, batch=args.batch,
             seconds=seconds, rows_per_s=args.rows / best, max_abs_err=err,
             setup_s=setup_s, prefetch=pred.prefetch,
             packed_blocks=[list(shape) for shape, _ in pred._blocks],
             logit_mean=float(got.mean()), logit_std=float(got.std()), card=smi)

    # 6b. where one serving pass spends its time on the card, in each dtype
    batches = -(-args.rows // args.batch)  # a step: one batch of --batch rows
    for dname, (pred, *_) in serving.items():
        prof = profile(lambda: pred.predict_logits(score_ids), top_n=8)
        emit("serving_profile", compute_dtype=dname, rows=args.rows, steps=batches,
             rows_per_s=args.rows / prof["wall_ms"] * 1e3,
             **kernel_ms_per_step(prof, batches), **prof)
    del serving, pred

    # 7. training through the Trainer, bf16 and f32
    data = teacher_dataset(rng, args.train_steps * TRAIN_BATCH)
    eval_batches = 2 * -(-EVAL_ROWS // EVAL_BATCH)  # valid once, test once
    train_dirs = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    train_launches = {}
    for dname in ("bfloat16", "float32"):
        cfg_d = dataclasses.replace(cfg, compute_dtype=dname)
        out_dir = os.path.join(train_dirs.name, dname)
        targs = TrainingArguments(
            output_dir=out_dir, dataset_name="in-memory", data_dir="",
            per_device_train_batch_size=TRAIN_BATCH,
            per_device_eval_batch_size=EVAL_BATCH, learning_rate=LR,
            weight_decay=WEIGHT_DECAY, lr_sched="const", num_train_epochs=1,
            logging_steps=10, compute_dtype=dname, seed=args.seed)
        trainer = Trainer(models.from_config(cfg_d, torch.Generator().manual_seed(args.seed)),
                          cfg_d, targs, data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        test = trainer.test()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the launches that ran: a graph's replay counts its captured launches
        counts = train_launches[dname] = trainer.launches_run(read_counts())
        steps = trainer.global_step
        expected = {"embedding_gather": steps + eval_batches,
                    "cross_net": steps + eval_batches,
                    "scatter_add": steps,
                    "fused_adamw": steps * k1_launches_a_step(trainer.optimizer),
                    "scatter_unique_sorted": 0, "block_cumsum": 0, "sparse_adamw": 0,
                    "field_block_gather": 0, "field_block_scatter": 0}
        windows = trainer.train_windows
        losses = [w["window_loss"] for w in windows]
        emit("training", compute_dtype=dname, steps=steps, batch=TRAIN_BATCH,
             wall_s=wall, windows=windows, eval_auc_logloss=trainer.eval_metrics,
             test=test, best_step=trainer.best_eval_step, launches=counts,
             expected_launches=expected, graphs=graph_replays(trainer),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        check(f"training {dname}: {args.train_steps} steps", steps == args.train_steps)
        check(f"training {dname}: loss finite and falling",
              all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              first_window_loss=losses[0], last_window_loss=losses[-1])
        check(f"training {dname}: eval AUC > 0.6", trainer.eval_metrics[0][0] > 0.6,
              eval_auc=trainer.eval_metrics[0][0])
        check(f"training {dname}: launches, K1 once a step", counts == expected
              and k1_launches_a_step(trainer.optimizer) == 1)

        # the best checkpoint, scored by Predictor
        cfg_d.save(out_dir)
        pred = Predictor(out_dir, trainer.best_eval_step, batch_size=EVAL_BATCH)
        pred_auc = roc_auc(data.Y["test"], pred.predict_proba(data.X["test"]))
        check(f"training {dname}: Predictor scores the best checkpoint",
              abs(pred_auc - test["eval_auc"]) <= 1e-4,
              predictor_auc=pred_auc, trainer_test_auc=test["eval_auc"])
        if dname == "bfloat16":
            carry_check("dcnv2 (the bf16 training run's weights)", trainer.model.state_dict(),
                        cfg_d)

        # 5 steps from the same weights, kernels vs plain versions on the card
        batches = list(Batcher(data.X["train"], data.Y["train"], TRAIN_BATCH,
                               shuffle=True, seed=args.seed).epoch(0))[:PARITY_STEPS]

        (k_loss, k_params, _), (p_loss, p_params, _) = (
            supervised_steps(dev, cfg_d, targs, batches, read_counts, seed=args.seed,
                             steps=args.train_steps, plain=plain) for plain in (False, True))
        p0 = dict(models.from_config(cfg_d, torch.Generator().manual_seed(args.seed))
                  .named_parameters())
        parity_check(f"training {dname}: {PARITY_STEPS} steps, kernels vs plain versions",
                     dname, LR, k_loss, p_loss, k_params, p_params, p0)
        del k_params, p_params, p0

        # K1's list launch on one real step (bf16 run): the trained model's
        # parameters and moments, the step's gradients and both wd values,
        # against the plain version, leaf by leaf
        if dname == "bfloat16":
            opt, update, captured = trainer.optimizer, trainer.optimizer.update, {}

            def capture_step(ps, mus, nus, gs, wds, scal, slot):
                captured.update(state=[[t.clone() for t in leaf] for leaf in zip(ps, mus, nus)],
                                gs=[g.clone() for g in gs],
                                ss=[step_scalars(scal, slot, wd) for wd in wds])
                update(ps, mus, nus, gs, wds, scal, slot)

            opt.update = capture_step
            try:
                trainer.train_step(batches[0])
            finally:
                opt.update = update
            k1_step = (captured["state"], captured["gs"], captured["ss"])
            st, gs, ss = k1_step
            ref = [[t.clone() for t in leaf] for leaf in st]
            fused_adamw.fused_adamw_multi_plain(*([leaf[j] for leaf in ref] for j in range(3)),
                                                gs, ss)
            got = [[t.clone() for t in leaf] for leaf in st]
            before = fused_adamw.launches
            fused_adamw.fused_adamw_multi(*([leaf[j] for leaf in got] for j in range(3)), gs, ss)
            torch.cuda.synchronize()
            pairs = [(a, b) for x, y in zip(got, ref) for a, b in zip(x, y)]
            k1_err["step"] = max(float((a - b).abs().max()) for a, b in pairs)
            wds = sorted({s_.wd for s_ in ss})
            check("K1 list launch on one training step's leaves: bit-equal to the plain "
                  "version, leaf by leaf, in one launch",
                  all(torch.equal(a, b) for a, b in pairs) and fused_adamw.launches == before + 1
                  and len(wds) == 2 and wds[0] == 0.0,
                  leaves=len(gs), elements=sum(g.numel() for g in gs), wd=wds,
                  max_abs_err=k1_err["step"])
            del ref, got, pairs

        # step time and where it goes
        for _ in range(3):
            trainer.train_step(batches[0])
        torch.cuda.synchronize()
        timed = 20
        t0 = time.perf_counter()
        for i in range(timed):
            trainer.train_step(batches[i % PARITY_STEPS])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / timed * 1e3
        emit("training_time", compute_dtype=dname, card=smi, batch=TRAIN_BATCH,
             step_ms=step_ms, examples_per_s=TRAIN_BATCH / step_ms * 1e3,
             trainer_window_examples_per_s=[w["examples_per_sec"] for w in windows])
        prof_steps = 5
        prof = profile(lambda: [trainer.train_step(batches[i]) for i in range(prof_steps)],
                       top_n=12)
        emit("training_profile", compute_dtype=dname, steps=prof_steps,
             busy_ms_per_step=prof["device_busy_ms"] / prof_steps,
             **kernel_ms_per_step(prof, prof_steps), **prof)
        k1_host_us = k1_plan_host_us(trainer.optimizer)
        del trainer, pred

        # today's path against the new default, on the same batches
        def make(resident, spc, cfg_d=cfg_d, targs=targs):
            return Trainer(models.from_config(cfg_d, torch.Generator().manual_seed(args.seed)),
                           cfg_d, dataclasses.replace(
                               targs, num_train_epochs=3, device_resident_data=resident,
                               steps_per_call=spc), data)

        path = path_phase(f"supervised {dname}", make)
        emit("k1_plan_host", compute_dtype=dname, us_per_step=k1_host_us,
             share_of_today_wall=k1_host_us / 1e3 / path["today"]["wall_ms_per_step"])
    train_dirs.cleanup()

    # 7b-9. RFD and MFP pretraining, and the finetunes from their checkpoints
    rfd = rfd_phase(args, dev, cfg, data, reset_counts, read_counts)
    finetune_phase(args, dev, cfg, data, rfd["ckpt"], "RFD", reset_counts, read_counts)
    shutil.rmtree(rfd["work"], ignore_errors=True)
    mfp = mfp_phase(args, dev, cfg, data, reset_counts, read_counts)
    pfs = mfp_shared_phase(args, dev, cfg, data, mfp, reset_counts, read_counts)
    finetune_phase(args, dev, cfg, data, mfp["ckpt"], "MFP", reset_counts, read_counts)
    shutil.rmtree(mfp["work"], ignore_errors=True)
    zoo = zoo_phase(args, dev, cfg, data, mfp, reset_counts, read_counts)

    # 10. times at the serving, training and MFP shapes. K4 at every shape
    # the main path launches it (the phases' own ids; the decoder table is
    # the MFP decoder's shape, random), with its launches by shape in each
    # training run, which must sum to the run's K4 count; its wrapper's host
    # time a call at the training input
    times = {}
    by_shape = k4_launches_by_shape(args.train_steps)
    for run, k4_count in (("rfd", rfd["launches"]), ("pf-shared", pfs["launches"]),
                          ("per-position", mfp["launches"]),
                          ("supervised bf16", train_launches["bfloat16"])):
        check(f"K4 launches by shape, {run} run: they sum to the run's count",
              sum(by_shape[run].values()) == k4_count["embedding_gather"],
              by_shape=by_shape[run], launches=k4_count["embedding_gather"])
    mask_num = pfs["k4_ids"]["targets"].shape[1]
    decoder = (torch.randn(vocab, MFP_PROJ, generator=torch.Generator().manual_seed(
        args.seed + 11)) * 0.05).to(dev)
    k4_cases = {
        "K4 f32": (table, ids, None),
        "K4 bf16 out": (table, ids, torch.bfloat16),
        "K4 training input": (table, train_ids, torch.bfloat16),
        "K4 MFP decoder": (decoder, mfp["fold_inputs"][0].reshape(
            TRAIN_BATCH, mask_num, 1 + MFP_NEG), None),
        "K4 pf-shared targets": (decoder, pfs["k4_ids"]["targets"], None),
        "K4 pf-shared noise": (decoder, pfs["k4_ids"]["noise"], None),
    }
    with torch.inference_mode():
        for key, (tab, id_t, out_dtype) in k4_cases.items():
            t = times[key] = k4_times(tab, id_t, out_dtype)
            t.update(plan=embedding.plan(id_t.numel(), tab.shape[1],
                                         out_dtype == torch.bfloat16, True)._asdict(),
                     launches_by_run={run: shapes.get(key, 0)
                                      for run, shapes in by_shape.items()})
            check(f"{key} {tuple(id_t.shape)} x {tab.shape[1]}: bit-equal to the plain "
                  "version, twice", t["bit_equal_twice"])
        # LR's (V, 1) table (LR, FM, DeepFM): K4 at E = 1, f32 out, the
        # training input and the serving ids (the scalar path)
        lr_table = (torch.randn(vocab, 1, generator=torch.Generator().manual_seed(
            args.seed + 12))).to(dev)
        for key, id_t in (("K4 LR table, training", train_ids),
                          ("K4 LR table, serving", ids)):
            t = times[key] = k4_times(lr_table, id_t, None)
            t.update(plan=embedding.plan(id_t.numel(), 1, False, True)._asdict())
            check(f"{key} {tuple(id_t.shape)} x 1: bit-equal to the plain version, twice",
                  t["bit_equal_twice"])
        times["K4 training input"]["host_us_per_call"] = host_us_per_call(
            lambda: embedding.embedding_lookup(table, train_ids, torch.bfloat16))
        del decoder

        def library_cross(x0, w, b, save_residuals=False):
            """The one-call-a-step chain: addmm, multiply, add a layer (9 calls
            at L = 3), and the residuals stacked where they are asked for."""
            xi, xs, us = x0, [], []
            for layer in range(w.shape[0]):
                u = torch.addmm(b[layer], xi, w[layer].t())
                xs.append(xi)
                us.append(u)
                xi = xi + x0 * u
            return (xi, torch.stack(xs), torch.stack(us)) if save_residuals else xi

        for key, inputs, res in (("K2 bf16", k2_inputs["bfloat16"], False),
                                 ("K2 f32", k2_inputs["float32"], False),
                                 ("K2 f32 D=624", k2_inputs["ragged"], False),
                                 ("K2 bf16 D=624", k2_inputs["ragged bf16"], False),
                                 ("K2 bf16 training call", k2_inputs["train bfloat16"], True),
                                 ("K2 f32 training call", k2_inputs["train float32"], True)):
            x0, w, b = inputs
            bsz, d = x0.shape
            num_layers = w.shape[0]
            dname = "bfloat16" if x0.dtype == torch.bfloat16 else "float32"
            flops = 2 * num_layers * bsz * d * d
            # x0 in and y out, W and b in, and each residual slab out
            nbytes = ((2 + (2 * num_layers if res else 0)) * bsz * d
                      + num_layers * d * d + num_layers * d) * x0.element_size()
            op_ms = flops / PEAK_FLOPS[dname] * 1e3
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            # the kernel and its yardsticks in turns; the L products alone
            # (cuBLAS, no epilogue) are the floor a fused kernel should approach
            times[key] = time_ms_each(dict(
                ms=lambda: cross.cross_net(x0, w, b, save_residuals=res),
                plain_ms=lambda: cross.cross_net_plain(x0, w, b, save_residuals=res),
                library_ms=lambda: library_cross(x0, w, b, save_residuals=res),
                products_ms=lambda: [torch.matmul(x0, w[layer].t())
                                     for layer in range(num_layers)]))
            # the chain again with no spin ahead of it: paced by the host's
            # launches where they take longer than the card's work
            host_paced = time_ms_each(dict(
                ms=lambda: cross.cross_net(x0, w, b, save_residuals=res),
                library_ms=lambda: library_cross(x0, w, b, save_residuals=res)), spin=False)
            times[key].update(
                ms_no_spin=host_paced["ms"], library_ms_no_spin=host_paced["library_ms"],
                bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                gflops=flops / 1e9, shape=[bsz, d, num_layers], save_residuals=res,
                plan=cross.plan(bsz, d, x0.dtype)._asdict())
            times[key].update(ms_over_library=times[key]["ms"] / times[key]["library_ms"],
                              ms_over_bound=times[key]["ms"] / times[key]["bound_ms"])

        # K1: the table and a leaf alone, and one training step's leaves in
        # one launch, each in turns with its plain version and its library
        # yardstick, torch._fused_adamw_ (one call for each wd group; its
        # algebra differs), on the same inputs
        step_t = torch.ones((), device=dev)
        st, gs, ss = k1_step
        k1_cases = {key: ([[p, mu, nu]], [g], [adam_s])
                    for key, (p, mu, nu, g) in k1_inputs.items()}
        k1_cases["step's leaves"] = (st, gs, ss)
        for key, (state, grads, sc) in k1_cases.items():
            n = sum(g.numel() for g in grads)
            byte_ms = 7 * 4 * n / HBM_BYTES_PER_S * 1e3  # p, mu, nu, g in; p, mu, nu out
            op_ms = 14 * n / PEAK_FLOPS["float32"] * 1e3
            lib = [[t.clone() for t in leaf] for leaf in state]
            groups = [[i for i, s_ in enumerate(sc) if (s_.wd != 0.0) == d] for d in (True, False)]

            def k1_library(lib=lib, grads=grads, groups=groups, sc=sc):
                for group in groups:
                    if group:
                        torch._fused_adamw_(
                            [lib[i][0] for i in group], [grads[i] for i in group],
                            [lib[i][1] for i in group], [lib[i][2] for i in group], [],
                            [step_t] * len(group), lr=sc[group[0]].lr, beta1=sc[0].b1,
                            beta2=sc[0].b2, weight_decay=sc[group[0]].wd, eps=sc[0].eps,
                            amsgrad=False, maximize=False)

            ps_, mus_, nus_ = ([leaf[j] for leaf in state] for j in range(3))
            # the step's form: the scalars from a row of a buffer on the card
            row = torch.tensor([fused_adamw.scalar_row(sc[0])], device=dev)
            wds = [s_.wd for s_ in sc]
            t = time_ms_each(dict(
                ms=lambda: fused_adamw.fused_adamw_leaves(ps_, mus_, nus_, grads, wds, row, 0),
                plain_ms=lambda: fused_adamw.fused_adamw_multi_plain(ps_, mus_, nus_, grads, sc),
                library_ms=k1_library))
            t.update(bound_ms=max(byte_ms, op_ms),
                     bound_by="bytes" if byte_ms >= op_ms else "operations",
                     leaves=len(grads), elements=n,
                     launches=len(fused_adamw.plan([g.numel() for g in grads])))
            t.update(ms_over_bound=t["ms"] / t["bound_ms"],
                     ms_over_library=t["ms"] / t["library_ms"])
            times[f"K1 {key}"] = t
            del lib

        def k3_times(k3_ids, g, vocab):
            """K3 as the step calls it (ms: the stable sort and the kernel),
            and apart: the sort alone and the kernel alone on sorted ids."""
            flat, e = k3_ids.reshape(-1), g.shape[-1]
            flat_long, g32 = flat.long(), g.reshape(-1, e).float()
            sorted_ids, perm = torch.sort(flat, stable=True)
            # ids (int32) and grads read once, the dense f32 table written once
            nbytes = flat.numel() * 4 + g.numel() * g.element_size() + vocab * e * 4
            counts = torch.bincount(flat_long)
            t = dict(
                ms=time_ms(lambda: scatter.scatter_add(k3_ids, g, vocab)),
                sort_ms=time_ms(lambda: torch.sort(flat, stable=True)),
                kernel_ms=time_ms(lambda: scatter.scatter_add_sorted(sorted_ids, perm, g, vocab)),
                plain_ms=time_ms(lambda: scatter.scatter_add_plain(k3_ids, g, vocab)),
                library_ms=time_ms(lambda: torch.zeros(vocab, e, device=dev)
                                   .index_add_(0, flat_long, g32)),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", width=e,
                # max_duplicates: the longest segment, which one warp sums in order
                ids=flat.numel(), segments=int((counts > 0).sum()),
                max_duplicates=int(counts.max()))
            t.update(kernel_over_bound=t["kernel_ms"] / t["bound_ms"],
                     plain_over_ms=t["plain_ms"] / t["ms"],
                     ms_over_library=t["ms"] / t["library_ms"])
            return t

        # K3 at the training shape; and, to show what its time depends on,
        # once with ids uniform over the whole table (few duplicates) in place
        # of the field-blocked ones, whose 4-to-8-id fields give segments of
        # about 1000 gradient rows that one thread sums in order
        uniform_ids = torch.randint(0, vocab, tuple(train_ids.shape), generator=gen,
                                    dtype=torch.int32).to(dev)
        # and on an MFP step's corrupted ids, where every masked position
        # holds the <mask> id 3: one segment of about 25,000 rows
        # and LR's (V, 1) table gradient from f32 rows (E = 1, the scalar walk)
        k3_grads["lr"] = (torch.randn(TRAIN_BATCH, len(FIELD_SIZES), 1,
                                      generator=gen) * 1e-3).to(dev)
        for key, dname, k3_ids in (("K3 LR table, f32, E = 1", "lr", train_ids),
                                   ("K3 bfloat16", "bfloat16", train_ids),
                                   ("K3 float32", "float32", train_ids),
                                   ("K3 bfloat16, uniform ids", "bfloat16", uniform_ids),
                                   ("K3 bfloat16, MFP corrupted ids", "bfloat16",
                                    mfp["corrupted"])):
            g = k3_grads[dname]
            times[key] = k3_times(k3_ids, g, vocab)
            got = scatter.scatter_add(k3_ids, g, vocab)
            if g.shape[-1] > 1:
                check(f"{key}: bit-equal to the plain version", torch.equal(
                    got, scatter.scatter_add_plain(k3_ids, g, vocab)),
                    max_duplicates=times[key]["max_duplicates"])
            else:
                # at width 1 the card's index_put_ sums a segment of 32 or
                # more rows by warps, not in turn: the plain version's
                # in-order sum is its CPU route (index_add_), and the card's
                # is held within the f32 sums' rounding bound
                plain = scatter.scatter_add_plain(k3_ids, g, vocab)
                flat = k3_ids.reshape(-1).long()
                abs_sum = torch.zeros_like(plain).index_add_(0, flat, g.reshape(-1, 1).abs())
                count = torch.bincount(flat, minlength=vocab).float()[:, None]
                bound = 2 * (count - 1).clamp(min=0) * 2.0 ** -24 * abs_sum
                check(f"{key}: bit-equal to the plain version's in-order sum (index_add_ "
                      "on the CPU), within the rounding bound of the card's index_put_",
                      torch.equal(got.cpu(), scatter.scatter_add_plain(
                          k3_ids.cpu(), g.cpu(), vocab))
                      and bool(((got - plain).abs() <= bound).all()),
                      max_duplicates=times[key]["max_duplicates"],
                      max_abs_err_card_plain=float((got - plain).abs().max()))
            del got

        # K5 on the MFP step's folded candidate stream: the dense output
        # written once, the num_unique valid entries (id and 33 values) read
        # once; the sentinel tail is not needed, and the library call adds
        # the valid entries only
        uids, vals, num_unique = mfp["k5_stream"]
        valid_ids, valid_vals = uids[:num_unique].long(), vals[:num_unique]
        width = vals.shape[1]
        nbytes = vocab * width * 4 + num_unique * (width + 1) * 4
        for mode in scatter_unique.MODES:
            times[f"K5 {mode}"] = dict(
                ms=time_ms(lambda: scatter_unique.scatter_unique_sorted(
                    uids, vals, vocab, (width - 1, 1), mode)),
                plain_ms=time_ms(lambda: scatter_unique.scatter_unique_sorted_plain(
                    uids, vals, vocab, (width - 1, 1), mode)),
                library_ms=time_ms(lambda: torch.zeros(vocab, width, device=dev)
                                   .index_add_(0, valid_ids, valid_vals)),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                stream=uids.numel(), num_unique=num_unique)
        # the fold around K5 in the decoder's backward (PyTorch ops)
        times["K5 highest"]["fold_ms"] = time_ms(
            lambda: dedup_scatter.sort_and_fold(*mfp["fold_inputs"], vocab))

        # K7 on the per-field shared step's streams: p, mu, nu read and
        # written once, each stream's valid entries (id and E values) read
        # once; no single PyTorch call computes it, so two yardsticks: the
        # library chain, and the port's dense route that K7 replaces
        target, noise, s, p0, mu0, nu0 = pfs["k7_inputs"]
        v7, e7 = p0.shape
        state = [t.clone() for t in (p0, mu0, nu0)]
        valid = [(st.uids[:n].long(), st.vals[:n])
                 for st, n in zip((target, noise), pfs["k7_valid"])]
        step_t = torch.ones((), device=dev)
        byte_ms = (24 * v7 * e7 + sum(pfs["k7_valid"]) * (e7 + 1) * 4) / HBM_BYTES_PER_S * 1e3
        op_ms = 16 * v7 * e7 / PEAK_FLOPS["float32"] * 1e3  # K1's 14 and two adds

        def k7_chain():
            g = torch.zeros(v7, e7, device=dev)
            for stream_ids, stream_vals in valid:
                g.index_add_(0, stream_ids, stream_vals)
            torch._fused_adamw_([state[0]], [g], [state[1]], [state[2]], [], [step_t],
                                lr=s.lr, beta1=s.b1, beta2=s.b2, weight_decay=s.wd,
                                eps=s.eps, amsgrad=False, maximize=False)

        row7 = torch.tensor([fused_adamw.scalar_row(s)], device=dev)

        def k7_dense_route():
            g = (scatter_unique.scatter_unique_sorted(*target, v7)[0]
                 + scatter_unique.scatter_unique_sorted(*noise, v7)[0])
            fused_adamw.fused_adamw_leaves(*([t_] for t_ in state), [g], [s.wd], row7, 0)

        times["K7"] = dict(
            ms=time_ms(lambda: sparse_adamw.sparse_adamw_step(*state, target, noise, s.wd,
                                                              row7, 0)),
            plain_ms=time_ms(lambda: sparse_adamw.sparse_adamw_plain(*state, target, noise, s)),
            library_ms=None, chain_ms=time_ms(k7_chain), dense_route_ms=time_ms(k7_dense_route),
            bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations",
            shape=[v7, e7], streams=[target.uids.numel(), noise.uids.numel()],
            valid=pfs["k7_valid"])
        del state

        # K8: x read once, the scan written once; torch.cumsum over dim 0 is
        # one library call (slow at the fold's length: few timed calls there)
        for key, x in pfs["k8_inputs"].items():
            times[f"K8 {key}"] = dict(
                ms=time_ms(lambda: scan.block_cumsum(x)),
                plain_ms=time_ms(lambda: scan.block_cumsum_plain(x)),
                library_ms=time_ms(lambda: torch.cumsum(x, 0),
                                   reps=3 if x.shape[0] > 100_000 else 20),
                bound_ms=2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                shape=list(x.shape))
        # K6b on the training step's small-field rows: g read once, the ids
        # read once, the tiles written once; the library call adds the same
        # rows onto a zero stack. K6a at the serving shape: the ids and the
        # distinct rows read once, the rows written once; the library call
        # is F.embedding and a mask.
        # Beside the bound stands K6b's order floor: its longest row's chain of
        # dependent adds, 4 cycles each at the card's top SM clock. "one hot
        # row": the 4-id field's ids all on its first row, a chain of 4096.
        u_rows = len(utiles) * field_gather.TILE
        sm_mhz = float(smi_line("clocks.max.sm").split()[0])
        pos4 = next(pos for pos, plo, pe in plan if pe - plo == 4)
        hot_phys = k6_phys.clone()
        hot_phys[pos4] = plan[pos4][1]

        def k6b_times(g_small, phys):
            stack_rows = field_gather.stack_rows(phys, plan, vocab).reshape(-1)
            keep = stack_rows >= 0
            vals = g_small.float().reshape(TRAIN_BATCH, len(small), EMBED).transpose(
                0, 1).reshape(-1, EMBED)[keep]
            rows_k = stack_rows[keep]
            nbytes = (g_small.numel() * g_small.element_size() + phys.numel() * 4
                      + u_rows * EMBED * 4)
            max_hits = int(torch.bincount(rows_k).max())
            t = dict(
                ms=time_ms(lambda: field_gather.field_block_scatter(g_small, phys, plan, vocab)),
                plain_ms=time_ms(lambda: field_gather.field_block_scatter_plain(
                    g_small, phys, plan, vocab), reps=3),
                library_ms=time_ms(lambda: torch.zeros(u_rows, EMBED, device=dev)
                                   .index_add_(0, rows_k, vals)),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                order_floor_ms=max_hits * 4 / (sm_mhz * 1e3), sm_clock_mhz=sm_mhz,
                rows=int(keep.sum()), tiles=len(utiles), max_hits_a_row=max_hits)
            t.update(ms_over_library=t["ms"] / t["library_ms"],
                     ms_over_bound=t["ms"] / t["bound_ms"])
            return t

        for dname, g_small in k6b_inputs.items():
            times[f"K6b {dname}"] = k6b_times(g_small, k6_phys)
        g_hot = k6b_inputs["bfloat16"]
        times["K6b bfloat16, one hot row"] = k6b_times(g_hot, hot_phys)
        got = field_gather.field_block_scatter(g_hot, hot_phys, plan, vocab)
        check("K6b bfloat16, one hot row: bit-equal to the plain version, twice",
              torch.equal(got, field_gather.field_block_scatter_plain(g_hot, hot_phys, plan, vocab))
              and torch.equal(got, field_gather.field_block_scatter(g_hot, hot_phys, plan, vocab)),
              max_hits_a_row=times["K6b bfloat16, one hot row"]["max_hits_a_row"])
        dense = torch.zeros(vocab, EMBED, device=dev)
        times["K6b bfloat16"]["add_ms"] = time_ms(lambda: field_gather.field_block_scatter_add(
            dense, k6b_inputs["bfloat16"], k6_phys, plan))
        valid = serve_phys >= 0
        serve_long = serve_phys.long().clamp(min=0)
        distinct = int(torch.unique(serve_phys[valid]).numel())
        nbytes = serve_phys.numel() * 4 + distinct * EMBED * 4 + serve_phys.numel() * EMBED * 4
        times["K6a"] = dict(
            ms=time_ms(lambda: field_gather.field_block_gather(table, serve_phys, plan, vocab)),
            plain_ms=time_ms(lambda: field_gather.field_block_gather_plain(
                table, serve_phys, plan, vocab)),
            library_ms=time_ms(lambda: torch.where(valid[..., None],
                                                   F.embedding(serve_long, table), 0.0)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            ids=serve_phys.numel(), distinct_rows=distinct,
            b_per_block=field_gather.gather_plan(*serve_phys.shape[::-1], EMBED,
                                                 build.sm_count(table.device.index)))

        # the MFP step's table gradient under the matmul backward, on one
        # step's corrupted ids: the small fields' one-hot products, and K3 on
        # the big fields' rows, against K3 on every row (above)
        route = hybrid_gather.routing(bounds, NUM_RESERVED, dev)
        mfp_ids = mfp["corrupted"]
        g_mfp = k3_grads["bfloat16"]
        sub = mfp_ids.index_select(1, route.small_idx)
        g_sub = g_mfp.index_select(1, route.small_idx).float()
        in_block = (sub >= route.lo) & (sub < route.hi)
        big_ids = mfp_ids.index_select(1, route.big_idx)
        big_g = g_mfp.index_select(1, route.big_idx)
        times["MFP matmul backward"] = dict(
            small_fields_matmul_ms=time_ms(lambda: hybrid_gather.add_matmul(
                dense, sub, g_sub, in_block, route), reps=5),
            k3_big_fields=k3_times(big_ids, big_g, vocab),
            whole_ms=time_ms(lambda: hybrid_gather.table_grad(
                mfp_ids, g_mfp, vocab, bounds, NUM_RESERVED, "matmul"), reps=5),
            fwd_whole_ms=time_ms(lambda: hybrid_gather.table_grad(
                mfp_ids, g_mfp, vocab, bounds, NUM_RESERVED, "fwd"), reps=5),
            k3_rows=big_ids.numel(), k3_mask_rows=int((big_ids == 3).sum()))
        del dense
    emit("times", card=smi, kernels=times)

    # 10b-10d. same-data validation, resume, the streaming eval and profile_steps
    val = validation_phase(args, dev, reset_counts, read_counts)
    zoo_val = zoo_validation_phase(args, dev, reset_counts, read_counts)
    resume_phase(args, dev, val)
    streaming_phase(args, dev, val)
    grouped_eval = grouped_eval_phase(args, dev, val, reset_counts, read_counts)
    chi_square_phase(args, dev, val)
    shutil.rmtree(val["work"], ignore_errors=True)

    # 10g. the parallel layer
    parallel = parallel_phase(args, dev, cfg, reset_counts, read_counts)

    # 10h-10j. the memmap mode and the native gather, the layers no model
    # calls, the preprocessing modules
    memmap = memmap_phase(args, dev, cfg, data, reset_counts, read_counts)
    layers_phase(args, dev)
    preprocess_phase()

    # 11. summary; each kernel's launches are those of the path that runs
    # it, counted from 0 over that path's run: the RFD run under the K6b
    # backward (this slice's main path: K1-K4, K6b) and the per-field shared
    # MFP run (K5, K7, K8). K6a has no caller in the package (nor in
    # map_tpu's): 0.
    # The zoo's paths (each model's supervised bf16 graph path, counted from
    # 0 before it) and the validation's five stages (each counted from 0
    # before it) add theirs: `launches` sums the paths, `launches_by_path`
    # gives each.
    src = "map_tpu_torch/csrc"
    main_path = {**pfs["launches"], **{k: v for k, v in rfd["launches"].items()
                                       if k not in ("scatter_unique_sorted",
                                                    "block_cumsum", "sparse_adamw")}}
    by_path = {name: {"dcnv2 rfd bwd_pallas / mfp pf-shared": n,
                      **{f"zoo {m} graph": zoo[m][name] for m in zoo},
                      "validation synthazu, five stages": val["launches"][name],
                      "zoo validation synthazu, nine models' stages": zoo_val.get(name, 0),
                      "grouped eval synthazu, four kinds x two dtypes": grouped_eval[name],
                      "serving dcnv2 pipelined, two dtypes": sum(
                          v[name] for v in serving_launches.values()),
                      "parallel nccl 1x1 graph path": parallel["launches_nccl_1x1"].get(name, 0),
                      f"parallel two ranks, both ranks, {PARALLEL_RUN_COUNT - 1} runs": parallel[
                          "launches_two_ranks"].get(name, 0),
                      "parallel full loss 1x2 psum f32, both ranks": parallel[
                          "launches_full"].get(name, 0),
                      "memmap supervised and mfp, resident auto and off": memmap[
                          "launches_total"].get(name, 0)}
               for name, n in main_path.items()}

    def entry(name, source, replaces, err, timing):
        return dict(name=name, route="cuda", source=f"{src}/{source}",
                    replaces=replaces, launches=sum(by_path[name].values()),
                    max_abs_err=err,
                    **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
                    launches_by_path=by_path[name])

    kernels = [
        entry("embedding_gather", "embedding_gather.cu",
              "map_tpu/ops/pallas_embedding.py:55", k4_err, times["K4 f32"]),
        entry("cross_net", "cross_net.cu", "map_tpu/ops/pallas_cross.py:98",
              k2_err["bfloat16"], times["K2 bf16"]),
        entry("fused_adamw", "fused_adamw.cu", "map_tpu/ops/fused_adamw.py:51",
              k1_err["step"], times["K1 step's leaves"]),
        entry("scatter_add", "scatter_add.cu", "map_tpu/ops/pallas_scatter.py:171",
              k3_err["bfloat16"], times["K3 bfloat16"]),
        entry("scatter_unique_sorted", "scatter_unique_sorted.cu",
              "map_tpu/ops/pallas_scatter.py:64", mfp["k5_err"], times["K5 highest"]),
        entry("sparse_adamw", "sparse_adamw.cu", "map_tpu/ops/sparse_adamw.py:229",
              pfs["k7_err"], times["K7"]),
        entry("block_cumsum", "block_cumsum.cu", "map_tpu/ops/pallas_scan.py:35",
              pfs["k8_err"], times["K8 target fold"]),
        entry("field_block_gather", "field_block.cu",
              "map_tpu/ops/pallas_field_gather.py:82", k6a_err, times["K6a"]),
        entry("field_block_scatter", "field_block.cu",
              "map_tpu/ops/pallas_field_gather.py:150", k6b_err, times["K6b bfloat16"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
