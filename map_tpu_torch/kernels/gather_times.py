"""Times K4 (the embedding row gather) at every shape the main path launches
it and K6a (the field-block gather) at the serving shape, for the
map_tpu_torch package under --root, so that two trees can be timed by one
script, in turns, on one card:

    python map_tpu_torch/kernels/gather_times.py [--root DIR] [--reps 20] [--sweep]

--root (default: this file's tree) is put first on sys.path; the timing
(`chip_smoke.k4_times` and `time_ms_each`: CUDA events, L2 flushed and a
~1 ms spin queued on the card ahead of each call, the calls in turns rep by
rep) and the shapes come from this file's tree. The ids are drawn as
`chip_smoke.py`'s phases draw them, from --seed: the serving batch (10000 x
24 field-blocked ids, the smoke's own), a training batch (4096 x 24, bf16
out), one MFP step's per-position candidates (4096 x 7 x 26: the masked
fields' ids and 25 draws each from the train split's unigram) into a
1,013,519 x 32 table, and per-field shared noise's targets (4096 x 7) and
noise (24 x 100, each field's unigram). Beside each: the plain version,
`F.embedding` (f32 out), `copy_ms` (`Tensor.copy_` of the output's size)
and the byte bound. K6a: the 21 small fields' rows of the serving batch,
beside its plain version, `F.embedding` and a mask, and `copy_` of its
output. `host_us_per_call`: K4's wrapper at the training input, 1,000 calls
with no synchronize. --sweep (a tree with `embedding.plan`) also times K4
under other launch plans (units a thread, units of 4 or 8 floats in bf16
out) and K6a under other rows of b a block, in turns with the default, and
the host time of the wrappers' stream lookups. Prints one JSON line, and
nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

TREE = Path(__file__).resolve().parents[2]


def draw_cases(smoke, dev, seed: int):
    """-> ({row name: (table, ids, out dtype)} of K4, (phys, plan, r) of K6a):
    the ids drawn as the smoke's phases draw them, from `seed`."""
    import torch

    from map_tpu_torch.nn import init
    from map_tpu_torch.objectives import alias
    from map_tpu_torch.objectives.corruption import mfp_corrupt, sample_masked_index
    from map_tpu_torch.ops import hybrid_gather

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    lo, hi, vocab = smoke.field_blocks()
    fields = len(smoke.FIELD_SIZES)
    table_cpu = torch.empty(vocab, smoke.EMBED)
    init.embedding_(table_cpu, fields, smoke.EMBED, gen)
    table = table_cpu.to(dev)
    serve_ids = torch.from_numpy(smoke.draw_ids(rng, 10_000)).to(dev)
    train = smoke.draw_ids(rng, 55 * smoke.TRAIN_BATCH)
    batch = torch.from_numpy(train[:smoke.TRAIN_BATCH]).to(dev)
    decoder = (torch.randn(vocab, smoke.MFP_PROJ, generator=gen) * 0.05).to(dev)

    # one MFP step's draws from the train split's unigram (the Trainer's noise)
    feat_count = np.bincount(train.reshape(-1), minlength=vocab)
    probs, logq, _ = alias.noise_log_prior(feat_count)
    fused = torch.from_numpy(alias.build_fused_alias(
        *alias.build_alias_table(probs), logq)).to(dev)
    draw = torch.Generator(device=dev).manual_seed(seed + 3)
    mask_num = int(fields * smoke.MFP_MASK_RATIO)
    masked = sample_masked_index(draw, smoke.TRAIN_BATCH, fields, mask_num, "randint", dev)
    targets = mfp_corrupt(batch, masked)[1]
    noise, _ = alias.alias_draw_logq(draw, fused, (smoke.TRAIN_BATCH, mask_num, smoke.MFP_NEG))
    candidates = torch.cat([targets[..., None], noise.to(targets.dtype)], -1)
    prob_f, alias_f, logq_f, _ = alias.build_per_field_alias(feat_count, lo.tolist(),
                                                             hi.tolist())
    fused_f = torch.from_numpy(alias.build_fused_alias(prob_f, alias_f, logq_f)).to(dev)
    lo_t = torch.from_numpy(lo.astype(np.int32)).to(dev)
    noise_f, _ = alias.per_field_alias_draw_logq(
        draw, fused_f, lo_t, torch.from_numpy((hi - lo).astype(np.int32)).to(dev),
        torch.arange(fields, device=dev), smoke.PFS_NEG)
    cases = {"K4 f32": (table, serve_ids, None),
             "K4 bf16 out": (table, serve_ids, torch.bfloat16),
             "K4 training input": (table, batch, torch.bfloat16),
             "K4 MFP decoder": (decoder, candidates, None),
             "K4 pf-shared targets": (decoder, targets, None),
             "K4 pf-shared noise": (decoder, noise_f, None)}

    # K6a: the small fields' rows of the serving batch, -1 outside their field
    bounds = tuple((int(a), int(b)) for a, b in zip(lo, hi))
    small, _ = hybrid_gather.field_groups(bounds)
    plan = tuple((pos, plo, pe) for pos, (_, _, _, plo, pe) in enumerate(small))
    lo_s = torch.tensor([a for _, a, _, _, _ in small], dtype=torch.int32, device=dev)
    hi_s = torch.tensor([b for _, _, b, _, _ in small], dtype=torch.int32, device=dev)
    sub = serve_ids[:, [fi for fi, *_ in small]]
    phys = torch.where((sub >= lo_s) & (sub < hi_s), sub, -1).t().contiguous()
    return cases, (phys, plan, vocab)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(TREE))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gather_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(TREE))
    import chip_smoke as smoke

    sys.path.insert(0, str(Path(args.root).resolve()))
    for name in [m for m in sys.modules if m == "map_tpu_torch" or m.startswith("map_tpu_torch.")]:
        del sys.modules[name]
    import torch.nn.functional as F

    import map_tpu_torch
    from map_tpu_torch.kernels import build
    from map_tpu_torch.ops import embedding, field_gather

    dev = torch.device("cuda")
    cases, k6a = draw_cases(smoke, dev, args.seed)
    table, batch = cases["K4 training input"][:2]
    times = {}
    with torch.inference_mode():
        for key, (tab, ids, out_dtype) in cases.items():
            times[key] = smoke.k4_times(tab, ids, out_dtype, reps=args.reps)
        times["K4 training input"]["host_us_per_call"] = smoke.host_us_per_call(
            lambda: embedding.embedding_lookup(table, batch, torch.bfloat16))

        # K6a: the small fields' rows of the serving batch
        phys, plan, vocab = k6a
        valid = phys >= 0
        phys_long = phys.long().clamp(min=0)
        k6a_ref = field_gather.field_block_gather_plain(table, phys, plan, vocab)
        src, dst = torch.empty_like(k6a_ref), torch.empty_like(k6a_ref)
        t = smoke.time_ms_each(dict(
            ms=lambda: field_gather.field_block_gather(table, phys, plan, vocab),
            plain_ms=lambda: field_gather.field_block_gather_plain(table, phys, plan, vocab),
            library_ms=lambda: torch.where(valid[..., None], F.embedding(phys_long, table), 0.0),
            copy_ms=lambda: dst.copy_(src)), reps=args.reps)
        distinct = int(torch.unique(phys[valid]).numel())
        nbytes = phys.numel() * 4 + distinct * smoke.EMBED * 4 + k6a_ref.numel() * 4
        t.update(bound_ms=nbytes / smoke.HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 ids=list(phys.shape), distinct_rows=distinct,
                 bit_equal_twice=all(torch.equal(field_gather.field_block_gather(
                     table, phys, plan, vocab), k6a_ref) for _ in range(2)))
        times["K6a"] = t

        sweep = {}
        if args.sweep and hasattr(embedding, "plan"):
            lib = build.library()
            sms = build.sm_count(0)
            stream = torch.cuda.current_stream().cuda_stream

            def k4_with(tab, ids, out, p):
                def run():
                    status = lib.map_tpu_embedding_gather(
                        tab.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(),
                        tab.shape[1], int(out.dtype == torch.bfloat16), p.vec,
                        p.units_a_thread, p.blocks, stream)
                    build.check_status(status, "embedding_gather")
                return run

            # K4 with 1, 2 or 4 units a thread, and in bf16 out with units of 4
            # floats (8-byte stores) as well as 8, beside the copy_ floor
            for key, (tab, ids, out_dtype) in cases.items():
                ref = embedding.embedding_lookup(tab, ids, out_dtype)
                n, e, bf16 = ids.numel(), tab.shape[1], out_dtype == torch.bfloat16
                default = embedding.plan(n, e, bf16, True)
                plans = {"default": default}
                for vec in ((4, 8) if bf16 else (4,)):
                    for u in embedding.UNITS:
                        blocks = -(-(n * e // vec) // (embedding.THREADS * u))
                        plans[f"vec {vec}, units {u}"] = embedding.Plan(
                            vec, u, min(blocks, embedding.MAX_BLOCKS))
                fns = {}
                for name, p in plans.items():
                    out = torch.empty_like(ref)
                    fns[name] = k4_with(tab, ids, out, p)
                    fns[name]()
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise AssertionError(f"{key}, plan {name}: not bit-equal")
                src, dst = torch.empty_like(ref), torch.empty_like(ref)
                fns["copy_"] = lambda dst=dst, src=src: dst.copy_(src)
                sweep[key] = dict(default=default._asdict(),
                                  ms=smoke.time_ms_each(fns, reps=args.reps))
            fs, b = phys.shape
            win_lo, win_hi = field_gather._gather_windows(plan, vocab, dev)
            out = torch.empty_like(k6a_ref)

            def k6a_with(t_b):
                def run():
                    status = lib.map_tpu_field_block_gather(
                        table.data_ptr(), phys.data_ptr(), win_lo.data_ptr(),
                        win_hi.data_ptr(), out.data_ptr(), b, fs, smoke.EMBED, t_b, stream)
                    build.check_status(status, "field_block_gather")
                return run

            sweep["K6a"] = dict(default=field_gather.gather_plan(b, fs, smoke.EMBED, sms),
                                ms=smoke.time_ms_each({f"b a block {t_b}": k6a_with(t_b)
                                                       for t_b in (1, 2, 4, 8, 16, 32)},
                                                      reps=max(5, args.reps // 2)))
            # the wrapper's stream lookup, on the host
            sweep["stream_host_us"] = {
                "current_stream().cuda_stream": smoke.host_us_per_call(
                    lambda: torch.cuda.current_stream().cuda_stream),
                "_cuda_getCurrentRawStream": smoke.host_us_per_call(
                    lambda: torch._C._cuda_getCurrentRawStream(0))
                if hasattr(torch._C, "_cuda_getCurrentRawStream") else None,
                "plan lookup": smoke.host_us_per_call(
                    lambda: embedding.plan(98_304, 16, True, True))}
    smi = smoke.smi_line()
    print(json.dumps({"tree": str(Path(args.root).resolve()),
                      "package": str(Path(map_tpu_torch.__file__).parent),
                      "card": smi, "kernels": times, "sweep": sweep}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
