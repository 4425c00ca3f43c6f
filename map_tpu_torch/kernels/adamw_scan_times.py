"""Times K1 (the AdamW update) over a training step's leaves and K8 (the
fold's scan) at the MFP folds' shapes, for the map_tpu_torch package under
--root, so that two trees can be timed by one script, in turns, on one card:

    python map_tpu_torch/kernels/adamw_scan_times.py [--root DIR] [--reps 20]

--root (default: this file's tree) is put first on sys.path; the timing
(`chip_smoke.time_ms_each`: CUDA events, L2 flushed and a ~1 ms spin queued
on the card ahead of each call, the calls in turns rep by rep) and the
shapes come from this file's tree. K1 takes its scalars as a step does:
from a row of a buffer on the card (`fused_adamw_leaves`), or by value in a
tree without it (`fused_adamw_multi`); a tree with neither list call
updates a step's leaves one launch a leaf.

K1: the canonical DCNv2's parameters (1,013,519 x 16 table, 24 fields, MLP
3 x 1000, 3 cross layers) with random moments and gradients and the
optimizer's wd mask: the table alone, the (1000, 384) leaf alone, and all
15 leaves as a supervised step updates them; beside the plain version,
the two `torch._fused_adamw_` calls of the decay and the no-decay group,
and the byte bound (28 bytes an element). K8: random (n, 33) f32 at the
per-position fold's, the per-field shared target fold's and noise fold's
lengths, and one of several rounds; beside `torch.cumsum` over dim 0 and
the byte bound. Beside each, `copy_ms`: `Tensor.copy_` of as many bytes
read and written, the floor of a pass over them in this harness. Prints one
JSON line, and nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
FOLDS = {"per-position fold": 745_472, "target fold": 28_672, "noise fold": 2_400,
         "several rounds": 3 * 745_472 + 1}
FOLD_WIDTH = 33


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(TREE))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("adamw_scan_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(TREE))
    import chip_smoke as smoke

    sys.path.insert(0, str(Path(args.root).resolve()))
    for name in [m for m in sys.modules if m == "map_tpu_torch" or m.startswith("map_tpu_torch.")]:
        del sys.modules[name]
    import map_tpu_torch
    from map_tpu_torch import models
    from map_tpu_torch.config import Config
    from map_tpu_torch.ops import fused_adamw, scan
    from map_tpu_torch.train.optimizer import decays

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    lo, hi, vocab = smoke.field_blocks()
    cfg = Config(model_name="dcnv2", input_size=vocab, num_fields=len(smoke.FIELD_SIZES),
                 embed_size=smoke.EMBED, hidden_size=1000, num_hidden_layers=3,
                 hidden_act="relu", num_cross_layers=3,
                 idx_low=[int(x) for x in lo], idx_high=[int(x) for x in hi])
    named = [(n, p.detach().to(dev)) for n, p in
             models.from_config(cfg, torch.Generator().manual_seed(args.seed)).named_parameters()]
    names = [n for n, _ in named]

    def state(p):
        return [(torch.randn(p.shape, generator=gen) * s).to(dev) for s in (1e-3, 1e-3)] \
            + [(torch.rand(p.shape, generator=gen) * 1e-6).to(dev)]

    ps = [p for _, p in named]
    mus, gs, nus = zip(*[state(p) for p in ps])
    wd = smoke.WEIGHT_DECAY
    ss = [fused_adamw.scalars(smoke.LR, wd if decays(n) else 0.0, 0.9, 0.999, 1e-8, 7)
          for n in names]
    multi = getattr(fused_adamw, "fused_adamw_multi", None)
    leaves = getattr(fused_adamw, "fused_adamw_leaves", None)

    def k1(idx):
        sel = [[seq[i] for i in idx] for seq in (ps, mus, nus, gs, ss)]
        if leaves is not None:  # the scalars from a row on the card, as a step takes them
            row = torch.tensor([fused_adamw.scalar_row(ss[0])], device=dev)
            return lambda: leaves(*sel[:4], [s.wd for s in sel[4]], row, 0)
        if multi is not None:
            return lambda: multi(*sel)
        return lambda: [fused_adamw.fused_adamw(*leaf) for leaf in zip(*sel)]

    def plain(idx):
        return lambda: [fused_adamw.fused_adamw_plain(ps[i], mus[i], nus[i], gs[i], ss[i])
                        for i in idx]

    step_t = torch.ones((), device=dev)
    lib_state = [[t.clone() for t in (ps[i], mus[i], nus[i])] for i in range(len(ps))]

    def library(idx):
        """torch._fused_adamw_ over the leaves: one call for the decay
        group, one for the no-decay group (a timing yardstick only: its
        algebra differs)."""
        groups = [[i for i in idx if (ss[i].wd != 0.0) == d] for d in (True, False)]

        def run():
            for d, group in zip((True, False), groups):
                if group:
                    torch._fused_adamw_(
                        [lib_state[i][0] for i in group], [gs[i] for i in group],
                        [lib_state[i][1] for i in group], [lib_state[i][2] for i in group],
                        [], [step_t] * len(group), lr=smoke.LR, beta1=0.9, beta2=0.999,
                        weight_decay=wd if d else 0.0, eps=1e-8, amsgrad=False,
                        maximize=False)
        return run

    table = names.index("embed.embedding.weight") if "embed.embedding.weight" in names \
        else max(range(len(ps)), key=lambda i: ps[i].numel())
    leaf = next(i for i, p in enumerate(ps) if tuple(p.shape) == (1000, 384))
    cases = {"K1 table": [table], "K1 leaf (1000, 384)": [leaf],
             "K1 step's leaves": list(range(len(ps)))}

    def copy_of(nbytes):
        """copy_ reading and writing nbytes / 2 bytes each"""
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        return lambda: dst.copy_(src)

    times = {}
    for key, idx in cases.items():
        n = sum(ps[i].numel() for i in idx)
        t = smoke.time_ms_each(dict(ms=k1(idx), plain_ms=plain(idx), library_ms=library(idx),
                                    copy_ms=copy_of(28 * n)), reps=args.reps)
        t.update(bound_ms=28 * n / smoke.HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 elements=n, leaves=len(idx),
                 launches=(len(fused_adamw.plan([ps[i].numel() for i in idx]))
                           if multi is not None else len(idx)))
        times[key] = t
    for key, rows in FOLDS.items():
        x = (torch.randn(rows, FOLD_WIDTH, generator=gen) * 1e-3).to(dev)
        t = smoke.time_ms_each(dict(ms=lambda: scan.block_cumsum(x),
                                    library_ms=lambda: torch.cumsum(x, 0),
                                    copy_ms=copy_of(2 * x.numel() * 4)),
                               reps=args.reps if rows < 1_000_000 else max(3, args.reps // 4))
        t.update(bound_ms=2 * x.numel() * 4 / smoke.HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 shape=[rows, FOLD_WIDTH])
        times[f"K8 {key}"] = t
        del x
    smi = smoke.smi_line()
    print(json.dumps({"tree": str(Path(args.root).resolve()),
                      "package": str(Path(map_tpu_torch.__file__).parent),
                      "card": smi, "kernels": times}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
