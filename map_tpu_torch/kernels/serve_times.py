"""Times `Predictor.predict_logits` of the map_tpu_torch package under --root,
so that two trees' serving can be timed by one script, in turns, on one
card:

    python map_tpu_torch/kernels/serve_times.py [--root DIR] [--rows 200000]
                                                [--batch 10000] [--seed 0]
                                                [--no_compress] [--threaded]

--root (default: this file's tree) is put first on sys.path for the
package; the model, the rows and the profile come from this file's tree
(`chip_smoke.py`'s serving phase): DCNv2 at full width (embed 16, the 24
fields of `FIELD_SIZES`, MLP 3 x 1000, 3 cross layers) from --seed, saved
as a port checkpoint with its config.json (the fields' id ranges in it),
and --rows field-blocked rows. For bf16 and f32: the Predictor built with
the constructor arguments both trees take (model_dir, step, batch_size),
one warm-up chunk, three timed passes (host clock, a synchronize after
each; `rows_per_s` is the best), and one pass under torch.profiler
(`chip_smoke.profile`: device-busy ms, idle share, the costliest kernels).
`--no_compress` passes `compress_transfer=False` where the tree's Predictor
takes it (the transfer of plain int32 ids); `--threaded` also times the
same Predictor's three stages on producer and drainer threads, as map_tpu
runs them (`threaded`), its logits checked against the Predictor's.
Prints one JSON line, and nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
PASSES = 3


def threaded(pred, ids):
    """The Predictor's three stages on threads, as map_tpu runs them: a
    producer thread checks and packs chunk i + 2 into pinned memory and
    copies it on a side stream, the calling thread replays chunk i + 1, a
    drainer thread waits for chunk i's logits by their event and writes
    them out; bounded queues, `pred.prefetch` deep -> the logits. A
    yardstick for the Predictor's stages interleaved on one thread, from
    its own parts (`_fill`, the captured graph)."""
    import queue
    import threading

    import numpy as np
    import torch

    n, bs = len(ids), pred.batch_size
    slots = pred.prefetch + 2  # no slot is reused before its last use was waited on
    host_in = [pred._host_blocks(pinned=True) for _ in range(slots)]
    dev_in = [[torch.empty_like(t) for t in pred._static_in] for _ in range(slots)]
    copied = [torch.cuda.Event() for _ in range(slots)]
    consumed = [torch.cuda.Event() for _ in range(slots)]
    host_out = [torch.empty(bs, pin_memory=True) for _ in range(slots)]
    fetched = [torch.cuda.Event() for _ in range(slots)]
    free_out: queue.Queue = queue.Queue()
    for o in range(slots):
        free_out.put(o)
    q: queue.Queue = queue.Queue(maxsize=pred.prefetch)
    rq: queue.Queue = queue.Queue(maxsize=pred.prefetch + 1)
    side = torch.cuda.Stream()
    out = np.empty(n, np.float32)
    errors = []

    def producer():
        try:
            for i, lo in enumerate(range(0, n, bs)):
                s = i % slots
                if i >= slots:
                    copied[s].synchronize()
                pred._fill(ids[lo:lo + bs], lo, host_in[s])
                with torch.cuda.stream(side):
                    if i >= slots:
                        side.wait_event(consumed[s])
                    for d, h in zip(dev_in[s], host_in[s]):
                        d.copy_(torch.from_numpy(h), non_blocking=True)
                    copied[s].record(side)
                q.put((lo, s))
            q.put(None)
        except BaseException as e:  # raised in the caller
            q.put(e)

    def drainer():
        try:
            while (item := rq.get()) is not None:
                lo, o = item
                fetched[o].synchronize()
                out[lo:lo + bs] = host_out[o].numpy()[:min(bs, n - lo)]
                free_out.put(o)
        except BaseException as e:  # raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=f, daemon=True) for f in (producer, drainer)]
    for t in threads:
        t.start()
    compute = torch.cuda.current_stream()
    with torch.inference_mode():
        while (item := q.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            lo, s = item
            compute.wait_event(copied[s])
            for st, d in zip(pred._static_in, dev_in[s]):
                st.copy_(d)
            consumed[s].record(compute)
            pred.graph.replay()
            o = free_out.get()
            host_out[o].copy_(pred._static_out, non_blocking=True)
            fetched[o].record(compute)
            rq.put((lo, o))
    rq.put(None)
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(TREE))
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_compress", action="store_true",
                    help="compress_transfer=False, where the tree's Predictor takes it")
    ap.add_argument("--threaded", action="store_true",
                    help="also time the Predictor's three stages on producer and drainer "
                         "threads")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(TREE))
    import chip_smoke as smoke

    sys.path.insert(0, str(Path(args.root).resolve()))
    for name in [m for m in sys.modules if m == "map_tpu_torch" or m.startswith("map_tpu_torch.")]:
        del sys.modules[name]
    import inspect

    import map_tpu_torch
    from map_tpu_torch import models
    from map_tpu_torch.config import Config
    from map_tpu_torch.serve import Predictor
    from map_tpu_torch.train import checkpoints

    options = {}
    kwargs = {}
    if args.no_compress and "compress_transfer" in inspect.signature(Predictor).parameters:
        kwargs = options["predictor"] = {"compress_transfer": False}

    rng = np.random.default_rng(args.seed)
    lo, hi, vocab = smoke.field_blocks()
    cfg = Config(model_name="dcnv2", input_size=vocab, num_fields=len(smoke.FIELD_SIZES),
                 embed_size=smoke.EMBED, hidden_size=1000, num_hidden_layers=3,
                 hidden_act="relu", num_cross_layers=3,
                 idx_low=[int(x) for x in lo], idx_high=[int(x) for x in hi])
    model = models.from_config(cfg, torch.Generator().manual_seed(args.seed))
    ids = smoke.draw_ids(rng, args.rows)
    out = {}
    with tempfile.TemporaryDirectory() as model_dir:
        checkpoints.save_model(model.state_dict(), model_dir, 1)
        for dname in ("bfloat16", "float32"):
            dataclasses.replace(cfg, compute_dtype=dname).save(model_dir)
            t0 = time.perf_counter()
            pred = Predictor(model_dir, 1, batch_size=args.batch, **kwargs)
            pred.predict_logits(ids[:args.batch])  # warm-up: one chunk
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            seconds = []
            for _ in range(PASSES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = pred.predict_logits(ids)
                seconds.append(time.perf_counter() - t0)
            prof = smoke.profile(lambda: pred.predict_logits(ids), top_n=6)
            out[dname] = dict(rows=args.rows, batch=args.batch, seconds=seconds,
                              rows_per_s=args.rows / min(seconds), setup_s=setup_s,
                              busy_ms=prof["device_busy_ms"], wall_ms=prof["wall_ms"],
                              idle_share=prof["idle_share"], top=prof["top"],
                              logit_mean=float(np.mean(logits)))
            if args.threaded and getattr(pred, "graph", None) is not None:
                one = []
                for _ in range(PASSES):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = threaded(pred, ids)
                    one.append(time.perf_counter() - t0)
                out[dname]["threaded"] = dict(seconds=one, rows_per_s=args.rows / min(one),
                                              bit_equal=bool(np.array_equal(got, logits)))
            del pred
            torch.cuda.empty_cache()
    smi = smoke.smi_line()
    print(json.dumps({"tree": str(Path(args.root).resolve()),
                      "package": str(Path(map_tpu_torch.__file__).parent),
                      "options": options, "card": smi, "serving": out}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
