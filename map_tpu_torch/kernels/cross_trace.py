"""Where a K2 block's time goes, on the card.

    python -m map_tpu_torch.kernels.cross_trace [--batch 10000] [--d 384]
                                                 [--layers 3]

Builds the kernels with -DMAP_TPU_CROSS_TRACE (`kernels/build.py:DEFINES`;
each K2 block's thread 0 stamps the globaltimer at its phases, `trace` in
`csrc/cross_net.cu`), runs K2 through its wrapper in f32 and bf16, and
prints one JSON line a dtype: the span of the launch, how many blocks ran
at once and on how many SMs, and the median block's phases in microseconds
(set-up, each layer's product, each layer's epilogue and exchange). The
traced build is a library of its own name; the untraced one is left as it
is.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from map_tpu_torch.kernels import build
from map_tpu_torch.ops import cross

SLOTS = 16  # cross_net.cu's g_cross_trace: 16 slots a block, 8192 blocks


def traced_library() -> ctypes.CDLL:
    """The package's library built with MAP_TPU_CROSS_TRACE (beside the
    untraced one, under its own name); the wrappers launch it from here on."""
    build.DEFINES = ("MAP_TPU_CROSS_TRACE",)
    build.library.cache_clear()
    lib = build.library()
    lib.map_tpu_cross_trace.argtypes = [ctypes.c_void_p]
    lib.map_tpu_cross_trace.restype = ctypes.c_int
    return lib


def summary(stamps: np.ndarray, layers: int) -> dict:
    """Phase times (us) of the median block and the launch's concurrency."""
    t = stamps.astype(np.int64)
    rel = (t[:, :15] - t[:, 0].min()) / 1e3
    start, end = rel[:, 0], rel[:, 14]

    def med(a, b):
        return float(np.median(rel[:, b] - rel[:, a]))

    return dict(
        span_us=float(end.max()), blocks=len(t), sms=len(set(t[:, 15].tolist())),
        most_at_once=int(max(((start <= s) & (end > s)).sum() for s in start)),
        setup_us=med(0, 1),
        product_us=[med(1 if i == 0 else 1 + 2 * i, 2 + 2 * i) for i in range(layers)],
        epilogue_us=[med(2 + 2 * i, 3 + 2 * i) for i in range(layers)],
        block_us=med(0, 14))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--layers", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cross_trace: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = traced_library()
    stamps = np.zeros((8192, SLOTS), np.uint64)
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x0 = (torch.randn(args.batch, args.d, generator=gen) * 0.3).to("cuda", dtype)
        w = (torch.randn(args.layers, args.d, args.d, generator=gen)
             / args.d ** 0.5).to("cuda", dtype)
        b = (torch.randn(args.layers, args.d, generator=gen) * 0.1).to("cuda", dtype)
        for _ in range(3):
            cross.cross_net(x0, w, b)
        torch.cuda.synchronize()
        build.check_status(lib.map_tpu_cross_trace(stamps.ctypes.data), "cross_trace")
        p = cross.plan(args.batch, args.d, dtype)
        print(json.dumps(dict(dtype=str(dtype).removeprefix("torch."),
                              shape=[args.batch, args.d, args.layers],
                              card=torch.cuda.get_device_name(0), plan=p._asdict(),
                              **summary(stamps[:p.grid], args.layers))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
