"""map_tpu_torch: the PyTorch + CUDA port of map_tpu for NVIDIA Hopper.

The JAX package `map_tpu` is the reference; this package imports nothing of
it (nor JAX). Its layout mirrors map_tpu's (`nn/`, `models/`, `ops/`,
`interop/`, `train/`, `utils/`, `data/`, `serve.py`); the kernels that
map_tpu wrote in Pallas for the TPU are hand-written CUDA C++ under `csrc/`,
built by `kernels/build.py`.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`None` means the card. A CUDA device without a card raises: nothing
    silently carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "map_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
