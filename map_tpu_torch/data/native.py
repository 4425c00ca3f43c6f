"""ctypes bindings of the host library `csrc/batcher.cpp` (counterpart:
`map_tpu/native/__init__.py`): the Batcher's row gathers and the alias
table build, in C++ on the host. ctypes releases the GIL for the call, so
the prefetch thread's gathers overlap the training loop.

The library is built from the source at first use
(`kernels/build.host_library`); a failed build raises. There is no quiet
fallback: a caller picks the plain numpy versions itself (`np.take`,
`objectives/alias.build_alias_table`), as the port's CPU runs do, and the
native ones on a CUDA run (`Batcher.native`, `Trainer`).

`calls()` counts the gathers served (one a call of `take`, from any
thread), so a run can show that its host batches came through here.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

from map_tpu_torch.kernels import build

_calls = 0
_lock = threading.Lock()


def calls() -> int:
    """The gathers `take` has served in this process."""
    return _calls


def _addr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def take(src: np.ndarray, idx: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """src[idx] along axis 0 (idx of any shape) into `out` (made if None;
    C-contiguous, idx.shape + src.shape[1:], src's dtype): `np.take`'s
    values for in-range indices. src: a C-contiguous int32 matrix (rows of
    ids) or float32 vector (labels), in RAM or a memmap."""
    global _calls
    if not src.flags.c_contiguous or src.dtype not in (np.int32, np.float32) \
            or src.ndim != (2 if src.dtype == np.int32 else 1):
        raise TypeError(f"native take: a C-contiguous int32 matrix or float32 vector, "
                        f"not {src.dtype} {src.shape}")
    flat = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
    shape = tuple(np.shape(idx)) + src.shape[1:]
    if out is None:
        out = np.empty(shape, src.dtype)
    elif out.shape != shape or out.dtype != src.dtype or not out.flags.c_contiguous:
        raise ValueError(f"native take: out {out.dtype} {out.shape}, want {src.dtype} {shape}")
    lib = build.host_library()
    if src.ndim == 2:
        lib.map_tpu_torch_gather_rows_i32(_addr(src), src.shape[1], _addr(flat), len(flat),
                                          _addr(out))
    else:
        lib.map_tpu_torch_gather_f32(_addr(src), _addr(flat), len(flat), _addr(out))
    with _lock:
        _calls += 1
    return out


def build_alias(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walker's alias table (keep prob float32 (K,), alias int32 (K,)),
    bit-equal to `objectives/alias.build_alias_table`'s loop."""
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    prob = np.empty(len(probs), np.float32)
    alias = np.empty(len(probs), np.int32)
    build.host_library().map_tpu_torch_build_alias(_addr(probs), len(probs), _addr(prob),
                                                   _addr(alias))
    return prob, alias
