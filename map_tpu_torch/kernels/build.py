"""Build the CUDA sources under `map_tpu_torch/csrc/` and load them.

Route: `nvcc` by hand into one shared library with a plain C interface,
loaded with `ctypes` (no PyTorch headers, so a build takes seconds). Each
source compiles to an object in its own `nvcc` process, all started together,
and one more `nvcc` links them. The library lands in `build/map_tpu_torch/`
beside the package, named by a hash of the sources and flags, so a changed
source builds anew at its first use and an unchanged one is reused.

Every C entry point returns `cudaGetLastError()` after its launch;
`check_status` raises on anything but 0. A missing `nvcc` or a failed build
raises too: there is no prebuilt fallback.

`host_library()` builds the host C++ source `csrc/batcher.cpp` (the
Batcher's row gathers and the alias build, `data/native.py`) the same way,
with `g++` (or `nvcc` as the host compiler's driver when there is no
`g++`), into `libmap_tpu_torch_host_{hash}.so` beside the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "map_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas=-v"]
# Macros defined for every source, set before the first build; part of the
# library's name. `kernels/cross_trace.py` sets MAP_TPU_CROSS_TRACE.
DEFINES: Tuple[str, ...] = ()

_P = ctypes.c_void_p
_SIGNATURES = {
    # (table, ids, out, n, e, out_bf16, vec, units_a_thread, blocks, stream)
    "map_tpu_embedding_gather": [_P, _P, _P, ctypes.c_longlong] + [ctypes.c_int] * 5
                                + [_P],
    # (x0, w, b, y, xs, us, scratch, batch, d, layers, is_bf16, tile_rows,
    #  cluster, grid, smem, stages, x_buffers, vector, stream)
    "map_tpu_cross_net": [_P] * 7 + [ctypes.c_int] * 11 + [_P],
    # (leaves, count, units, blocks, scal, slot, stream)
    "map_tpu_fused_adamw_leaves": [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                   _P, ctypes.c_int, _P],
    # (sorted_ids, perm, grads, out, n, vocab, e, grads_bf16, stream)
    "map_tpu_scatter_add": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_int, _P],
    # (uids, vals, out0, out1, c, vocab, ew, e0, bf16x2, stream)
    "map_tpu_scatter_unique_sorted": [_P, _P, _P, _P, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, _P],
    # (p, mu, nu, t_uids, t_vals, nt, n_uids, n_vals, nn, vocab, e, wd,
    #  scal, slot, stream)
    "map_tpu_sparse_adamw": [_P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P,
                             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_float, _P, ctypes.c_int, _P],
    # (x, out, agg, n, w, tile_rows, tiles, grid, rounds, segs, seg_rows,
    #  part_tiles, smem, vector, stream)
    "map_tpu_block_cumsum": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong] + [ctypes.c_int] * 7 + [_P],
    # (g, phys, work, pair_pos, out, b, fs, w, r, blocks, g_bf16, add, stream)
    "map_tpu_field_block_scatter": [_P] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                                   + [ctypes.c_int] * 3 + [_P],
    # (table, phys, win_lo, win_hi, out, b, fs, w, b_per_block, stream)
    "map_tpu_field_block_gather": [_P] * 5 + [ctypes.c_int] * 4 + [_P],
}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _flags() -> List[str]:
    return COMPILE_FLAGS + [f"-D{name}" for name in DEFINES]


def _digest() -> str:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmap_tpu_torch_{_digest()}.so"


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the map_tpu_torch "
                           "kernels are built from source at first use")
    return found


def build() -> Path:
    """Compile every source (one nvcc each, in parallel) and link; returns
    the library path. Reuses a library built from the same sources."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        jobs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *_flags(), "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = work / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def build_log() -> str:
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


def timed_build() -> float:
    """Build from the sources (reusing nothing) and return the seconds taken."""
    lib = library_path()
    if lib.exists():
        lib.unlink()
    library.cache_clear()
    t0 = time.perf_counter()
    build()
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.map_tpu_error_string.argtypes = [ctypes.c_int]
    lib.map_tpu_error_string.restype = ctypes.c_char_p
    return lib


def current_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device
    `device_index`, which a C entry launches on: during a CUDA graph's
    capture, the capture stream. On an H100 host it takes about 0.2 us a
    call, against about 7 for `torch.cuda.current_stream().cuda_stream`,
    which builds a Stream object (`kernels/gather_times.py --sweep`)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SMs of CUDA device `device_index`, which the launch plans size
    their grids by."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_status(status: int, kernel: str) -> None:
    if status != 0:
        msg = library().map_tpu_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA error {status} ({msg})")


HOST_SOURCE = CSRC_DIR / "batcher.cpp"
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]


def host_library_path() -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    return BUILD_DIR / f"libmap_tpu_torch_host_{h.hexdigest()[:16]}.so"


def _host_compiler() -> List[str]:
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is not None:
        return [gxx, *HOST_FLAGS]
    # nvcc drives the host compiler for a .cpp source
    return [_nvcc(), "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC,-fopenmp"]


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """Build (once per source) and load the host library; raises if the
    build fails."""
    lib_path = host_library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="host-", dir=BUILD_DIR))
        try:
            tmp = work / lib_path.name
            run = subprocess.run([*_host_compiler(), str(HOST_SOURCE), "-o", str(tmp)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if run.returncode != 0:
                raise RuntimeError(f"host build of {HOST_SOURCE.name} failed:\n{run.stdout}")
            os.replace(tmp, lib_path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(str(lib_path))
    i64 = ctypes.c_int64
    lib.map_tpu_torch_gather_rows_i32.argtypes = [_P, i64, _P, i64, _P]
    lib.map_tpu_torch_gather_f32.argtypes = [_P, _P, i64, _P]
    lib.map_tpu_torch_build_alias.argtypes = [_P, i64, _P, _P]
    for fn in (lib.map_tpu_torch_gather_rows_i32, lib.map_tpu_torch_gather_f32,
               lib.map_tpu_torch_build_alias):
        fn.restype = None
    return lib
