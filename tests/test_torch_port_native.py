"""The port's host library (`csrc/batcher.cpp`, `data/native.py`) against
numpy and map_tpu, on the CPU: g++ builds it here as on the card's host.

Its row gathers give `np.take`'s bits (int32 rows of a matrix in RAM or a
memmap, float32 labels, indices of one or two axes, into a given array),
its alias build gives `objectives/alias.build_alias_table`'s loop and
map_tpu's `build_alias_table` bit for bit, and a failed build raises.
"""

import numpy as np
import pytest

from map_tpu.objectives import alias as jax_alias
from map_tpu_torch.data import native
from map_tpu_torch.data.loader import Batcher
from map_tpu_torch.kernels import build
from map_tpu_torch.objectives import alias


def test_the_host_library_builds_and_loads():
    assert build.host_library() is not None
    assert build.host_library_path().exists()


@pytest.mark.parametrize("shape", [(4096,), (8, 4096), (3,)])
def test_rows_and_labels_equal_np_take(tmp_path, shape):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 20, (50000, 24)).astype(np.int32)
    y = rng.random(50000).astype(np.float32)
    mm = np.memmap(tmp_path / "x.i32.mmap", np.int32, "w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    mm = np.memmap(tmp_path / "x.i32.mmap", np.int32, "r").reshape(x.shape)
    idx = rng.integers(0, 50000, shape)
    calls = native.calls()
    for src in (x, mm):
        assert np.array_equal(native.take(src, idx), np.take(x, idx, axis=0))
    out = np.empty(shape, np.float32)
    assert native.take(y, idx.astype(np.int32), out) is out
    assert np.array_equal(out, np.take(y, idx))
    assert native.calls() - calls == 3


def test_take_refuses_what_it_cannot_gather():
    x = np.zeros((10, 4), np.int32)
    with pytest.raises(TypeError):
        native.take(x[:, ::2], np.arange(3))
    with pytest.raises(TypeError):
        native.take(x.astype(np.int64), np.arange(3))
    with pytest.raises(ValueError):
        native.take(x, np.arange(3), np.empty((3, 5), np.int32))


def test_native_batcher_stream_equals_numpy():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 5000, (1037, 6)).astype(np.int32)
    y = rng.integers(0, 2, 1037).astype(np.float32)
    a, b = (Batcher(x, y, 128, shuffle=True, seed=7, noise_source=x,
                    noise_rows_per_example=2) for _ in range(2))
    b.native = True
    for (n1, g1, _), (n2, g2, _) in zip(a.epoch_stacked(4), b.epoch_stacked(4)):
        assert n1 == n2 and sorted(g1) == sorted(g2)
        for k in g1:
            assert g1[k].dtype == g2[k].dtype
            np.testing.assert_array_equal(g1[k], g2[k], err_msg=k)


@pytest.mark.parametrize("vocab", [1, 7, 100003])
def test_alias_build_equals_the_loop_and_map_tpus(vocab):
    rng = np.random.default_rng(vocab)
    count = np.floor(rng.zipf(1.2, vocab) % 1000).astype(np.float32)
    count[rng.random(vocab) < 0.3] = 0
    probs = alias.noise_distribution(count)
    loop = alias.build_alias_table(probs)
    built = alias.build_alias_table(probs, native=True)
    ref = jax_alias.build_alias_table(jax_alias.noise_distribution(count))
    for got in (built, ref):
        assert got[0].dtype == np.float32 and got[1].dtype == np.int32
        assert np.array_equal(got[0], loop[0]) and np.array_equal(got[1], loop[1])


def test_per_field_alias_native_equals_the_loop():
    rng = np.random.default_rng(9)
    lo = [10 + 500 * i for i in range(6)]
    count = rng.integers(0, 50, 10 + 500 * 6).astype(np.float32)
    a = alias.build_per_field_alias(count, lo, [v + 500 for v in lo])
    b = alias.build_per_field_alias(count, lo, [v + 500 for v in lo], native=True)
    for u, v in zip(a, b):
        assert np.array_equal(np.asarray(u), np.asarray(v))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "batcher.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "HOST_SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="host build"):
            build.host_library()
    finally:
        build.host_library.cache_clear()
