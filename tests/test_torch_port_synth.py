"""map_tpu_torch's synthetic data and artifact writers against map_tpu's.

- `generate_realistic_arrays` (synthazu) and `generate_arrays` give the
  arrays map_tpu's `generate_realistic` and `generate` write, read back bit
  for bit (dtypes included), with the default vocabularies and a small
  override;
- the port's writers give map_tpu's `-meta.json` and `split.pkl` bytes and
  the `.h5`'s dataset names, dtypes, shapes and values (HDF5 stores object
  times, so the `.h5`'s bytes differ);
- the in-memory dataset equals the port's `CTRDataset` of the written files;
- `data.synth`, `data.artifacts` and `validate` import without h5py.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from map_tpu.data import artifacts as jax_artifacts
from map_tpu.data import synth as jax_synth
from map_tpu_torch.data import synth
from map_tpu_torch.data.dataset import CTRDataset

ROWS = 3000
SMALL_VOCABS = [3, 7, 60, 200, 5, 16]


def _read_back(data_dir, name):
    x, y = jax_artifacts.read_ctr_h5(data_dir, name)
    return x, y, jax_artifacts.read_split(data_dir)


def _h5_datasets(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k].shape, f[k][:]) for k in f.keys()}


def _assert_same_artifacts(jax_dir, port_dir, name):
    for fname in (f"{name}-meta.json", "split.pkl"):
        with open(os.path.join(jax_dir, fname), "rb") as a, \
                open(os.path.join(port_dir, fname), "rb") as b:
            assert a.read() == b.read(), fname
    ref = _h5_datasets(os.path.join(jax_dir, f"{name}.h5"))
    got = _h5_datasets(os.path.join(port_dir, f"{name}.h5"))
    assert sorted(got) == sorted(ref) == ["feat_ids", "labels"]
    for key in ref:
        assert got[key][0] == ref[key][0] and got[key][1] == ref[key][1], key
        np.testing.assert_array_equal(got[key][2], ref[key][2], err_msg=key)


def _assert_arrays(arrays, jax_dir, name):
    x, y, splits = _read_back(jax_dir, name)
    assert arrays.feat_ids.dtype == x.dtype and arrays.labels.dtype == y.dtype
    np.testing.assert_array_equal(arrays.feat_ids, x)
    np.testing.assert_array_equal(arrays.labels, y)
    for s in ("train", "valid", "test"):
        np.testing.assert_array_equal(arrays.splits[s], splits[s])


def _assert_in_memory_is_ctr_dataset(arrays, data_dir, name):
    ref = CTRDataset(data_dir, name, pretrain=True)
    got = synth.in_memory(arrays, pretrain=True)
    for s in ("train", "valid", "test"):
        assert got.X[s].dtype == np.int32 and got.Y[s].dtype == np.float32
        np.testing.assert_array_equal(got.X[s], ref.X[s])
        np.testing.assert_array_equal(got.Y[s], ref.Y[s])
    np.testing.assert_array_equal(got.idx_low, ref.idx_low)
    np.testing.assert_array_equal(got.idx_high, ref.idx_high)
    np.testing.assert_array_equal(got.feat_count, ref.feat_count)
    assert (got.input_size, got.num_fields, got.field_blocked_ok) == (
        ref.input_size, ref.num_fields, ref.field_blocked_ok)
    assert synth.in_memory(arrays).feat_count is None


@pytest.mark.parametrize("vocab_sizes", [None, SMALL_VOCABS])
def test_realistic_arrays_and_files_are_map_tpus(tmp_path, vocab_sizes):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_synth.generate_realistic(jax_dir, num_rows=ROWS, vocab_sizes=vocab_sizes, seed=7)
    arrays = synth.generate_realistic_arrays(num_rows=ROWS, vocab_sizes=vocab_sizes, seed=7)
    _assert_arrays(arrays, jax_dir, "synthazu")
    synth.write(arrays, port_dir, "synthazu")
    _assert_same_artifacts(jax_dir, port_dir, "synthazu")
    _assert_in_memory_is_ctr_dataset(arrays, port_dir, "synthazu")
    if vocab_sizes is None:
        # map_tpu's Avazu-like mix: 101,178 ids, 24 fields, 13 of 60 ids or fewer
        assert arrays.vocab_size == 101_178 and len(arrays.vocab_sizes) == 24
        assert sum(v <= 60 for v in arrays.vocab_sizes) == 13


def test_generate_arrays_and_files_are_map_tpus(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(num_rows=ROWS, num_fields=6, vocab_per_field=25, seed=3)
    jax_synth.generate(jax_dir, name="synth", **kw)
    arrays = synth.generate_arrays(**kw)
    _assert_arrays(arrays, jax_dir, "synth")
    assert synth.generate(port_dir, name="synth", **kw) == port_dir
    _assert_same_artifacts(jax_dir, port_dir, "synth")
    _assert_in_memory_is_ctr_dataset(arrays, port_dir, "synth")


def test_h5_writer_appends_chunks(tmp_path):
    from map_tpu_torch.data import artifacts

    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (70, 4)).astype(np.int32)
    y = rng.integers(0, 2, 70)
    for mod, sub in ((artifacts, "port"), (jax_artifacts, "jax")):
        os.makedirs(tmp_path / sub)
        w = mod.H5Writer(str(tmp_path / sub), "d", 4)
        w.append(x[:30], y[:30])
        w.append(x[30:], y[30:])
        assert w.close() == 70
    ref = _h5_datasets(str(tmp_path / "jax" / "d.h5"))
    got = _h5_datasets(str(tmp_path / "port" / "d.h5"))
    for key in ref:
        assert got[key][:2] == ref[key][:2]
        np.testing.assert_array_equal(got[key][2], ref[key][2])
    rx, ry = artifacts.read_ctr_h5(str(tmp_path / "port"), "d")
    np.testing.assert_array_equal(rx, x)
    np.testing.assert_array_equal(ry, y)


def test_modules_import_without_h5py():
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import map_tpu_torch.data.synth, map_tpu_torch.data.artifacts, "
            "map_tpu_torch.validate\n"
            "a = map_tpu_torch.data.synth.generate_realistic_arrays(num_rows=200)\n"
            "d = map_tpu_torch.data.synth.in_memory(a, pretrain=True)\n"
            "assert d.input_size == 101178 and 'jax' not in sys.modules\n"
            "assert not any(m == 'map_tpu' or m.startswith('map_tpu.') for m in sys.modules)\n"
            "print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
