"""The port's preprocessing CLIs against map_tpu's, on raw files built here
as map_tpu's `tests/test_preprocess.py` builds them: the same meta JSON,
`feat_ids` / `labels` (values and dtypes) and `split.pkl` for an Avazu and
a Criteo file, the chunked Criteo pass equal to the single one, the vendored
legacy StratifiedKFold at map_tpu's pin, and the modules importing without
pandas, h5py or sklearn (the card's machine has none of them).
"""

import gzip
import hashlib
import json
import os
import pickle
import subprocess
import sys

import h5py
import numpy as np
import pandas as pd
import pytest

from map_tpu.data.preprocess import avazu as jax_avazu
from map_tpu.data.preprocess import criteo as jax_criteo
from map_tpu.data.preprocess import split_x4 as jax_split
from map_tpu_torch.data.dataset import CTRDataset
from map_tpu_torch.data.preprocess import avazu, common, criteo, split_x4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AVAZU_COLS = ["C1", "banner_pos", "site_id", "site_domain", "site_category", "app_id",
              "app_domain", "app_category", "device_id", "device_ip", "device_model",
              "device_type", "device_conn_type", "C14", "C15", "C16", "C17", "C18",
              "C19", "C20", "C21"]


def _avazu_raw(path, n=2000):
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "id": np.arange(n), "click": rng.integers(0, 2, n),
        "hour": rng.choice([14102113, 14102204, 14102523, 14102900], n),
        **{c: rng.choice([f"v{i}" for i in range(int(rng.integers(2, 40)))], n)
           for c in AVAZU_COLS}})
    with gzip.open(path, "wt") as f:
        df.to_csv(f, index=False)
    return str(path)


def _criteo_raw(path, n=3000):
    """Numeric fields with holes, Zipf-like categorical ones with empties
    and ties (`tests/test_preprocess.py::test_chunked_criteo_matches_single_pass`)."""
    rng = np.random.default_rng(5)
    cols = [rng.integers(0, 2, n).astype(str)]
    for _ in range(13):
        v = rng.integers(-2, 4000, n).astype(object)
        v[rng.random(n) < 0.2] = ""
        cols.append(np.asarray(v, dtype=object))
    for _ in range(26):
        k = int(rng.integers(5, 400))
        v = np.minimum((rng.pareto(1.0, n) * 3).astype(np.int64), k)
        s = np.asarray([f"v{x:x}" for x in v], dtype=object)
        s[rng.random(n) < 0.1] = ""
        cols.append(s)
    with open(path, "w") as f:
        for r in range(n):
            f.write("\t".join(str(c[r]) for c in cols) + "\n")
    return str(path)


def _assert_same_artifacts(a, b, name, split=True):
    with open(f"{a}/{name}-meta.json") as fa, open(f"{b}/{name}-meta.json") as fb:
        ja, jb = json.load(fa), json.load(fb)
    assert ja == jb and list(ja["feat_map"]) == list(jb["feat_map"])
    with h5py.File(f"{a}/{name}.h5") as fa, h5py.File(f"{b}/{name}.h5") as fb:
        for k in ("feat_ids", "labels"):
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k][:], fb[k][:], err_msg=k)
    if split:
        with open(f"{a}/split.pkl", "rb") as fa, open(f"{b}/split.pkl", "rb") as fb:
            pa, pb = pickle.load(fa), pickle.load(fb)
        assert sorted(pa) == sorted(pb)
        for k in pa:
            assert pa[k].dtype == pb[k].dtype
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("down_sample", [None, 1500])
def test_avazu_artifacts_equal_map_tpus(tmp_path, down_sample):
    raw = _avazu_raw(tmp_path / "train.gz")
    jax_avazu.run(raw, str(tmp_path / "jax"), name="avazu", n_core=2,
                  down_sample=down_sample)
    argv = ["--raw", raw, "--out", str(tmp_path / "port"), "--n_core", "2"]
    avazu.main(argv + ([] if down_sample is None else ["--down_sample", str(down_sample)]))
    _assert_same_artifacts(tmp_path / "jax", tmp_path / "port", "avazu")
    ds = CTRDataset(str(tmp_path / "port"), "avazu")
    assert ds.num_fields == 25 and sum(len(v) for v in ds.Y.values()) == (down_sample or 2000)


def test_avazu_split_pkl_is_taken_as_given(tmp_path):
    raw = _avazu_raw(tmp_path / "train.gz", 500)
    given = tmp_path / "given.pkl"
    rng = np.random.default_rng(3)
    perm = rng.permutation(500)
    with open(given, "wb") as f:
        pickle.dump({"train_index": perm[:300], "valid_index": perm[300:400],
                     "test_index": perm[400:]}, f)
    for mod, out in ((jax_avazu, "jax"), (avazu, "port")):
        mod.run(raw, str(tmp_path / out), n_core=2, split_pkl=str(given))
    _assert_same_artifacts(tmp_path / "jax", tmp_path / "port", "avazu")


def test_criteo_artifacts_and_split_equal_map_tpus(tmp_path):
    raw = _criteo_raw(tmp_path / "dac.txt")
    jax_criteo.run(raw, str(tmp_path / "jax"), name="criteo")
    jax_split.run(str(tmp_path / "jax" / "criteo.h5"), str(tmp_path / "jax"))
    criteo.main(["--raw", raw, "--out", str(tmp_path / "port")])
    split_x4.main(["--labels", str(tmp_path / "port" / "criteo.h5"),
                   "--out", str(tmp_path / "port")])
    _assert_same_artifacts(tmp_path / "jax", tmp_path / "port", "criteo")
    ds = CTRDataset(str(tmp_path / "port"), "criteo", pretrain=True)
    assert ds.num_fields == 39 and ds.feat_count is not None


def test_chunked_criteo_equals_the_single_pass(tmp_path):
    raw = _criteo_raw(tmp_path / "dac.txt")
    jax_criteo.run(raw, str(tmp_path / "single"), name="criteo")
    criteo.main(["--raw", raw, "--out", str(tmp_path / "chunked"), "--chunked",
                 "--chunk_rows", "700"])
    _assert_same_artifacts(tmp_path / "single", tmp_path / "chunked", "criteo", split=False)


def test_legacy_split_pin_and_map_tpus_folds():
    rng = np.random.default_rng(11)
    y = (rng.random(5000) < 0.2).astype(np.int64)
    tf = split_x4.stratified_kfold_legacy(y, n_splits=10, seed=2018)
    assert hashlib.md5(tf.astype(np.int64).tobytes()).hexdigest() == split_x4.LEGACY_PIN
    assert split_x4.LEGACY_PIN == jax_split.stratified_kfold_legacy.__test_pin__
    y = (np.random.default_rng(5).random(997) < 0.27).astype(np.int64)
    for legacy in (True, False):
        got, want = split_x4.make_split(y, legacy=legacy), jax_split.make_split(y, legacy=legacy)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} legacy={legacy}")


def test_vocab_ties_and_oov_equal_map_tpus():
    from map_tpu.data.preprocess import common as jax_common

    rng = np.random.default_rng(2)
    cols = {"a": rng.choice(["x", "y", "z", "r1", "r2"], 400, p=[.3, .3, .3, .05, .05]),
            "b": rng.integers(0, 9, 400), "c": np.where(rng.random(400) < .2, None, "k")}
    got, want = common.build_dataset_arrays(cols, 5), jax_common.build_dataset_arrays(cols, 5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1:] == want[1:]


def test_modules_import_without_pandas_h5py_or_sklearn():
    code = ("import sys\n"
            "for m in ('pandas', 'h5py', 'sklearn'):\n"
            "    sys.modules[m] = None\n"
            "import map_tpu_torch.data.preprocess.common\n"
            "import map_tpu_torch.data.preprocess.avazu\n"
            "import map_tpu_torch.data.preprocess.criteo\n"
            "import map_tpu_torch.data.preprocess.split_x4 as s\n"
            "import map_tpu_torch.data.dataset\n"
            "assert s.make_split(__import__('numpy').arange(40) % 2)['test'].size == 4\n"
            "assert 'jax' not in sys.modules and 'map_tpu' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
