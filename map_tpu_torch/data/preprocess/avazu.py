"""Avazu's offline preprocessing. Counterpart:
`map_tpu/data/preprocess/avazu.py` (the reference's
`data_preprocess/proc_avazu.py`), the same artifacts for the same raw file:

- fields C1, banner_pos, the site / app / device fields, C14-C21, and
  `hour` (YYMMDDHH) expanded to weekday, day, hour and is_weekend;
- rows shuffled by `np.random.seed(42)`; `--down_sample` keeps the first n;
- the n-core vocabulary (default 5) with each field's `<oov>` and the 10
  reserved ids (`common.py`);
- `{name}.h5` (feat_ids int32, labels int64), `{name}-meta.json` and
  `split.pkl` (8:1:1 contiguous over the shuffled rows, or `--split_pkl`).

    python -m map_tpu_torch.data.preprocess.avazu --raw train.gz --out data/avazu
        [--name avazu] [--n_core 5] [--split 8:1:1 | --split_pkl path]
        [--down_sample N]

A host job: pandas and h5py are imported when it runs, not with the module.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, Optional

import numpy as np

from map_tpu_torch.data import artifacts
from map_tpu_torch.data.preprocess import common

RAW_FIELDS = ["click", "hour", "C1", "banner_pos", "site_id", "site_domain",
              "site_category", "app_id", "app_domain", "app_category",
              "device_id", "device_ip", "device_model", "device_type",
              "device_conn_type", "C14", "C15", "C16", "C17", "C18", "C19",
              "C20", "C21"]
VALID_FIELDS = ["weekday", "day", "hour", "is_weekend", "C1", "banner_pos",
                "site_id", "site_domain", "site_category", "app_id",
                "app_domain", "app_category", "device_id", "device_ip",
                "device_model", "device_type", "device_conn_type", "C14",
                "C15", "C16", "C17", "C18", "C19", "C20", "C21"]


def expand_hour(hour_raw: np.ndarray) -> Dict[str, np.ndarray]:
    """YYMMDDHH ints -> weekday, day, hour, is_weekend."""
    import pandas as pd

    ts = pd.to_datetime(pd.Series(hour_raw).astype(str), format="%y%m%d%H")
    weekday = ts.dt.weekday.to_numpy()
    return {"weekday": weekday, "day": ts.dt.day.to_numpy(), "hour": ts.dt.hour.to_numpy(),
            "is_weekend": (weekday > 4).astype(np.int64)}


def run(raw_path: str, out_dir: str, name: str = "avazu", n_core: int = 5,
        split: str = "8:1:1", split_pkl: Optional[str] = None,
        down_sample: Optional[int] = None) -> None:
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    df = pd.read_csv(raw_path, compression="gzip" if raw_path.endswith(".gz") else None,
                     usecols=list(RAW_FIELDS))
    np.random.seed(42)
    index = np.arange(len(df))
    np.random.shuffle(index)
    if down_sample:
        index = index[:down_sample]
    df = df.iloc[index].reset_index(drop=True)
    labels = df["click"].to_numpy().astype(np.int64)
    time_cols = expand_hour(df["hour"].to_numpy())
    columns = {f: time_cols[f] if f in time_cols else df[f].to_numpy() for f in VALID_FIELDS}
    feat_ids, feat_map, field_map, field_names = common.build_dataset_arrays(columns, n_core)
    common.verify_field_blocked(feat_ids, field_map)
    artifacts.write_meta(out_dir, name, field_names, feat_map, field_map)
    artifacts.write_ctr_h5(out_dir, name, feat_ids, labels)
    if split_pkl:
        with open(split_pkl, "rb") as f:
            payload = pickle.load(f)
        splits = {s: np.asarray(payload[f"{s}_index"]) for s in ("train", "valid", "test")}
    else:
        fr = [float(x) for x in split.split(":")]
        fr = [x / sum(fr) for x in fr]
        n = len(labels)
        n_train, n_valid = int(fr[0] * n), int(fr[1] * n)  # the rows are shuffled
        splits = {"train": np.arange(0, n_train),
                  "valid": np.arange(n_train, n_train + n_valid),
                  "test": np.arange(n_train + n_valid, n)}
    artifacts.write_split(out_dir, splits)
    print(f"avazu: {len(labels)} rows, input_size={len(feat_map)}, "
          f"num_fields={len(field_map) - 1}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--raw", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--name", default="avazu")
    p.add_argument("--n_core", type=int, default=5)
    p.add_argument("--split", default="8:1:1")
    p.add_argument("--split_pkl", default=None)
    p.add_argument("--down_sample", type=int, default=None)
    a = p.parse_args(argv)
    run(a.raw, a.out, a.name, a.n_core, a.split, a.split_pkl, a.down_sample)


if __name__ == "__main__":
    main()
