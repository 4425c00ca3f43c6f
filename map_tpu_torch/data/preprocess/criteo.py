"""Criteo's offline preprocessing. Counterpart:
`map_tpu/data/preprocess/criteo.py` (the reference's
`data_preprocess/proc_criteo.py`), the same artifacts for the same raw file:

- I1-I13 bucketed to floor(log(v)^2) for v > 2, kept for v <= 2, NaN -> -1;
- C1-C26 as they are, NaN -> '-1';
- the n-core vocabulary (default 10) with each field's `<oov>` and the 10
  reserved ids (`common.py`);
- `{name}.h5` and `{name}-meta.json`; the split comes from `split_x4.py`.

`--chunked` reads the raw file twice in `--chunk_rows` chunks
(`common.ChunkedVocabBuilder`, `artifacts.H5Writer`), for files whose frame
does not fit the host's RAM, and writes the single pass's bytes.

    python -m map_tpu_torch.data.preprocess.criteo --raw dac/train.txt --out data/criteo
        [--name criteo] [--n_core 10] [--down_sample N] [--chunked --chunk_rows N]

A host job: pandas and h5py are imported when it runs, not with the module.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np

from map_tpu_torch.data import artifacts
from map_tpu_torch.data.preprocess import common

NUM_FIELDS = [f"I{i}" for i in range(1, 14)]
CAT_FIELDS = [f"C{i}" for i in range(1, 27)]
COLS = ["click"] + NUM_FIELDS + CAT_FIELDS


def bucket_numeric(col) -> np.ndarray:
    """A pandas Series -> floor(log(v)^2) for v > 2, v for v <= 2, NaN -> -1
    (int64)."""
    import pandas as pd

    v = pd.to_numeric(col, errors="coerce").to_numpy(dtype=np.float64)
    out = np.where(np.isnan(v), -1.0, v)
    big = out > 2
    with np.errstate(invalid="ignore"):
        out = np.where(big, np.floor(np.log(np.where(big, out, 1.0)) ** 2), out)
    return out.astype(np.int64)


def clean_categorical(col) -> np.ndarray:
    return col.fillna("-1").to_numpy()


def _read(raw_path: str, **kwargs):
    import pandas as pd

    return pd.read_csv(raw_path, sep="\t", header=None, names=COLS, dtype=object,
                       encoding="utf-8", **kwargs)


def run(raw_path: str, out_dir: str, name: str = "criteo", n_core: int = 10,
        down_sample=None) -> None:
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    df = _read(raw_path)
    if down_sample:
        df = df.iloc[:down_sample]
    labels = pd.to_numeric(df["click"]).to_numpy().astype(np.int64)
    columns: Dict[str, np.ndarray] = {f: bucket_numeric(df[f]) for f in NUM_FIELDS}
    columns.update({f: clean_categorical(df[f]) for f in CAT_FIELDS})
    feat_ids, feat_map, field_map, field_names = common.build_dataset_arrays(columns, n_core)
    common.verify_field_blocked(feat_ids, field_map)
    artifacts.write_meta(out_dir, name, field_names, feat_map, field_map)
    artifacts.write_ctr_h5(out_dir, name, feat_ids, labels)
    print(f"criteo: {len(labels)} rows, input_size={len(feat_map)}, "
          f"num_fields={len(field_map) - 1}")


def run_chunked(raw_path: str, out_dir: str, name: str = "criteo", n_core: int = 10,
                chunk_rows: int = 2_000_000) -> None:
    """`run` in two passes of `chunk_rows` chunks: host memory about a chunk
    and the fields' count dicts; the same bytes as `run`."""
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    fields = NUM_FIELDS + CAT_FIELDS
    builder = common.ChunkedVocabBuilder(fields, n_core)

    def transformed(df, f):
        return bucket_numeric(df[f]) if f in NUM_FIELDS else clean_categorical(df[f])

    t0 = time.time()
    for i, df in enumerate(_read(raw_path, chunksize=chunk_rows)):
        for f in fields:
            builder.observe(f, transformed(df, f))
        print(f"  pass1 chunk {i}: +{len(df)} rows ({time.time() - t0:.0f}s)", flush=True)
    builder.finalize()
    print(f"  vocab built: input_size={len(builder.feat_map)} ({time.time() - t0:.0f}s)",
          flush=True)
    writer = artifacts.H5Writer(out_dir, name, len(fields))
    lo = hi = None
    for i, df in enumerate(_read(raw_path, chunksize=chunk_rows)):
        labels = pd.to_numeric(df["click"]).to_numpy().astype(np.int64)
        ids = np.stack([builder.map_chunk(f, transformed(df, f)) for f in fields], axis=1)
        clo, chi = ids.min(axis=0), ids.max(axis=0)
        lo = clo if lo is None else np.minimum(lo, clo)
        hi = chi if hi is None else np.maximum(hi, chi)
        writer.append(ids, labels)
        print(f"  pass2 chunk {i}: +{len(df)} rows ({time.time() - t0:.0f}s)", flush=True)
    n = writer.close()
    for f in range(len(lo) - 1):  # common.verify_field_blocked over the chunks
        assert hi[f] < lo[f + 1] or hi[f] < artifacts.NUM_RESERVED, \
            f"field blocks overlap at column {f}"
    artifacts.write_meta(out_dir, name, fields, builder.feat_map, builder.field_map)
    print(f"criteo (chunked): {n} rows, input_size={len(builder.feat_map)}, "
          f"num_fields={len(builder.field_map) - 1}, wall={time.time() - t0:.0f}s")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--raw", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--name", default="criteo")
    p.add_argument("--n_core", type=int, default=10)
    p.add_argument("--down_sample", type=int, default=None)
    p.add_argument("--chunked", action="store_true",
                   help="two passes over chunks, for raw files larger than RAM")
    p.add_argument("--chunk_rows", type=int, default=2_000_000)
    a = p.parse_args(argv)
    if a.chunked:
        if a.down_sample is not None:
            raise SystemExit("--down_sample is the in-RAM path's")
        run_chunked(a.raw, a.out, a.name, a.n_core, a.chunk_rows)
    else:
        run(a.raw, a.out, a.name, a.n_core, a.down_sample)


if __name__ == "__main__":
    main()
