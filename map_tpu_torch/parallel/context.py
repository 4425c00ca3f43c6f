"""The process-global parallel context. Counterpart:
`map_tpu/parallel/context.py`.

The active mesh (`set_mesh`), the table exchange ('psum' | 'hotcold') and
the hot-row lists. map_tpu reads them at trace time; the port reads them
when a step runs, and a CUDA graph captures what they were at its capture,
so the Trainer sets them before it builds its steps (map_tpu
`trainer.py:172-200`). `table_mesh()` is the mesh when it row-shards tables
(model axis > 1), `data_group()` the data axis' group when a mesh is set
(a process group backs it: its collectives run, of any size).

The exchanges:
- 'psum': every shard gathers the rows it owns of the whole id stream
  (others zeroed) and the partials are summed over the model group
  (`parallel/embedding.sharded_embedding_lookup`);
- 'hotcold': each table's hot rows (the per-field frequency-descending
  prefixes, `Trainer._build_hot_rows`) come from a cache assembled once a
  lookup, the cold ids through a capacity-bounded sorted segment a shard
  (`hotcold_embedding_lookup`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from map_tpu_torch.parallel.mesh import Group, Mesh

_MESH: Optional[Mesh] = None
_TABLE_EXCHANGE: str = "psum"
# hot id lists keyed by the table's global row count (the port's tables
# are plain, pack factor 1: one list for every table of V rows)
_TABLE_HOT_ROWS: Dict[int, np.ndarray] = {}
_HOT_ON_DEVICE: Dict[tuple, Optional[torch.Tensor]] = {}

EXCHANGES = ("psum", "hotcold")


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def set_table_exchange(kind: str, hot_rows: Optional[dict] = None) -> None:
    """'psum' | 'hotcold' and, for 'hotcold', {rows: ascending (H,) ids}."""
    global _TABLE_EXCHANGE, _TABLE_HOT_ROWS
    if kind not in EXCHANGES:
        raise ValueError(f"table_exchange={kind!r}: one of {EXCHANGES}")
    _TABLE_EXCHANGE = kind
    _HOT_ON_DEVICE.clear()
    _TABLE_HOT_ROWS = {int(k): np.asarray(v, np.int32) for k, v in (hot_rows or {}).items()}


def table_exchange() -> str:
    return _TABLE_EXCHANGE


def table_hot_rows(num_rows: int) -> Optional[np.ndarray]:
    return _TABLE_HOT_ROWS.get(int(num_rows))


def table_hot_rows_on(num_rows: int, device: torch.device) -> Optional[torch.Tensor]:
    """The hot list as an int32 tensor on `device`, made once (so a CUDA
    graph capture finds it there: no copy in the captured step)."""
    key = (int(num_rows), str(device))
    if key not in _HOT_ON_DEVICE:
        rows = table_hot_rows(num_rows)
        _HOT_ON_DEVICE[key] = (None if rows is None
                               else torch.from_numpy(rows).to(device))
    return _HOT_ON_DEVICE[key]


def table_mesh() -> Optional[Mesh]:
    """The active mesh if it row-shards tables (model axis > 1), else None."""
    m = _MESH
    return m if m is not None and m.num_model > 1 else None


def data_group() -> Optional[Group]:
    """The data axis' group when a process group backs the mesh, else None."""
    m = _MESH
    return m.data_group if m is not None and m.distributed else None

