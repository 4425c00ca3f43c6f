"""Sharding rules: vocabulary tables row-sharded over the model axis, the
rest replicated, batches split over the data axis. Counterpart:
`map_tpu/parallel/sharding.py:40-125` (`is_vocab_table`, `leaf_pspec`,
`process_data_blocks`).

Which parameters are tables (`is_vocab_table`) is map_tpu's rule on the
port's names: the input embedding (`embed.embedding.weight`, FGCNN's
`fg_embed.embedding.weight`), the NCE decoder's `mfp_criterion.emb.weight`
and `mfp_criterion.bias.weight` (V, 1), the LR table `embed_w.weight`
(top level in LR, under `lr_layer` in FM, DeepFM and xDeepFM), and any 2-D
parameter with >= 4096 rows and >= 8x more rows than columns.

Row blocks: map_tpu's tables are packed and 512-row aligned, so every table
divides by the model axis (`:74-84`). The port's are flat and V may be odd,
so a table of V rows splits into blocks of ceil(V / M) rows, the last one
shorter (`shard_rows`); nothing falls back to replication. The exchanges
sum disjoint masked partials, so their result does not depend on where the
boundaries lie.

`shard_tables` replaces each table parameter of a model by its block (a new
Parameter on the same device, tagged with its `Shard`, which the lookups
read: `shard_of`); the optimizer then holds moments of the block's shape.
`gather_tables` / `slice_tables` turn a state dict of blocks into the full
one (a collective over the model group) and back, so a sharded run saves
the same `{step}.model` as an unsharded one and loads any save.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from map_tpu_torch.parallel.mesh import Group, Mesh

SHARD_ATTR = "map_tpu_shard"


class Shard(NamedTuple):
    """A table's row block: rows [lo, lo + rows) of `total`."""

    lo: int
    rows: int
    total: int


def shard_rows(total: int, num: int, index: int) -> Shard:
    """Block `index` of `num` over `total` rows: ceil(total / num) rows a
    block, the last one shorter."""
    per = -(-int(total) // int(num))
    lo = min(index * per, total)
    rows = min(per, total - lo)
    if rows <= 0:
        raise ValueError(f"a table of {total} rows has no rows for block {index} of {num}")
    return Shard(lo, rows, int(total))


def is_vocab_table(name: str, shape: Sequence[int]) -> bool:
    """map_tpu's `is_vocab_table` on the port's parameter names (a moment's
    name is its parameter's)."""
    if len(shape) != 2:
        return False
    keys = name.split(".")
    tail = keys[-2:]
    if any(k in ("embedding", "emb", "embed_w") for k in tail):
        return True
    if "bias" in tail and "mfp_criterion" in keys:  # the NCE decoder bias (V, 1)
        return True
    return shape[0] >= 4096 and shape[0] >= 8 * shape[1]


def leaf_pspec(name: str, shape: Sequence[int], table_sharding: str = "rows") -> str:
    """'rows' (sharded over the model axis) or 'replicated'."""
    if table_sharding == "replicated":
        return "replicated"
    return "rows" if is_vocab_table(name, shape) else "replicated"


def process_data_blocks(mesh: Mesh) -> Tuple[List[int], int]:
    """(blocks, D): the data blocks this rank reads, and the data axis'
    size. A rank has one device, so one block: its data coordinate; the
    ranks of a model group read the same block."""
    return [mesh.data_index], mesh.num_data


def shard_of(t: torch.Tensor) -> Optional[Shard]:
    return getattr(t, SHARD_ATTR, None)


@torch.no_grad()
def shard_tables(model: nn.Module, mesh: Mesh, table_sharding: str = "rows"
                 ) -> Dict[str, Shard]:
    """Replace every table parameter of `model` by this rank's row block
    (model axis > 1 and `rows`); returns {name: Shard}, empty otherwise."""
    shards: Dict[str, Shard] = {}
    if mesh.num_model <= 1 or table_sharding != "rows":
        return shards
    for name, p in list(model.named_parameters()):
        if leaf_pspec(name, p.shape, table_sharding) != "rows":
            continue
        s = shard_rows(p.shape[0], mesh.num_model, mesh.model_index)
        block = nn.Parameter(p[s.lo:s.lo + s.rows].clone(), requires_grad=p.requires_grad)
        setattr(block, SHARD_ATTR, s)
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner) if owner else model, attr, block)
        shards[name] = s
    return shards


def gather_rows(block: torch.Tensor, shard: Shard, group: Group) -> torch.Tensor:
    """The full (total, ...) table from every rank's block (a collective
    over the model group; blocks padded to ceil(total / M) rows)."""
    per = -(-shard.total // group.size)
    padded = block.new_zeros((per, *block.shape[1:]))
    padded[:block.shape[0]] = block
    return group.all_gather(padded).reshape(-1, *block.shape[1:])[:shard.total]


def gather_tables(tensors: Dict[str, torch.Tensor], shards: Dict[str, Shard],
                  group: Group) -> Dict[str, torch.Tensor]:
    """`tensors` with every block named in `shards` replaced by its full
    table (every rank of the model group must call it, in one order)."""
    return {k: gather_rows(v, shards[k], group) if k in shards else v
            for k, v in tensors.items()}


def slice_tables(tensors: Dict[str, torch.Tensor], shards: Dict[str, Shard]
                 ) -> Dict[str, torch.Tensor]:
    """`tensors` (full tables) with every table named in `shards` cut to
    this rank's block."""
    out = {}
    for k, v in tensors.items():
        s = shards.get(k)
        out[k] = v if s is None or v.shape[0] != s.total else v[s.lo:s.lo + s.rows]
    return out
