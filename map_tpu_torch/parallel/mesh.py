"""The ('data', 'model') mesh over torch.distributed ranks. Counterpart:
`map_tpu/parallel/mesh.py:25-71` (`maybe_init_distributed`, `build_mesh`,
`data_parallel_size`).

A rank is a process with one device. `build_mesh(D, M)` lays the world out
row-major, as map_tpu's `build_mesh` reshapes its devices: rank r sits at
(data, model) = divmod(r, M). The 'data' axis carries data parallelism (each
data coordinate reads its own block of every global batch; the gradients
are summed over the data group), the 'model' axis row-sharded tables (the
ranks of a model group hold the row blocks of every vocabulary table and
read the same rows of data). `Group` wraps a process group with the
collectives the layer uses; a `Group` without one (no process group in the
run) does nothing, so a one-rank run makes no collective at all.

The backend is NCCL on the card and gloo on the CPU. Gloo is also the
backend of several ranks on one card (NCCL refuses two ranks on one
device): gloo takes CUDA tensors and copies them through host memory
itself, and a group of one gloo rank makes no collective.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _env_int(*names: str, default: int) -> int:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def maybe_init_distributed(backend: Optional[str] = None) -> int:
    """Initialise the default process group when the environment names
    more than one rank; returns the world size (1: nothing done).

    map_tpu's variables: MAP_TPU_COORDINATOR (host:port), MAP_TPU_NUM_PROCESSES,
    MAP_TPU_PROCESS_ID; torchrun's: RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT. The backend is `backend`, else
    MAP_TPU_DIST_BACKEND, else NCCL where a card is present and gloo
    otherwise; where a card is present a rank takes cuda:(LOCAL_RANK mod the
    cards), so gloo ranks may share one card."""
    if dist.is_initialized():
        return dist.get_world_size()
    coord = os.environ.get("MAP_TPU_COORDINATOR")
    world = _env_int("MAP_TPU_NUM_PROCESSES", "WORLD_SIZE", default=1)
    if world <= 1:
        return 1
    rank_ = _env_int("MAP_TPU_PROCESS_ID", "RANK", default=0)
    if not coord:
        coord = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
    backend = backend or os.environ.get("MAP_TPU_DIST_BACKEND") or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        torch.cuda.set_device(_env_int("LOCAL_RANK", default=rank_)
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world,
                            rank=rank_, timeout=datetime.timedelta(minutes=10))
    return world


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


class Group:
    """The ranks of one mesh axis that hold this rank, with the layer's
    collectives. `index` is this rank's place in `ranks`. Without a process
    group (`pg` None) every collective returns its input unchanged."""

    def __init__(self, ranks: List[int], index: int, pg=None):
        self.ranks = list(ranks)
        self.index = index
        self.pg = pg
        self.backend = dist.get_backend(pg) if pg is not None else None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def active(self) -> bool:
        return self.pg is not None

    def _noop(self) -> bool:
        """No process group; or one gloo rank (nothing to sum, and gloo
        would copy a CUDA tensor through the host and back). One NCCL rank
        still runs its collectives, which a CUDA graph captures."""
        return self.pg is None or (self.size == 1 and self.backend == "gloo")

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce `t` over the group ('sum', 'max' or 'min'), in place;
        returns t."""
        if not self._noop():
            dist.all_reduce(t, op=_REDUCE_OPS[op], group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in the group's order."""
        if self._noop():
            return t.unsqueeze(0)
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.pg)
        return torch.stack(parts)

    def barrier(self) -> None:
        if not self._noop():
            dist.barrier(group=self.pg)


class Mesh:
    """This rank's place on a (data, model) mesh and the groups of its two
    axes. `device` is the rank's device."""

    def __init__(self, num_data: int, num_model: int, rank_: int,
                 data_group: Group, model_group: Group, world: Group):
        self.shape = {DATA_AXIS: num_data, MODEL_AXIS: num_model}
        self.rank = rank_
        self.data_index, self.model_index = divmod(rank_, num_model)
        self.data_group = data_group
        self.model_group = model_group
        self.world = world

    @property
    def num_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def num_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def distributed(self) -> bool:
        """A process group backs the mesh (collectives run, of any size)."""
        return self.world.active

    def __repr__(self) -> str:
        return (f"Mesh(data={self.num_data}, model={self.num_model}, rank={self.rank}, "
                f"backend={self.world.backend})")


def build_mesh(num_data_shards: int = -1, num_model_shards: int = 1) -> Mesh:
    """The (data, model) mesh over the world's ranks, row-major (rank r at
    divmod(r, M)); num_data_shards -1 = world // num_model_shards. Every
    rank must call it (it creates the groups, in one order on every rank).
    Without a process group the mesh is 1 x 1, whatever the shard counts
    (as map_tpu builds no mesh on one device), and its groups are empty."""
    if not dist.is_initialized():
        solo = Group([0], 0)
        return Mesh(1, 1, 0, solo, solo, solo)
    n, r = world_size(), rank()
    m = max(1, int(num_model_shards))
    d = int(num_data_shards) if num_data_shards and num_data_shards > 0 else n // m
    if d * m != n:
        raise ValueError(f"mesh {d}x{m} != {n} ranks")
    di, mi = divmod(r, m)
    data_groups = [[i * m + j for i in range(d)] for j in range(m)]
    model_groups = [[i * m + j for j in range(m)] for i in range(d)]
    data_pg = model_pg = None
    for ranks in data_groups:  # every rank creates every group, in order
        pg = dist.new_group(ranks)
        if r in ranks:
            data_pg = pg
    for ranks in model_groups:
        pg = dist.new_group(ranks)
        if r in ranks:
            model_pg = pg
    return Mesh(d, m, r, Group(data_groups[mi], di, data_pg),
                Group(model_groups[di], mi, model_pg),
                Group(list(range(n)), r, dist.group.WORLD))


def data_parallel_size(args=None) -> int:
    """The data axis' size of the mesh `build_mesh` lays out: 1 without a
    process group (the mesh is 1 x 1 whatever the flags), else
    num_data_shards when given, else the world divided by the model axis.
    Raises, as `build_mesh` does, where the axes do not fill the world."""
    if not dist.is_initialized():
        return 1
    n = world_size()
    if args is None:
        return n
    m = max(1, int(args.num_model_shards))
    d = int(args.num_data_shards)
    d = d if d > 0 else n // m
    if d * m != n:
        raise ValueError(f"mesh {d}x{m} != {n} ranks")
    return d
