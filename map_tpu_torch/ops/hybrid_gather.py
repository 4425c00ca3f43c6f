"""Field-blocked hybrid embedding lookup: (B, F) ids, routed by field.
Counterpart: `map_tpu/ops/hybrid_gather.py` (`SMALL_FIELD_MAX` :61,
`_resolve_mode` :93-102, `field_groups` :105-128, the forward
`_gather_wide` :161-210, the backward `_hg_bwd` :230-305,
`_assemble_matmul` :317-337).

The dataset's ids are field-blocked: field f owns the rows [lo_f, hi_f),
ids 0-9 are reserved (padding, the MFP `<mask>` id 3). Fields of at most
`SMALL_FIELD_MAX` ids whose block starts at or above the reserved ids are
"small"; the rest are "big". map_tpu routes its lane-packed table this way
by default (`packed_lookup` with `field_bounds`); the port's table is plain,
so the pack factor is 1 and a field's row window is its block.

Values, as map_tpu's in every mode:
- Forward: K4 (`ops/embedding.py`) gathers every row from the whole table;
  a small field's id outside its block and outside the reserved ids gives
  0. In mode `bwd` the forward is the flat gather, unmasked.
- Backward (`_HybridLookup`, one dense (R, W) float32 gradient; the
  cotangent is summed in float32 whatever its dtype):
  - `fwd`: one flat K3 (`ops/scatter.py`) over all B*F rows, the ids the
    forward zeroed included;
  - `fwd_split`: every reserved id's rows as masked sums onto rows
    [0, nresv), the rest through K3;
  - `matmul`: per small field, onehot (s, B) @ g (B, W) at full float32
    (the precision is pinned "highest" for the call, as map_tpu pins
    Precision.HIGHEST); the big fields through K3;
  - `both`, `bwd`, `bwd_pallas`: the small fields' in-block rows through K6b
    (`ops/field_gather.py`), one launch for all of them; the big fields
    through K3. map_tpu picks an XLA or a Pallas form of this sum by backend
    and mode; they compute one function, which the port has one kernel for.
  In every decomposed mode (all but `fwd`) a small field's reserved ids are
  masked sums onto rows [0, nresv); the big fields' ids, reserved ones
  included, go through K3. K3 writes every row of its output, so the small
  fields' sums and the reserved sums are added after it.

The mode is `mode`, else `MAP_TPU_HYBRID_MODE`, else `fwd`; an unknown mode
raises. A mode that needs K6b fails loudly if it cannot build or launch it:
nothing falls back to another route.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch

from map_tpu_torch.data.dataset import NUM_RESERVED
from map_tpu_torch.ops.embedding import embedding_lookup
from map_tpu_torch.ops.field_gather import field_block_scatter_add
from map_tpu_torch.ops.scatter import scatter_add

SMALL_FIELD_MAX = int(os.environ.get("MAP_TPU_SMALL_FIELD_MAX", "16384"))
DEFAULT_MODE = "fwd"
MODES = frozenset({"fwd", "fwd_split", "both", "matmul", "bwd", "bwd_pallas"})

Bounds = Tuple[Tuple[int, int], ...]


def resolve_mode(mode: Optional[str]) -> str:
    resolved = mode or os.environ.get("MAP_TPU_HYBRID_MODE", DEFAULT_MODE)
    if resolved not in MODES:
        raise ValueError(f"unknown hybrid mode {resolved!r} (config.hybrid_mode / "
                         f"MAP_TPU_HYBRID_MODE); valid: {sorted(MODES)}")
    return resolved


def field_groups(bounds: Bounds, pack: int = 1, nresv: int = NUM_RESERVED):
    """-> (small, big): small a tuple of (field, lo, hi, plo, pe), [plo, pe)
    the row window; big a tuple of field indices. A block starting below
    nresv, or small blocks out of ascending order, go flat (map_tpu's rule)."""
    small, big = [], []
    for f, (lo, hi) in enumerate(bounds):
        if nresv <= lo and hi - lo <= SMALL_FIELD_MAX and hi > lo:
            small.append((f, lo, hi, lo // pack, (hi - 1) // pack + 1))
        else:
            big.append(f)
    for a, b in zip(small, small[1:]):
        if not (a[1] <= b[1] and a[4] <= b[4] and a[3] <= b[3]):
            return (), tuple(range(len(bounds)))
    return tuple(small), tuple(big)


class _Route(NamedTuple):
    small: tuple                # field_groups' small fields
    plan: tuple                 # (pos, plo, pe) for ops/field_gather.py
    small_idx: torch.Tensor     # (Fs,) int64 field indices
    big_idx: torch.Tensor       # (Fb,) int64
    lo: torch.Tensor            # (Fs,) int32 block starts
    hi: torch.Tensor            # (Fs,) int32 block ends
    lo_f: torch.Tensor          # (F,) int32: a small field's block, else all ids
    hi_f: torch.Tensor


def routing(bounds: Bounds, nresv: int, device: torch.device) -> _Route:
    """The fields' routing as tensors on `device`, built once per bounds."""
    return _routing(bounds, nresv, SMALL_FIELD_MAX, device)


@functools.lru_cache(maxsize=64)
def _routing(bounds: Bounds, nresv: int, small_max: int, device: torch.device) -> _Route:
    small, big = field_groups(bounds, 1, nresv)
    lo_f = [-2 ** 31] * len(bounds)
    hi_f = [2 ** 31 - 1] * len(bounds)
    for fi, lo, hi, _, _ in small:
        lo_f[fi], hi_f[fi] = lo, hi

    def t(values, dtype):
        return torch.tensor(list(values), dtype=dtype, device=device)

    return _Route(
        small, tuple((pos, plo, pe) for pos, (_, _, _, plo, pe) in enumerate(small)),
        t((s[0] for s in small), torch.int64), t(big, torch.int64),
        t((s[1] for s in small), torch.int32), t((s[2] for s in small), torch.int32),
        t(lo_f, torch.int32), t(hi_f, torch.int32))


def _forward(table: torch.Tensor, ids: torch.Tensor, bounds: Bounds, nresv: int,
             mode: str, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    rows = embedding_lookup(table, ids, out_dtype)
    if mode == "bwd":
        return rows
    route = routing(bounds, nresv, ids.device)
    if not route.small:
        return rows
    keep = ((ids >= route.lo_f) & (ids < route.hi_f)) | (ids < nresv)
    return torch.where(keep[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))


@contextlib.contextmanager
def _full_f32():
    """float32 matmuls at full float32 precision inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _reserved_sums(ids: torch.Tensor, g: torch.Tensor, nresv: int) -> torch.Tensor:
    """(nresv, W) float32: row j = sum of g over the positions holding id j,
    as one product of the ids' (nresv, N) one-hot and the (N, W) rows."""
    flat = ids.reshape(-1)
    onehot = (torch.arange(nresv, device=ids.device)[:, None] == flat[None, :]).float()
    with _full_f32():
        return onehot @ g.reshape(flat.numel(), -1)


def add_matmul(dense: torch.Tensor, sub: torch.Tensor, g_sub: torch.Tensor,
                in_block: torch.Tensor, route: _Route) -> None:
    """dense[lo:hi] += onehot(local)^T @ g for each small field, in float32."""
    with _full_f32():
        for pos, (_, lo, hi, _, _) in enumerate(route.small):
            gf = torch.where(in_block[:, pos, None], g_sub[:, pos], 0.0)
            local = (sub[:, pos].long() - lo).clamp(0, hi - lo - 1)
            onehot = (torch.arange(hi - lo, device=sub.device)[:, None]
                      == local[None, :]).float()
            dense[lo:hi] += onehot @ gf


def table_grad(ids: torch.Tensor, g: torch.Tensor, r: int, bounds: Bounds,
               nresv: int, mode: str) -> torch.Tensor:
    """The dense (r, W) float32 gradient of the lookup for cotangent g
    (B, F, W), float32 or bfloat16."""
    if mode == "fwd":
        return scatter_add(ids, g, r)
    if mode == "fwd_split":
        is_resv = ids < nresv
        dense = scatter_add(torch.where(is_resv, 0, ids),
                            torch.where(is_resv[..., None], 0.0, g.float()), r)
        dense[:nresv] += _reserved_sums(ids, g.float(), nresv)
        return dense
    route = routing(bounds, nresv, ids.device)
    if len(route.big_idx):
        dense = scatter_add(ids.index_select(1, route.big_idx),
                            g.index_select(1, route.big_idx), r)
    else:
        dense = torch.zeros(r, g.shape[-1], dtype=torch.float32, device=g.device)
    if route.small:
        sub = ids.index_select(1, route.small_idx)                    # (B, Fs)
        g_sub = g.index_select(1, route.small_idx)                    # (B, Fs, W)
        in_block = (sub >= route.lo) & (sub < route.hi)
        if mode == "matmul":
            add_matmul(dense, sub, g_sub.float(), in_block, route)
        else:
            phys = torch.where(in_block, sub, -1).t().contiguous()
            field_block_scatter_add(dense, g_sub.reshape(g.shape[0], -1), phys,
                                    route.plan)
        dense[:nresv] += _reserved_sums(sub, g_sub.float(), nresv)
    return dense


class _HybridLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, bounds, nresv, mode, out_dtype):
        ctx.save_for_backward(ids)
        ctx.args = (table.shape[0], bounds, nresv, mode)
        return _forward(table, ids, bounds, nresv, mode, out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        r, bounds, nresv, mode = ctx.args
        return (table_grad(ids.contiguous(), grad_out.contiguous(), r, bounds, nresv,
                           mode), None, None, None, None, None)


def hybrid_lookup(table: torch.Tensor, ids: torch.Tensor, bounds: Bounds,
                  nresv: int = NUM_RESERVED, mode: Optional[str] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(R, W) table, (B, F) ids, each field's (lo, hi) -> (B, F, W) rows in
    `out_dtype` (None: the table's), with map_tpu's values for `mode`.
    Differentiable in `table`."""
    mode = resolve_mode(mode)
    if torch.is_grad_enabled() and table.requires_grad:
        return _HybridLookup.apply(table, ids, tuple(bounds), nresv, mode, out_dtype)
    return _forward(table, ids, tuple(bounds), nresv, mode, out_dtype)
