"""Carry the port's weights into map_tpu (the reverse of `from_jax.py`).

`variables_from_state_dict(state_dict, config, packed=True)` takes a port
state_dict (any of the ten models, with its MFP, RFD or supervised head) and
returns map_tpu's variables tree, `{"params": ..., "batch_stats": ...}`
(`batch_stats` for FGCNN's BatchNorm running statistics only), with numpy
float32 leaves. It inverts `from_jax.state_dict_from_jax` rule by rule
(`from_jax.model_rules`, `stats_rules`) and is the port's counterpart of
map_tpu's `interop/torch_import.py:405 convert_state_dict` and `:448
apply_stats_rules`, without a template tree. On the way:
- tables (`embed`, `fg_embed`, the MFP decoder's `emb` and `bias`) are
  lane-packed as map_tpu's default `packed_tables=True` stores them
  (`map_tpu/config.py:97`, `ops/packed_table.py`): p = 128 // E rows a
  128-lane row, zero rows up to ceil(V / p) rounded up to 512 physical rows
  when that is at least 512, reshaped to (R, p * E); with `packed=False`
  they stay (V, E), the decoder's bias (V,). The LR table stays (V, 1);
- Linear weights (out, in) become flax kernels (in, out); CIN's Conv1d
  weights (out, in, 1) its (in, out) kernels; FGCNN's Conv2d weights (out,
  in, kh, kw) flax's (kh, kw, in, out); each recombine weight's columns go
  from the reference's NCHW order (c, h, e) back to map_tpu's (h, e, c)
  (the inverse of from_jax's `recombine:` transform, map_tpu's
  `_recombine_perm` forward);
- the Transformer's packed `in_proj_weight` (3D, D) / `in_proj_bias` split
  into the q_proj, k_proj and v_proj kernels and biases;
- FiGNN's GRUCell (gates r | z | n) into flax's `ir`, `iz`, `in`, `hr`,
  `hz`, `hn` kernels and the `ir`, `iz`, `in`, `hn` biases, torch's r and
  z biases folded into the input-side ones (map_tpu's `_gru_composite`
  emit; the port's `bias_hh[:2E]` is zero);
- LayerNorm and BatchNorm `weight` / `bias` become `scale` / `bias`, and
  `running_mean` / `running_var` the `mean` / `var` statistics.
Every key of the state_dict must have a rule (`KeyError` otherwise), so
nothing is dropped on the way.

`save_jax_model(state_dict, config, model_dir, step, packed=True)` writes
`{model_dir}/{step}.model` in map_tpu's format, flax's msgpack
serialization of the tree (the `msgpack` package, imported when called;
arrays above 2**30 bytes chunked as flax chunks them), and the run's
`config.json` with `packed_tables` set to the layout, so that
`map_tpu.serve.Predictor` scores it and map_tpu's `--finetune
--pretrained_model_path` restores from it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from map_tpu_torch.config import Config
from map_tpu_torch.interop.from_jax import model_rules, stats_rules

# flax/serialization.py: _MsgpackExtType.ndarray / npscalar, MAX_CHUNK_SIZE
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_ROW_ALIGN = 512  # map_tpu ops/packed_table.py:ROW_ALIGN


def pack_factor(width: int) -> int:
    """Logical rows a 128-lane row (map_tpu `packed_table.pack_factor`)."""
    return 1 if width >= 128 or 128 % width else 128 // width


def packed_rows(rows: int, width: int) -> int:
    """Physical rows of a packed (rows, width) table (map_tpu `packed_rows`)."""
    r = -(-rows // pack_factor(width))
    return -(-r // _ROW_ALIGN) * _ROW_ALIGN if r >= _ROW_ALIGN else r


def pack_table(table: np.ndarray) -> np.ndarray:
    """(V, E) -> (R, p * E), zero rows after the V real ones (map_tpu
    `pack_table`)."""
    v, e = table.shape
    p = pack_factor(e)
    out = np.zeros((packed_rows(v, e) * p, e), np.float32)
    out[:v] = table
    return out.reshape(-1, p * e)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _inverse(kind: str, arr: np.ndarray, config: Config, packed: bool) -> np.ndarray:
    """The flax leaf of a port tensor under from_jax's transform `kind`."""
    if kind == "t":
        return arr.T
    if kind == "conv1x1":  # (out, in, 1) -> (in, out)
        return arr[..., 0].T
    if kind == "conv2d":  # torch (out, in, kh, kw) -> flax (kh, kw, in, out)
        return arr.transpose(2, 3, 1, 0)
    if kind.startswith("recombine:"):  # (out, c * h * e) -> (h * e * c, out)
        c, e = int(kind.split(":")[1]), config.embed_size
        o = arr.shape[0]
        h = arr.shape[1] // (c * e)
        return arr.reshape(o, c, h, e).transpose(2, 3, 1, 0).reshape(h * e * c, o)
    if kind in ("table", "proj_table"):
        return pack_table(arr) if packed else arr
    if kind == "bias_table":  # the reference's (V, 1)
        return pack_table(arr) if packed else arr.reshape(-1)
    if kind == "id":
        return arr
    raise ValueError(f"no inverse for transform {kind!r}")


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = np.ascontiguousarray(value, dtype=np.float32)


def _in_proj(tree, path, key: str, arr: np.ndarray) -> None:
    """torch's packed in_proj (3D, D) / (3D,) -> q, k, v kernels / biases."""
    d = arr.shape[0] // 3
    leaf = "kernel" if key.endswith("in_proj_weight") else "bias"
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        part = arr[i * d:(i + 1) * d]
        _set(tree, path + (name, "dense", leaf), part.T if leaf == "kernel" else part)


def _gru(tree, path, sd: Dict[str, torch.Tensor], prefix: str) -> None:
    """torch's GRUCell (gates r | z | n) -> flax's GRUCell subtree (map_tpu
    `_gru_composite` emit)."""
    w_ih, w_hh = _np(sd[prefix + "weight_ih"]), _np(sd[prefix + "weight_hh"])
    b_ih, b_hh = _np(sd[prefix + "bias_ih"]), _np(sd[prefix + "bias_hh"])
    e = w_ih.shape[1]
    for i, g in enumerate("rzn"):
        _set(tree, path + (f"i{g}", "kernel"), w_ih[i * e:(i + 1) * e].T)
        _set(tree, path + (f"h{g}", "kernel"), w_hh[i * e:(i + 1) * e].T)
    _set(tree, path + ("ir", "bias"), b_ih[0:e] + b_hh[0:e])
    _set(tree, path + ("iz", "bias"), b_ih[e:2 * e] + b_hh[e:2 * e])
    _set(tree, path + ("in", "bias"), b_ih[2 * e:3 * e])
    _set(tree, path + ("hn", "bias"), b_hh[2 * e:3 * e])


def variables_from_state_dict(state_dict: Dict[str, torch.Tensor], config: Config,
                              packed: bool = True) -> Dict[str, Any]:
    """A port state_dict -> map_tpu's {"params", "batch_stats"} tree."""
    out: Dict[str, Any] = {"params": {}}
    used = set()
    for collection, rules in (("params", model_rules(config)),
                              ("batch_stats", stats_rules(config))):
        if not rules:
            continue
        tree = out.setdefault(collection, {})
        for key, path, kind in rules:
            if kind.startswith("gru_"):
                prefix = key[:-len(kind[4:])]
                if prefix not in used:
                    _gru(tree, path, state_dict, prefix)
                    used.add(prefix)
                used.add(key)
                continue
            if key not in state_dict:
                raise KeyError(f"the state_dict lacks {key} (for {collection}/"
                               f"{'/'.join(path)})")
            arr = _np(state_dict[key])
            if kind in ("in_proj_weight", "in_proj_bias"):
                _in_proj(tree, path, key, arr)
            else:
                _set(tree, path, _inverse(kind, arr, config, packed))
            used.add(key)
    extra = sorted(set(state_dict) - used)
    if extra:
        raise KeyError(f"no map_tpu leaf for {extra}")
    return out


def _msgpack_chunked(tree: Any) -> Any:
    """Arrays above flax's MAX_CHUNK_SIZE as its chunked dicts."""
    if isinstance(tree, dict):
        return {k: _msgpack_chunked(v) for k, v in tree.items()}
    if tree.size * tree.dtype.itemsize <= _MAX_CHUNK_SIZE:
        return tree
    size = max(1, _MAX_CHUNK_SIZE // tree.dtype.itemsize)
    flat = tree.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def msgpack_bytes(variables: Dict[str, Any]) -> bytes:
    """flax's `msgpack_serialize` of a tree of numpy arrays."""
    import msgpack

    def ext(obj):
        if isinstance(obj, (np.ndarray, np.generic)):
            a = np.asarray(obj)
            payload = msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")),
                                    use_bin_type=True)
            return msgpack.ExtType(_EXT_NDARRAY if isinstance(obj, np.ndarray)
                                   else _EXT_NPSCALAR, payload)
        raise TypeError(f"cannot serialize {type(obj)}")

    return msgpack.packb(_msgpack_chunked(variables), default=ext, strict_types=True)


def save_jax_model(state_dict: Dict[str, torch.Tensor], config: Config, model_dir: str,
                   step: int, packed: bool = True) -> str:
    """`{model_dir}/{step}.model` in map_tpu's format and the run's
    config.json (packed_tables = `packed`); returns the model file's path."""
    from map_tpu_torch.train.checkpoints import model_checkpoint_path

    os.makedirs(model_dir, exist_ok=True)
    path = model_checkpoint_path(model_dir, step)
    data = msgpack_bytes(variables_from_state_dict(state_dict, config, packed))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    Config.from_dict({**config.to_dict(), "packed_tables": bool(packed)}).save(model_dir)
    return path
