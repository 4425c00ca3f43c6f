"""Checkpoint I/O. Counterpart: `map_tpu/train/checkpoints.py:24-50`,
`prune_checkpoints` (:65-81), the resume state (:90-118) and
`partial_restore` (:120-140).

The port's `{step}.model` is `torch.save` of the model's state_dict (the
reference's own format, `code/trainer.py:517-519`), buffers included
(FGCNN's BatchNorm running statistics), written to a temporary file and
renamed, so a crash never leaves a torn checkpoint.

The resume state, `{output_dir}/resume.state`, is `torch.save` of
{"state": the Trainer's tensors and host state (`Trainer._train_state`:
parameters and buffers, the AdamW moments and count, the generators'
states), "meta": global_step, best_eval_auc, best_eval_step, patience,
eval_metrics}, on the host, written to a temporary file and renamed.

`load_jax_model_file` reads map_tpu's `{step}.model`: flax's msgpack
serialization of the variables tree, decoded here with the `msgpack` package
alone (mirroring `flax/serialization.py` `_MsgpackExtType`,
`_ndarray_from_bytes` and `_unchunk`). `load_any_model_file` takes either
kind (a torch file is a zip archive) and returns a port state_dict.
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from map_tpu_torch.config import Config

logger = logging.getLogger(__name__)

# flax/serialization.py _MsgpackExtType
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def model_checkpoint_path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"{step}.model")


def save_model(state_dict: Dict[str, torch.Tensor], model_dir: str, step: int) -> str:
    os.makedirs(model_dir, exist_ok=True)
    path = model_checkpoint_path(model_dir, step)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)
    return path


def prune_checkpoints(model_dir: str, keep: int) -> None:
    """Keep the newest `keep` step-named checkpoints (`save_total_limit`;
    map_tpu/train/checkpoints.py:prune_checkpoints)."""
    steps = sorted(int(name[:-len(".model")]) for name in os.listdir(model_dir)
                   if name.endswith(".model") and name[:-len(".model")].isdigit())
    for step in steps[:-keep] if keep > 0 else []:
        try:
            os.remove(model_checkpoint_path(model_dir, step))
        except OSError:
            pass


def load_model(model_dir: str, step: int) -> Dict[str, torch.Tensor]:
    return torch.load(model_checkpoint_path(model_dir, step),
                      map_location="cpu", weights_only=True)


def resume_path(output_dir: str) -> str:
    return os.path.join(output_dir, "resume.state")


def save_train_state(output_dir: str, state: Dict[str, Any], meta: Dict[str, Any]) -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = resume_path(output_dir)
    tmp = path + ".tmp"
    torch.save({"state": state, "meta": meta}, tmp)
    os.replace(tmp, path)
    return path


def load_train_state(output_dir: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    payload = torch.load(resume_path(output_dir), map_location="cpu", weights_only=True)
    return payload["state"], payload["meta"]


def has_resume_state(output_dir: str) -> bool:
    return os.path.exists(resume_path(output_dir))


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _indexed(d: Dict[str, Any]) -> list:
    """flax's `_dict_to_tuple`: {'0': a, '1': b, ...} -> [a, b, ...]."""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            flat = np.concatenate(_indexed(tree["chunks"]))
            return flat.reshape(tuple(_indexed(tree["shape"])))
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def load_jax_model_file(path: str) -> Dict[str, Any]:
    """map_tpu's `{step}.model` -> its variables tree with numpy leaves."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(tree)


def load_any_model_file(path: str, config: Config) -> Dict[str, torch.Tensor]:
    """A port `{step}.model` or map_tpu's msgpack one -> a port state_dict
    on the CPU. A map_tpu checkpoint is carried with the config.json of its
    run directory when there is one (its model config: heads, packing),
    else with `config`."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    from map_tpu_torch.interop.from_jax import state_dict_from_jax

    run_dir = os.path.dirname(os.path.abspath(path))
    if os.path.exists(os.path.join(run_dir, "config.json")):
        config = Config.load(run_dir)
    return state_dict_from_jax(load_jax_model_file(path), config)


def partial_restore(state_dict: Dict[str, torch.Tensor],
                    target: Dict[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Copy every tensor of `target` whose name AND shape match one of
    `state_dict`; keep the rest. Returns (merged, loaded, skipped), counted
    over `target` as map_tpu counts them, a tensor for each of its leaves
    of `params` and `batch_stats` (FGCNN's BatchNorm: `running_mean` and
    `running_var` for map_tpu's `mean` and `var`), but where torch packs
    several of map_tpu's leaves into one tensor: the Transformer's
    `in_proj_weight` / `in_proj_bias` (6 leaves: q, k, v kernels and
    biases) and FiGNN's GRUCell's 4 tensors (10 leaves: 6 kernels, 4
    biases), so a restore loads 4 fewer a Transformer layer and 6 fewer in
    FiGNN than map_tpu counts."""
    merged = dict(state_dict)
    loaded = skipped = 0
    for name, value in target.items():
        if name in merged and tuple(merged[name].shape) == tuple(value.shape):
            merged[name] = value.to(merged[name].dtype)
            logger.info(f"Load tensor: {name}, {tuple(value.shape)}")
            loaded += 1
        else:
            logger.info(f"Unmatched tensor in the target model: {name}, "
                        f"{tuple(value.shape)}")
            skipped += 1
    return merged, loaded, skipped
