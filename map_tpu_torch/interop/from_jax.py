"""Carry map_tpu (flax) weights into the port.

`state_dict_from_jax(variables, config)` takes map_tpu's variables tree as
numpy arrays (`train/checkpoints.load_jax_model_file` reads one from a
`{step}.model` file) and returns the port's `state_dict`, whose keys are the
reference torch names of `map_tpu/interop/torch_import.py:model_rules`.

Layout changes on the way:
- lane-packed tables (map_tpu `ops/packed_table.py`, (R, p*E) with p = 128//E
  and padding rows up to a 512-row multiple) are unpacked to (V, E) with
  `reshape(-1, E)[:V]`, which drops the padding rows; a plain (V, E) table
  passes through the same reshape unchanged. The MFP decoder's tables go the
  same way: `emb` (R, 4 * 32) or (V, 32) to (V, proj_size), `bias` (R, 128)
  or (V,) to the reference's (V, 1);
- Dense and cross kernels are flax (in, out) and become torch (out, in);
- LayerNorm `scale` / `bias` become `weight` / `bias`.
The heads follow the config: the MFP head, the RFD head (`pred_rfd_hidden`
and `pred_rfd_out` to `pred_rfd.0` and `pred_rfd.2`), or fc_out.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from map_tpu_torch.config import Config

Rule = Tuple[str, Tuple[str, ...], str]  # (torch key, flax path, transform)


def dcnv2_rules(config: Config) -> List[Rule]:
    rules: List[Rule] = [("embed.embedding.weight", ("embed", "embedding"), "table")]
    if config.embed_norm:
        rules += [("embed.layer_norm.weight", ("embed", "layer_norm", "scale"), "id"),
                  ("embed.layer_norm.bias", ("embed", "layer_norm", "bias"), "id")]
    for i in range(config.num_cross_layers):
        rules += [(f"cross_net.cross_layers.{i}.weight", ("cross_net", f"kernel_{i}"), "t"),
                  (f"cross_net.cross_layers.{i}.bias", ("cross_net", f"bias_{i}"), "id")]
    for j in range(config.num_hidden_layers):
        fp = ("parallel_dnn", f"layer_{j}", "dense")
        rules += [(f"parallel_dnn.dnn.{3 * j}.weight", fp + ("kernel",), "t"),
                  (f"parallel_dnn.dnn.{3 * j}.bias", fp + ("bias",), "id")]
    if config.mfp:  # the MFP head replaces fc_out (torch_import.py:281-289)
        rules += [("feat_encoder.weight", ("feat_encoder", "dense", "kernel"), "t"),
                  ("feat_encoder.bias", ("feat_encoder", "dense", "bias"), "id"),
                  ("mfp_criterion.emb.weight", ("mfp_decoder", "emb"), "proj_table"),
                  ("mfp_criterion.bias.weight", ("mfp_decoder", "bias"), "bias_table")]
    elif config.rfd:  # pred_rfd.0 / pred_rfd.2 (torch_import.py:287-288)
        for key, node in (("pred_rfd.0", "pred_rfd_hidden"), ("pred_rfd.2", "pred_rfd_out")):
            rules += [(f"{key}.weight", (node, "dense", "kernel"), "t"),
                      (f"{key}.bias", (node, "dense", "bias"), "id")]
    else:
        rules += [("fc_out.weight", ("fc_out", "dense", "kernel"), "t"),
                  ("fc_out.bias", ("fc_out", "dense", "bias"), "id")]
    return rules


def _transform(kind: str, arr: np.ndarray, config: Config) -> np.ndarray:
    if kind == "t":
        return arr.T
    width = {"table": config.embed_size, "proj_table": config.proj_size,
             "bias_table": 1}.get(kind)
    if width is not None:
        return arr.reshape(-1, width)[:config.input_size]
    return arr


def state_dict_from_jax(variables: Dict[str, Any],
                        config: Config) -> Dict[str, torch.Tensor]:
    if config.model_name.lower() != "dcnv2":
        raise NotImplementedError(
            f"weight carry for {config.model_name!r} is not ported yet "
            "(ROADMAP.md)")
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    for key, path, kind in dcnv2_rules(config):
        node = params
        for name in path:
            if name not in node:
                raise KeyError(f"map_tpu variables lack {'/'.join(path)} "
                               f"(for {key})")
            node = node[name]
        arr = _transform(kind, np.asarray(node, dtype=np.float32), config)
        out[key] = torch.from_numpy(np.array(arr, order="C"))  # owned, writable
    return out
