"""Carry map_tpu (flax) weights into the port.

`state_dict_from_jax(variables, config)` takes map_tpu's variables tree as
numpy arrays (`train/checkpoints.load_jax_model_file` reads one from a
`{step}.model` file) and returns the port's `state_dict`, whose keys are the
reference torch names of `map_tpu/interop/torch_import.py:model_rules`:
the parameters from the `params` collection and, where the tree has a
`batch_stats` collection, FGCNN's BatchNorm running statistics from it
(`stats_rules`, map_tpu's `model_stats_rules`).

The rules are the port's copy of map_tpu's, for all ten of its models.
Layout changes on the way:
- lane-packed tables (map_tpu `ops/packed_table.py`, (R, p*E) with p = 128//E
  and padding rows up to a 512-row multiple) are unpacked to (V, E) with
  `reshape(-1, E)[:V]`, which drops the padding rows; a plain (V, E) table
  passes through the same reshape unchanged. The MFP decoder's tables go the
  same way: `emb` (R, 4 * 32) or (V, 32) to (V, proj_size), `bias` (R, 128)
  or (V,) to the reference's (V, 1);
- Dense and cross kernels are flax (in, out) and become torch (out, in);
- CIN's kernels (in, out) become the reference's Conv1d weights (out, in, 1);
- the Transformer's q_proj, k_proj and v_proj (kernels and biases) stack
  into torch's packed `self_attn.in_proj_weight` (3D, D) / `in_proj_bias`;
- LayerNorm and BatchNorm `scale` / `bias` become `weight` / `bias`, and
  BatchNorm's `mean` / `var` statistics `running_mean` / `running_var`;
- FiGNN's flax GRUCell (`ir`, `iz`, `in` kernels with biases, `hr`, `hz`
  kernels, `hn` kernel and bias) packs into torch's GRUCell (gates r | z |
  n): `weight_ih` and `weight_hh` (3E, E), `bias_ih` = [ir; iz; in] and
  `bias_hh` = [0; 0; hn], the inverse of map_tpu's `_gru_composite`
  (`torch_import.py:167`), which folds torch's r and z biases into flax's
  input-side ones;
- FGCNN's flax Conv kernels (kh, 1, in, out) become torch's Conv2d weights
  (out, in, kh, 1), and each recombine kernel, whose input rows map_tpu
  takes in its NHWC flatten order (h, e, c), becomes a weight whose columns
  are in the reference's NCHW order (c, h, e): map_tpu's `_recombine_perm`
  (`torch_import.py:264`) in reverse, with h the pooled rows the kernel
  has.
The heads follow the config: the MFP head, the RFD head (`pred_rfd_hidden`
and `pred_rfd_out` to `pred_rfd.0` and `pred_rfd.2`), or the model's
supervised heads (with the `attn,fc` reduction's `attn_hidden` and
`attn_score` as `field_reduction_attn.0` and `.2`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from map_tpu_torch.config import Config

Rule = Tuple[str, Tuple[str, ...], str]  # (torch key, flax path, transform)


def _linear(tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    return [(f"{tk}.weight", fp + ("dense", "kernel"), "t"),
            (f"{tk}.bias", fp + ("dense", "bias"), "id")]


def _emb(config: Config, name: str = "embed") -> List[Rule]:
    rules: List[Rule] = [(f"{name}.embedding.weight", (name, "embedding"), "table")]
    if config.embed_norm:
        rules += [(f"{name}.layer_norm.weight", (name, "layer_norm", "scale"), "id"),
                  (f"{name}.layer_norm.bias", (name, "layer_norm", "bias"), "id")]
    return rules


def _mlp(tk: str, fp: str, num_layers: int) -> List[Rule]:
    # [Linear, act, Dropout] a layer in one nn.Sequential named `dnn`
    rules: List[Rule] = []
    for j in range(num_layers):
        rules += _linear(f"{tk}.dnn.{3 * j}", (fp, f"layer_{j}"))
    return rules


def _lr(tk: str) -> List[Rule]:
    # the standalone LR names its table embed_w (`code/models.py:133-135`)
    return [(f"{tk}embed_w.weight", ("lr_layer", "weight"), "id"),
            (f"{tk}bias", ("lr_layer", "bias"), "id")]


def _cin(units: List[int]) -> List[Rule]:
    # the reference's CIN names its 1x1 convolutions layer_1.. (torch
    # (out, in, 1); map_tpu's kernel is (in, out))
    rules: List[Rule] = []
    for i in range(len(units)):
        rules += [(f"cin.cin_layer.layer_{i + 1}.weight", ("cin", f"kernel_{i}"), "conv1x1"),
                  (f"cin.cin_layer.layer_{i + 1}.bias", ("cin", f"bias_{i}"), "id")]
    return rules


def _encoder_layer(tk: str, fp: str) -> List[Rule]:
    """torch's TransformerEncoderLayer; its packed in_proj holds map_tpu's
    q_proj, k_proj and v_proj (the `in_proj_*` transforms read all three)."""
    rules: List[Rule] = [(f"{tk}.self_attn.in_proj_weight", (fp,), "in_proj_weight"),
                         (f"{tk}.self_attn.in_proj_bias", (fp,), "in_proj_bias")]
    rules += _linear(f"{tk}.self_attn.out_proj", (fp, "out_proj"))
    rules += _linear(f"{tk}.linear1", (fp, "linear1"))
    rules += _linear(f"{tk}.linear2", (fp, "linear2"))
    for j in (1, 2):
        rules += [(f"{tk}.norm{j}.weight", (fp, f"norm{j}", "scale"), "id"),
                  (f"{tk}.norm{j}.bias", (fp, f"norm{j}", "bias"), "id")]
    return rules


def _fignn(config: Config) -> List[Rule]:
    """The attention, the GraphLayers and the GRU (its four tensors read
    the `gru` subtree: the `gru_*` transforms)."""
    rules: List[Rule] = [("fignn.W_attn.weight", ("fignn", "W_attn", "dense", "kernel"),
                          "t")]
    gnn = ([("fignn.gnn", "gnn")] if config.reuse_graph_layer else
           [(f"fignn.gnn.{i}", f"gnn_{i}") for i in range(config.num_hidden_layers)])
    for tk, fp in gnn:
        rules += [(f"{tk}.{w}", ("fignn", fp, w), "id") for w in ("W_in", "W_out", "bias_p")]
    rules += [(f"fignn.gru.{t}", ("fignn", "gru"), f"gru_{t}")
              for t in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    return rules


def _fgcnn(config: Config) -> List[Rule]:
    rules: List[Rule] = []
    for i, ch in enumerate(config.channels.split(",")):
        tk = f"fgcnn_layer.conv_layers.{i}"
        rules += [(f"{tk}.0.weight", ("fgcnn_layer", f"conv_{i}", "kernel"), "conv2d"),
                  (f"{tk}.0.bias", ("fgcnn_layer", f"conv_{i}", "bias"), "id"),
                  (f"{tk}.1.weight", ("fgcnn_layer", f"bn_{i}", "scale"), "id"),
                  (f"{tk}.1.bias", ("fgcnn_layer", f"bn_{i}", "bias"), "id")]
        rules += [(f"fgcnn_layer.recombine_layers.{i}.0.weight",
                   ("fgcnn_layer", f"recombine_{i}", "dense", "kernel"),
                   f"recombine:{int(ch)}"),
                  (f"fgcnn_layer.recombine_layers.{i}.0.bias",
                   ("fgcnn_layer", f"recombine_{i}", "dense", "bias"), "id")]
    return rules


def stats_rules(config: Config) -> List[Rule]:
    """The BatchNorm running statistics, from map_tpu's `batch_stats`
    collection (`torch_import.py:_fgcnn_rules`' stats): FGCNN's only."""
    if config.model_name.lower() != "fgcnn":
        return []
    rules: List[Rule] = []
    for i in range(len(config.channels.split(","))):
        tk = f"fgcnn_layer.conv_layers.{i}.1"
        rules += [(f"{tk}.running_mean", ("fgcnn_layer", f"bn_{i}", "mean"), "id"),
                  (f"{tk}.running_var", ("fgcnn_layer", f"bn_{i}", "var"), "id")]
    return rules


def _heads(config: Config, *supervised: str) -> List[Rule]:
    """The MFP head or the RFD head in place of the supervised heads."""
    if config.mfp:  # torch_import.py:281-289
        return (_linear("feat_encoder", ("feat_encoder",))
                + [("mfp_criterion.emb.weight", ("mfp_decoder", "emb"), "proj_table"),
                   ("mfp_criterion.bias.weight", ("mfp_decoder", "bias"), "bias_table")])
    if config.rfd:  # pred_rfd.0 / pred_rfd.2 (torch_import.py:287-288)
        return (_linear("pred_rfd.0", ("pred_rfd_hidden",))
                + _linear("pred_rfd.2", ("pred_rfd_out",)))
    rules: List[Rule] = []
    for name in supervised:
        rules += _linear(name, (name,))
    return rules


def model_rules(config: Config) -> List[Rule]:
    """The port's copy of map_tpu's `model_rules` (`interop/torch_import.py:
    292-363`, with `model_composites` :366 for the Transformer's in_proj and
    FiGNN's GRU),
    restricted to the tensors the port's model of `config` holds: each
    model's own, then its MFP, RFD or supervised head."""
    c = config
    name = c.model_name.lower()
    sup = not c.pretrain
    if name == "lr":
        return _lr("")
    rules = _emb(c)
    if name == "fm":
        return rules + _lr("lr_layer.")
    if name == "dcnv2":
        for i in range(c.num_cross_layers):
            rules += [(f"cross_net.cross_layers.{i}.weight", ("cross_net", f"kernel_{i}"), "t"),
                      (f"cross_net.cross_layers.{i}.bias", ("cross_net", f"bias_{i}"), "id")]
        return rules + _mlp("parallel_dnn", "parallel_dnn", c.num_hidden_layers) + _heads(
            c, "fc_out")
    if name == "dnn":
        return rules + _mlp("dnn", "dnn", c.num_hidden_layers) + _heads(c, "fc_out")
    if name == "deepfm":
        return (rules + _lr("lr_layer.") + _mlp("dnn", "dnn", c.num_hidden_layers)
                + _heads(c, "dnn_fc_out"))
    if name == "xdeepfm":
        rules += _cin([int(u) for u in c.cin_layer_units.split(",")])
        rules += _mlp("dnn", "dnn", c.num_hidden_layers) + _heads(c, "fc")
        return rules + (_lr("lr_layer.") if sup and c.use_lr else [])
    if name == "autoint":
        width = c.num_attn_heads * c.attn_size
        for i in range(c.num_attn_layers):
            # bias-free projections; W_res only where the widths differ
            ws = ("W_q", "W_k", "W_v") + (("W_res",) if i == 0 and c.embed_size != width
                                          else ())
            rules += [(f"self_attention.{i}.{w}.weight", (f"attn_{i}", w, "dense", "kernel"),
                       "t") for w in ws]
        rules += _heads(c, "attn_out")
        if sup and c.use_lr:
            rules += _lr("lr_layer.")
        if sup and c.num_dnn_layers:
            rules += _mlp("dnn", "dnn", c.num_dnn_layers) + _linear("dnn_out", ("dnn_out",))
        return rules
    if name == "fignn":
        rules += _fignn(c) + _heads(c)
        if sup:  # the attentional prediction, bias-free
            rules += [("fc.linear1.weight", ("fc", "linear1", "dense", "kernel"), "t"),
                      ("fc.linear2.0.weight", ("fc", "linear2", "dense", "kernel"), "t")]
        return rules
    if name == "fgcnn":
        if not c.share_embedding:
            rules += _emb(c, "fg_embed")
        rules += _fgcnn(c)
        if sup:
            rules += _mlp("dnn", "dnn", c.num_hidden_layers)
        return rules + _heads(c, "fc_out")
    if name == "trans":
        for i in range(c.num_hidden_layers):
            rules += _encoder_layer(f"encoder.layers.{i}", f"layer_{i}")
        rules += _heads(c, "trans_out")
        if sup and c.output_reduction == "attn,fc":
            rules += (_linear("field_reduction_attn.0", ("attn_hidden",))
                      + _linear("field_reduction_attn.2", ("attn_score",)))
        if sup and c.use_lr:
            rules += _lr("lr_layer.")
        if sup and c.num_dnn_layers > 0:
            rules += _mlp("mlp", "mlp", c.num_dnn_layers) + _linear("mlp_out", ("mlp_out",))
        return rules
    raise NotImplementedError(f"no weight carry for model {c.model_name!r}")


def _gru(kind: str, node: Any) -> np.ndarray:
    """torch's GRUCell tensor `kind` from flax's GRUCell subtree (gates r, z, n)."""
    def leaf(gate, name):
        return np.asarray(node[gate][name], np.float32)

    if kind in ("gru_weight_ih", "gru_weight_hh"):
        side = "i" if kind == "gru_weight_ih" else "h"
        return np.concatenate([leaf(side + g, "kernel").T for g in "rzn"])
    if kind == "gru_bias_ih":
        return np.concatenate([leaf("i" + g, "bias") for g in "rzn"])
    zero = np.zeros_like(leaf("hn", "bias"))
    return np.concatenate([zero, zero, leaf("hn", "bias")])


def _transform(kind: str, node: Any, config: Config) -> np.ndarray:
    if kind in ("in_proj_weight", "in_proj_bias"):  # node: the layer's subtree
        leaf = "kernel" if kind == "in_proj_weight" else "bias"
        parts = [np.asarray(node[p]["dense"][leaf], np.float32)
                 for p in ("q_proj", "k_proj", "v_proj")]
        return np.concatenate([a.T for a in parts] if leaf == "kernel" else parts)
    if kind.startswith("gru_"):  # node: the GRU's subtree
        return _gru(kind, node)
    arr = np.asarray(node, dtype=np.float32)
    if kind == "t":
        return arr.T
    if kind == "conv1x1":
        return arr.T[..., None]
    if kind == "conv2d":  # flax (kh, kw, in, out) -> torch (out, in, kh, kw)
        return arr.transpose(3, 2, 0, 1)
    if kind.startswith("recombine:"):  # (h * e * c, out) -> (out, c * h * e)
        c, e = int(kind.split(":")[1]), config.embed_size
        h = arr.shape[0] // (e * c)
        return arr.reshape(h, e, c, -1).transpose(3, 2, 0, 1).reshape(-1, c * h * e)
    width = {"table": config.embed_size, "proj_table": config.proj_size,
             "bias_table": 1}.get(kind)
    if width is not None:
        return arr.reshape(-1, width)[:config.input_size]
    return arr


def state_dict_from_jax(variables: Dict[str, Any],
                        config: Config) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    collections = [("params", model_rules(config))]
    if "batch_stats" in variables:  # a tree of parameters alone carries none
        collections.append(("batch_stats", stats_rules(config)))
    for collection, rules in collections:
        for key, path, kind in rules:
            node = variables[collection]
            for name in path:
                if name not in node:
                    raise KeyError(f"map_tpu variables lack {collection}/"
                                   f"{'/'.join(path)} (for {key})")
                node = node[name]
            arr = _transform(kind, node, config)
            out[key] = torch.from_numpy(np.array(arr, order="C"))  # owned, writable
    return out
