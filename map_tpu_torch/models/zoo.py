"""Model zoo of the port. Counterpart: `map_tpu/models/zoo.py`: LR and FM
(:98-121), DNN (:124-141), DeepFM (:144-170), xDeepFM (:173-200), DCNv2
(:203-230), FGCNN (:233-288), FiGNN (:291-313), AutoInt (:316-368) and
Transformer (:371-445): all ten of map_tpu's models.

Each pretrain-capable model (all but LR and FM) builds the MFP or RFD head
of `models/base.py` on its backbone's final_dim in place of its supervised
head, as map_tpu's do. The rounding points are map_tpu's: the embeddings,
the cross net and the `_mlp` MLPs compute in `compute_dtype`; LR, CIN's
convolutions, the attention, the Transformer, AutoInt's and the
Transformer's MLP towers, FGCNN's feature generation and inner products,
FiGNN's graph and GRU, and every head in the promotion of their input with
their float32 parameters (float32 when the input is bf16).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from map_tpu_torch.config import Config
from map_tpu_torch.models.base import CTRModel
from map_tpu_torch.nn.layers import (
    CIN,
    AttentionalPrediction,
    CrossNetV2,
    Embeddings,
    FGCNNBlock,
    FiGNNBlock,
    InnerProductLayer,
    LRLayer,
    MLPBlock,
    MultiHeadSelfAttention,
    TorchDense,
    TransformerEncoderLayer,
    lr_logits,
    resolve_dtype,
)


def field_bounds(config: Config):
    """Each field's (lo, hi) id range for the field-blocked hybrid lookup,
    or None: off, or the ranges unknown (map_tpu `zoo.py:42-56`)."""
    lo, hi = config.idx_low, config.idx_high
    if not config.field_blocked_lookup or lo is None or hi is None:
        return None
    if len(lo) != config.num_fields or len(hi) != config.num_fields:
        return None
    return tuple((int(a), int(b)) for a, b in zip(lo, hi))


def _embeddings(c: Config) -> Embeddings:
    return Embeddings(c.input_size, c.embed_size, c.num_fields, embed_norm=c.embed_norm,
                      layer_norm_eps=c.layer_norm_eps, dropout_rate=c.embed_dropout_rate,
                      dtype=resolve_dtype(c.compute_dtype), field_bounds=field_bounds(c),
                      hybrid_mode=c.hybrid_mode)


def _mlp(c: Config, input_dim: int) -> MLPBlock:
    """map_tpu's `_mlp`: hidden_size x num_hidden_layers in compute_dtype."""
    return MLPBlock(input_dim, c.hidden_size, c.num_hidden_layers, c.hidden_act,
                    c.hidden_dropout_rate, dtype=resolve_dtype(c.compute_dtype))


def _mlp_width(c: Config) -> int:
    """The width out of `_mlp`: hidden_size, or F * E with no layer."""
    return c.hidden_size if c.num_hidden_layers > 0 else c.num_fields * c.embed_size


def _dnn_tower(c: Config, input_dim: int) -> MLPBlock:
    """AutoInt's and the Transformer's auxiliary MLP: dnn_size x
    num_dnn_layers, no compute dtype (map_tpu builds it without one)."""
    return MLPBlock(input_dim, c.dnn_size, c.num_dnn_layers, c.dnn_act, c.dnn_drop)


class LR(CTRModel):
    """The (V, 1) table summed over the fields plus a bias (map_tpu
    `zoo.py:98-106`), under the reference's top-level names `embed_w` and
    `bias`. Not pretrain-capable."""

    def __init__(self, config: Config):
        super().__init__(config)
        if config.pretrain:
            raise NotImplementedError("LR is not pretrain-capable (reference parity)")
        self.embed_w = nn.Embedding(config.input_size, 1)
        self.bias = nn.Parameter(torch.zeros(1))

    reset_parameters = LRLayer.reset_parameters

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        return lr_logits(self.embed_w.weight, self.bias, input_ids)


class FM(CTRModel):
    """LR plus the embeddings' pairwise inner products summed (map_tpu
    `zoo.py:109-121`). Not pretrain-capable."""

    def __init__(self, config: Config):
        super().__init__(config)
        if config.pretrain:
            raise NotImplementedError("FM is not pretrain-capable (reference parity)")
        self.lr_layer = LRLayer(config.input_size)
        self.embed = _embeddings(config)
        self.ip_layer = InnerProductLayer(config.num_fields)

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.ip_layer(self.embed(input_ids)) + self.lr_layer(input_ids)


class DNN(CTRModel):
    """embed -> flatten -> MLP -> fc_out (map_tpu `zoo.py:124-141`).
    final_dim = hidden_size."""

    def __init__(self, config: Config):
        super().__init__(config)
        c = config
        self.embed = _embeddings(c)
        self.dnn = _mlp(c, c.num_fields * c.embed_size)
        self.finish(_mlp_width(c), "fc_out")

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.dnn(self.embed(input_ids).flatten(1))

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.backbone(input_ids))


class DeepFM(CTRModel):
    """embed -> MLP beside LR + FM (map_tpu `zoo.py:144-170`). The
    pretraining backbone is [dnn_vec, lr + fm]: final_dim = hidden_size + 1.
    Supervised: dnn_fc_out(dnn_vec) + lr + fm."""

    def __init__(self, config: Config):
        super().__init__(config)
        c = config
        self.embed = _embeddings(c)
        self.lr_layer = LRLayer(c.input_size)
        self.dnn = _mlp(c, c.num_fields * c.embed_size)
        self.ip_layer = InnerProductLayer(c.num_fields)
        if c.pretrain:
            self.finish(_mlp_width(c) + 1)
        else:
            self.dnn_fc_out = TorchDense(_mlp_width(c), 1)

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        feat_embed = self.embed(input_ids)
        dnn_vec = self.dnn(feat_embed.flatten(1))
        lr_fm = self.lr_layer(input_ids) + self.ip_layer(feat_embed)
        return torch.cat([dnn_vec, lr_fm], dim=-1)  # promotes bf16, as jnp does

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        feat_embed = self.embed(input_ids)
        logits = self.dnn_fc_out(self.dnn(feat_embed.flatten(1)))
        logits = logits + self.lr_layer(input_ids)
        return logits + self.ip_layer(feat_embed)


class XDeepFM(CTRModel):
    """CIN beside an optional MLP, then fc, plus an optional LR (map_tpu
    `zoo.py:173-200`). final_dim = sum(cin_layer_units) + hidden_size (no
    MLP: sum(cin_layer_units)); the LR is supervised only."""

    def __init__(self, config: Config):
        super().__init__(config)
        c = config
        units = [int(u) for u in c.cin_layer_units.split(",")]
        self.embed = _embeddings(c)
        self.cin = CIN(c.num_fields, units)
        self.dnn = (_mlp(c, c.num_fields * c.embed_size)
                    if c.num_hidden_layers > 0 else None)
        self.lr_layer = (LRLayer(c.input_size) if c.use_lr and not c.pretrain
                         else None)
        self.finish(sum(units) + (_mlp_width(c) if self.dnn is not None else 0), "fc")

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        feat_embed = self.embed(input_ids)
        final_vec = self.cin(feat_embed)
        if self.dnn is not None:
            final_vec = torch.cat([final_vec, self.dnn(feat_embed.flatten(1))], dim=-1)
        return final_vec

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        logits = self.fc(self.backbone(input_ids))
        if self.lr_layer is not None:
            logits = logits + self.lr_layer(input_ids)
        return logits


def _ints(csv: str):
    return [int(x) for x in str(csv).split(",")]


class FGCNN(CTRModel):
    """Convolutional feature generation, inner products and an MLP (map_tpu
    `zoo.py:233-288`): the (B, F, E) embeddings of `embed` beside the new
    fields `fgcnn_layer` generates from `fg_embed`'s (`embed`'s own with
    `share_embedding`), all of them flattened and their pairwise inner
    products -> `_mlp` -> `fc_out`. final_dim = T (T - 1) / 2 + T * E, T the
    fields old and new (`compute_input_dim`). The feature generation and
    the products compute in float32 (a bf16 embedding is promoted, as flax's
    Conv promotes it); the MLP in compute_dtype."""

    def __init__(self, config: Config):
        super().__init__(config)
        c = config
        channels, pooling = _ints(c.channels), _ints(c.pooling_sizes)
        recombined = _ints(c.recombined_channels)
        self.embed = _embeddings(c)
        self.fg_embed = None if c.share_embedding else _embeddings(c)
        self.fgcnn_layer = FGCNNBlock(c.num_fields, c.embed_size, channels,
                                      _ints(c.kernel_heights), pooling, recombined,
                                      c.conv_act)
        final_dim, total = self.compute_input_dim(c.embed_size, c.num_fields, channels,
                                                  pooling, recombined)
        self.ip_layer = InnerProductLayer(total, "inner_product")
        self.dnn = (_mlp(c, final_dim) if not c.pretrain and c.num_hidden_layers > 0
                    else None)
        self.finish(c.hidden_size if self.dnn is not None else final_dim, "fc_out")

    @staticmethod
    def compute_input_dim(embedding_dim, num_fields, channels, pooling_sizes,
                          recombined_channels):
        """-> (final_dim, total fields): map_tpu's (`zoo.py:262-274`)."""
        total = height = num_fields
        for p, rc in zip(pooling_sizes, recombined_channels):
            height = int(math.ceil(height / p))
            total += height * rc
        return total * (total - 1) // 2 + total * embedding_dim, total

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        feat_embed = self.embed(input_ids)
        fg_embed = feat_embed if self.fg_embed is None else self.fg_embed(input_ids)
        new_feat_embed = self.fgcnn_layer(fg_embed.float())
        combined = torch.cat([feat_embed, new_feat_embed], dim=1)  # float32, as jnp's
        return torch.cat([combined.flatten(1), self.ip_layer(combined)], dim=1)

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        dense_input = self.backbone(input_ids)
        if self.dnn is not None:
            dense_input = self.dnn(dense_input)
        return self.fc_out(dense_input)


class FiGNN(CTRModel):
    """The field graph (map_tpu `zoo.py:291-313`): `fignn` (attention graph,
    num_hidden_layers rounds of GraphLayer and GRU, `res_conn`,
    `reuse_graph_layer`) over the embeddings, then `fc`, the attentional
    prediction. The pretraining backbone is the fields' states flattened:
    final_dim = F * E."""

    def __init__(self, config: Config):
        super().__init__(config)
        c = config
        self.embed = _embeddings(c)
        self.fignn = FiGNNBlock(c.num_fields, c.embed_size, c.num_hidden_layers,
                                use_residual=c.res_conn,
                                reuse_graph_layer=c.reuse_graph_layer)
        if not c.pretrain:
            self.fc = AttentionalPrediction(c.num_fields, c.embed_size)
        self.finish(c.num_fields * c.embed_size)

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.fignn(self.embed(input_ids)).flatten(1)

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.fc(self.fignn(self.embed(input_ids)))


class AutoInt(CTRModel):
    """Stacked self-attention over the field embeddings (map_tpu
    `zoo.py:316-368`): num_attn_layers MultiHeadSelfAttention layers named
    `self_attention.{i}`, each projecting the residual to its output width.
    final_dim = F * attn_size * num_attn_heads. Supervised: attn_out of the
    flattened attention, plus the optional LR (`use_lr`) and MLP tower
    (`num_dnn_layers`, `dnn_out`)."""

    def __init__(self, config: Config):
        super().__init__(config)
        c = config
        width = c.num_attn_heads * c.attn_size
        self.embed = _embeddings(c)
        self.self_attention = nn.ModuleList(
            MultiHeadSelfAttention(c.embed_size if i == 0 else width, c.attn_size,
                                   c.num_attn_heads, c.attn_probs_dropout_rate,
                                   use_residual=c.res_conn, use_scale=c.attn_scale)
            for i in range(c.num_attn_layers))
        final_dim = c.num_fields * width
        self.lr_layer = self.dnn = None
        if not c.pretrain:
            self.attn_out = TorchDense(final_dim, 1)
            if c.use_lr:
                self.lr_layer = LRLayer(c.input_size)
            if c.num_dnn_layers:
                self.dnn = _dnn_tower(c, c.num_fields * c.embed_size)
                self.dnn_out = TorchDense(c.dnn_size, 1)
        self.finish(final_dim)

    def _attention(self, feat_embed: torch.Tensor) -> torch.Tensor:
        h = feat_embed
        for layer in self.self_attention:
            h = layer(h)
        return h.flatten(1)

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self._attention(self.embed(input_ids))

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        feat_embed = self.embed(input_ids)
        logits = self.attn_out(self._attention(feat_embed))
        if self.lr_layer is not None:
            logits = logits + self.lr_layer(input_ids)
        if self.dnn is not None:
            logits = logits + self.dnn_out(self.dnn(feat_embed.flatten(1)))
        return logits


class _Encoder(nn.Module):
    """Holds the layers under torch.nn.TransformerEncoder's name `layers`."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Transformer(CTRModel):
    """A Transformer encoder over the field tokens (map_tpu `zoo.py:371-445`):
    num_hidden_layers TransformerEncoderLayers (`encoder.layers.{i}`) of
    width hidden_size, which must equal embed_size. final_dim = F *
    hidden_size. Supervised: the `output_reduction` head (fc of the
    flattened tokens; fc of their mean or sum; or `attn,fc`, an attention
    pooling whose scores come from `field_reduction_attn`, Linear, ReLU,
    Linear, softmaxed over the fields) into `trans_out`, plus the optional
    LR and MLP tower (`mlp`, `mlp_out`)."""

    REDUCTIONS = ("fc", "mean,fc", "sum,fc", "attn,fc")

    def __init__(self, config: Config):
        super().__init__(config)
        c = config
        self.embed = _embeddings(c)
        self.encoder = _Encoder(
            TransformerEncoderLayer(c.hidden_size, c.num_attn_heads, c.intermediate_size,
                                    c.hidden_dropout_rate, c.hidden_act, c.layer_norm_eps,
                                    c.norm_first)
            for _ in range(c.num_hidden_layers))
        self.lr_layer = self.mlp = None
        if not c.pretrain:
            red = c.output_reduction
            if red not in self.REDUCTIONS:
                raise NotImplementedError(red)
            if red == "attn,fc":
                self.field_reduction_attn = nn.Sequential(
                    TorchDense(c.hidden_size, c.embed_size), nn.ReLU(),
                    TorchDense(c.embed_size, 1))
            self.trans_out = TorchDense(
                c.num_fields * c.hidden_size if red == "fc" else c.hidden_size, 1)
            if c.use_lr:
                self.lr_layer = LRLayer(c.input_size)
            if c.num_dnn_layers > 0:
                self.mlp = _dnn_tower(c, c.num_fields * c.embed_size)
                self.mlp_out = TorchDense(c.dnn_size, 1)
        self.finish(c.num_fields * c.hidden_size)

    def _encode(self, feat_embed: torch.Tensor) -> torch.Tensor:
        h = feat_embed
        for layer in self.encoder.layers:
            h = layer(h)
        return h

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self._encode(self.embed(input_ids)).flatten(1)

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        c = self.config
        feat_embed = self.embed(input_ids)
        enc = self._encode(feat_embed)
        red = c.output_reduction
        if red == "fc":
            logits = self.trans_out(enc.flatten(1))
        elif red == "mean,fc":
            logits = self.trans_out(enc.sum(dim=1) / c.num_fields)
        elif red == "sum,fc":
            logits = self.trans_out(enc.sum(dim=1))
        else:
            score = torch.softmax(self.field_reduction_attn(enc), dim=1)
            logits = self.trans_out((enc * score).sum(dim=1))
        if self.lr_layer is not None:
            logits = logits + self.lr_layer(input_ids)
        if self.mlp is not None:
            logits = logits + self.mlp_out(self.mlp(feat_embed.flatten(1)))
        return logits


class DCNV2(CTRModel):
    """CrossNetV2 || MLP -> concat -> fc_out. final_dim = F*E + hidden_size.
    With `config.mfp` the MFP head (`models/base.py`) replaces fc_out, as in
    map_tpu (`zoo.py:215-218`), with `config.rfd` the RFD head: 17
    parameters each at 3 cross and 3 MLP layers. The embedding takes the
    field-blocked hybrid lookup as map_tpu's (`zoo.py:59-71`).

    In bf16 the rounding points are map_tpu's: rows gathered in float32 and
    cast to bf16, the cross net and the MLP in bf16 (f32 accumulate), and
    fc_out in float32 (map_tpu's TorchDense with dtype=None promotes).

    `train()` is map_tpu's `train=True`: it turns on the embedding and MLP
    dropout (from the generator of `nn.layers.set_dropout_generator`); the
    gather and the cross net are differentiable through their kernels
    (`ops/embedding.py`, `ops/cross.py`) in both modes."""

    def __init__(self, config: Config):
        super().__init__(config)
        c = config
        dim = c.num_fields * c.embed_size
        self.embed = _embeddings(c)
        self.cross_net = CrossNetV2(dim, c.num_cross_layers,
                                    dtype=resolve_dtype(c.compute_dtype))
        self.parallel_dnn = _mlp(c, dim) if c.num_hidden_layers > 0 else None
        self.finish(dim + (c.hidden_size if self.parallel_dnn is not None else 0), "fc_out")

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        feat_embed = self.embed(input_ids).reshape(input_ids.shape[0], -1)
        cross_output = self.cross_net(feat_embed)
        if self.parallel_dnn is not None:
            dnn_output = self.parallel_dnn(feat_embed)
            return torch.cat([cross_output, dnn_output], dim=-1)
        return cross_output

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.backbone(input_ids))
