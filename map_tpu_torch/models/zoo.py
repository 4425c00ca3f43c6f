"""Model zoo of the port. Counterpart: `map_tpu/models/zoo.py`; only DCNv2 so
far (zoo.py:203-230). The rest of the zoo is queued in ROADMAP.md."""

from __future__ import annotations

import torch

from map_tpu_torch.config import Config
from map_tpu_torch.models.base import CTRModel
from map_tpu_torch.nn.layers import (
    CrossNetV2,
    Embeddings,
    MLPBlock,
    TorchDense,
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
        dt = resolve_dtype(c.compute_dtype)
        dim = c.num_fields * c.embed_size
        self.embed = Embeddings(c.input_size, c.embed_size, c.num_fields,
                                embed_norm=c.embed_norm,
                                layer_norm_eps=c.layer_norm_eps,
                                dropout_rate=c.embed_dropout_rate, dtype=dt,
                                field_bounds=field_bounds(c), hybrid_mode=c.hybrid_mode)
        self.cross_net = CrossNetV2(dim, c.num_cross_layers, dtype=dt)
        self.parallel_dnn = (
            MLPBlock(dim, c.hidden_size, c.num_hidden_layers, c.hidden_act,
                     c.hidden_dropout_rate, dtype=dt)
            if c.num_hidden_layers > 0 else None)
        final_dim = dim + (c.hidden_size if self.parallel_dnn is not None else 0)
        if c.mfp or c.rfd:
            self.create_pretraining_predictor(final_dim)
        else:
            self.fc_out = TorchDense(final_dim, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        self.cross_net.reset_parameters(generator)
        if self.parallel_dnn is not None:
            for layer in self.parallel_dnn.dnn:
                if isinstance(layer, TorchDense):
                    layer.reset_parameters(generator)
        if self.config.mfp or self.config.rfd:
            self.reset_pretraining_predictor(generator)
        else:
            self.fc_out.reset_parameters(generator)

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        feat_embed = self.embed(input_ids).reshape(input_ids.shape[0], -1)
        cross_output = self.cross_net(feat_embed)
        if self.parallel_dnn is not None:
            dnn_output = self.parallel_dnn(feat_embed)
            return torch.cat([cross_output, dnn_output], dim=-1)
        return cross_output

    def supervised_logits(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.backbone(input_ids))
