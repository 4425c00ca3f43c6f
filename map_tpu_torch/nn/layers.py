"""The DCNv2 layers. Counterpart: `map_tpu/nn/layers.py:49-181`.

Attribute names follow the reference's torch modules, so `state_dict()` keys
are the names `map_tpu/interop/torch_import.py` exchanges: an
`embedding.weight` table with an optional `layer_norm`, cross layers in
`cross_layers.{i}`, and an MLP `nn.Sequential` named `dnn` of
[Linear, act, Dropout] per layer (Linear j at index 3j).

`dtype` is the compute dtype, as in map_tpu: parameters stay float32 and are
cast where they are used.

Train mode (`module.train()`) switches dropout on, as map_tpu's `train=True`
does. Dropout draws from an explicit `torch.Generator` on the activations'
device (`set_dropout_generator`); the canonical configurations have no
dropout (rate 0.0), and then the layers are identity in both modes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from map_tpu_torch.data.dataset import NUM_RESERVED
from map_tpu_torch.nn import init
from map_tpu_torch.nn.activations import Activation
from map_tpu_torch.ops.cross import cross_net
from map_tpu_torch.ops.embedding import embedding_lookup
from map_tpu_torch.ops.hybrid_gather import hybrid_lookup

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """'float32' | 'bfloat16' | None -> torch dtype (None: promote as-is)."""
    return None if name is None else DTYPES[name]


class Dropout(nn.Module):
    """flax nn.Dropout: in train mode keep each element with probability
    1 - rate and scale the kept ones by 1 / (1 - rate); identity otherwise.
    The mask is drawn from `self.generator` (one on the input's device)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: call "
                               "set_dropout_generator(model, generator) first")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def set_dropout_generator(module: nn.Module, generator: torch.Generator) -> None:
    """Hand one generator to every Dropout of `module`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class TorchDense(nn.Linear):
    """nn.Linear computed in `dtype` (None: in the input's dtype promoted with
    the float32 parameters, as flax Dense with dtype=None). Like flax Dense,
    the product is rounded to `dtype` before the bias is added."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:  # nn.Linear's own construction-time init
            super().reset_parameters()
        else:
            init.linear_(self.weight, self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y if self.bias is None else y + self.bias.to(dt)


class Embeddings(nn.Module):
    """One (V, E) table over the field-blocked id space, optional LayerNorm
    and dropout. map_tpu may store the table lane-packed; the port always
    stores it plain (`interop/from_jax.py` unpacks). With `field_bounds`,
    each field's (lo, hi) id range, (B, F) ids take the field-blocked hybrid
    lookup (`ops/hybrid_gather.py`) in `hybrid_mode` ("" = its default), as
    map_tpu's Embeddings (`nn/layers.py:89-119`) routes its packed table."""

    def __init__(self, input_size: int, embed_size: int, num_fields: int,
                 embed_norm: bool = False, layer_norm_eps: float = 1e-12,
                 dropout_rate: float = 0.0, dtype: Optional[torch.dtype] = None,
                 field_bounds=None, hybrid_mode: str = ""):
        super().__init__()
        self.num_fields = num_fields
        self.embed_size = embed_size
        self.dtype = dtype
        self.field_bounds = None if field_bounds is None else tuple(field_bounds)
        self.hybrid_mode = hybrid_mode
        self.embedding = nn.Embedding(input_size, embed_size)
        self.layer_norm = (nn.LayerNorm(embed_size, eps=layer_norm_eps)
                           if embed_norm else None)
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0.0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.embedding_(self.embedding.weight, self.num_fields, self.embed_size,
                        generator)
        if self.layer_norm is not None:
            self.layer_norm.reset_parameters()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        bounds = self.field_bounds
        if (bounds is not None and input_ids.dim() == 2
                and input_ids.shape[1] == len(bounds)):
            emb = hybrid_lookup(self.embedding.weight, input_ids, bounds, NUM_RESERVED,
                                self.hybrid_mode or None, self.dtype)
        else:
            emb = embedding_lookup(self.embedding.weight, input_ids, self.dtype)
        if self.layer_norm is not None:
            # flax LayerNorm reduces in float32 and returns the promotion of
            # its input with its float32 parameters: float32
            emb = self.layer_norm(emb.float())
        if self.dropout is not None:
            emb = self.dropout(emb)
        return emb


class MLPBlock(nn.Module):
    """[Dense -> act -> dropout] x L."""

    def __init__(self, input_dim: int, hidden_size: int, num_hidden_layers: int,
                 hidden_act: str = "relu", hidden_dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        layers = []
        for _ in range(num_hidden_layers):
            layers += [TorchDense(input_dim, hidden_size, dtype=dtype),
                       Activation(hidden_act), Dropout(hidden_dropout_rate)]
            input_dim = hidden_size
        self.dnn = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dnn(x)


class CrossNetV2(nn.Module):
    """DCNv2 full-rank cross network; the L layers run as one `ops.cross`
    call on the stacked weights."""

    def __init__(self, dim: int, num_cross_layers: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.cross_layers = nn.ModuleList(
            nn.Linear(dim, dim) for _ in range(num_cross_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.cross_layers:
            init.linear_(layer.weight, layer.bias, generator)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x0.dtype
        w = torch.stack([layer.weight for layer in self.cross_layers]).to(dt)
        b = torch.stack([layer.bias for layer in self.cross_layers]).to(dt)
        return cross_net(x0.to(dt).contiguous(), w, b)
