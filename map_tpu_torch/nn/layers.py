"""The model zoo's layers. Counterpart: `map_tpu/nn/layers.py:49-261`
(TorchDense, Embeddings, MLPBlock, CrossNetV2, InnerProductLayer, CIN),
`:466-574` (MultiHeadSelfAttention, TransformerEncoderLayer) and LR's
`LRLayer` (`map_tpu/models/zoo.py:86-95`).

Attribute names follow the reference's torch modules, so `state_dict()` keys
are the names `map_tpu/interop/torch_import.py` exchanges: an
`embedding.weight` table with an optional `layer_norm`, cross layers in
`cross_layers.{i}`, an MLP `nn.Sequential` named `dnn` of
[Linear, act, Dropout] per layer (Linear j at index 3j), LR's `embed_w`
(V, 1) table and `bias`, CIN's 1x1 convolutions `cin_layer.layer_{i+1}`,
AutoInt's bias-free `W_q` / `W_k` / `W_v` / `W_res`, and torch's
TransformerEncoderLayer names (`self_attn.in_proj_weight` /
`in_proj_bias`, `self_attn.out_proj`, `linear1`, `linear2`, `norm1`,
`norm2`).

`dtype` is the compute dtype, as in map_tpu: parameters stay float32 and are
cast where they are used. map_tpu casts only the embeddings, the cross net
and the models' `_mlp` to it; every other layer computes in the promotion of
its input with its float32 parameters (TorchDense with dtype=None), and so
do these: a bf16 input meets a float32 weight in float32. LayerNorm reduces
in float32 and returns float32, as flax's does for a bf16 input.

Train mode (`module.train()`) switches dropout on, as map_tpu's `train=True`
does. Dropout draws from an explicit `torch.Generator` on the activations'
device (`set_dropout_generator`); the canonical configurations have no
dropout (rate 0.0), and then the layers are identity in both modes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.dnn:
            if isinstance(layer, TorchDense):
                layer.reset_parameters(generator)

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


def lr_logits(weight: torch.Tensor, bias: torch.Tensor,
              input_ids: torch.Tensor) -> torch.Tensor:
    """LR: (V, 1) table rows of (B, F) ids summed over the fields, plus the
    global bias -> (B, 1) float32. The rows go through the gather (K4 at
    E = 1 on the card) and their gradient through its scatter (K3), which
    sums each row's duplicates in index order: deterministic, where
    atomics are not (map_tpu gathers with `jnp.take`)."""
    return embedding_lookup(weight, input_ids).sum(dim=1) + bias


class LRLayer(nn.Module):
    """map_tpu's `LRLayer` (`models/zoo.py:86-95`) under the reference's
    names (`code/models.py:129-143`): `embed_w` (V, 1), drawn from N(0, 1),
    and `bias` (1,), zeros."""

    def __init__(self, input_size: int):
        super().__init__()
        self.embed_w = nn.Embedding(input_size, 1)
        self.bias = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed_w.weight.normal_(0.0, 1.0, generator=generator)
        self.bias.zero_()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return lr_logits(self.embed_w.weight, self.bias, input_ids)


class InnerProductLayer(nn.Module):
    """product_sum (B, 1) / bi_interaction (B, E) / inner_product
    (B, F (F - 1) / 2, the pairs in `np.triu_indices(F, 1)` order) over
    (B, F, E) field embeddings, in their dtype (map_tpu `nn/layers.py:184-209`)."""

    def __init__(self, num_fields: Optional[int] = None, output: str = "product_sum"):
        super().__init__()
        if output not in ("product_sum", "bi_interaction", "inner_product"):
            raise NotImplementedError(output)
        self.num_fields = num_fields
        self.output = output

    def forward(self, feat_embed: torch.Tensor) -> torch.Tensor:
        if self.output == "inner_product":
            ip = torch.matmul(feat_embed, feat_embed.transpose(1, 2))
            # np.triu_indices' order, made on the device (no host copy)
            iu, ju = torch.triu_indices(self.num_fields, self.num_fields, 1,
                                        device=feat_embed.device)
            return ip[:, iu, ju]
        sum_of_square = feat_embed.sum(dim=1) ** 2
        square_of_sum = (feat_embed ** 2).sum(dim=1)
        bi = 0.5 * (sum_of_square - square_of_sum)
        if self.output == "bi_interaction":
            return bi
        return bi.sum(dim=-1, keepdim=True)


class CIN(nn.Module):
    """xDeepFM's compressed interaction network (map_tpu `nn/layers.py:237-261`):
    layer i takes the outer product of x0 and x_i over the fields (B, F * H_i,
    E), a 1x1 convolution over that axis (the reference's Conv1d
    `cin_layer.layer_{i+1}`, weight (units, F * H_i, 1)) plus its bias, and
    sum-pools over E; the pooled layers concatenate to (B, sum(units)).
    x0's first product is in its own dtype (bf16 x bf16 in bf16); the
    convolution's float32 weight promotes it, as map_tpu's einsum does."""

    def __init__(self, num_fields: int, cin_layer_units: Sequence[int]):
        super().__init__()
        self.num_fields = num_fields
        self.units = tuple(int(u) for u in cin_layer_units)
        layers = {}
        for i, unit in enumerate(self.units):
            in_ch = num_fields * (self.units[i - 1] if i > 0 else num_fields)
            layers[f"layer_{i + 1}"] = nn.Conv1d(in_ch, unit, 1)
        self.cin_layer = nn.ModuleDict(layers)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for conv in self.cin_layer.values():
            init.linear_(conv.weight[..., 0], conv.bias, generator)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        b, _, e = x0.shape
        xi, pooled = x0, []
        for conv in self.cin_layer.values():
            had = (x0[:, :, None, :] * xi[:, None, :, :]).reshape(b, -1, e)
            dt = torch.promote_types(had.dtype, conv.weight.dtype)
            xi = (torch.matmul(conv.weight[..., 0].to(dt), had.to(dt))
                  + conv.bias.to(dt)[None, :, None])
            pooled.append(xi.sum(dim=-1))
        return torch.cat(pooled, dim=-1)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H * D) -> (B, H, N, D): the heads split on the channel axis."""
    b, n, _ = t.shape
    return t.reshape(b, n, num_heads, -1).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H * D)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              scale: Optional[float], dropout: Optional["Dropout"]) -> torch.Tensor:
    """map_tpu's attention, product, softmax, product, on (B, N, H * D)
    projections: scores q k^T (times `scale`), softmax over the keys,
    dropout on the probabilities, then the probabilities times v ->
    (B, N, H * D)."""
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(-1, -2))
    if scale is not None:
        scores = scores / scale
    probs = torch.softmax(scores, dim=-1)
    if dropout is not None:
        probs = dropout(probs)
    return _merge_heads(torch.matmul(probs, vh))


class MultiHeadSelfAttention(nn.Module):
    """AutoInt's attention (map_tpu `nn/layers.py:466-516`): bias-free
    `W_q` / `W_k` / `W_v` to num_heads * attention_dim, optional 1/sqrt(d)
    scale, dropout on the probabilities, `W_res` where the input width
    differs from the output's (align_to 'output' projects the residual,
    'input' the output), the residual when `use_residual`, then relu.
    `W_res` exists whatever `use_residual` says, as in map_tpu; unused, its
    gradient is zero. map_tpu's optional LayerNorm has no caller in its zoo
    and is not ported."""

    def __init__(self, input_dim: int, attention_dim: int, num_heads: int = 1,
                 dropout_rate: float = 0.0, use_residual: bool = True,
                 use_scale: bool = False, align_to: str = "output"):
        super().__init__()
        out = num_heads * attention_dim
        self.num_heads = num_heads
        self.attention_dim = attention_dim
        self.use_residual = use_residual
        self.use_scale = use_scale
        self.align_to = align_to
        self.W_q = TorchDense(input_dim, out, bias=False)
        self.W_k = TorchDense(input_dim, out, bias=False)
        self.W_v = TorchDense(input_dim, out, bias=False)
        self.W_res = None
        if input_dim != out:
            self.W_res = (TorchDense(input_dim, out, bias=False) if align_to == "output"
                          else TorchDense(out, input_dim, bias=False))
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = attention(self.W_q(x), self.W_k(x), self.W_v(x), self.num_heads,
                        math.sqrt(self.attention_dim) if self.use_scale else None,
                        self.dropout)
        residual = x
        if self.W_res is not None:
            if self.align_to == "output":
                residual = self.W_res(residual)
            else:
                out = self.W_res(out)
        if self.use_residual:
            out = out + residual
        return torch.relu(out)


class PackedSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (`in_proj_weight` (3D, D)
    holding q, k and v, `in_proj_bias`, `out_proj`) computed as map_tpu's
    q/k/v/out TorchDense (`nn/layers.py:545-562`): heads on the channel
    axis, scores over sqrt(D / heads), dropout on the probabilities."""

    def __init__(self, d_model: int, nhead: int, dropout_rate: float = 0.0):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = TorchDense(d_model, d_model)
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """q, k and v each as a Linear(d_model, d_model), as map_tpu draws them."""
        for w, b in zip(self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)):
            init.linear_(w, b, generator)
        self.out_proj.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.in_proj_weight.dtype)
        qkv = (torch.matmul(x.to(dt), self.in_proj_weight.to(dt).t())
               + self.in_proj_bias.to(dt))
        d = qkv.shape[-1] // 3
        head = d // self.nhead
        ctx = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], self.nhead,
                        math.sqrt(head), self.dropout)
        return self.out_proj(ctx)


class TransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer (batch first) as map_tpu computes it
    (`nn/layers.py:519-574`): self-attention and a feed-forward block
    (linear1, act, dropout, linear2), each followed by dropout, with
    LayerNorms of eps `layer_norm_eps` after each residual (post-norm) or
    before each block (`norm_first`)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout_rate: float = 0.0, activation: str = "relu",
                 layer_norm_eps: float = 1e-12, norm_first: bool = False):
        super().__init__()
        self.norm_first = norm_first
        self.self_attn = PackedSelfAttention(d_model, nhead, dropout_rate)
        self.linear1 = TorchDense(d_model, dim_feedforward)
        self.linear2 = TorchDense(dim_feedforward, d_model)
        self.act = Activation(activation)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dropout is None else self.dropout(x)

    def _attn_block(self, h: torch.Tensor) -> torch.Tensor:
        return self._drop(self.self_attn(h))

    def _ff_block(self, h: torch.Tensor) -> torch.Tensor:
        return self._drop(self.linear2(self._drop(self.act(self.linear1(h)))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's LayerNorm reduces in float32 and returns float32 for a bf16 x
        if self.norm_first:
            x = x + self._attn_block(self.norm1(x.float()))
            return x + self._ff_block(self.norm2(x.float()))
        x = self.norm1((x + self._attn_block(x)).float())
        return self.norm2((x + self._ff_block(x)).float())


# the layers whose reset_parameters takes the init generator
_SEEDED = (TorchDense, Embeddings, MLPBlock, CrossNetV2, LRLayer, CIN,
           PackedSelfAttention)


def reset_children(module: nn.Module, generator: torch.Generator,
                   skip: Sequence[str] = ()) -> None:
    """Draw every parameter under `module` from `generator`, child by child
    in the order they were registered (the children named in `skip` left
    out); LayerNorms take ones and zeros."""
    for name, child in module.named_children():
        if name in skip:
            continue
        if isinstance(child, _SEEDED):
            child.reset_parameters(generator)
        elif isinstance(child, nn.LayerNorm):
            child.reset_parameters()
        else:
            reset_children(child, generator)
