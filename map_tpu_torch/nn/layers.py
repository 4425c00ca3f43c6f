"""The model zoo's layers. Counterpart: `map_tpu/nn/layers.py:49-261`
(TorchDense, Embeddings, MLPBlock, CrossNetV2, InnerProductLayer, CIN),
`:264-305` (FGCNNBlock and its BatchNorm), `:358-434` (GraphLayer,
FiGNNBlock, AttentionalPrediction), `:466-574` (MultiHeadSelfAttention,
TransformerEncoderLayer) and LR's `LRLayer` (`map_tpu/models/zoo.py:86-95`).

Attribute names follow the reference's torch modules, so `state_dict()` keys
are the names `map_tpu/interop/torch_import.py` exchanges: an
`embedding.weight` table with an optional `layer_norm`, cross layers in
`cross_layers.{i}`, an MLP `nn.Sequential` named `dnn` of
[Linear, act, Dropout] per layer (Linear j at index 3j), LR's `embed_w`
(V, 1) table and `bias`, CIN's 1x1 convolutions `cin_layer.layer_{i+1}`,
AutoInt's bias-free `W_q` / `W_k` / `W_v` / `W_res`, torch's
TransformerEncoderLayer names (`self_attn.in_proj_weight` /
`in_proj_bias`, `self_attn.out_proj`, `linear1`, `linear2`, `norm1`,
`norm2`), FiGNN's `W_attn`, `gnn` (`W_in`, `W_out`, `bias_p`) and torch's
GRUCell names under `gru`, and FGCNN's `conv_layers.{i}.0` (convolution)
and `.1` (BatchNorm, with `running_mean` / `running_var` buffers) and
`recombine_layers.{i}.0`.

`dtype` is the compute dtype, as in map_tpu: parameters stay float32 and are
cast where they are used. map_tpu casts only the embeddings, the cross net
and the models' `_mlp` to it; every other layer computes in the promotion of
its input with its float32 parameters (TorchDense with dtype=None), and so
do these: a bf16 input meets a float32 weight in float32. LayerNorm reduces
in float32 and returns float32, as flax's does for a bf16 input.

Train mode (`module.train()`) switches dropout on and makes FGCNN's
BatchNorm normalise by the batch and move its running statistics, as
map_tpu's `train=True` does. Dropout draws from an explicit `torch.Generator` on the activations'
device (`set_dropout_generator`); the canonical configurations have no
dropout (rate 0.0), and then the layers are identity in both modes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
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


def _cast_once(module: nn.Module, dt: torch.dtype):
    """The module's weights as `cast_once` kept them in `dt`, under
    inference mode only; else None (cast on the call)."""
    casts = getattr(module, "_casts", None)
    if casts is None or not torch.is_inference_mode_enabled():
        return None
    return casts.get(dt)


def cast_weights_once(model: nn.Module) -> None:
    """Cast once the weights that TorchDense and CrossNetV2 cast on every
    call, for a model that only scores from here on (the Predictor's): its
    inference-mode forwards use the copies, the same values in the same
    layout. Training, its graphs and the Trainer's evals never call this,
    and a forward outside inference mode casts on the call as before."""
    for m in model.modules():
        if hasattr(m, "cast_once"):
            m.cast_once()


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
        w, b = _cast_once(self, dt) or (self.weight.to(dt),
                                        None if self.bias is None else self.bias.to(dt))
        y = torch.matmul(x.to(dt), w.t())
        return y if b is None else y + b

    def cast_once(self) -> None:
        """Keep the weight and bias cast to compute_dtype (`cast_weights_once`)."""
        if self.compute_dtype is not None and self.compute_dtype != self.weight.dtype:
            self._casts = {self.compute_dtype: (
                self.weight.detach().to(self.compute_dtype),
                None if self.bias is None else self.bias.detach().to(self.compute_dtype))}


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

    def _stacked(self, dt: torch.dtype):
        return (torch.stack([layer.weight for layer in self.cross_layers]).to(dt),
                torch.stack([layer.bias for layer in self.cross_layers]).to(dt))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x0.dtype
        w, b = _cast_once(self, dt) or self._stacked(dt)
        return cross_net(x0.to(dt).contiguous(), w, b)

    def cast_once(self) -> None:
        """Keep W and b stacked and cast (`cast_weights_once`): in the compute
        dtype, or in both float32 and bfloat16 when the input sets it."""
        with torch.no_grad():
            self._casts = {dt: self._stacked(dt) for dt in
                           ((self.dtype,) if self.dtype else (torch.float32, torch.bfloat16))}


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
            f = self.num_fields
            ip = torch.matmul(feat_embed, feat_embed.transpose(1, 2))
            # np.triu_indices' order, made on the device (no host copy); one
            # index_select of the flattened products, whose backward adds
            # each pair's gradient once onto zeros (an advanced index's
            # sorts and serialises them)
            iu, ju = torch.triu_indices(f, f, 1, device=feat_embed.device)
            return ip.reshape(ip.shape[0], f * f).index_select(1, iu * f + ju)
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


class GraphLayer(nn.Module):
    """FiGNN's message passing (map_tpu `nn/layers.py:358-373`): per-field
    matrices `W_out` and `W_in` (F, E, E) around the attention graph's
    aggregation, plus `bias_p` (E,): W_in_f (sum_g G[f, g] W_out_g h_g) + b."""

    def __init__(self, num_fields: int, embed_size: int):
        super().__init__()
        self.W_in = nn.Parameter(torch.empty(num_fields, embed_size, embed_size))
        self.W_out = nn.Parameter(torch.empty(num_fields, embed_size, embed_size))
        self.bias_p = nn.Parameter(torch.empty(embed_size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier normal over the last two axes, as map_tpu's; bias zeros."""
        for w in (self.W_in, self.W_out):
            std = math.sqrt(2.0 / float(w.shape[-1] + w.shape[-2]))
            w.normal_(0.0, std, generator=generator)
        self.bias_p.zero_()

    def forward(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        h_out = torch.einsum("fij,bfj->bfi", self.W_out, h)
        aggr = torch.matmul(g, h_out)
        return torch.einsum("fij,bfj->bfi", self.W_in, aggr) + self.bias_p


class GRUCell(nn.Module):
    """torch.nn.GRUCell's parameters (`weight_ih` / `weight_hh` (3H, ·) and
    `bias_ih` / `bias_hh` (3H,), gates r | z | n) in plain tensor
    arithmetic: r = sigmoid(x W_ir + b_ir + h W_hr + b_hr), z likewise,
    n = tanh(x W_in + b_in + r (h W_hn + b_hn)), h' = (1 - z) n + z h,
    which is flax's GRUCell(carry=h, inputs=x) with its input-side r and z
    biases in `bias_ih` and zeros in `bias_hh[:2H]`. flax has one bias for
    each of r and z, so b_hr and b_hz take no gradient here (they stay
    where the carry or the init put them: zero); trained, each would move
    the gate's bias a second time a step, which map_tpu's do not. Weights
    start at U(-1/sqrt(H), 1/sqrt(H)) and biases at zero, as map_tpu's FiGNN
    draws them."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hh = nn.Parameter(torch.empty(3 * hidden_size))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight_hh.shape[1])
        for w in (self.weight_ih, self.weight_hh):
            w.uniform_(-bound, bound, generator=generator)
        self.bias_ih.zero_()
        self.bias_hh.zero_()

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        hidden = self.weight_hh.shape[1]
        bias_hh = torch.cat([self.bias_hh[:2 * hidden].detach(), self.bias_hh[2 * hidden:]])
        gi = torch.matmul(x, self.weight_ih.t()) + self.bias_ih
        gh = torch.matmul(h, self.weight_hh.t()) + bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class FiGNNBlock(nn.Module):
    """FiGNN's field graph (map_tpu `nn/layers.py:376-420`): an attention
    graph over the fields (`W_attn` on [src; dst] for every ordered pair,
    leaky_relu 0.01, the diagonal at -inf, a softmax over the destinations),
    then `gnn_layers` rounds of GraphLayer (`gnn` when `reuse_graph_layer`,
    else `gnn.{i}`), each followed by the GRU cell and the optional
    residual. A bf16 input is promoted to float32 first, as every product
    of map_tpu's block promotes it; the pair tensor keeps map_tpu's
    arithmetic, (B, F * F, 2E)."""

    def __init__(self, num_fields: int, embed_size: int, gnn_layers: int,
                 use_residual: bool = False, reuse_graph_layer: bool = False):
        super().__init__()
        self.num_fields = num_fields
        self.gnn_layers = gnn_layers
        self.use_residual = use_residual
        self.reuse_graph_layer = reuse_graph_layer
        self.gnn = (GraphLayer(num_fields, embed_size) if reuse_graph_layer else
                    nn.ModuleList(GraphLayer(num_fields, embed_size)
                                  for _ in range(gnn_layers)))
        self.gru = GRUCell(embed_size, embed_size)
        self.W_attn = TorchDense(2 * embed_size, 1, bias=False)

    def build_graph_with_attention(self, feat_embed: torch.Tensor) -> torch.Tensor:
        b, f, e = feat_embed.shape
        src = feat_embed[:, :, None, :].expand(b, f, f, e).reshape(b, f * f, e)
        dst = feat_embed[:, None, :, :].expand(b, f, f, e).reshape(b, f * f, e)
        alpha = self.W_attn(torch.cat([src, dst], dim=-1))
        alpha = F.leaky_relu(alpha, negative_slope=0.01).reshape(b, f, f)
        eye = torch.eye(f, dtype=torch.bool, device=alpha.device)
        return torch.softmax(alpha.masked_fill(eye, float("-inf")), dim=-1)

    def forward(self, feat_embed: torch.Tensor) -> torch.Tensor:
        feat_embed = feat_embed.float()
        b, f, e = feat_embed.shape
        g = self.build_graph_with_attention(feat_embed)
        h = feat_embed
        for i in range(self.gnn_layers):
            gnn = self.gnn if self.reuse_graph_layer else self.gnn[i]
            a = gnn(g, h)
            h = self.gru(a.reshape(-1, e), h.reshape(-1, e)).reshape(b, f, e)
            if self.use_residual:
                h = h + feat_embed
        return h


class AttentionalPrediction(nn.Module):
    """FiGNN's head (map_tpu `nn/layers.py:423-434`): a score a field
    (`linear1`, E -> 1) times a gate a field (`linear2.0`, F * E -> F, then
    a sigmoid), summed over the fields -> (B, 1). Both bias-free."""

    def __init__(self, num_fields: int, embed_size: int):
        super().__init__()
        self.linear1 = TorchDense(embed_size, 1, bias=False)
        self.linear2 = nn.Sequential(TorchDense(num_fields * embed_size, num_fields,
                                                bias=False), nn.Sigmoid())

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        score = self.linear1(h)[..., 0]
        weight = self.linear2(h.flatten(1))
        return (weight * score).sum(dim=1, keepdim=True)


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over the last axis
    (channels last, as flax's), under torch's BatchNorm2d names (`weight`,
    `bias` and the buffers `running_mean`, `running_var`; no
    `num_batches_tracked`, which map_tpu has no counterpart of). In train mode it normalises by the
    batch's mean and biased variance, E[x^2] - E[x]^2 clipped at 0 (flax's
    fast variance), and moves the running statistics in place,
    running = 0.9 running + 0.1 batch, with the biased variance too (torch's
    BatchNorm2d would take the unbiased one). In eval mode it normalises by
    the running statistics. Plain tensor arithmetic, and the update is an
    in-place write of registered buffers, so a captured CUDA graph replays
    it. Every row counts, padding rows included: flax's BatchNorm takes no
    mask (map_tpu `nn/layers.py:296`)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = list(range(x.dim() - 1))
        if self.training:
            mean = x.mean(dim=axes)
            var = torch.clamp_min((x * x).mean(dim=axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class FieldConv(nn.Module):
    """A (kh x 1) convolution over the field axis of a channels-last input
    (B, H, E, C), "same" padding (kh - 1) // 2 on both sides, with bias:
    the reference's Conv2d (`weight` (out, in, kh, 1), `bias`), computed as
    one product of the input's kh-row windows (`unfold`, in the weight's
    (c, t) order) with the weight, a GEMM whose bits do not depend on the
    library's choice of algorithm -> (B, H', E, out). The weight starts at
    U(-1/sqrt(kh * in), 1/sqrt(kh * in)) and the bias at zero (flax's Conv,
    map_tpu `nn/init.py:conv_kernel_init`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_height: int):
        super().__init__()
        self.padding = (kernel_height - 1) // 2
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_height, 1))
        self.bias = nn.Parameter(torch.empty(out_channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, e, c = x.shape
        out_ch, _, kh, _ = self.weight.shape
        p = self.padding
        xp = F.pad(x, (0, 0, 0, 0, p, p)) if p else x
        cols = xp.unfold(1, kh, 1)  # (B, H', E, C, kh)
        h = cols.shape[1]
        out = torch.matmul(cols.reshape(b * h * e, c * kh),
                           self.weight.reshape(out_ch, c * kh).t()) + self.bias
        return out.reshape(b, h, e, out_ch)


def fgcnn_heights(num_fields: int, kernel_heights: Sequence[int],
                  pooling_sizes: Sequence[int]):
    """FGCNN's field-axis heights, stage by stage, as map_tpu computes them
    (`nn/layers.py:284-300`): -> [(pooled rows, pad rows, new fields a
    recombined channel)]. map_tpu pads the pool by h mod p rows of -inf on
    both sides, h being its ceil(h / p) chain, which also sizes each stage's
    new fields; the rows the pool returns (and so the recombine's input)
    follow from the rows it is given. With p = 2 both are ceil(h / p); with
    p >= 3 they may differ (h = 8, p = 3: 4 rows pooled, 3 new fields a
    channel)."""
    h = rows = num_fields
    out = []
    for kh, p in zip(kernel_heights, pooling_sizes):
        rows = rows + 2 * ((kh - 1) // 2) - kh + 1  # the convolution's
        pad = h % p
        rows = (rows + 2 * pad - p) // p + 1
        h = int(math.ceil(h / p))
        out.append((rows, pad, h))
    return out


class FGCNNBlock(nn.Module):
    """FGCNN's feature generation (map_tpu `nn/layers.py:264-305`): each
    stage `conv_layers.{i}` = [FieldConv (kh x 1), BatchNorm, act] on the
    channels-last map (B, H, E, C), as map_tpu's NHWC, a (p x 1) max-pool
    with `fgcnn_heights`' -inf rows on both sides, then
    `recombine_layers.{i}` = [Linear(C * H_pooled * E -> h * E * rc), act]
    of the pooled map flattened in the reference's NCHW order (c, h, e), so
    that the Linear's weight is the reference's, reshaped to h * rc new
    fields of width E. Input (B, F, E) float32 -> (B, new fields, E)."""

    def __init__(self, num_fields: int, embedding_dim: int, channels: Sequence[int],
                 kernel_heights: Sequence[int], pooling_sizes: Sequence[int],
                 recombined_channels: Sequence[int], activation: str = "tanh"):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.pooling_sizes = tuple(int(p) for p in pooling_sizes)
        heights = fgcnn_heights(num_fields, kernel_heights, pooling_sizes)
        self.pool_pads = tuple(pad for _, pad, _ in heights)
        convs, recombines = [], []
        in_ch = 1
        for out_ch, kh, (rows, _, h), rc in zip(channels, kernel_heights, heights,
                                                 recombined_channels):
            convs.append(nn.Sequential(FieldConv(in_ch, out_ch, kh), BatchNorm(out_ch),
                                       Activation(activation)))
            recombines.append(nn.Sequential(
                TorchDense(out_ch * rows * embedding_dim, h * embedding_dim * rc),
                Activation(activation)))
            in_ch = out_ch
        self.conv_layers = nn.ModuleList(convs)
        self.recombine_layers = nn.ModuleList(recombines)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        out = x[..., None]
        new_features = []
        for conv, pad, p, recombine in zip(self.conv_layers, self.pool_pads,
                                           self.pooling_sizes, self.recombine_layers):
            out = conv(out)
            if pad:
                out = F.pad(out, (0, 0, 0, 0, pad, pad), value=float("-inf"))
            # an NCHW view of the channels-last map: pooled in that layout,
            # flattened in the reference's (c, h, e) order
            out = F.max_pool2d(out.permute(0, 3, 1, 2), (p, 1), (p, 1))
            new_features.append(
                recombine(out.flatten(1)).reshape(b, -1, self.embedding_dim))
            out = out.permute(0, 2, 3, 1)
        return torch.cat(new_features, dim=1)


# the layers whose reset_parameters takes the init generator
_SEEDED = (TorchDense, Embeddings, MLPBlock, CrossNetV2, LRLayer, CIN,
           PackedSelfAttention, GraphLayer, GRUCell, BatchNorm, FieldConv)


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
