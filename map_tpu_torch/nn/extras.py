"""Layers of the reference's `code/layers.py` that no model calls, as plain
PyTorch modules. Counterpart: `map_tpu/nn/extras.py`:

- `scaled_dot_product_attention` (:32): products and a softmax, as map_tpu
  writes it (the reference's ScaledDotProductAttention, layers.py:724-743);
- `InterHAtAttentionalAggregation` (:44), `InterHAtMultiHeadSelfAttention`
  (:58) and `InterHAtFeedForward` (:103) (layers.py:746-845);
- `PairwiseKeyAttention` (:123), attention over (B, N, N, E) keys
  (layers.py:429-492);
- `ProductLayer` (:151), per-field kernel products with sum / mean / attn
  aggregation (layers.py:495-578);
- `MultiChannelOutputHead` (:206), the reduction head over (B, N, C, E)
  (layers.py:614-693, without the dead branch at :686).

Dense layers are `TorchDense` (weight (out, in)); raw kernels keep flax's
shapes. flax's LayerNorm (eps 1e-6 where map_tpu gives none) reduces in
float32. Dropout is the port's (`nn/layers.Dropout`), on in train mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from map_tpu_torch.nn.layers import (
    Dropout,
    SelfAttention,
    TorchDense,
    attention,
    layer_norm,
    reset_children,
)

FLAX_LN_EPS = 1e-6  # flax.linen.LayerNorm's default epsilon


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: Optional[float] = None, mask=None):
    """(B, N, E) x (B, M, E) x (B, M, E) -> (context (B, N, E), probs
    (B, N, M)): scores q k^T (over `scale`; -inf where `mask`), softmax over
    the keys, then the probabilities times v."""
    scores = torch.matmul(q, k.transpose(-1, -2))
    if scale:
        scores = scores / scale
    if mask is not None:
        scores = scores.masked_fill(mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v), probs


class InterHAtAttentionalAggregation(nn.Module):
    """softmax over the fields of MLP(x) (`agg_0` relu, `agg_1` to one
    score, no bias), then the fields' weighted sum: (B, N, E) -> (B, E)."""

    def __init__(self, embedding_dim: int, hidden_dim: Optional[int] = None):
        super().__init__()
        hidden = hidden_dim or 4 * embedding_dim
        self.agg_0 = TorchDense(embedding_dim, hidden)
        self.agg_1 = TorchDense(hidden, 1, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = torch.softmax(self.agg_1(torch.relu(self.agg_0(x))), dim=1)
        return (attn * x).sum(1)


class InterHAtMultiHeadSelfAttention(nn.Module):
    """InterHAt's attention: bias-free `W_q` / `W_k` / `W_v` to num_heads *
    attention_dim (default input_dim // num_heads), optional 1/sqrt(d)
    scale, dropout on the probabilities, `W_res` back to input_dim where the
    widths differ, relu, dropout, the residual, an optional LayerNorm `ln`."""

    def __init__(self, input_dim: int, attention_dim: Optional[int] = None,
                 num_heads: int = 1, dropout_rate: float = 0.0, use_residual: bool = True,
                 use_scale: bool = False, layer_norm: bool = False):
        super().__init__()
        self.attn_dim = attention_dim or input_dim // num_heads
        out = num_heads * self.attn_dim
        self.num_heads, self.use_residual, self.use_scale = num_heads, use_residual, use_scale
        self.W_q = TorchDense(input_dim, out, bias=False)
        self.W_k = TorchDense(input_dim, out, bias=False)
        self.W_v = TorchDense(input_dim, out, bias=False)
        self.W_res = TorchDense(out, input_dim, bias=False) if input_dim != out else None
        self.ln = nn.LayerNorm(input_dim, eps=FLAX_LN_EPS) if layer_norm else None
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = attention(self.W_q(x), self.W_k(x), self.W_v(x), self.num_heads,
                        math.sqrt(self.attn_dim) if self.use_scale else None, self.dropout)
        if self.W_res is not None:
            out = self.W_res(out)
        out = torch.relu(out)
        if self.dropout is not None:
            out = self.dropout(out)
        if self.use_residual:
            out = out + x
        return out if self.ln is None else layer_norm(self.ln, out)


class InterHAtFeedForward(nn.Module):
    """Position-wise FFN (`ffn_0` relu, `ffn_1`), the residual, LayerNorm `ln`."""

    def __init__(self, input_dim: int, hidden_dim: Optional[int] = None,
                 use_residual: bool = True, layer_norm: bool = True):
        super().__init__()
        hidden = hidden_dim or 4 * input_dim
        self.use_residual = use_residual
        self.ffn_0 = TorchDense(input_dim, hidden)
        self.ffn_1 = TorchDense(hidden, input_dim)
        self.ln = nn.LayerNorm(input_dim, eps=FLAX_LN_EPS) if layer_norm else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ffn_1(torch.relu(self.ffn_0(x)))
        if self.use_residual:
            h = h + x
        return h if self.ln is None else layer_norm(self.ln, h)


class PairwiseKeyAttention(nn.Module):
    """BERT-style attention whose keys and values are per pair: query
    (B, N, Dq), key_states (B, N, N, Dk) -> (B, N, H * head), head =
    hidden_size // num_attn_heads; position n attends over its N keys
    k[n, m], scores over sqrt(head), dropout on the probabilities."""

    def __init__(self, hidden_size: int, num_attn_heads: int, dropout_rate: float = 0.1,
                 query_dim: Optional[int] = None, key_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_attn_heads
        self.head = hidden_size // num_attn_heads
        all_head = num_attn_heads * self.head
        self.query = TorchDense(query_dim or hidden_size, all_head)
        self.key = TorchDense(key_dim or hidden_size, all_head)
        self.value = TorchDense(key_dim or hidden_size, all_head)
        self.dropout = Dropout(dropout_rate) if dropout_rate > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def forward(self, query_states: torch.Tensor, key_states: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(query_states), self.key(key_states), self.value(key_states)
        b, n, a = q.shape
        h, d = self.num_heads, self.head
        qh = q.reshape(b, n, h, d).permute(0, 2, 1, 3)
        kh = k.reshape(b, n, n, h, d).permute(0, 3, 1, 2, 4)
        vh = v.reshape(b, n, n, h, d).permute(0, 3, 1, 2, 4)
        scores = torch.einsum("bhne,bhnme->bhnm", qh, kh) / math.sqrt(d)
        probs = torch.softmax(scores, dim=-1)
        if self.dropout is not None:
            probs = self.dropout(probs)
        ctx = torch.einsum("bhnm,bhnme->bhne", probs, vh)
        return ctx.permute(0, 2, 1, 3).reshape(b, n, a)


class ProductLayer(nn.Module):
    """Per-field kernel products (B, N, c_in, E) -> (B, N, c_out, E):
    `kernel` (c_out, c_in, N, E, E), xavier-normal times sqrt(N), applied to
    each field's embedding, then contracted with the fields' sum or mean
    (`agg_type` sum | mean) or with each field's `self_attn` output (attn),
    plus `bias` (N, c_out); the input added back when `res_conn` (c_in ==
    c_out or c_in == 1); LayerNorm `ln` before (`norm_first`) or after."""

    def __init__(self, num_fields: int, hidden_size: int, c_in: int = 1, c_out: int = 1,
                 agg_type: str = "mean", res_conn: bool = False,
                 use_layer_norm: bool = False, norm_first: bool = False,
                 num_attn_heads: int = 1, attn_dropout: float = 0.0):
        super().__init__()
        n, e = num_fields, hidden_size
        self.num_fields, self.hidden_size, self.c_in, self.c_out = n, e, c_in, c_out
        self.agg_type, self.res_conn, self.norm_first = agg_type, res_conn, norm_first
        self.kernel = nn.Parameter(torch.empty(c_out, c_in, n, e, e))
        self.bias = nn.Parameter(torch.zeros(n, c_out))
        self.ln = nn.LayerNorm(e, eps=FLAX_LN_EPS) if use_layer_norm else None
        self.self_attn = (SelfAttention(e, num_attn_heads, attn_dropout)
                          if agg_type == "attn" else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        e = self.hidden_size
        self.kernel.normal_(0.0, math.sqrt(2.0 / (e + e)) * math.sqrt(self.num_fields),
                            generator=generator)
        self.bias.zero_()
        reset_children(self, generator)

    def forward(self, feat_embeds: torch.Tensor) -> torch.Tensor:
        n, e = self.num_fields, self.hidden_size
        q = feat_embeds
        if self.ln is not None and self.norm_first:
            q = layer_norm(self.ln, q)
        pk = torch.einsum("bnie,oinef->bnoif", feat_embeds, self.kernel)
        if self.self_attn is not None:
            b = q.shape[0]
            qa = self.self_attn(q.transpose(1, 2).reshape(-1, n, e))
            qa = qa.reshape(b, self.c_in, n, e).transpose(1, 2)
            pkq = torch.einsum("bnoif,bnif->bnof", pk, qa)
        else:
            qr = (q.sum(1, keepdim=True) if self.agg_type == "sum"
                  else q.mean(1, keepdim=True))
            pkq = torch.einsum("bnoif,brif->bnof", pk, qr)
        pkq = pkq + self.bias[None, :, :, None]
        if self.res_conn and (self.c_in == self.c_out or self.c_in == 1):
            pkq = pkq + feat_embeds
        if self.ln is not None and not self.norm_first:
            pkq = layer_norm(self.ln, pkq)
        return pkq


class MultiChannelOutputHead(nn.Module):
    """The head over (B, N, C, E): `output_reduction` 'fc' (one `fc_out`
    over everything), 'mean,fc' (the fields' mean, then `fc_out`), or three
    of sum | max | avg | fc for the field, channel and embedding axes
    (reduced embedding first; an fc axis is kept for `fc_out`, which exists
    when more than one value is left)."""

    def __init__(self, num_fields: int, num_channels: int, embed_size: int,
                 output_reduction: str = "sum,max,sum", output_dim: int = 1):
        super().__init__()
        self.num_fields = num_fields
        self.parts = output_reduction.split(",")
        sizes = (num_fields, num_channels, embed_size)
        if self.parts == ["fc"]:
            width = num_fields * num_channels * embed_size
        elif self.parts == ["mean", "fc"]:
            width = num_channels * embed_size
        else:
            width = 1
            for kind, size in zip(self.parts, sizes):
                if kind not in ("sum", "max", "avg"):
                    width *= size
        self.fc_out = (TorchDense(width, output_dim)
                       if width > 1 or self.parts in (["fc"], ["mean", "fc"]) else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.parts == ["fc"]:
            return self.fc_out(h.reshape(h.shape[0], -1))
        if self.parts == ["mean", "fc"]:
            return self.fc_out((h.sum(1) / self.num_fields).reshape(h.shape[0], -1))

        def reduce(kind, x, axis):
            if kind == "sum":
                return x.sum(axis)
            if kind == "max":
                return x.amax(axis)
            if kind == "avg":
                return x.mean(axis)
            return x

        x = reduce(self.parts[0], reduce(self.parts[1], reduce(self.parts[2], h, 3), 2), 1)
        x = x.reshape(x.shape[0], -1)
        return self.fc_out(x) if self.fc_out is not None else x
