"""The layers no model calls, the port's against map_tpu's flax modules on
the CPU: `nn/extras.py` (scaled_dot_product_attention, the InterHAt three,
PairwiseKeyAttention, ProductLayer, MultiChannelOutputHead) and the five of
`nn/layers.py` (OuterProductLayer, SqueezeExtractionLayer,
BilinearInteractionLayer, SelfAttention, IntermediateLayer). map_tpu's
parameters are carried by hand (its interop has no name rules for them):
a flax Dense's (in, out) kernel is the TorchDense weight transposed, a
LayerNorm's scale its weight, raw kernels keep their shapes. Same seeded
inputs, f32, dropout off: the outputs and the inputs' gradients at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from map_tpu.nn import extras as jx
from map_tpu.nn import layers as jl
from map_tpu_torch.nn import extras as tx
from map_tpu_torch.nn import layers as tl

TOL = 1e-5
B, N, E = 4, 5, 8


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def carry(module: nn.Module, params) -> None:
    """map_tpu's flax params into the port's module, by name."""
    owners = dict(module.named_modules())
    with torch.no_grad():
        for name, p in module.named_parameters():
            *path, leaf = name.split(".")
            owner = owners[".".join(path)]
            node = params
            for key in path:
                node = node[key]
            if isinstance(owner, tl.TorchDense):
                value = (np.asarray(node["dense"]["kernel"]).T if leaf == "weight"
                         else node["dense"]["bias"])
            elif isinstance(owner, nn.LayerNorm):
                value = node["scale" if leaf == "weight" else "bias"]
            else:
                value = node[leaf]
            value = np.array(value)
            assert value.shape == tuple(p.shape), name
            p.copy_(torch.from_numpy(value))


def check(flax_module, torch_module, inputs, seed=0, init_rngs=None, **kw):
    """Forward and the inputs' gradients of sum(out * cotangent)."""
    jin = [jnp.asarray(a) for a in inputs]
    variables = flax_module.init(init_rngs or jax.random.PRNGKey(seed), *jin, **kw)
    carry(torch_module, variables.get("params", {}))
    torch_module.eval()

    def f(*xs):
        return flax_module.apply(variables, *xs, **kw)

    want = f(*jin)
    cot = jnp.asarray(_x(want.shape, seed + 99))
    jgrads = jax.grad(lambda *xs: jnp.sum(f(*xs) * cot), argnums=tuple(range(len(jin))))(*jin)
    tin = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    got = torch_module(*tin)
    (got * torch.from_numpy(np.asarray(cot))).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for t, g in zip(tin, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_scaled_dot_product_attention(masked):
    q, k, v = _x((B, N, E), 1), _x((B, 7, E), 2), _x((B, 7, E), 3)
    mask = np.zeros((B, N, 7), bool)
    mask[:, :, 5:] = masked
    jc, jp = jx.scaled_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             scale=E ** 0.5, mask=jnp.asarray(mask))
    tc, tp = tx.scaled_dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), scale=E ** 0.5,
                                             mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=TOL, atol=TOL)


def test_interhat_aggregation():
    check(jx.InterHAtAttentionalAggregation(embedding_dim=E),
          tx.InterHAtAttentionalAggregation(E), [_x((B, N, E), 4)])


@pytest.mark.parametrize("heads,attn_dim,scale,ln", [(2, None, False, False),
                                                    (2, 3, True, True), (1, 8, True, False)])
def test_interhat_self_attention(heads, attn_dim, scale, ln):
    check(jx.InterHAtMultiHeadSelfAttention(input_dim=E, attention_dim=attn_dim,
                                            num_heads=heads, use_scale=scale, layer_norm=ln),
          tx.InterHAtMultiHeadSelfAttention(E, attn_dim, heads, use_scale=scale,
                                            layer_norm=ln), [_x((B, N, E), 5)])


@pytest.mark.parametrize("residual,ln", [(True, True), (False, False)])
def test_interhat_feed_forward(residual, ln):
    check(jx.InterHAtFeedForward(input_dim=E, hidden_dim=12, use_residual=residual,
                                 layer_norm=ln),
          tx.InterHAtFeedForward(E, 12, residual, ln), [_x((B, N, E), 6)])


def test_pairwise_key_attention():
    check(jx.PairwiseKeyAttention(hidden_size=E, num_attn_heads=2),
          tx.PairwiseKeyAttention(E, 2), [_x((B, N, E), 7), _x((B, N, N, E), 8)])


@pytest.mark.parametrize("agg,c_in,c_out,res,ln,first", [
    ("sum", 1, 2, True, True, False), ("mean", 2, 2, True, True, True),
    ("mean", 2, 3, False, False, False), ("attn", 2, 1, False, True, False)])
def test_product_layer(agg, c_in, c_out, res, ln, first):
    check(jx.ProductLayer(num_fields=N, hidden_size=E, c_in=c_in, c_out=c_out, agg_type=agg,
                          res_conn=res, use_layer_norm=ln, norm_first=first,
                          num_attn_heads=2),
          tx.ProductLayer(N, E, c_in, c_out, agg, res, ln, first, num_attn_heads=2),
          [_x((B, N, c_in, E), 9)],
          init_rngs={"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})


@pytest.mark.parametrize("red", ["fc", "mean,fc", "sum,max,sum", "sum,sum,sum", "fc,max,avg",
                                 "max,fc,fc", "avg,sum,fc"])
def test_multi_channel_output_head(red):
    check(jx.MultiChannelOutputHead(num_fields=N, num_channels=3, embed_size=E,
                                    output_reduction=red),
          tx.MultiChannelOutputHead(N, 3, E, red), [_x((B, N, 3, E), 10)])


@pytest.mark.parametrize("kind,fields,e", [("vec", N, E), ("num", N, E), ("mat", 4, 6)])
def test_outer_product_layer(kind, fields, e):
    """'mat' where map_tpu defines it, P == E (4 fields: 6 pairs)."""
    check(jl.OuterProductLayer(num_fields=fields, embed_size=e, kernel_type=kind),
          tl.OuterProductLayer(fields, e, kind), [_x((B, fields, e), 11)])


def test_outer_product_mat_needs_as_many_pairs_as_widths():
    m = tl.OuterProductLayer(N, E, "mat")
    with pytest.raises(RuntimeError):
        m(torch.zeros(2, N, E))


def test_squeeze_extraction_layer():
    check(jl.SqueezeExtractionLayer(num_fields=6, reduction_ratio=3),
          tl.SqueezeExtractionLayer(6, 3), [_x((B, 6, E), 12)])


@pytest.mark.parametrize("kind", ["field_all", "field_each", "field_interaction"])
def test_bilinear_interaction_layer(kind):
    check(jl.BilinearInteractionLayer(num_fields=N, embed_size=E, bilinear_type=kind),
          tl.BilinearInteractionLayer(N, E, kind), [_x((B, N, E), 13)])


@pytest.mark.parametrize("heads", [1, 2])
def test_self_attention(heads):
    check(jl.SelfAttention(hidden_size=E, num_attn_heads=heads),
          tl.SelfAttention(E, heads), [_x((B, N, E), 14)])


@pytest.mark.parametrize("act,res,ln,first", [("relu", False, False, False),
                                              ("gelu", True, True, False),
                                              ("relu", True, True, True)])
def test_intermediate_layer(act, res, ln, first):
    check(jl.IntermediateLayer(hidden_size=E, intermediate_size=12, hidden_act=act,
                               res_conn=res, use_layer_norm=ln, norm_first=first),
          tl.IntermediateLayer(E, 12, act, 0.0, res, ln, first), [_x((B, N, E), 15)])


def test_every_layer_draws_its_parameters_from_the_generator():
    mods = [tx.InterHAtAttentionalAggregation(E), tx.InterHAtMultiHeadSelfAttention(E, 3, 2),
            tx.InterHAtFeedForward(E), tx.PairwiseKeyAttention(E, 2),
            tx.ProductLayer(N, E, agg_type="attn"), tx.MultiChannelOutputHead(N, 2, E),
            tl.OuterProductLayer(N, E, "vec"), tl.SqueezeExtractionLayer(6),
            tl.BilinearInteractionLayer(N, E), tl.SelfAttention(E, 2),
            tl.IntermediateLayer(E, 12, use_layer_norm=True)]
    for m in mods:
        a = [p.detach().clone() for p in m.parameters()]
        m.reset_parameters(torch.Generator().manual_seed(3))
        b = [p.detach().clone() for p in m.parameters()]
        m.reset_parameters(torch.Generator().manual_seed(3))
        assert all(torch.equal(x, y) for x, y in zip(b, m.parameters())), type(m).__name__
        assert all(torch.isfinite(x).all() for x in b) and len(a) == len(b)
