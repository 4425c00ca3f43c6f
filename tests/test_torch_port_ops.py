"""map_tpu_torch ops on the CPU against map_tpu's Pallas kernels.

K4 (`ops/embedding.py`) against `pallas_embedding_lookup` in interpret mode,
exact; K2 (`ops/cross.py`) against `cross_net_pallas` / `_cross_forward` in
interpret mode and against `cross_net_xla` for a ragged D. On the CPU each
port wrapper takes its plain PyTorch version; the CUDA kernels are held
against the same plain versions on the card by `chip_smoke.py` and
`tests/test_torch_port_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu.ops import pallas_cross
from map_tpu.ops.cross import cross_net_xla
from map_tpu.ops.pallas_embedding import pallas_embedding_lookup
from map_tpu_torch.ops import cross as port_cross
from map_tpu_torch.ops import embedding as port_emb

# bf16 band: one bf16 ulp of U (2**-8 relative) may round the other way where
# the two sides sum the f32 products in another order; it reaches the output
# through X_0 * U and the next layers' products.
BF16_ATOL = 2e-2
BF16_RTOL = 2e-2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _bf16_as_f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("e", [8, 16, 12])
def test_embedding_plain_matches_pallas_gather(e):
    rng = np.random.default_rng(e)
    table = rng.normal(size=(300, e)).astype(np.float32)
    ids = rng.integers(0, 300, size=(20, 8)).astype(np.int32)
    ref = np.asarray(pallas_embedding_lookup(jnp.asarray(table),
                                             jnp.asarray(ids), True))
    before = port_emb.launches
    out = port_emb.embedding_lookup(_t(table), _t(ids))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        port_emb.embedding_lookup_plain(_t(table), _t(ids)).numpy(), ref)
    # the fused bf16 cast is the round-to-nearest cast of the gathered rows
    out_bf16 = port_emb.embedding_lookup(_t(table), _t(ids), torch.bfloat16)
    np.testing.assert_array_equal(
        out_bf16.float().numpy(),
        _bf16_as_f32(jnp.asarray(ref).astype(jnp.bfloat16)))
    assert port_emb.launches == before  # the CPU path launches nothing


def _cross_inputs(b, d, num_layers, seed):
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(b, d)) * 0.3).astype(np.float32)
    kernels = (rng.normal(size=(num_layers, d, d)) / np.sqrt(d)).astype(np.float32)
    biases = (rng.normal(size=(num_layers, d)) * 0.1).astype(np.float32)
    return x0, kernels, biases


def _port_weights(kernels, biases, dtype=torch.float32):
    # flax kernels are (in, out); the port takes nn.Linear (out, in)
    return (_t(np.transpose(kernels, (0, 2, 1))).to(dtype),
            _t(biases).to(dtype))


def test_cross_plain_matches_pallas_f32():
    x0, kernels, biases = _cross_inputs(64, 128, 3, seed=0)
    ref = pallas_cross.cross_net_pallas(
        jnp.asarray(x0), list(jnp.asarray(kernels)), list(jnp.asarray(biases)),
        interpret=True)
    w, b = _port_weights(kernels, biases)
    before = port_cross.launches
    out = port_cross.cross_net(_t(x0), w, b)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert port_cross.launches == before


def test_cross_plain_matches_pallas_bf16():
    x0, kernels, biases = _cross_inputs(64, 128, 3, seed=1)
    bf = jnp.bfloat16
    ref = pallas_cross.cross_net_pallas(
        jnp.asarray(x0, bf), [jnp.asarray(k, bf) for k in kernels],
        [jnp.asarray(v, bf) for v in biases], interpret=True)
    w, b = _port_weights(kernels, biases, torch.bfloat16)
    out = port_cross.cross_net(_t(x0).to(torch.bfloat16), w, b)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _bf16_as_f32(ref),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_cross_residuals_match_pallas_forward(monkeypatch):
    x0, kernels, biases = _cross_inputs(40, 128, 3, seed=2)
    monkeypatch.setattr(pallas_cross, "_INTERPRET", True)
    y_ref, xs_ref, us_ref = pallas_cross._cross_forward(
        jnp.asarray(x0), jnp.asarray(kernels), jnp.asarray(biases))
    w, b = _port_weights(kernels, biases)
    y, xs, us = port_cross.cross_net(_t(x0), w, b, save_residuals=True)
    assert xs.shape == us.shape == (3, 40, 128)
    for got, ref in ((y, y_ref), (xs, xs_ref), (us, us_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_cross_ragged_width_matches_xla():
    # D = 40 is no multiple of 128: the TPU path falls back to XLA there
    x0, kernels, biases = _cross_inputs(37, 40, 2, seed=3)
    ref = cross_net_xla(jnp.asarray(x0), list(jnp.asarray(kernels)),
                        list(jnp.asarray(biases)))
    w, b = _port_weights(kernels, biases)
    out = port_cross.cross_net(_t(x0), w, b)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_wrappers_reject_devices_without_a_kernel():
    table = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError):
        port_emb.embedding_lookup(table, torch.zeros(3, dtype=torch.int32,
                                                     device="meta"))
    x0 = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError):
        port_cross.cross_net(x0, torch.zeros(1, 8, 8, device="meta"),
                             torch.zeros(1, 8, device="meta"))


# ---- K1: fused AdamW -------------------------------------------------------

def test_adamw_scalars_match_pack_scalars():
    from map_tpu.ops.fused_adamw import pack_scalars
    from map_tpu_torch.ops import fused_adamw as port_adamw

    for count_inc in (1, 2, 7, 1000):
        ref = np.asarray(pack_scalars(1e-3, 0.1, 0.9, 0.999, 1e-8, count_inc))[0, :7]
        got = np.asarray(port_adamw.scalars(1e-3, 0.1, 0.9, 0.999, 1e-8, count_inc),
                         np.float32)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("wd", [0.1, 0.0])
def test_adamw_plain_matches_pallas(wd):
    from map_tpu.ops.fused_adamw import fused_adamw_dense, pack_scalars
    from map_tpu_torch.ops import fused_adamw as port_adamw

    rng = np.random.default_rng(11)
    shape = (1024, 128)  # the Pallas path: rows a multiple of 512, lanes of 128
    p = rng.normal(size=shape).astype(np.float32)
    mu = (rng.normal(size=shape) * 1e-2).astype(np.float32)
    nu = (rng.random(size=shape) * 1e-4).astype(np.float32)
    g = (rng.normal(size=shape) * 1e-2).astype(np.float32)
    # map_tpu's update first, run to its end, on arrays of its own: JAX on
    # the CPU dispatches it asynchronously and may take a numpy buffer as
    # its own (zero-copy, when the buffer happens to be 64-byte aligned), so
    # nothing it reads is shared with the port or with the test
    scalars = pack_scalars(1e-3, wd, 0.9, 0.999, 1e-8, 3)
    ref = [np.array(r) for r in jax.block_until_ready(fused_adamw_dense(
        *(jnp.array(a, copy=True) for a in (p, mu, nu, g)), scalars, interpret=True))]
    # the port's update from the same float32 scalars (their computation is
    # test_adamw_scalars_match_pack_scalars's), on copies of its own
    s = port_adamw.AdamScalars(*np.asarray(scalars)[0, :7].tolist())
    tp, tmu, tnu, tg = (torch.from_numpy(a.copy()) for a in (p, mu, nu, g))
    before = port_adamw.launches
    port_adamw.fused_adamw(tp, tmu, tnu, tg, s)
    assert port_adamw.launches == before  # the CPU path launches nothing
    for got, want in zip((tp, tmu, tnu), ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)


# ---- K3: gradient scatter-add ----------------------------------------------

@pytest.mark.parametrize("e", [16, 8, 3])
@pytest.mark.parametrize("upstream", ["float32", "bfloat16"])
def test_scatter_plain_matches_pallas(e, upstream):
    from map_tpu.ops import pallas_scatter
    from map_tpu_torch.ops import scatter as port_scatter

    rng = np.random.default_rng(e)
    vocab = 1000
    # duplicates, a run of one hot id, and rows no id touches
    ids = np.concatenate([rng.integers(0, 200, 500), np.full(100, 7),
                          rng.integers(600, vocab, 37)]).astype(np.int32)
    rng.shuffle(ids)
    grads = rng.normal(size=(ids.size, e)).astype(np.float32)
    if upstream == "bfloat16":  # the same values reach both sides
        grads = _bf16_as_f32(jnp.asarray(grads, jnp.bfloat16))
    ref = pallas_scatter.scatter_add(jnp.asarray(ids), jnp.asarray(grads), vocab,
                                     interpret=True)
    g = _t(grads).to(getattr(torch, upstream))
    before = port_scatter.launches
    out = port_scatter.scatter_add(_t(ids), g, vocab)
    assert out.dtype == torch.float32 and out.shape == (vocab, e)
    assert port_scatter.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert not out.numpy()[200:600].any()


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_embedding_backward_matches_gather_rows_vjp(out_dtype):
    import jax

    from map_tpu.ops.embedding import gather_rows

    rng = np.random.default_rng(5)
    table = rng.normal(size=(300, 16)).astype(np.float32)
    ids = rng.integers(0, 40, size=(24, 8)).astype(np.int32)  # many duplicates
    cot = rng.normal(size=(24, 8, 16)).astype(np.float32)
    if out_dtype is not None:
        cot = _bf16_as_f32(jnp.asarray(cot, jnp.bfloat16))
    _, vjp = jax.vjp(lambda t: gather_rows(t, jnp.asarray(ids)), jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(cot))
    tt = _t(table).requires_grad_()
    out = port_emb.embedding_lookup(tt, _t(ids), out_dtype)
    assert out.dtype == (out_dtype or torch.float32) and out.grad_fn is not None
    out.backward(_t(cot).to(out.dtype))
    assert tt.grad.dtype == torch.float32
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ---- K2 backward: the cross net under autograd -------------------------------

def _port_cross_vjp(x0, kernels, biases, cot, dtype):
    w, b = _port_weights(kernels, biases, dtype)
    x = _t(x0).to(dtype).requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    y = port_cross.cross_net(x, w, b)
    assert y.grad_fn is not None and y.dtype == dtype
    y.backward(_t(cot).to(dtype))
    # the port's dW is (L, out, in); map_tpu's is (L, in, out)
    return (x.grad.float().numpy(), w.grad.float().numpy().transpose(0, 2, 1),
            b.grad.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_backward_matches_pallas_vjp(dtype):
    import jax

    x0, kernels, biases = _cross_inputs(48, 128, 3, seed=4)
    cot = np.random.default_rng(9).normal(size=x0.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        x0, kernels, biases, cot = (_bf16_as_f32(jnp.asarray(a, jdt))
                                    for a in (x0, kernels, biases, cot))

    def f(x, ks, bs):
        return pallas_cross.cross_net_pallas(x, list(ks), list(bs), interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x0, jdt), jnp.asarray(kernels, jdt),
                     jnp.asarray(biases, jdt))
    ref = [_bf16_as_f32(r) for r in vjp(jnp.asarray(cot, jdt))]
    got = _port_cross_vjp(x0, kernels, biases, cot, getattr(torch, dtype))
    tol = (1e-5, 1e-5) if dtype == "float32" else (BF16_ATOL, BF16_RTOL)
    for name, g, r in zip(("dx0", "dW", "db"), got, ref):
        np.testing.assert_allclose(g, r, atol=tol[0], rtol=tol[1], err_msg=name)


def test_cross_backward_ragged_width_matches_xla_autodiff():
    import jax

    x0, kernels, biases = _cross_inputs(37, 40, 2, seed=6)
    cot = np.random.default_rng(2).normal(size=x0.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, ks, bs: cross_net_xla(x, list(ks), list(bs)),
                     jnp.asarray(x0), jnp.asarray(kernels), jnp.asarray(biases))
    ref = vjp(jnp.asarray(cot))
    got = _port_cross_vjp(x0, kernels, biases, cot, torch.float32)
    for name, g, r in zip(("dx0", "dW", "db"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=1e-5, err_msg=name)


# ---- K5: sorted-unique scatter, and the decoder gather around it ---------------

def _unique_stream(case):
    """(uids (C,) int32 with the sentinel V behind the valid ids, vals (C, E)
    float32, V) for the Pallas kernel's own test shapes: C a multiple of 512
    and at least 1024."""
    rng = np.random.default_rng(len(case))
    if case == "dense_window":  # every id of the table, every window full
        v, c = 2048, 2048
        uids = np.arange(c, dtype=np.int32)
    else:  # "sparse", or a vocabulary that is not a multiple of the tile
        v, c, nu = (4096, 1024, 700) if case == "sparse" else (3000, 1024, 400)
        uids = np.concatenate([np.sort(rng.choice(v, nu, replace=False)),
                               np.full(c - nu, v)]).astype(np.int32)
    vals = rng.normal(size=(c, 33)).astype(np.float32)
    vals[uids >= v] = 0.0
    return uids, vals, v


@pytest.mark.parametrize("case", ["sparse", "vocab_not_tile_multiple", "dense_window"])
@pytest.mark.parametrize("matmul", ["highest", "bf16x2"])
def test_scatter_unique_sorted_plain_matches_pallas(case, matmul):
    from map_tpu.ops.pallas_scatter import scatter_unique_sorted as jax_k5
    from map_tpu_torch.ops import scatter_unique

    uids, vals, v = _unique_stream(case)
    ref = np.asarray(jax_k5(jnp.asarray(uids), jnp.asarray(vals), v, interpret=True,
                            matmul=matmul))
    before = scatter_unique.launches
    (out,) = scatter_unique.scatter_unique_sorted(_t(uids), _t(vals), v, matmul=matmul)
    assert scatter_unique.launches == before  # the CPU path launches nothing
    assert out.dtype == torch.float32 and out.shape == (v, 33)
    np.testing.assert_array_equal(out.numpy(), ref)  # exact in both modes
    # the decoder's split: the emb columns and the bias column, contiguous
    emb, bias = scatter_unique.scatter_unique_sorted(_t(uids), _t(vals), v,
                                                     widths=(32, 1), matmul=matmul)
    assert emb.is_contiguous() and bias.shape == (v, 1)
    np.testing.assert_array_equal(torch.cat([emb, bias], 1).numpy(), ref)


def test_scatter_unique_sorted_rejects_what_it_does_not_take():
    from map_tpu_torch.ops import scatter_unique

    uids, vals = torch.zeros(4, dtype=torch.int32), torch.zeros(4, 33)
    with pytest.raises(ValueError):
        scatter_unique.scatter_unique_sorted(uids, vals, 10, widths=(32, 2))
    with pytest.raises(ValueError):
        scatter_unique.scatter_unique_sorted(uids, vals, 10, matmul="default")
    with pytest.raises(ValueError):  # no kernel for a meta tensor
        scatter_unique.scatter_unique_sorted(uids.to("meta"), vals.to("meta"), 10)


@pytest.mark.parametrize("num_distinct", [5, 60, 3000])
def test_decoder_gather_matches_map_tpu(num_distinct):
    import jax

    from map_tpu.ops import dedup_scatter as jax_ds
    from map_tpu_torch.ops import dedup_scatter

    rng = np.random.default_rng(num_distinct)
    v, e, b, m, c = 4000, 8, 16, 3, 26
    pool = rng.choice(v, num_distinct, replace=False)
    ids = rng.choice(pool, size=(b, m, c)).astype(np.int32)
    emb = rng.normal(size=(v, e)).astype(np.float32)
    bias = rng.normal(size=v).astype(np.float32)
    x = rng.normal(size=(b, m, e)).astype(np.float32)

    def jax_loss(emb_, bias_):
        rows, bb = jax_ds.decoder_gather(emb_, bias_, jnp.asarray(ids), True)
        return jnp.sum(jnp.tanh(jnp.einsum("bmke,bme->bmk", rows, jnp.asarray(x)) + bb))

    ref_rows, ref_b = jax_ds.decoder_gather(jnp.asarray(emb), jnp.asarray(bias),
                                            jnp.asarray(ids), True)
    ref_demb, ref_dbias = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(emb),
                                                             jnp.asarray(bias))
    t_emb = _t(emb).requires_grad_()
    t_bias = _t(bias).reshape(-1, 1).requires_grad_()
    rows, bb = dedup_scatter.decoder_gather(t_emb, t_bias, _t(ids))
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(ref_rows))
    np.testing.assert_array_equal(bb.detach().numpy(), np.asarray(ref_b))
    torch.sum(torch.tanh(torch.einsum("bmke,bme->bmk", rows, _t(x)) + bb)).backward()
    # Both fold by float32 prefix-sum differences, summed in other orders, so
    # a folded value carries the rounding of the running prefix, not of its
    # own size: 1e-5 + 1e-5 |ref|, plus 16 ulps of the largest prefix of its
    # column (measured: differences of up to 9 such ulps, 3.1e-5, where the
    # bias column's prefix, a sum of positive terms, reaches 405).
    s = 1.0 - np.tanh(np.einsum("bmke,bme->bmk", emb[ids].astype(np.float64), x)
                      + bias[ids]) ** 2
    g = np.concatenate([(s[..., None] * x[:, :, None, :]).reshape(-1, e),
                        s.reshape(-1, 1)], axis=1)[np.argsort(ids.ravel(), kind="stable")]
    ulps = 16 * 2.0 ** -24 * np.abs(np.cumsum(g, axis=0)).max(axis=0)
    np.testing.assert_array_less(np.abs(t_emb.grad.numpy() - np.asarray(ref_demb)),
                                 1e-5 + 1e-5 * np.abs(ref_demb) + ulps[:e])
    np.testing.assert_array_less(np.abs(t_bias.grad.numpy()[:, 0] - np.asarray(ref_dbias)),
                                 1e-5 + 1e-5 * np.abs(ref_dbias) + ulps[e])
    untouched = np.setdiff1d(np.arange(v), ids)
    assert not t_emb.grad.numpy()[untouched].any()


def test_sort_and_fold_compacts_the_distinct_ids():
    from map_tpu_torch.ops.dedup_scatter import sort_and_fold

    ids = torch.tensor([7, 3, 7, 9, 3, 3], dtype=torch.int32)
    g = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    uids, vals, num_unique = sort_and_fold(ids, g, 10)
    assert num_unique.item() == 3 and uids.dtype == torch.int32
    assert uids.tolist() == [3, 7, 9, 10, 10, 10]
    assert vals.tolist() == [[2 + 8 + 10, 3 + 9 + 11], [0 + 4, 1 + 5], [6, 7],
                             [0, 0], [0, 0], [0, 0]]
