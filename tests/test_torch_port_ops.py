"""map_tpu_torch ops on the CPU against map_tpu's Pallas kernels.

K4 (`ops/embedding.py`) against `pallas_embedding_lookup` in interpret mode,
exact; K2 (`ops/cross.py`) against `cross_net_pallas` / `_cross_forward` in
interpret mode and against `cross_net_xla` for a ragged D. On the CPU each
port wrapper takes its plain PyTorch version; the CUDA kernels are held
against the same plain versions on the card by `chip_smoke.py` and
`tests/test_torch_port_cuda.py`.
"""

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
