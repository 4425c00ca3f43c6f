"""map_tpu_torch DCNv2 and its weight carry against map_tpu on the CPU.

The flax DCNv2 is initialised by map_tpu, carried across by
`map_tpu_torch.interop.from_jax.state_dict_from_jax`, checked key for key
against `map_tpu.interop.torch_import.export_state_dict`, and both forwards
are compared on the same ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu import models as jax_models
from map_tpu.interop.torch_import import export_state_dict
from map_tpu.nn import activations as jax_acts
from map_tpu.ops.packed_table import unpack_table
from map_tpu.utils import metrics as jax_metrics
from map_tpu_torch import models
from map_tpu_torch.config import Config
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.nn import activations, init
from map_tpu_torch.utils import metrics

from conftest import base_model_config

# bf16 band for logits: map_tpu's XLA cross path rounds the product to bf16
# before the bias, the port once after it, and the MLP's bf16 products are
# summed in another order; each differs by about one bf16 ulp (2**-8).
BF16_ATOL = 3e-2
BF16_RTOL = 3e-2


def _flax_dcnv2(seed=0, **overrides):
    cfg = base_model_config(**overrides)
    model = jax_models.from_config(cfg)
    ids = jnp.zeros((2, cfg.num_fields), jnp.int32)
    variables = model.init(jax.random.PRNGKey(seed), ids)
    return cfg, model, jax.tree.map(np.asarray, variables)


def _port_model(cfg, variables):
    port_cfg = Config.from_dict(cfg.to_dict())
    model = models.from_config(port_cfg)
    model.load_state_dict(state_dict_from_jax(variables, port_cfg))
    return model


def _ids(cfg, n=33, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.input_size, size=(n, cfg.num_fields)).astype(np.int32)


@pytest.mark.parametrize("embed_norm", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_weight_carry_matches_export_state_dict(packed, embed_norm):
    # 4100 ids at E = 16 pack into 513 rows, padded to 1024 (ROW_ALIGN)
    cfg, _, variables = _flax_dcnv2(input_size=4100, packed_tables=packed,
                                    embed_norm=embed_norm)
    port_cfg = Config.from_dict(cfg.to_dict())
    sd = state_dict_from_jax(variables, port_cfg)
    ref = export_state_dict(variables["params"], "dcnv2", cfg)
    assert set(sd) == set(ref)
    table = variables["params"]["embed"]["embedding"]
    assert (table.shape == (1024, 128)) == packed
    for key, val in ref.items():
        if key == "embed.embedding.weight" and packed:
            # export_state_dict passes the packed array through unchanged
            val = np.asarray(unpack_table(jnp.asarray(table), 4100, 16))
        assert sd[key].shape == val.shape, key
        np.testing.assert_array_equal(sd[key].numpy(), val, err_msg=key)
    assert sd["embed.embedding.weight"].shape == (4100, 16)
    # the carried state_dict loads strictly into the port's DCNv2
    models.from_config(port_cfg).load_state_dict(sd)


@pytest.mark.parametrize("embed_norm", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_dcnv2_logits_match_flax_f32(packed, embed_norm):
    cfg, model, variables = _flax_dcnv2(seed=1, packed_tables=packed,
                                        embed_norm=embed_norm)
    ids = _ids(cfg)
    ref = np.asarray(model.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        out = _port_model(cfg, variables)(torch.from_numpy(ids))
    assert out.dtype == torch.float32 and out.shape == (33, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("embed_norm", [False, True])
def test_dcnv2_logits_match_flax_bf16(embed_norm):
    cfg, model, variables = _flax_dcnv2(seed=2, compute_dtype="bfloat16",
                                        packed_tables=True, embed_norm=embed_norm)
    ids = _ids(cfg, seed=1)
    ref = np.asarray(model.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        out = _port_model(cfg, variables)(torch.from_numpy(ids))
    assert out.dtype == torch.float32  # fc_out promotes, as map_tpu's does
    np.testing.assert_allclose(out.numpy(), ref, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_from_config_is_seeded_and_torch_named():
    cfg = Config.from_dict(base_model_config().to_dict())
    a = models.from_config(cfg, torch.Generator().manual_seed(5)).state_dict()
    b = models.from_config(cfg, torch.Generator().manual_seed(5)).state_dict()
    assert list(a) == ["embed.embedding.weight",
                       "cross_net.cross_layers.0.weight", "cross_net.cross_layers.0.bias",
                       "cross_net.cross_layers.1.weight", "cross_net.cross_layers.1.bias",
                       "parallel_dnn.dnn.0.weight", "parallel_dnn.dnn.0.bias",
                       "parallel_dnn.dnn.3.weight", "parallel_dnn.dnn.3.bias",
                       "fc_out.weight", "fc_out.bias"]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(NotImplementedError, match="not one of map_tpu's"):
        models.from_config(Config.from_dict(
            base_model_config(model_name="fibinet").to_dict()))


def test_init_statistics_match_reference():
    g = torch.Generator().manual_seed(0)
    table = torch.empty(20000, 16)
    init.embedding_(table, num_fields=24, embed_size=16, generator=g)
    assert abs(table.std().item() - np.sqrt(2.0 / 40)) < 5e-3
    w, b = torch.empty(64, 384), torch.empty(64)
    init.linear_(w, b, g)
    bound = 1.0 / np.sqrt(384)
    assert w.abs().max() <= bound and w.abs().max() > 0.99 * bound
    assert b.abs().max() <= bound


@pytest.mark.parametrize("name", sorted(activations._ACTS))
def test_activation_matches_map_tpu(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = np.asarray(jax_acts.get_act(name)(jnp.asarray(x)))
    out = activations.get_act(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_metrics_match_map_tpu():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 500)
    s = np.round(rng.random(500), 2)  # ties exercise the average ranks
    x = rng.normal(size=500) * 30
    assert metrics.roc_auc(y, s) == jax_metrics.roc_auc(y, s)
    assert metrics.binary_log_loss(y, s) == jax_metrics.binary_log_loss(y, s)
    np.testing.assert_array_equal(metrics.sigmoid(x), jax_metrics.sigmoid(x))


def test_config_load_keeps_unknown_keys(tmp_path):
    cfg = base_model_config(compute_dtype="bfloat16", idx_low=[10, 20],
                            idx_high=[20, 30])
    cfg.save(str(tmp_path))
    port = Config.load(str(tmp_path))
    assert port.compute_dtype == "bfloat16" and port.idx_low == [10, 20]
    assert port.num_cross_layers == cfg.num_cross_layers
    assert port.cin_layer_units == cfg.cin_layer_units  # a field of the zoo's
    assert port.channels == cfg.channels  # FGCNN's
    assert port.extra["use_pallas"] == cfg.use_pallas  # a key the port does not read
    assert Config.from_dict({"compute_dtype": None}).compute_dtype == "float32"
