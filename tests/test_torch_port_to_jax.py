"""The reverse weight carry (`map_tpu_torch/interop/to_jax.py`) against map_tpu
on the CPU, for all ten of its models.

A port model drawn from a seed (FGCNN's running statistics moved off their
start by one train-mode forward) is carried into map_tpu's variables tree,
lane-packed as map_tpu's default stores its tables and plain: the tree has
the leaves and shapes of map_tpu's own init, map_tpu's `model.apply` on it
gives the port's logits at 1e-5 in f32 (FGCNN through its `batch_stats`),
`state_dict_from_jax` brings it back bit for bit, and the msgpack file
`save_jax_model` writes loads with map_tpu's `load_model_file`, restores
every leaf through map_tpu's `partial_restore`, and scores through
`map_tpu.serve.Predictor`. The pretraining heads (MFP, RFD) round-trip
against map_tpu's init tree as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from map_tpu import models as jax_models
from map_tpu.train import checkpoints as jax_checkpoints
from map_tpu_torch import models
from map_tpu_torch.config import Config
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.interop.to_jax import save_jax_model, variables_from_state_dict

from test_torch_port_zoo import PRETRAIN, ZOO, _cfg, _ids8, _pretrain_cfg

MODELS = ["dcnv2", *ZOO]
# 4100 ids at E = 16 pack into 513 rows, padded to 1024 (ROW_ALIGN)
VOCAB = 4100


def _port_model(cfg, seed=3):
    port_cfg = Config.from_dict(cfg.to_dict())
    port_cfg.feat_count = getattr(cfg, "feat_count", None)
    model = models.from_config(port_cfg, torch.Generator().manual_seed(seed))
    if any(".running_" in k for k in model.state_dict()):
        model.train()  # move the running statistics off their start
        with torch.no_grad():
            model.backbone(torch.from_numpy(_ids8(16, cfg.input_size, seed + 100)))
    return port_cfg, model.eval()


def _jax_init_shapes(cfg):
    kwargs = {}
    if cfg.pretrain and cfg.pt_type == "MFP":
        kwargs = dict(masked_index=jnp.zeros((2, 2), jnp.int32),
                      candidates=jnp.zeros((2, 2, 6), jnp.int32))
    model = jax_models.from_config(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((2, cfg.num_fields), jnp.int32),
                                               **kwargs))
    return model, {k: tuple(v.shape) for k, v in
                   traverse_util.flatten_dict(jax.tree.map(lambda x: x, dict(shapes))).items()}


def _flat(tree):
    return traverse_util.flatten_dict(tree)


def _assert_round_trip(tree, port_cfg, sd):
    back = state_dict_from_jax(tree, port_cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_carry_gives_map_tpu_the_ports_logits_and_round_trips(name, packed, tmp_path):
    cfg = _cfg(name, input_size=VOCAB, packed_tables=packed,
               **({"share_embedding": False} if name == "fgcnn" else {}))
    port_cfg, port = _port_model(cfg)
    sd = port.state_dict()
    tree = variables_from_state_dict(sd, port_cfg, packed=packed)
    model, shapes = _jax_init_shapes(cfg)
    assert {k: v.shape for k, v in _flat(tree).items()} == shapes
    if packed and name != "lr":  # LR's one table is its (V, 1) weight
        assert tree["params"]["embed"]["embedding"].shape == (1024, 128)
    ids = _ids8(33, VOCAB, 5)
    ref = np.asarray(model.apply(tree, jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    _assert_round_trip(tree, port_cfg, sd)
    # the file: map_tpu's reader gives the tree back, and its partial
    # restore takes every leaf into a model it built itself
    path = save_jax_model(sd, port_cfg, str(tmp_path), 7, packed=packed)
    loaded = jax_checkpoints.load_model_file(path)
    assert set(_flat(loaded)) == set(_flat(tree))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(np.asarray(_flat(loaded)[k]), v, err_msg=str(k))
    fresh = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.zeros((2, cfg.num_fields), jnp.int32)))
    _, n_loaded, skipped = jax_checkpoints.partial_restore(fresh, loaded)
    assert (n_loaded, skipped) == (len(shapes), 0)
    assert Config.load(str(tmp_path)).packed_tables == packed


@pytest.mark.parametrize("pt_type", ["MFP", "RFD"])
@pytest.mark.parametrize("name", ["dcnv2", *PRETRAIN])
def test_pretraining_heads_round_trip_in_map_tpus_layout(name, pt_type):
    cfg = _pretrain_cfg(name, pt_type, packed_tables=True)
    port_cfg, port = _port_model(cfg)
    sd = port.state_dict()
    tree = variables_from_state_dict(sd, port_cfg, packed=True)
    _, shapes = _jax_init_shapes(cfg)
    assert {k: v.shape for k, v in _flat(tree).items()} == shapes
    _assert_round_trip(tree, port_cfg, sd)


def test_map_tpu_predictor_scores_a_port_checkpoint(tmp_path):
    """map_tpu's own Predictor (byte-packed transfer, packed tables) over the
    written run directory gives the port's logits."""
    from map_tpu.serve import Predictor as JaxPredictor

    lo = [int(x) for x in np.cumsum([10] + [300, 60, 2000, 5, 900, 40, 700])]
    hi = [a + s for a, s in zip(lo, [300, 60, 2000, 5, 900, 40, 700, 85])]
    cfg = _cfg("dcnv2", input_size=hi[-1], idx_low=lo, idx_high=hi)
    port_cfg, port = _port_model(cfg)
    save_jax_model(port.state_dict(), port_cfg, str(tmp_path), 4)
    rng = np.random.default_rng(2)
    ids = np.stack([rng.integers(a, b, 50) for a, b in zip(lo, hi)], 1).astype(np.int32)
    got = JaxPredictor(str(tmp_path), 4, batch_size=32).predict_logits(ids)
    with torch.no_grad():
        ref = port(torch.from_numpy(ids)).numpy().reshape(-1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_an_unknown_key_is_refused():
    cfg = _cfg("dnn", input_size=VOCAB)
    port_cfg, port = _port_model(cfg)
    sd = dict(port.state_dict(), stray=torch.zeros(2))
    with pytest.raises(KeyError, match="stray"):
        variables_from_state_dict(sd, port_cfg)
