"""map_tpu_torch's Predictor v2 (`serve.py`) against map_tpu's on the CPU.

- map_tpu's Predictor (byte-packed transfer, AOT forward) and the port's,
  with `compress_transfer` on and off, on fields of the three widths
  (uint8, uint16, int32 offsets), the last chunk padded: logits at 1e-5 in
  f32.
- The packing: a chunk's blocks rebuild its ids exactly; the padding rows
  are each field's `idx_low` (offset 0) when packing, id 0 when not; the
  real rows' logits do not depend on the padding.
- A bad id raises: outside its field's block when packing (map_tpu's packed
  transfer would wrap it), outside [0, V) when not.
- The weights cast once (`nn.layers.cast_weights_once`): the Predictor's
  bf16 logits are an uncached model's bits, and outside inference mode the
  layers cast on the call.
The three-stage pipeline and the captured forward run on the card only:
`tests/test_torch_port_cuda.py` holds them to an eager forward bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from map_tpu import models as jax_models
from map_tpu.serve import Predictor as JaxPredictor
from map_tpu.train import checkpoints as jax_checkpoints
from map_tpu_torch import models
from map_tpu_torch.config import Config
from map_tpu_torch.nn.layers import CrossNetV2, TorchDense, cast_weights_once
from map_tpu_torch.serve import Predictor
from map_tpu_torch.train import checkpoints

from conftest import base_model_config

STEP = 5
# fields of the three packed widths: <= 256, <= 65,536 and more ids
SIZES = [7, 256, 300, 70_000, 24, 65_536, 5, 1_000]
LOW = [int(x) for x in np.cumsum([10] + SIZES[:-1])]
HIGH = [a + s for a, s in zip(LOW, SIZES)]
VOCAB = HIGH[-1]


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(a, b, n) for a, b in zip(LOW, HIGH)], 1).astype(np.int32)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A map_tpu run directory: config.json and {STEP}.model from a seeded
    init, packed tables."""
    cfg = base_model_config(input_size=VOCAB, embed_size=8, hidden_size=16,
                            num_hidden_layers=1, packed_tables=True,
                            compute_dtype="float32", idx_low=LOW, idx_high=HIGH)
    model = jax_models.from_config(cfg)
    variables = model.init(jax.random.PRNGKey(2), jnp.zeros((2, 8), jnp.int32))
    path = str(tmp_path_factory.mktemp("run"))
    jax_checkpoints.save_model(variables, path, STEP)
    cfg.save(path)
    return path


@pytest.mark.parametrize("compress", [True, False])
def test_logits_match_map_tpus_predictor(run_dir, compress):
    ids = _rows(70)
    ref = JaxPredictor(run_dir, STEP, batch_size=32).predict_logits(ids)
    port = Predictor(run_dir, STEP, batch_size=32, device="cpu", source="jax",
                     compress_transfer=compress)
    assert (port._groups is not None) == compress
    if compress:
        assert [len(g) for g in port._groups[2]] == [4, 3, 1]
    np.testing.assert_allclose(port.predict_logits(ids), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compress", [True, False])
def test_blocks_rebuild_the_ids_and_pad_inside_every_block(run_dir, compress):
    port = Predictor(run_dir, STEP, batch_size=32, device="cpu", source="jax",
                     compress_transfer=compress)
    chunk = _rows(20, seed=1)
    chunk[1] = LOW  # every field's first id: offset 0
    chunk[2] = np.asarray(HIGH) - 1  # every field's last id: the widest offsets
    padded = port._check_and_pad(chunk, 0)
    assert padded.shape == (32, 8)
    np.testing.assert_array_equal(padded[:20], chunk)
    np.testing.assert_array_equal(padded[20:], np.broadcast_to(
        np.asarray(LOW if compress else [0] * 8), (12, 8)))
    host = port._host_blocks(pinned=False)
    port._fill(chunk, 0, host)
    if compress:  # field-major blocks: a row of offsets a field
        assert [h.dtype for h in host] == [np.uint8, np.int16, np.int32]
        assert [h.shape for h in host] == [(4, 32), (3, 32), (1, 32)]
        assert all((h[:, 20:] == 0).all() for h in host)  # padding offsets are 0
    ids = port._ids([torch.from_numpy(h) for h in host])
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), padded)


def test_real_rows_do_not_depend_on_the_padding(run_dir):
    port = Predictor(run_dir, STEP, batch_size=32, device="cpu", source="jax")
    ids = _rows(40, seed=3)
    whole = port.predict_logits(ids)
    np.testing.assert_array_equal(port.predict_logits(ids[32:]), whole[32:])
    np.testing.assert_array_equal(port.predict_logits(ids[:5]), whole[:5])


def test_a_bad_id_raises(run_dir):
    packed = Predictor(run_dir, STEP, batch_size=32, device="cpu", source="jax")
    plain = Predictor(run_dir, STEP, batch_size=32, device="cpu", source="jax",
                      compress_transfer=False)
    ids = _rows(50, seed=4)
    other_block = ids.copy()
    other_block[40, 2] = LOW[3]  # a valid id, of field 3's block
    with pytest.raises(ValueError, match="field 2's block"):
        packed.predict_logits(other_block)
    plain.predict_logits(other_block)  # within [0, V): K4 reads it as the plain path does
    for bad in (-1, VOCAB):
        wrong = ids.copy()
        wrong[45, 6] = bad
        with pytest.raises(ValueError, match="leave"):
            packed.predict_logits(wrong)
        with pytest.raises(ValueError, match="leave"):
            plain.predict_logits(wrong)


def test_scores_with_the_supervised_head_of_a_pretraining_config(run_dir, tmp_path):
    cfg = Config.load(run_dir)
    sd = models.from_config(cfg, torch.Generator().manual_seed(1)).state_dict()
    checkpoints.save_model(sd, str(tmp_path), 2)
    dataclasses.replace(cfg, pretrain=True, pt_type="RFD").save(str(tmp_path))
    port = Predictor(str(tmp_path), 2, batch_size=16, device="cpu")
    assert port.config.pretrain is False
    assert np.isfinite(port.predict_logits(_rows(20))).all()


def test_weights_cast_once_give_the_uncached_bits(run_dir, tmp_path):
    cfg = dataclasses.replace(Config.load(run_dir), compute_dtype="bfloat16")
    cfg.save(str(tmp_path))
    sd = models.from_config(cfg, torch.Generator().manual_seed(4)).state_dict()
    checkpoints.save_model(sd, str(tmp_path), 1)
    port = Predictor(str(tmp_path), 1, batch_size=32, device="cpu")
    cached = [m for m in port.model.modules() if getattr(m, "_casts", None)]
    assert {type(m) for m in cached} == {TorchDense, CrossNetV2}
    ref_model = models.from_config(cfg)
    ref_model.load_state_dict(sd)
    ids = _rows(32, seed=5)
    with torch.no_grad():
        ref = ref_model.eval()(torch.from_numpy(ids)).reshape(-1).float().numpy()
    np.testing.assert_array_equal(port.predict_logits(ids), ref)


def test_cast_copies_serve_inference_mode_only():
    layer = TorchDense(4, 3, dtype=torch.bfloat16)
    cast_weights_once(layer)
    w, b = layer._casts[torch.bfloat16]
    x = torch.randn(2, 4)
    plain = layer(x)
    w.zero_()  # a stale copy shows where it is read
    b.zero_()
    assert torch.equal(layer(x), plain)  # grad mode: cast on the call
    with torch.inference_mode():
        assert torch.equal(layer(x), torch.zeros(2, 3, dtype=torch.bfloat16))
