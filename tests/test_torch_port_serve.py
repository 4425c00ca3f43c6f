"""map_tpu_torch serving against map_tpu's, and the port's isolation.

A map_tpu checkpoint (flax msgpack `{step}.model` + config.json) is written
on synthetic data; map_tpu's Predictor and the port's Predictor
(`source="jax"`, on the CPU) must score it alike, and both CLIs must print
the same AUC line.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from map_tpu import models as jax_models
from map_tpu.data.dataset import CTRDataset as JaxDataset
from map_tpu.serve import Predictor as JaxPredictor
from map_tpu.serve import main as jax_serve_main
from map_tpu.train import checkpoints as jax_checkpoints
from map_tpu_torch import models
from map_tpu_torch.config import Config
from map_tpu_torch.data.dataset import CTRDataset
from map_tpu_torch.serve import Predictor, main as serve_main
from map_tpu_torch.train import checkpoints

from conftest import base_model_config

REPO = Path(__file__).resolve().parent.parent
STEP = 7


class _Args:
    dataset_name = "synth"
    pretrain = False
    pt_type = "MFP"
    RFD_replace = "Unigram"
    pt_per_field_noise = False


@pytest.fixture(scope="module")
def jax_run(synth_dir, tmp_path_factory):
    """A map_tpu model dir: config.json + {STEP}.model from a seeded init."""
    args = _Args()
    args.data_dir = synth_dir
    ds = JaxDataset(args)
    cfg = base_model_config(
        input_size=ds.input_size, num_fields=ds.num_fields, embed_size=8,
        packed_tables=True, compute_dtype="float32",
        idx_low=[int(x) for x in ds.idx_low], idx_high=[int(x) for x in ds.idx_high])
    model = jax_models.from_config(cfg)
    variables = model.init(jax.random.PRNGKey(3),
                           jnp.zeros((2, cfg.num_fields), jnp.int32))
    model_dir = str(tmp_path_factory.mktemp("jax_run"))
    jax_checkpoints.save_model(variables, model_dir, STEP)
    cfg.save(model_dir)
    return model_dir, ds


def test_predictor_matches_map_tpu(jax_run):
    model_dir, ds = jax_run
    x = ds.X["test"]
    assert len(x) % 300 != 0  # the last chunk is padded
    ref = JaxPredictor(model_dir, STEP, batch_size=300).predict_logits(x)
    port = Predictor(model_dir, STEP, batch_size=300, device="cpu", source="jax")
    assert port.device == torch.device("cpu")
    out = port.predict_logits(x)
    assert out.dtype == np.float32 and out.shape == (len(x),)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    probs = port.predict_proba(x)
    assert ((probs > 0) & (probs < 1)).all()


def test_predictor_rejects_ids_out_of_range(jax_run):
    model_dir, ds = jax_run
    port = Predictor(model_dir, STEP, batch_size=64, device="cpu", source="jax")
    bad = ds.X["test"][:100].copy()
    bad[70, 3] = port.config.input_size
    with pytest.raises(ValueError, match="leave"):
        port.predict_logits(bad)


def test_port_checkpoint_round_trip(jax_run, tmp_path):
    model_dir, ds = jax_run
    cfg = Config.load(model_dir)
    sd = models.from_config(cfg, torch.Generator().manual_seed(9)).state_dict()
    path = checkpoints.save_model(sd, str(tmp_path), 3)
    assert path == os.path.join(str(tmp_path), "3.model")
    assert not os.path.exists(path + ".tmp")
    back = checkpoints.load_model(str(tmp_path), 3)
    assert list(back) == list(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    # a port checkpoint serves through the default source
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text((Path(model_dir) / "config.json").read_text())
    port = Predictor(str(tmp_path), 3, batch_size=50, device="cpu")
    model = models.from_config(cfg)
    model.load_state_dict(back)
    with torch.no_grad():
        ref = model(torch.from_numpy(ds.X["test"][:50])).reshape(-1).numpy()
    np.testing.assert_array_equal(port.predict_logits(ds.X["test"][:50]), ref)


def test_jax_msgpack_decoder_matches_flax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"params": {"a": rng.normal(size=(37, 5)).astype(np.float32),
                       "b": {"c": rng.integers(0, 9, size=(6,)).astype(np.int32)}},
            "step": np.float32(2.5)}
    # force flax's chunked-array encoding (used above 2**30 bytes) on small leaves
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    path = tmp_path / "1.model"
    jax_checkpoints.save_model_file(tree, str(path))
    assert b"__msgpack_chunked_array__" in path.read_bytes()
    ref = jax_checkpoints.load_model_file(str(path))
    got = checkpoints.load_jax_model_file(str(path))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (_, g), (_, r) in zip(flat_got, flat_ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        assert np.asarray(g).dtype == np.asarray(r).dtype


def test_cli_prints_map_tpu_auc(jax_run, synth_dir, tmp_path, capsys):
    model_dir, _ = jax_run
    common = ["--model_dir", model_dir, "--step", str(STEP), "--data_dir",
              synth_dir, "--dataset_name", "synth", "--split", "test",
              "--batch_size", "256"]
    assert jax_serve_main(common + ["--out", str(tmp_path / "jax.npy")]) == 0
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert serve_main(common + ["--out", str(tmp_path / "port.npy"),
                                "--jax_checkpoint", "--device", "cpu"]) == 0
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_line.startswith("scored ") and port_line == jax_line
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"),
                               np.load(tmp_path / "jax.npy"), atol=1e-6)


def test_dataset_matches_map_tpu(jax_run, synth_dir):
    _, ref = jax_run
    ds = CTRDataset(synth_dir, "synth")
    assert ds.num_fields == ref.num_fields and ds.input_size == ref.input_size
    for s in ds.split_names:
        np.testing.assert_array_equal(ds.X[s], ref.X[s])
        np.testing.assert_array_equal(ds.Y[s], ref.Y[s])
        assert ds.X[s].dtype == np.int32 and ds.Y[s].dtype == np.float32


def test_predictor_needs_a_card_unless_asked_for_the_cpu(jax_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model_dir, _ = jax_run
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model_dir, STEP, source="jax")


_FORBIDDEN = ("jax", "flax", "optax", "pandas")


def _is_forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in _FORBIDDEN or root == "map_tpu"


def test_port_imports_neither_jax_nor_map_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import map_tpu_torch\n"
        "for m in pkgutil.walk_packages(map_tpu_torch.__path__, 'map_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.split()
    assert "map_tpu_torch.serve" in loaded and "map_tpu_torch.ops.cross" in loaded
    assert [m for m in loaded if _is_forbidden(m)] == []


def test_port_sources_import_neither_jax_nor_map_tpu():
    """No source names jax, flax, optax or map_tpu in an import; pandas only
    in an indented one (the preprocessing CLIs, host jobs, import it when
    they run; the test above shows that no module loads it on import)."""
    pattern = re.compile(r"^(\s*)(?:import|from)\s+([A-Za-z_][\w.]*)", re.M)
    files = sorted((REPO / "map_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for indent, module in pattern.findall(path.read_text()):
            if indent and module.split(".")[0] == "pandas":
                continue
            assert not _is_forbidden(module), f"{path.name} imports {module}"
