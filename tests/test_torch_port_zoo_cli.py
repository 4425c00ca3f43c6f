"""The port's CLI over its model zoo on the CPU (`python -m map_tpu_torch.run
--device cpu`), on the synthetic data of `tests/conftest.py:synth_dir`:
each of LR, FM, DNN, DeepFM, xDeepFM, AutoInt, Transformer, FiGNN and
FGCNN trains and tests; each pretrain-capable one pretrains with MFP and
with RFD and finetunes from that checkpoint, the backbone (FGCNN's
BatchNorm running statistics among it) loaded and the pretraining head's 4
tensors skipped. The numbers are held to map_tpu's by
`tests/test_torch_port_zoo.py`; here the whole path runs end to end.
"""

import glob
import os
import re

import pytest
import torch

from map_tpu_torch.run import main as port_main

_COMMON = ["--dataset_name=synth", "--embed_size=8", "--compute_dtype", "float32",
           "--logging_steps=5", "--device", "cpu", "--per_device_train_batch_size=256",
           "--per_device_eval_batch_size=200"]
# small widths: one MLP layer of 32, CIN 8,8, AutoInt 2 x 8, a Transformer
# layer of width 8 (= embed_size) with 2 heads and the attention pooling,
# FiGNN's 2 GNN rounds, FGCNN's two stages of 3 and 4 channels
MODEL_FLAGS = {
    "lr": [],
    "fm": [],
    "dnn": ["--hidden_size=32", "--num_hidden_layers=1"],
    "deepfm": ["--hidden_size=32", "--num_hidden_layers=1"],
    "xdeepfm": ["--hidden_size=32", "--num_hidden_layers=1", "--cin_layer_units=8,8"],
    "autoint": ["--attn_size=8", "--num_attn_layers=2"],
    "trans": ["--hidden_size=8", "--num_hidden_layers=1", "--num_attn_heads=2",
              "--intermediate_size=16", "--output_reduction=attn,fc"],
    "fignn": ["--num_hidden_layers=2"],
    "fgcnn": ["--hidden_size=32", "--num_hidden_layers=1", "--channels=3,4",
              "--kernel_heights=3,3", "--pooling_sizes=2,2", "--recombined_channels=2,2"],
}
_SUPERVISED = ["--learning_rate=1e-2", "--lr_sched=const", "--weight_decay=1e-1"]
# LR's table starts at N(0, 1), eight of its rows a logit: LR, and FM which
# carries that table, need the larger steps to unlearn that noise in two
# epochs (FM at 1e-2 clears 0.6 at some seeds and not at others)
_LR_RATE = {"lr": ["--learning_rate=1e-1"], "fm": ["--learning_rate=3e-2"]}
_PRETRAIN = {
    "MFP": ["--pretrain", "--pt_type=MFP", "--sampling_method=randint",
            "--mask_ratio=0.3", "--pt_neg_num=5", "--proj_size=8"],
    "RFD": ["--pretrain", "--pt_type=RFD", "--RFD_replace=Unigram",
            "--sampling_method=randint", "--mask_ratio=0.3", "--proj_size=8"],
}


def _flags(name, synth_dir, out_dir):
    return (_COMMON + MODEL_FLAGS[name]
            + [f"--model_name={name}", f"--data_dir={synth_dir}", f"--output_dir={out_dir}"])


@pytest.mark.parametrize("name", list(MODEL_FLAGS))
def test_cli_trains_each_model(name, synth_dir, tmp_path):
    out = tmp_path / name
    assert port_main(_flags(name, synth_dir, out) + _SUPERVISED + _LR_RATE.get(name, [])
                     + ["--num_train_epochs=2"]) == 0
    assert os.path.exists(out / "results.log")
    log = open(out / "train.log").read()
    aucs = [float(x) for x in re.findall(r"'eval_auc': ([\d.]+)", log)]
    assert len(aucs) == 3 and max(aucs[:2]) > 0.6, aucs  # 2 evals + TEST
    # the best step's checkpoint (each better eval saves one): every
    # parameter and buffer (FGCNN's running statistics)
    ckpt = max(glob.glob(str(out / "*.model")), key=os.path.getmtime)
    assert sorted(torch.load(ckpt, weights_only=True)) == sorted(
        _model_of(out).state_dict())


def _model_of(run_dir):
    from map_tpu_torch import models
    from map_tpu_torch.config import Config

    return models.from_config(Config.load(str(run_dir)))


@pytest.mark.parametrize("pt_type", ["MFP", "RFD"])
@pytest.mark.parametrize("name", ["dnn", "deepfm", "xdeepfm", "autoint", "trans",
                                  "fignn", "fgcnn"])
def test_cli_pretrains_and_finetunes_each_model(name, pt_type, synth_dir, tmp_path):
    pt_dir = tmp_path / "pt"
    assert port_main(_flags(name, synth_dir, pt_dir) + _PRETRAIN[pt_type] + [
        "--learning_rate=1e-3", "--lr_sched=cosine", "--weight_decay=5e-2",
        "--num_train_epochs=1"]) == 0
    assert os.path.exists(pt_dir / "results.log")
    log = open(pt_dir / "train.log").read()
    key = "eval_mfp_acc" if pt_type == "MFP" else "eval_rfd_acc"
    assert len(re.findall(rf"'{key}': [\d.]+", log)) == 1
    (ckpt,) = glob.glob(str(pt_dir / "*.model"))
    backbone = len(torch.load(ckpt, weights_only=True)) - 4
    ft_dir = tmp_path / "ft"
    assert port_main(_flags(name, synth_dir, ft_dir) + _SUPERVISED + [
        "--num_train_epochs=1", "--finetune", f"--pretrained_model_path={ckpt}"]) == 0
    log = open(ft_dir / "train.log").read()
    assert f"finetune restore: {backbone} tensors loaded, 4 skipped" in log
    aucs = [float(x) for x in re.findall(r"'eval_auc': ([\d.]+)", log)]
    assert len(aucs) == 2 and aucs[0] > 0.6, aucs  # one eval + TEST


@pytest.mark.parametrize("name", ["lr", "fm"])
def test_cli_refuses_to_pretrain_lr_and_fm(name, synth_dir, tmp_path):
    with pytest.raises(NotImplementedError, match="pretrain-capable"):
        port_main(_flags(name, synth_dir, tmp_path / "pt") + _PRETRAIN["MFP"])
