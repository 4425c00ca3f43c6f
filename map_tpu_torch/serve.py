"""Inference: load a checkpoint and score id blocks on the card.

Counterpart: `map_tpu/serve.py:28-208`. `Predictor` reads the run's
config.json and either the port's `{step}.model` (`source="torch"`) or
map_tpu's (`source="jax"`, carried across by `interop/from_jax.py` with its
`batch_stats`), moves the weights to the device once, and scores
fixed-size chunks in eval mode (FGCNN's BatchNorm from the checkpoint's
running statistics): the last chunk is padded with id 0 and its padding
rows are dropped. Each chunk's ids are checked on the host against
[0, input_size) (the gather kernel does not check them), sent as int32,
and the logits come back as float32.

The loop is plain: one host-to-device copy per chunk. map_tpu's byte-packed
transfer and three-stage pipeline are later work (ROADMAP.md).

float32 products on the card run in full float32:
`torch.backends.cuda.matmul.allow_tf32` is set to False.

CLI: python -m map_tpu_torch.serve --model_dir outputs/... --step 42 \
        --data_dir data/avazu --dataset_name avazu --split test --out scores.npy \
        [--jax_checkpoint] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from map_tpu_torch import models, resolve_device
from map_tpu_torch.config import Config
from map_tpu_torch.interop.from_jax import state_dict_from_jax
from map_tpu_torch.train import checkpoints
from map_tpu_torch.utils.metrics import sigmoid


class Predictor:
    def __init__(self, model_dir: str, step: int, batch_size: int = 10000,
                 device=None, source: str = "torch",
                 config: Optional[Config] = None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config if config is not None else Config.load(model_dir)
        if source == "torch":
            state_dict = checkpoints.load_model(model_dir, step)
        elif source == "jax":
            state_dict = state_dict_from_jax(
                checkpoints.load_jax_model_file(
                    checkpoints.model_checkpoint_path(model_dir, step)),
                self.config)
        else:
            raise ValueError(f"source must be 'torch' or 'jax', got {source!r}")
        model = models.from_config(self.config)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)

    def predict_logits(self, feat_ids: np.ndarray) -> np.ndarray:
        """feat_ids (N, F) int -> logits (N,) float32, in padded chunks."""
        feat_ids = np.asarray(feat_ids)
        c = self.config
        if feat_ids.ndim != 2 or feat_ids.shape[1] != c.num_fields:
            raise ValueError(f"feat_ids must be (N, {c.num_fields}), "
                             f"got {feat_ids.shape}")
        n, bs = len(feat_ids), self.batch_size
        out = np.empty(n, np.float32)
        with torch.inference_mode():
            for lo in range(0, n, bs):
                chunk = feat_ids[lo:lo + bs]
                real = len(chunk)
                if chunk.min() < 0 or chunk.max() >= c.input_size:
                    raise ValueError(
                        f"ids of rows {lo}..{lo + real - 1} leave "
                        f"[0, {c.input_size})")
                if real < bs:
                    chunk = np.pad(chunk, ((0, bs - real), (0, 0)))
                ids = torch.from_numpy(
                    np.ascontiguousarray(chunk, dtype=np.int32)).to(self.device)
                logits = self.model(ids).reshape(-1).float()
                out[lo:lo + real] = logits[:real].cpu().numpy()
        return out

    def predict_proba(self, feat_ids: np.ndarray) -> np.ndarray:
        return sigmoid(self.predict_logits(feat_ids)).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="score a split with map_tpu_torch")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--step", type=int, required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--out", required=True)
    p.add_argument("--batch_size", type=int, default=10000)
    p.add_argument("--jax_checkpoint", action="store_true",
                   help="the {step}.model in model_dir is map_tpu's (flax msgpack)")
    p.add_argument("--device", default=None, help="default: cuda")
    a = p.parse_args(argv)

    from map_tpu_torch.data.dataset import CTRDataset

    ds = CTRDataset(a.data_dir, a.dataset_name)
    pred = Predictor(a.model_dir, a.step, batch_size=a.batch_size,
                     device=a.device, source="jax" if a.jax_checkpoint else "torch")
    probs = pred.predict_proba(ds.X[a.split])
    np.save(a.out, probs)
    y = ds.Y[a.split]
    if len(np.unique(y)) == 2:
        from map_tpu_torch.utils.metrics import binary_log_loss, roc_auc

        print(f"scored {len(probs)} rows: auc={roc_auc(y, probs):.6f} "
              f"logloss={binary_log_loss(y, probs):.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
