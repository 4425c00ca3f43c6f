"""Walker alias sampling of the MFP noise. Counterpart:
`map_tpu/objectives/alias.py` (`noise_distribution`, `build_alias_table`,
`load_or_build_alias`, `build_fused_alias`, `alias_draw`, `alias_draw_logq`).

The table is built on the host with map_tpu's Python loop (about 1.5 s at
V = 1,013,519; map_tpu's C++ builder is not ported) and cached in the data
directory as map_tpu caches it (`alias_prob.npy`, `alias_alias.npy`). The
draws run on the tables' device from an explicit `torch.Generator` on that
device: a uniform bucket, a keep test against the bucket's probability and,
failing it, the bucket's alias (the reference's `alias_multinomial.py:81-97`).
torch's random streams are not jax.random's, so the tests compare
distributions, and hand map_tpu's own draws to the port where they compare
values.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

BACKOFF_PROB = 1e-10  # the reference's nce_loss.py:10


def noise_distribution(feat_count: np.ndarray) -> np.ndarray:
    """Renormalized unigram with backoff (float64)."""
    noise = np.asarray(feat_count, dtype=np.float64)
    probs = noise / noise.sum()
    probs = np.clip(probs, BACKOFF_PROB, None)
    return (probs / probs.sum()).astype(np.float64)


def noise_log_prior(feat_count: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """(probs float64, log q float32, norm_term = log V) of the noise, as
    map_tpu's trainer sets them (`trainer.py:111-112`); the NCE decoder's
    bias starts at log q + norm_term."""
    probs = noise_distribution(feat_count)
    return probs, np.log(probs).astype(np.float32), float(np.log(len(probs)))


def build_alias_table(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """O(V) construction: (keep prob float32, alias int32), both (V,)."""
    k = len(probs)
    prob = (np.asarray(probs, dtype=np.float64) * k).copy()
    alias = np.zeros(k, dtype=np.int64)
    smaller = [i for i in range(k) if prob[i] < 1.0]
    larger = [i for i in range(k) if prob[i] >= 1.0]
    while smaller and larger:
        small = smaller.pop()
        large = larger.pop()
        alias[small] = large
        prob[large] = (prob[large] - 1.0) + prob[small]
        if prob[large] < 1.0:
            smaller.append(large)
        else:
            larger.append(large)
    for last in smaller + larger:
        prob[last] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32)


def load_or_build_alias(data_dir: str, probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The table cached in `data_dir` (read if there, written if built);
    no cache when `data_dir` is not a directory (an in-memory dataset)."""
    if not (data_dir and os.path.isdir(data_dir)):
        return build_alias_table(probs)
    prob_file = os.path.join(data_dir, "alias_prob.npy")
    alias_file = os.path.join(data_dir, "alias_alias.npy")
    if os.path.exists(prob_file) and os.path.exists(alias_file):
        return np.load(prob_file), np.load(alias_file)
    prob, alias = build_alias_table(probs)
    try:
        np.save(prob_file, prob)
        np.save(alias_file, alias)
    except OSError:
        pass
    return prob, alias


def build_fused_alias(prob: np.ndarray, alias: np.ndarray,
                      logq: np.ndarray) -> np.ndarray:
    """(V, 4) float32: [keep prob, alias id's bits, logq, logq[alias]], so
    one row gather gives a draw and its log-probability."""
    alias_i = np.ascontiguousarray(np.asarray(alias, np.int32))
    logq = np.asarray(logq, np.float32)
    return np.stack([np.asarray(prob, np.float32), alias_i.view(np.float32),
                     logq, logq[alias_i]], axis=1)


def alias_draw(generator: torch.Generator, prob: torch.Tensor,
               alias: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """int64 ids of `shape` drawn from the table on its device."""
    kk = torch.randint(0, prob.shape[0], shape, generator=generator,
                       device=prob.device)
    keep = torch.rand(shape, generator=generator, device=prob.device) < prob[kk]
    return torch.where(keep, kk, alias[kk].long())


def alias_draw_logq(generator: torch.Generator, fused: torch.Tensor,
                    shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-gather draw from the fused (V, 4) table: (int32 ids, float32
    logq of the ids), both `shape`."""
    kk = torch.randint(0, fused.shape[0], shape, generator=generator,
                       device=fused.device, dtype=torch.int32)
    rows = fused[kk]
    keep = torch.rand(shape, generator=generator, device=fused.device) < rows[..., 0]
    al = rows[..., 1].contiguous().view(torch.int32)
    return (torch.where(keep, kk, al),
            torch.where(keep, rows[..., 2], rows[..., 3]))
