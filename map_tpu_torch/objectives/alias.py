"""Walker alias sampling of the MFP noise. Counterpart:
`map_tpu/objectives/alias.py` (`noise_distribution`, `build_alias_table`,
`load_or_build_alias`, `build_fused_alias`, `alias_draw`, `alias_draw_logq`,
and the per-field noise: `build_per_field_alias`, `per_field_alias_draw`,
`per_field_alias_draw_logq`).

The table is built on the host with map_tpu's Python loop (about 1.5 s at
V = 1,013,519; map_tpu's C++ builder is not ported) and cached in the data
directory as map_tpu caches it (`alias_prob.npy`, `alias_alias.npy`). The
draws run on the tables' device from an explicit `torch.Generator` on that
device: a uniform bucket, a keep test against the bucket's probability and,
failing it, the bucket's alias (the reference's `alias_multinomial.py:81-97`).
torch's random streams are not jax.random's, so the tests compare
distributions, and hand map_tpu's own draws to the port where they compare
values.

Per-field noise (`--pt_per_field_noise`) draws a masked position's noise
from the unigram of its own field's id block: one flat table over the whole
vocabulary in which each field's block [idx_low, idx_high) is an alias
table of its own, its redirects global ids. Ids outside every block (the
reserved ones) keep probability 1, themselves as alias and log q =
log(1e-10).

`chi_square` / `chi_square_p` hold a sample of draws to q (Pearson's
statistic over the buckets, those expected below 5 draws pooled).
"""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

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


def per_field_log_prior(feat_count: np.ndarray, idx_low: Sequence[int],
                        idx_high: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(logq (V,) float32, lnz (V,) float32): log q of each id within its
    field, and log of its field's size, the per-field norm_term; the
    per-field decoder bias starts at logq + lnz."""
    v = len(feat_count)
    logq = np.full(v, np.log(BACKOFF_PROB), np.float32)
    lnz = np.zeros(v, np.float32)
    for lo, hi in zip(idx_low, idx_high):
        lo, hi = int(lo), int(hi)
        logq[lo:hi] = np.log(noise_distribution(feat_count[lo:hi])).astype(np.float32)
        lnz[lo:hi] = np.log(hi - lo)
    return logq, lnz


def build_per_field_alias(feat_count: np.ndarray, idx_low: Sequence[int],
                          idx_high: Sequence[int]
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(prob (V,) float32, alias (V,) int32 global ids, logq, lnz) of the
    per-field noise, each field's block built by `build_alias_table`."""
    v = len(feat_count)
    prob_all = np.ones(v, np.float32)
    alias_all = np.arange(v, dtype=np.int32)
    for lo, hi in zip(idx_low, idx_high):
        lo, hi = int(lo), int(hi)
        p, a = build_alias_table(noise_distribution(feat_count[lo:hi]))
        prob_all[lo:hi] = p
        alias_all[lo:hi] = a + lo
    return (prob_all, alias_all, *per_field_log_prior(feat_count, idx_low, idx_high))


def _per_field_buckets(generator: torch.Generator, idx_low: torch.Tensor,
                       field_sizes: torch.Tensor, fields: torch.Tensor,
                       num_samples: int) -> torch.Tensor:
    """Uniform global bucket ids (..., num_samples) int32 in each position's
    field block: lo + floor(u * size) in float32, as map_tpu draws them."""
    lo = idx_low[fields.long()][..., None]
    size = field_sizes[fields.long()][..., None].float()
    u = torch.rand((*fields.shape, num_samples), generator=generator,
                   device=idx_low.device)
    return lo + torch.floor(u * size).int()


def per_field_alias_draw(generator: torch.Generator, prob: torch.Tensor,
                         alias: torch.Tensor, idx_low: torch.Tensor,
                         field_sizes: torch.Tensor, fields: torch.Tensor,
                         num_samples: int) -> torch.Tensor:
    """`num_samples` int32 ids per position from the field block of each
    position's field: fields (...) int -> (..., num_samples)."""
    kk = _per_field_buckets(generator, idx_low, field_sizes, fields, num_samples)
    keep = torch.rand(kk.shape, generator=generator, device=kk.device) < prob[kk]
    return torch.where(keep, kk, alias[kk])


def per_field_alias_draw_logq(generator: torch.Generator, fused: torch.Tensor,
                              idx_low: torch.Tensor, field_sizes: torch.Tensor,
                              fields: torch.Tensor, num_samples: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-field draw from the fused (V, 4) per-field table: (int32 ids,
    float32 logq of the ids), both (..., num_samples)."""
    kk = _per_field_buckets(generator, idx_low, field_sizes, fields, num_samples)
    rows = fused[kk]
    keep = torch.rand(kk.shape, generator=generator, device=kk.device) < rows[..., 0]
    al = rows[..., 1].contiguous().view(torch.int32)
    return (torch.where(keep, kk, al),
            torch.where(keep, rows[..., 2], rows[..., 3]))


def chi_square(counts: np.ndarray, q: np.ndarray) -> Tuple[float, int]:
    """Pearson's statistic of draw `counts` (V,) against the distribution
    `q` (V,), buckets of expected count below 5 pooled into one (joined to
    the smallest other bucket when the pool's own expectation is below 5)
    -> (statistic, degrees of freedom)."""
    counts = np.asarray(counts, np.float64)
    expected = counts.sum() * np.asarray(q, np.float64) / np.sum(q)
    big = expected >= 5.0
    obs, exp = list(counts[big]), list(expected[big])
    pool_obs, pool_exp = counts[~big].sum(), expected[~big].sum()
    if pool_exp >= 5.0:
        obs.append(pool_obs)
        exp.append(pool_exp)
    elif pool_exp > 0.0 and exp:
        j = int(np.argmin(exp))
        obs[j] += pool_obs
        exp[j] += pool_exp
    obs, exp = np.asarray(obs), np.asarray(exp)
    return float(((obs - exp) ** 2 / exp).sum()), len(obs) - 1


def chi_square_p(statistic: float, dof: int) -> float:
    """The upper tail of the chi-square distribution (Wilson-Hilferty's
    normal approximation of its cube root, close for dof in the tens and
    more)."""
    if dof <= 0:
        return 1.0
    h = 2.0 / (9.0 * dof)
    z = ((statistic / dof) ** (1.0 / 3.0) - (1.0 - h)) / math.sqrt(h)
    return 0.5 * math.erfc(z / math.sqrt(2.0))
