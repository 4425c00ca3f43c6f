"""Exact evaluation metrics, computed on the host in float64.

The port's own copy of `map_tpu/utils/metrics.py:14-110` (`roc_auc`,
`binary_log_loss`, `sigmoid`, and the streaming eval's
`auc_from_histograms` and `auc_histogram_error_bound`); the reference
computes both metrics with sklearn on the full split
(`code/trainer.py:193-195`).
"""

from __future__ import annotations

import numpy as np


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Exact ROC AUC via the Mann-Whitney U statistic with average ranks for
    ties; equal to sklearn.metrics.roc_auc_score for binary labels."""
    y_true = np.asarray(y_true).ravel().astype(np.int64)
    y_score = np.asarray(y_score).ravel().astype(np.float64)
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc requires both classes present")

    order = np.argsort(y_score, kind="mergesort")
    sorted_scores = y_score[order]
    ranks = np.empty(y_score.size, dtype=np.float64)
    boundary = np.empty(y_score.size + 1, dtype=bool)
    boundary[0] = True
    boundary[-1] = True
    boundary[1:-1] = sorted_scores[1:] != sorted_scores[:-1]
    idx = np.flatnonzero(boundary)
    starts, ends = idx[:-1], idx[1:]
    block_rank = (starts + ends + 1) / 2.0  # mean 1-based rank of a tie block
    ranks[order] = np.repeat(block_rank, ends - starts)

    u = ranks[y_true == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def binary_log_loss(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """Binary cross-entropy on probabilities, clipped to [eps, 1-eps] with
    eps = float64 machine epsilon, as sklearn.metrics.log_loss does."""
    y_true = np.asarray(y_true).ravel().astype(np.float64)
    y_prob = np.asarray(y_prob).ravel().astype(np.float64)
    eps = np.finfo(np.float64).eps
    p = np.clip(y_prob, eps, 1.0 - eps)
    return float(-np.mean(y_true * np.log(p) + (1.0 - y_true) * np.log(1.0 - p)))


def auc_from_histograms(hist_pos: np.ndarray, hist_neg: np.ndarray) -> float:
    """ROC AUC from per-bucket positive and negative counts, the buckets
    ascending by score; the scores of a bucket count as tied (half a pair
    each), so it is exact when a bucket holds one distinct score and an
    estimate within `auc_histogram_error_bound` otherwise. The reduction of
    the streaming eval (`--streaming_auc`), whose device pass builds the two
    histograms."""
    hist_pos = np.asarray(hist_pos, dtype=np.float64).ravel()
    hist_neg = np.asarray(hist_neg, dtype=np.float64).ravel()
    n_pos = hist_pos.sum()
    n_neg = hist_neg.sum()
    if n_pos == 0 or n_neg == 0:
        raise ValueError("auc_from_histograms requires both classes present")
    cum_neg_below = np.cumsum(hist_neg) - hist_neg
    u = np.sum(hist_pos * (cum_neg_below + 0.5 * hist_neg))
    return float(u / (n_pos * n_neg))


def auc_histogram_error_bound(hist_pos: np.ndarray, hist_neg: np.ndarray) -> float:
    """The worst |exact AUC - auc_from_histograms|: a positive-negative pair
    in one bucket counts 0.5 / (P N) where its true share is 0 or 1 / (P N),
    so the error is at most 0.5 * sum_b pos_b * neg_b / (P N)."""
    hist_pos = np.asarray(hist_pos, dtype=np.float64).ravel()
    hist_neg = np.asarray(hist_neg, dtype=np.float64).ravel()
    n_pos, n_neg = hist_pos.sum(), hist_neg.sum()
    if n_pos == 0 or n_neg == 0:
        return 0.0
    return float(0.5 * np.sum(hist_pos * hist_neg) / (n_pos * n_neg))


def sigmoid(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out
