"""Exact evaluation metrics, computed on the host in float64.

The port's own copy of `map_tpu/utils/metrics.py:14-110` (`roc_auc`,
`binary_log_loss`, `sigmoid`); the reference computes both metrics with
sklearn on the full split (`code/trainer.py:193-195`).
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


def sigmoid(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out
