"""Metric names + computation (core/metrics/MetricConstants.scala:9-83 and
train/ComputeModelStatistics.scala metric math).

Metric math is vectorized numpy/JAX over full prediction columns.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class MetricConstants:
    # classification
    ACCURACY = "accuracy"
    PRECISION = "precision"
    RECALL = "recall"
    AUC = "AUC"
    F1 = "f1_score"
    # regression
    MSE = "mean_squared_error"
    RMSE = "root_mean_squared_error"
    R2 = "R^2"
    MAE = "mean_absolute_error"

    ALL_CLASSIFICATION = [ACCURACY, PRECISION, RECALL, AUC, F1]
    ALL_REGRESSION = [MSE, RMSE, R2, MAE]
    HIGHER_IS_BETTER = {ACCURACY, PRECISION, RECALL, AUC, F1, R2}


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, n_classes: Optional[int] = None) -> np.ndarray:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    # rows with unknown labels/predictions (encoded -1) are excluded, not
    # silently wrapped onto the last class
    valid = (y_true >= 0) & (y_pred >= 0)
    y_true, y_pred = y_true[valid], y_pred[valid]
    n = n_classes or int(max(y_true.max(initial=0), y_pred.max(initial=0)) + 1)
    cm = np.zeros((n, n), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def binary_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the rank statistic (ties averaged)."""
    y = np.asarray(y_true).astype(np.float64)
    s = np.asarray(scores).astype(np.float64)
    n_pos = y.sum()
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), dtype=np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # average ranks over ties
    sorted_s = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            avg = (i + j) / 2.0 + 1.0
            ranks[order[i: j + 1]] = avg
        i = j + 1
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def roc_curve(y_true: np.ndarray, scores: np.ndarray) -> dict:
    y = np.asarray(y_true).astype(np.int64)
    s = np.asarray(scores).astype(np.float64)
    order = np.argsort(-s, kind="mergesort")
    y = y[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1 - y)
    n_pos = max(int(tps[-1]) if len(tps) else 0, 1)
    n_neg = max(int(fps[-1]) if len(fps) else 0, 1)
    return {
        "false_positive_rate": np.concatenate([[0.0], fps / n_neg]),
        "true_positive_rate": np.concatenate([[0.0], tps / n_pos]),
        "thresholds": np.concatenate([[np.inf], s[order]]),
    }


def classification_metrics(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    scores: Optional[np.ndarray] = None,
) -> dict:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    cm = confusion_matrix(y_true, y_pred)
    n = cm.sum()
    acc = float(np.trace(cm) / n) if n else float("nan")
    # macro-averaged precision/recall (binary: positive-class values, as in
    # the reference's evaluator for binary)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec_k = np.diag(cm) / cm.sum(axis=0)
        rec_k = np.diag(cm) / cm.sum(axis=1)
    if cm.shape[0] == 2:
        precision = float(np.nan_to_num(prec_k[1]))
        recall = float(np.nan_to_num(rec_k[1]))
    else:
        precision = float(np.nanmean(np.nan_to_num(prec_k)))
        recall = float(np.nanmean(np.nan_to_num(rec_k)))
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    out = {
        MetricConstants.ACCURACY: acc,
        MetricConstants.PRECISION: precision,
        MetricConstants.RECALL: recall,
        MetricConstants.F1: f1,
    }
    if scores is not None and cm.shape[0] <= 2:
        out[MetricConstants.AUC] = binary_auc(y_true, scores)
    return out


def regression_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> dict:
    y = np.asarray(y_true, dtype=np.float64)
    p = np.asarray(y_pred, dtype=np.float64)
    err = y - p
    mse = float((err ** 2).mean()) if len(y) else float("nan")
    var = float(((y - y.mean()) ** 2).mean()) if len(y) else float("nan")
    return {
        MetricConstants.MSE: mse,
        MetricConstants.RMSE: float(np.sqrt(mse)),
        MetricConstants.R2: 1.0 - mse / var if var else float("nan"),
        MetricConstants.MAE: float(np.abs(err).mean()) if len(y) else float("nan"),
    }
