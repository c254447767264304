"""Plotting helpers (reference: src/main/python/mmlspark/plot/plot.py —
confusion matrix + feature importance; ROC added since
ComputeModelStatistics emits the curve).

Matplotlib is imported lazily so headless/serving deployments never pay
for it; every function accepts an optional ``ax`` and returns it.

The PyTorch port's copy of ``mmlspark_tpu.plot``: host numpy, no device.
Nothing on the card path imports it (the card machine has no
matplotlib).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np


def _ax(ax: Any = None) -> Any:
    # never touch the global backend — the caller's session owns that choice
    import matplotlib.pyplot as plt

    return ax if ax is not None else plt.subplots()[1]


def confusion_matrix(
    y_true: Sequence,
    y_pred: Sequence,
    labels: Optional[Sequence] = None,
    normalize: bool = False,
    ax: Any = None,
) -> Any:
    """Heatmap of the confusion matrix with counts annotated."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = np.unique(np.concatenate([y_true, y_pred]))
    k = len(labels)
    label_arr = np.asarray(labels)
    # vectorized lookup that respects the caller's label ORDER: search the
    # sorted view, then map positions back through the sorter
    sorter = np.argsort(label_arr, kind="stable")
    sl = label_arr[sorter]
    tpos = np.clip(np.searchsorted(sl, y_true), 0, k - 1)
    ppos = np.clip(np.searchsorted(sl, y_pred), 0, k - 1)
    # pairs outside the explicit label list are skipped (sklearn behavior)
    ok = (sl[tpos] == y_true) & (sl[ppos] == y_pred)
    cm = np.zeros((k, k), np.float64)
    np.add.at(cm, (sorter[tpos][ok], sorter[ppos][ok]), 1.0)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)

    ax = _ax(ax)
    im = ax.imshow(cm, cmap="Blues")
    ax.figure.colorbar(im, ax=ax)
    ax.set_xticks(range(k), [str(v) for v in labels], rotation=45)
    ax.set_yticks(range(k), [str(v) for v in labels])
    ax.set_xlabel("predicted")
    ax.set_ylabel("actual")
    thresh = cm.max() / 2 if cm.size else 0
    for i in range(k):
        for j in range(k):
            val = f"{cm[i, j]:.2f}" if normalize else f"{int(cm[i, j])}"
            ax.text(j, i, val, ha="center",
                    color="white" if cm[i, j] > thresh else "black")
    ax.set_title("confusion matrix")
    return ax


def feature_importance(
    importances: Sequence[float],
    feature_names: Optional[Sequence[str]] = None,
    top_n: int = 20,
    ax: Any = None,
) -> Any:
    """Horizontal bar chart of the top-N most important features
    (pairs with ``LightGBM*Model.get_feature_importances``)."""
    imp = np.asarray(importances, np.float64)
    if feature_names is None:
        feature_names = [f"f{i}" for i in range(len(imp))]
    order = np.argsort(-imp)[:top_n][::-1]
    ax = _ax(ax)
    ax.barh(range(len(order)), imp[order])
    ax.set_yticks(range(len(order)), [str(feature_names[i]) for i in order])
    ax.set_xlabel("importance")
    ax.set_title("feature importance")
    return ax


def roc_curve(
    y_true: Sequence[int],
    scores: Sequence[float],
    ax: Any = None,
) -> Any:
    """ROC curve with AUC in the legend (binary labels, higher score =
    positive)."""
    y = np.asarray(y_true).astype(int)
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s)
    y, s = y[order], s[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1 - y)
    # collapse tied scores to one operating point (the curve is defined per
    # threshold, not per row — tie groups otherwise distort the AUC)
    last_of_group = np.concatenate([s[1:] != s[:-1], [True]])
    tps, fps = tps[last_of_group], fps[last_of_group]
    p, n = max(int(y.sum()), 1), max(int((1 - y).sum()), 1)
    tpr = np.concatenate([[0.0], tps / p])
    fpr = np.concatenate([[0.0], fps / n])
    auc = float(np.trapezoid(tpr, fpr))
    ax = _ax(ax)
    ax.plot(fpr, tpr, label=f"AUC = {auc:.3f}")
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=0.8)
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.legend()
    ax.set_title("ROC")
    return ax
