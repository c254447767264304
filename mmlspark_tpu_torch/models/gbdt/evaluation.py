"""Validation metrics and early stopping of a GBDT fit.

The port of the JAX package's device eval (``train._device_metric``, the
metric choice and ``_HIGHER_METRICS``) and of its early-stopping replay:
the metric of every round is computed on the device into a list of 0-d
tensors, the host reads them once per chunk of rounds, and
:class:`EarlyStopping` replays the stopping decision round by round, so the
split loop never waits on the host and the result equals a round-by-round
decision.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from mmlspark_tpu_torch.models.gbdt import objectives

# all lower-is-better except these
HIGHER_METRICS = ("ndcg", "auc")


def eval_kind(objective: str, metric: str, eval_at: int) -> tuple:
    """(kind, k): which metric the fit reports on its validation rows, and
    NDCG's truncation."""
    if objective == "binary":
        if metric in ("", "binary_logloss"):
            return "binary_logloss", eval_at
        return ("auc" if metric == "auc" else "binary_error"), eval_at
    if objective == "multiclass":
        return "multi_logloss", eval_at
    if objective == "lambdarank":
        k = int(metric.split("@", 1)[1]) if metric.startswith("ndcg@") else eval_at
        return "ndcg", k
    return objective, eval_at


def device_metric(s: torch.Tensor, y: torch.Tensor, vw: torch.Tensor, kind: str,
                  p1: Any = 0.0) -> torch.Tensor:
    """Weighted mean of the pointwise loss over the rows with weight
    ``vw`` (0-d f32), with the reference's clips and logs; ``auc`` is the
    rank statistic. ``ndcg`` is :func:`objectives.grouped_ndcg_device`."""
    wsum = torch.clamp_min(vw.sum(), 1.0)
    if kind == "auc":
        return objectives.binary_auc_device(s, y, vw)
    if kind == "binary_logloss":
        p = torch.clamp(torch.sigmoid(s), 1e-15, 1 - 1e-15)
        loss = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    elif kind == "binary_error":
        loss = ((torch.sigmoid(s) > 0.5) != (y > 0.5)).float()
    elif kind == "multi_logloss":
        p = torch.softmax(s, dim=-1)
        loss = -torch.log(torch.clamp((p * y).sum(dim=-1), 1e-15, 1.0))
    else:  # the regression zoo's own pointwise loss
        loss = objectives.regression_loss(kind, s, y, p1)
    return (loss * vw).sum() / wsum


class EarlyStopping:
    """The reference's stopping rule, replayed from the metric values: a
    round improves on the best so far (strictly, in the metric's direction;
    the first round always does), and ``patience`` rounds in a row without
    improvement stop the fit (``patience`` 0: never)."""

    def __init__(self, kind: str, patience: int):
        self.higher = kind in HIGHER_METRICS
        self.patience = patience
        self.best: Optional[float] = None
        self.best_iter = -1          # 1-based round of the best value
        self.since = 0

    def replay(self, values: list, it0: int) -> Optional[int]:
        """Feed the values of rounds it0, it0+1, ...; returns how many of
        them to keep when the fit stops inside them, else None."""
        for i, val in enumerate(values):
            if self.best is None or (val > self.best if self.higher else val < self.best):
                self.best, self.best_iter, self.since = val, it0 + i + 1, 0
                continue
            self.since += 1
            if self.patience > 0 and self.since >= self.patience:
                return i + 1
        return None
