"""ComputeModelStatistics / ComputePerInstanceStatistics
(train/ComputeModelStatistics.scala:153-229, ComputePerInstanceStatistics.scala).

Outputs a metrics DataFrame (confusion matrix included as a dense array
cell, like the reference's matrix-in-DataFrame) or per-row statistics.

The PyTorch port's copy of ``mmlspark_tpu.train.statistics``: host numpy
over the port's ``core.metrics`` (f64), no device.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.metrics import (
    MetricConstants,
    classification_metrics,
    confusion_matrix,
    regression_metrics,
)
from mmlspark_tpu_torch.core.params import HasLabelCol, Param
from mmlspark_tpu_torch.core.pipeline import Transformer


class ComputeModelStatistics(Transformer, HasLabelCol):
    evaluation_metric = Param(
        "classification|regression|all|<metric name>", default="all", type_=str
    )
    scores_col = Param("prediction column", default="prediction", type_=str)
    scored_probabilities_col = Param("probability column (binary AUC)", type_=str)

    def transform(self, df: DataFrame) -> DataFrame:
        y = df[self.get("label_col")]
        pred = df[self.get("scores_col")]
        want = self.get("evaluation_metric")
        is_classification = want in ("classification", "all") or want in MetricConstants.ALL_CLASSIFICATION
        if y.dtype == object or pred.dtype == object:
            # string labels: index jointly so labels and predictions share codes
            if want == "regression" or want in MetricConstants.ALL_REGRESSION:
                raise ValueError("regression metrics need numeric labels/predictions")
            levels = {v: i for i, v in enumerate(np.unique(
                np.concatenate([np.asarray(y, dtype=object), np.asarray(pred, dtype=object)]).astype(str)
            ))}
            y = np.array([levels[str(v)] for v in y], dtype=np.int64)
            pred = np.array([levels[str(v)] for v in pred], dtype=np.int64)
            looks_classy = True
        else:
            looks_classy = np.issubdtype(np.asarray(y).dtype, np.integer) or (
                np.asarray(y, dtype=np.float64) % 1 == 0
            ).all()
        row: dict = {}
        if is_classification and looks_classy and want != "regression":
            scores = None
            pc = self.get("scored_probabilities_col")
            if pc and pc in df.columns:
                probs = df[pc]
                scores = probs[:, 1] if probs.ndim == 2 and probs.shape[1] == 2 else probs
            row.update(classification_metrics(y, pred, scores))
            row["confusion_matrix"] = confusion_matrix(
                np.asarray(y, np.int64), np.asarray(pred, np.int64)
            ).astype(np.float64)
        if want in ("regression", "all") and not (want == "all" and looks_classy):
            row.update(regression_metrics(y, pred))
        if want not in ("classification", "regression", "all"):
            row = {want: row.get(want, float("nan"))} if want in row else _single(want, y, pred, df, self)
        return DataFrame.from_rows([row])


def _single(metric: str, y: Any, pred: Any, df: DataFrame, stage: ComputeModelStatistics) -> dict:
    if metric in MetricConstants.ALL_REGRESSION:
        return {metric: regression_metrics(y, pred)[metric]}
    scores = None
    pc = stage.get("scored_probabilities_col")
    if pc and pc in df.columns:
        probs = df[pc]
        scores = probs[:, 1] if probs.ndim == 2 and probs.shape[1] == 2 else probs
    m = classification_metrics(y, pred, scores)
    return {metric: m.get(metric, float("nan"))}


class ComputePerInstanceStatistics(Transformer, HasLabelCol):
    """Per-row L1/L2 (regression) or log-loss (classification with probs)."""

    scores_col = Param("prediction column", default="prediction", type_=str)
    scored_probabilities_col = Param("probability column", type_=str)

    def transform(self, df: DataFrame) -> DataFrame:
        label = self.get("label_col")
        pc = self.get("scored_probabilities_col")

        def fn(p: dict) -> dict:
            q = dict(p)
            y = np.asarray(p[label], np.float64)
            pred = np.asarray(p[self.get("scores_col")], np.float64)
            if pc and pc in p:
                probs = np.asarray(p[pc], np.float64)
                idx = np.clip(np.asarray(y, np.int64), 0, probs.shape[1] - 1)
                ll = -np.log(np.clip(probs[np.arange(len(y)), idx], 1e-15, 1.0))
                q["log_loss"] = ll
            q["L1_loss"] = np.abs(y - pred)
            q["L2_loss"] = (y - pred) ** 2
            return q

        return df.map_partitions(fn)
