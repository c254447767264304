"""RankingEvaluator: NDCG/MAP/precision/recall @ k over recommendation lists.

Reference: recommendation/RankingEvaluator.scala delegates to mllib
``RankingMetrics``; same metric definitions here, computed over a DataFrame
with one row per user holding the recommended item list and the
ground-truth item list.

The PyTorch port's copy of ``mmlspark_tpu.recommendation.evaluator``: host numpy,
unchanged, so that both packages give the same bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.params import Params


class RankingEvaluator(Params):
    k = Param("cutoff", default=10, type_=int)
    metric_name = Param(
        "ndcgAt | map | precisionAtk | recallAtK",
        default="ndcgAt",
        validator=lambda v: v in ("ndcgAt", "map", "precisionAtk", "recallAtK"),
    )
    prediction_col = Param("recommended item-list column", default="recommendations")
    label_col = Param("ground-truth item-list column", default="label")

    def _per_user(self, pred: Any, truth: Any) -> dict:
        k = self.get("k")
        pred = list(pred)[:k]
        truth_set = set(list(truth))
        if not truth_set:
            return {"ndcgAt": 0.0, "map": 0.0, "precisionAtk": 0.0, "recallAtK": 0.0}
        hits = np.array([1.0 if p in truth_set else 0.0 for p in pred])
        precision = hits.sum() / k
        recall = hits.sum() / len(truth_set)
        # NDCG@k with binary relevance
        dcg = (hits / np.log2(np.arange(2, len(hits) + 2))).sum()
        ideal_hits = min(len(truth_set), k)
        idcg = (1.0 / np.log2(np.arange(2, ideal_hits + 2))).sum()
        ndcg = dcg / idcg if idcg > 0 else 0.0
        # MAP (average precision at k, normalized by min(|truth|, k))
        cum = np.cumsum(hits)
        prec_at_i = cum / np.arange(1, len(hits) + 1)
        ap = (prec_at_i * hits).sum() / min(len(truth_set), k)
        return {"ndcgAt": ndcg, "map": ap, "precisionAtk": precision, "recallAtK": recall}

    def evaluate_all(self, df: DataFrame) -> dict:
        preds = df[self.get("prediction_col")]
        truths = df[self.get("label_col")]
        if len(preds) == 0:
            return {"ndcgAt": 0.0, "map": 0.0, "precisionAtk": 0.0, "recallAtK": 0.0}
        rows = [self._per_user(p, t) for p, t in zip(preds, truths)]
        return {m: float(np.mean([r[m] for r in rows])) for m in rows[0]}

    def evaluate(self, df: DataFrame) -> float:
        return self.evaluate_all(df)[self.get("metric_name")]

    @property
    def is_larger_better(self) -> bool:
        return True
