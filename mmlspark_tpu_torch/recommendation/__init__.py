"""Recommenders + ranking evaluation (reference: recommendation/, SURVEY.md
§2.14): the port of ``mmlspark_tpu.recommendation``.

SAR ("smart adaptive recommendations"): item-item co-occurrence similarity
with jaccard/lift variants + time-decayed user-item affinity
(SAR.scala:66-119). The co-occurrence count is one matmul ``A.T @ A`` on
the card, scoring is ``affinity @ similarity`` + a top-k with ties to the
lower item; the indexer, the evaluator, the adapter and the split are the
JAX package's host code.
"""

from mmlspark_tpu_torch.recommendation.indexer import (
    RecommendationIndexer,
    RecommendationIndexerModel,
)
from mmlspark_tpu_torch.recommendation.sar import SAR, SARModel
from mmlspark_tpu_torch.recommendation.evaluator import RankingEvaluator
from mmlspark_tpu_torch.recommendation.adapter import RankingAdapter, RankingAdapterModel
from mmlspark_tpu_torch.recommendation.split import RankingTrainValidationSplit

__all__ = [
    "RecommendationIndexer",
    "RecommendationIndexerModel",
    "SAR",
    "SARModel",
    "RankingEvaluator",
    "RankingAdapter",
    "RankingAdapterModel",
    "RankingTrainValidationSplit",
]
