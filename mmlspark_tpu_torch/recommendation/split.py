"""RankingTrainValidationSplit: per-user stratified split + grid search.

Reference: recommendation/RankingTrainValidationSplit.scala — splits each
user's interactions (so every user appears in both sides), fits the
estimator per param-map, scores with RankingEvaluator on the held-out
side, keeps the best model.

The PyTorch port's copy of ``mmlspark_tpu.recommendation.split``: host numpy,
unchanged, so that both packages give the same bits.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import ComplexParam, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.recommendation.adapter import RankingAdapter
from mmlspark_tpu_torch.recommendation.evaluator import RankingEvaluator


def per_user_split(
    df: DataFrame, user_col: str, train_ratio: float = 0.75, min_ratings: int = 2, seed: int = 0
) -> tuple:
    """Stratified-by-user split: each qualifying user keeps ceil(ratio*n)
    rows in train and the rest in validation."""
    users = np.asarray(df[user_col], np.int64)
    rng = np.random.RandomState(seed)
    order: dict[int, list] = {}
    for pos, u in enumerate(users):
        order.setdefault(int(u), []).append(pos)
    in_train = np.ones(len(users), bool)
    for u, positions in order.items():
        if len(positions) < max(min_ratings, 2):
            continue  # too few interactions to split: keep all in train
        positions = np.array(positions)
        rng.shuffle(positions)
        # at least one row on each side so the user exists in both splits
        n_train = int(np.clip(np.ceil(len(positions) * train_ratio), 1, len(positions) - 1))
        in_train[positions[n_train:]] = False

    data = df.to_dict()
    train = {c: v[in_train] for c, v in data.items()}
    val = {c: v[~in_train] for c, v in data.items()}
    return DataFrame.from_dict(train), DataFrame.from_dict(val)


class RankingTrainValidationSplit(Estimator):
    estimator = ComplexParam("recommender estimator to tune")
    estimator_param_maps = ComplexParam("list of {param: value} dicts", default=None)
    evaluator = ComplexParam("RankingEvaluator", default=None)
    train_ratio = Param("per-user train fraction", default=0.75, type_=float)
    min_ratings_per_user = Param("users below this stay train-only", default=2, type_=int)
    k = Param("recommendations per user for evaluation", default=10, type_=int)
    seed = Param("split seed", default=0, type_=int)

    def fit(self, df: DataFrame) -> "RankingTrainValidationSplitModel":
        est = self.get_or_fail("estimator")
        grid: Sequence[dict] = self.get("estimator_param_maps") or [{}]
        evaluator: RankingEvaluator = self.get("evaluator") or RankingEvaluator(k=self.get("k"))
        user_col = est.get("user_col")
        train, val = per_user_split(
            df, user_col, self.get("train_ratio"), self.get("min_ratings_per_user"), self.get("seed")
        )

        best_metric, best_model, metrics = -np.inf, None, []
        for pm in grid:
            candidate = est.copy(extra=pm)
            adapter = RankingAdapter(
                recommender=candidate,
                k=self.get("k"),
                label_col=evaluator.get("label_col"),
                prediction_col=evaluator.get("prediction_col"),
            )
            fitted = adapter.fit(train)
            scored = fitted.transform(val)
            metric = evaluator.evaluate(scored)
            metrics.append(metric)
            if metric > best_metric:
                best_metric, best_model = metric, fitted
        m = RankingTrainValidationSplitModel()
        m.set(
            best_model=best_model,
            validation_metrics=[float(v) for v in metrics],
        )
        return m


class RankingTrainValidationSplitModel(Model):
    best_model = ComplexParam("best fitted RankingAdapterModel")
    validation_metrics = ComplexParam("metric per grid entry")

    def transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_fail("best_model").transform(df)

    def recommend_for_all_users(self, k: int) -> DataFrame:
        return self.get_or_fail("best_model").get_or_fail("recommender_model").recommend_for_all_users(k)
