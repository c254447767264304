"""RankingAdapter: make a recommender evaluable by RankingEvaluator.

Reference: recommendation/RankingAdapter.scala — wraps a recommender
estimator; ``fit`` trains it, ``transform`` emits one row per user with the
top-k recommended items and the user's ground-truth items from the input
DataFrame, feeding RankingEvaluator.

The PyTorch port's copy of ``mmlspark_tpu.recommendation.adapter``: host numpy,
unchanged, so that both packages give the same bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import ComplexParam, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model


class _AdapterParams:
    recommender = ComplexParam("wrapped recommender estimator (e.g. SAR)")
    k = Param("recommendations per user", default=10, type_=int)
    min_rating_filter = Param("keep truth items with rating >= this", default=0.0, type_=float)
    label_col = Param("emitted ground-truth list column", default="label")
    prediction_col = Param("emitted recommendation list column", default="recommendations")


class RankingAdapter(Estimator, _AdapterParams):
    def fit(self, df: DataFrame) -> "RankingAdapterModel":
        rec = self.get_or_fail("recommender")
        model = rec.fit(df)
        m = RankingAdapterModel(**{k: v for k, v in self._paramMap.items()})
        m.set(recommender_model=model)
        return m


class RankingAdapterModel(Model, _AdapterParams):
    recommender_model = ComplexParam("fitted recommender model")

    def transform(self, df: DataFrame) -> DataFrame:
        model = self.get_or_fail("recommender_model")
        recs = model.recommend_for_all_users(self.get("k"))
        user_col = model.get("user_col")
        rating_col = model.get("rating_col")
        item_col = model.get("item_col")

        users = np.asarray(df[user_col], np.int64)
        items = np.asarray(df[item_col], np.int64)
        if rating_col and rating_col in df.columns:
            keep = np.asarray(df[rating_col], np.float64) >= self.get("min_rating_filter")
        else:
            keep = np.ones(len(users), bool)

        truth: dict[int, list] = {}
        for u, i, ok in zip(users, items, keep):
            if ok:
                truth.setdefault(int(u), []).append(int(i))

        # only evaluate users actually present in the evaluation DataFrame —
        # train-only users would otherwise contribute all-zero metrics
        eval_users = set(int(u) for u in users)
        rec_users_all = np.asarray(recs[user_col], np.int64)
        keep_rows = np.array([int(u) in eval_users for u in rec_users_all], bool)
        recs = DataFrame.from_dict({c: recs[c][keep_rows] for c in recs.columns})
        rec_users = np.asarray(recs[user_col], np.int64)
        labels = np.empty(len(rec_users), dtype=object)
        for j, u in enumerate(rec_users):
            labels[j] = truth.get(int(u), [])
        out = recs.with_column(self.get("label_col"), labels)
        if self.get("prediction_col") != "recommendations":
            out = out.rename({"recommendations": self.get("prediction_col")})
        return out
