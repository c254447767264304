"""RecommendationIndexer: string ids -> contiguous ints and back.

Reference: recommendation/RecommendationIndexer.scala — a pair of
StringIndexers for user and item columns whose maps are shared with the
evaluator/adapter so recommendations can be decoded back to raw ids.

The PyTorch port's copy of ``mmlspark_tpu.recommendation.indexer``: host numpy,
unchanged, so that both packages give the same bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import ComplexParam, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model


class _IndexerParams:
    user_input_col = Param("raw user id column", default="user")
    item_input_col = Param("raw item id column", default="item")
    user_output_col = Param("indexed user column", default="user_idx")
    item_output_col = Param("indexed item column", default="item_idx")
    rating_col = Param("rating column (passed through)", default="rating")


class RecommendationIndexer(Estimator, _IndexerParams):
    def fit(self, df: DataFrame) -> "RecommendationIndexerModel":
        users = sorted(set(np.asarray(df[self.get("user_input_col")]).tolist()))
        items = sorted(set(np.asarray(df[self.get("item_input_col")]).tolist()))
        m = RecommendationIndexerModel(**{k: v for k, v in self._paramMap.items()})
        m.set(user_labels=users, item_labels=items)
        return m


class RecommendationIndexerModel(Model, _IndexerParams):
    user_labels = ComplexParam("ordered raw user ids")
    item_labels = ComplexParam("ordered raw item ids")

    def transform(self, df: DataFrame) -> DataFrame:
        u_map = {v: i for i, v in enumerate(self.get_or_fail("user_labels"))}
        i_map = {v: i for i, v in enumerate(self.get_or_fail("item_labels"))}

        def fn(p: dict) -> dict:
            q = dict(p)
            q[self.get("user_output_col")] = np.array(
                [u_map[v] for v in p[self.get("user_input_col")]], np.int64
            )
            q[self.get("item_output_col")] = np.array(
                [i_map[v] for v in p[self.get("item_input_col")]], np.int64
            )
            return q

        return df.map_partitions(fn)

    def recover_user(self, idx: Any) -> Any:
        return np.asarray(self.get_or_fail("user_labels"))[np.asarray(idx)]

    def recover_item(self, idx: Any) -> Any:
        return np.asarray(self.get_or_fail("item_labels"))[np.asarray(idx)]
