"""Categorical indexing with column-metadata levels.

ValueIndexer/IndexToValue (featurize/ValueIndexer.scala, IndexToValue.scala)
with the reference's CategoricalMap-in-metadata design
(core/schema/Categoricals.scala): fitted levels ride in the DataFrame's
column metadata so downstream stages (TrainClassifier label round-trip) can
recover original values.

The PyTorch port's copy of ``mmlspark_tpu.featurize.indexers``: host numpy
code in both packages, with the same outputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.schema import CATEGORICAL_KEY


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Fit: collect distinct values -> levels; transform: value -> index."""

    def fit(self, df: DataFrame) -> "ValueIndexerModel":
        col = df[self.get_or_fail("input_col")]
        key = col.astype(str) if col.dtype == object else col
        uniq = np.unique(key)
        levels = [v.item() if hasattr(v, "item") else v for v in uniq]
        return ValueIndexerModel(
            input_col=self.get("input_col"),
            output_col=self.get_or_fail("output_col"),
            levels=list(map(_plain, levels)),
        )


def _plain(v: Any) -> Any:
    return v.item() if hasattr(v, "item") else v


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = Param("ordered distinct values", default=[], type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        levels = self.get("levels")
        table = {str(v): i for i, v in enumerate(levels)}
        ic, oc = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def fn(p: Partition) -> np.ndarray:
            return np.array([table.get(str(v), -1) for v in p[ic]], dtype=np.int32)

        out = df.with_column(oc, fn)
        return out.with_column_metadata(oc, {CATEGORICAL_KEY: levels})


class IndexToValue(Transformer, HasInputCol, HasOutputCol):
    """Inverse mapping using metadata levels (featurize/IndexToValue.scala)."""

    def transform(self, df: DataFrame) -> DataFrame:
        ic, oc = self.get_or_fail("input_col"), self.get_or_fail("output_col")
        levels = df.column_metadata(ic).get(CATEGORICAL_KEY)
        if levels is None:
            raise ValueError(f"column {ic!r} carries no categorical levels metadata")
        lv = np.array(levels, dtype=object)

        def fn(p: Partition) -> np.ndarray:
            idx = np.asarray(p[ic], dtype=np.int64)
            out = np.empty(len(idx), dtype=object)
            valid = (idx >= 0) & (idx < len(lv))
            out[valid] = lv[idx[valid]]
            return out

        return df.with_column(oc, fn)
