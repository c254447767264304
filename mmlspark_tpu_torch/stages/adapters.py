"""Column-adapter stages.

Three utility stages from the reference that round out the generic stage
toolkit:
- :class:`VectorZipper` — row-wise zip of columns into one array column
  (vw/VectorZipper.scala:14-35).
- :class:`FastVectorAssembler` — concatenate numeric/vector columns into a
  single dense features vector (org/apache/spark/ml/feature/
  FastVectorAssembler.scala; "fast" there = no per-slot metadata pass,
  which this columnar substrate never needed).
- :class:`MultiColumnAdapter` — fit/apply a single-column base stage to
  each of ``input_cols`` producing ``output_cols``
  (stages/MultiColumnAdapter.scala:19-90).

The PyTorch port's copy of ``mmlspark_tpu.stages.adapters``: host numpy
code in both packages, with the same outputs.
"""

from __future__ import annotations

import copy
import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasInputCols,
    HasOutputCol,
    HasOutputCols,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer


class VectorZipper(Transformer, HasInputCols, HasOutputCol):
    """Combine one or more input columns into a sequence output column."""

    def transform(self, df: DataFrame) -> DataFrame:
        cols = self.get_or_fail("input_cols")
        mats = [np.asarray(df[c]) for c in cols]
        kinds = {m.dtype.kind for m in mats}
        if len(kinds) > 1 and not kinds <= {"i", "f", "u", "b"}:
            # np.stack would silently stringify numerics; the reference
            # asserts identical column types (VectorZipper.scala:26-27)
            raise ValueError(
                f"VectorZipper input columns must share a type family, got "
                f"{[m.dtype.name for m in mats]}"
            )
        return df.with_column(
            self.get_or_fail("output_col"), np.stack(mats, axis=1)
        )


class FastVectorAssembler(Transformer, HasInputCols, HasOutputCol):
    """Assemble numeric scalar/vector columns into one dense vector."""

    def transform(self, df: DataFrame) -> DataFrame:
        cols = self.get_or_fail("input_cols")
        parts = []
        for c in cols:
            a = np.asarray(df[c], np.float64)
            parts.append(a[:, None] if a.ndim == 1 else a.reshape(len(a), -1))
        return df.with_column(
            self.get_or_fail("output_col"), np.concatenate(parts, axis=1)
        )


class _AdapterBase(HasInputCols, HasOutputCols):
    def _pairs(self) -> list:
        ins = self.get_or_fail("input_cols")
        outs = self.get_or_fail("output_cols")
        if len(ins) != len(outs):
            raise ValueError("input_cols and output_cols must align")
        return list(zip(ins, outs))


class MultiColumnAdapter(Estimator, _AdapterBase):
    """Fit a copy of ``base_stage`` per column; transformers pass through
    unfitted. The base stage must expose input_col/output_col params."""

    base_stage = ComplexParam("single-column stage applied per column")

    def fit(self, df: DataFrame) -> "MultiColumnAdapterModel":
        base = self.get_or_fail("base_stage")
        if "input_col" not in base.params() or "output_col" not in base.params():
            raise ValueError(
                "base_stage needs input_col/output_col params "
                "(MultiColumnAdapter.scala:31-40 contract)"
            )
        fitted = []
        for in_c, out_c in self._pairs():
            stage = copy.deepcopy(base)
            stage.set(input_col=in_c, output_col=out_c)
            fitted.append(stage.fit(df) if isinstance(stage, Estimator) else stage)
        m = MultiColumnAdapterModel(
            input_cols=self.get("input_cols"), output_cols=self.get("output_cols")
        )
        m.set(stages=fitted)
        return m


class MultiColumnAdapterModel(Model, _AdapterBase):
    stages = ComplexParam("per-column fitted stages")

    def transform(self, df: DataFrame) -> DataFrame:
        out = df
        for stage in self.get_or_fail("stages"):
            out = stage.transform(out)
        return out
