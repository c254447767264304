"""CleanMissingData + DataConversion (featurize/CleanMissingData.scala,
featurize/DataConversion.scala).

The PyTorch port's copy of ``mmlspark_tpu.featurize.clean``: host numpy
code in both packages, with the same outputs.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import HasInputCols, HasOutputCols, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer


class CleanMissingData(Estimator, HasInputCols, HasOutputCols):
    """Impute NaNs: Mean | Median | Custom."""

    cleaning_mode = Param("Mean|Median|Custom", default="Mean", type_=str)
    custom_value = Param("fill value for Custom mode", type_=float)

    def fit(self, df: DataFrame) -> "CleanMissingDataModel":
        mode = self.get("cleaning_mode")
        in_cols = self.get_or_fail("input_cols")
        fills = []
        for c in in_cols:
            col = df[c].astype(np.float64)
            col = col[~np.isnan(col)]
            if mode == "Mean":
                fills.append(float(col.mean()) if len(col) else 0.0)
            elif mode == "Median":
                fills.append(float(np.median(col)) if len(col) else 0.0)
            elif mode == "Custom":
                fills.append(float(self.get_or_fail("custom_value")))
            else:
                raise ValueError(f"unknown cleaning_mode {mode!r}")
        return CleanMissingDataModel(
            input_cols=in_cols,
            output_cols=self.get("output_cols") or in_cols,
            fill_values=fills,
        )


class CleanMissingDataModel(Model, HasInputCols, HasOutputCols):
    fill_values = Param("per-column fill values", default=[], type_=list)

    def pipeline_io(self) -> tuple:
        """Declared I/O for the pipeline compiler. Host-bound by design (no
        ``fusable_kernel``): the staged transform fills in float64 (fitted
        means/medians are not float32-representable), which the compiler's
        f32 device segments could not bit-match."""
        ins = self.get_or_fail("input_cols")
        return tuple(ins), tuple(self.get("output_cols") or ins)

    def transform(self, df: DataFrame) -> DataFrame:
        ins = self.get_or_fail("input_cols")
        outs = self.get("output_cols") or ins
        fills = self.get("fill_values")

        def fn(p: Partition) -> Partition:
            q = dict(p)
            for c, o, f in zip(ins, outs, fills):
                col = np.asarray(p[c], dtype=np.float64)
                q[o] = np.where(np.isnan(col), f, col)
            return q

        return df.map_partitions(fn)


class DataConversion(Transformer):
    """Cast columns between types (featurize/DataConversion.scala)."""

    cols = Param("columns to convert", default=[], type_=list)
    convert_to = Param(
        "boolean|byte|short|integer|long|float|double|string|date", default="double", type_=str
    )
    date_time_format = Param("strftime format for date conversion", type_=str)

    _DTYPES = {
        "boolean": np.bool_,
        "byte": np.int8,
        "short": np.int16,
        "integer": np.int32,
        "long": np.int64,
        "float": np.float32,
        "double": np.float64,
    }

    def transform(self, df: DataFrame) -> DataFrame:
        target = self.get("convert_to")

        def fn(p: Partition) -> Partition:
            q = dict(p)
            for c in self.get("cols"):
                col = p[c]
                if target == "string":
                    q[c] = np.array([str(v) for v in col], dtype=object)
                elif target == "date":
                    import datetime as _dt

                    fmt = self.get("date_time_format") or "%Y-%m-%d %H:%M:%S"
                    q[c] = np.array(
                        [_dt.datetime.strptime(str(v), fmt) for v in col], dtype=object
                    )
                else:
                    q[c] = col.astype(self._DTYPES[target])
            return q

        return df.map_partitions(fn)
