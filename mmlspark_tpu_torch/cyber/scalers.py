"""Per-partition score scalers (reference: cyber/utils/scalers.py, 325 LoC).

``StandardScalarScaler``: per-tenant z-score of a value column (fit mean/std
per tenant). ``LinearScalarScaler``: per-tenant affine map of the observed
value range onto [min_required, max_required]. Both are Estimator->Model
pairs keyed by a partition (tenant) column, exactly like the reference.

The PyTorch port's copy of ``mmlspark_tpu.cyber.scalers``: host numpy,
unchanged, so that both packages give the same bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model

# dict key for the no-tenant (global) group; msgpack map keys cannot be None
_GLOBAL = "__global__"


class _ScalerParams(HasInputCol, HasOutputCol):
    partition_key = Param("tenant/partition column; None = global", default=None)

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "output_col" not in self._paramMap and "input_col" in self._paramMap:
            self.set(output_col=self._paramMap["input_col"] + "_scaled")

    def _groups(self, df: DataFrame) -> dict:
        vals = np.asarray(df[self.get_or_fail("input_col")], np.float64)
        pk = self.get("partition_key")
        if pk is None:
            return {_GLOBAL: vals}
        keys = df[pk]
        out: dict = {}
        for k in np.unique(keys):
            out[k] = vals[keys == k]
        return out


class StandardScalarScaler(Estimator, _ScalerParams):
    use_std = Param("divide by std (else just center)", default=True, type_=bool)

    def fit(self, df: DataFrame) -> "StandardScalarScalerModel":
        stats = {
            k: (float(v.mean()), float(v.std()) if len(v) > 1 else 1.0)
            for k, v in self._groups(df).items()
        }
        m = StandardScalarScalerModel(**{k: v for k, v in self._paramMap.items()})
        m.set(per_group_stats=stats)
        return m


class StandardScalarScalerModel(Model, _ScalerParams):
    use_std = Param("divide by std (else just center)", default=True, type_=bool)
    per_group_stats = ComplexParam("{tenant: (mean, std)}")

    def transform(self, df: DataFrame) -> DataFrame:
        stats = self.get_or_fail("per_group_stats")
        pk = self.get("partition_key")
        ic, oc = self.get_or_fail("input_col"), self.get("output_col")

        def fn(p: dict) -> dict:
            vals = np.asarray(p[ic], np.float64)
            out = np.zeros_like(vals)
            keys = p[pk] if pk is not None else np.array([_GLOBAL] * len(vals), dtype=object)
            for k in set(keys.tolist()) if len(vals) else set():
                mean, std = stats.get(k, (0.0, 1.0))
                sel = keys == k if pk is not None else slice(None)
                denom = std if (self.get("use_std") and std > 0) else 1.0
                out[sel] = (vals[sel] - mean) / denom
            q = dict(p)
            q[oc] = out
            return q

        return df.map_partitions(fn)


class LinearScalarScaler(Estimator, _ScalerParams):
    min_required_value = Param("target range min", default=0.0, type_=float)
    max_required_value = Param("target range max", default=1.0, type_=float)

    def fit(self, df: DataFrame) -> "LinearScalarScalerModel":
        stats = {
            k: (float(v.min()) if len(v) else 0.0, float(v.max()) if len(v) else 1.0)
            for k, v in self._groups(df).items()
        }
        m = LinearScalarScalerModel(**{k: v for k, v in self._paramMap.items()})
        m.set(per_group_range=stats)
        return m


class LinearScalarScalerModel(Model, _ScalerParams):
    min_required_value = Param("target range min", default=0.0, type_=float)
    max_required_value = Param("target range max", default=1.0, type_=float)
    per_group_range = ComplexParam("{tenant: (min, max)}")

    def transform(self, df: DataFrame) -> DataFrame:
        stats = self.get_or_fail("per_group_range")
        pk = self.get("partition_key")
        ic, oc = self.get_or_fail("input_col"), self.get("output_col")
        lo_t, hi_t = self.get("min_required_value"), self.get("max_required_value")

        def fn(p: dict) -> dict:
            vals = np.asarray(p[ic], np.float64)
            out = np.zeros_like(vals)
            keys = p[pk] if pk is not None else np.array([_GLOBAL] * len(vals), dtype=object)
            for k in set(keys.tolist()) if len(vals) else set():
                lo, hi = stats.get(k, (0.0, 1.0))
                sel = keys == k if pk is not None else slice(None)
                span = hi - lo
                if span <= 0:
                    out[sel] = (lo_t + hi_t) / 2.0
                else:
                    out[sel] = lo_t + (vals[sel] - lo) * (hi_t - lo_t) / span
            q = dict(p)
            q[oc] = out
            return q

        return df.map_partitions(fn)
