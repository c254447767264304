"""SummarizeData — per-column statistics DataFrame (stages/SummarizeData.scala).

The PyTorch port's copy of ``mmlspark_tpu.stages.summarize``: host numpy
code in both packages, with the same outputs.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Transformer


class SummarizeData(Transformer):
    counts = Param("include count stats", default=True, type_=bool)
    basic = Param("include basic stats", default=True, type_=bool)
    sample = Param("include sample stats (quantiles)", default=True, type_=bool)
    percentiles = Param("include percentile stats", default=True, type_=bool)
    error_threshold = Param("API parity; exact quantiles are used", default=0.0, type_=float)

    def transform(self, df: DataFrame) -> DataFrame:
        rows = []
        data = df.to_dict()
        n = df.count()
        for name, col in data.items():
            row: dict = {"Feature": name}
            if self.get("counts"):
                row["Count"] = float(n)
                if col.dtype == object:
                    row["Unique Value Count"] = float(len(set(map(str, col))))
                    row["Missing Value Count"] = float(sum(v is None for v in col))
                else:
                    flat = col.reshape(n, -1) if col.ndim > 1 else col
                    row["Unique Value Count"] = (
                        float(len(np.unique(flat))) if col.ndim == 1 else float("nan")
                    )
                    row["Missing Value Count"] = (
                        float(np.isnan(flat).any(axis=-1).sum())
                        if np.issubdtype(col.dtype, np.floating)
                        else 0.0
                    )
            if col.dtype != object and np.issubdtype(col.dtype, np.number) and col.ndim == 1:
                c = col.astype(np.float64)
                c = c[~np.isnan(c)]
                if self.get("basic") and len(c):
                    row.update(
                        {
                            "Max": float(c.max()),
                            "Min": float(c.min()),
                            "Mean": float(c.mean()),
                            "Variance": float(c.var(ddof=1)) if len(c) > 1 else 0.0,
                        }
                    )
                if self.get("sample") and len(c):
                    row["Sample Variance"] = row.get("Variance", 0.0)
                    row["Sample Standard Deviation"] = float(np.sqrt(row.get("Variance", 0.0)))
                    row["Sample Skewness"] = _skew(c)
                    row["Sample Kurtosis"] = _kurt(c)
                if self.get("percentiles") and len(c):
                    for q in (0.5, 1, 5, 25, 50, 75, 95, 99, 99.5):
                        row[f"P{q}"] = float(np.percentile(c, q))
                    row["Median"] = float(np.median(c))
            rows.append(row)
        keys: list = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        filled = [{k: r.get(k, float("nan")) for k in keys} for r in rows]
        return DataFrame.from_rows(filled)


def _skew(c: np.ndarray) -> float:
    if len(c) < 2 or c.std() == 0:
        return 0.0
    z = (c - c.mean()) / c.std()
    return float((z ** 3).mean())


def _kurt(c: np.ndarray) -> float:
    if len(c) < 2 or c.std() == 0:
        return 0.0
    z = (c - c.mean()) / c.std()
    return float((z ** 4).mean() - 3.0)
