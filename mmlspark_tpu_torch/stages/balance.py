"""Label-aware partitioning and balancing stages.

- StratifiedRepartition (StratifiedRepartition.scala:44-73): spread every
  label evenly across partitions so gang-scheduled trainers see all classes.
- ClassBalancer: inverse-frequency instance weights.
- EnsembleByKey (EnsembleByKey.scala): aggregate vector/scalar columns by key.

The PyTorch port's copy of ``mmlspark_tpu.stages.balance``: host numpy
code in both packages, with the same outputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import HasInputCol, HasLabelCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer


class StratifiedRepartition(Transformer, HasLabelCol):
    n = Param("target partition count", default=2, type_=int)
    mode = Param("equal | original | mixed", default="equal", type_=str)
    seed = Param("shuffle seed", default=0, type_=int)

    def transform(self, df: DataFrame) -> DataFrame:
        cols = df.to_dict()
        y = cols[self.get("label_col")]
        n = self.get("n")
        rng = np.random.default_rng(self.get("seed"))
        # round-robin rows of each class over partitions => every partition
        # sees every class (the reference uses a range partitioner on
        # label-grouped keys to the same end)
        assign = np.zeros(len(y), dtype=np.int64)
        for label in np.unique(y.astype(str) if y.dtype == object else y):
            mask = (y.astype(str) if y.dtype == object else y) == label
            idx = np.flatnonzero(mask)
            rng.shuffle(idx)
            assign[idx] = np.arange(len(idx)) % n
        parts = []
        for i in range(n):
            m = assign == i
            parts.append({k: v[m] for k, v in cols.items()})
        return DataFrame(parts)


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Inverse-frequency weights (stages/ClassBalancer.scala)."""

    broadcast_join = Param("API parity; unused", default=True, type_=bool)
    output_col = Param("weight output column", default="weight", type_=str)

    def fit(self, df: DataFrame) -> "ClassBalancerModel":
        y = df[self.get_or_fail("input_col")]
        key = y.astype(str) if y.dtype == object else y
        uniq, counts = np.unique(key, return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        m = ClassBalancerModel(
            input_col=self.get("input_col"), output_col=self.get("output_col")
        )
        m.set(levels=[str(u) for u in uniq], weights=weights.tolist())
        return m


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    levels = Param("class levels", type_=list)
    weights = Param("weight per level", type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        table = dict(zip(self.get("levels"), self.get("weights")))

        def fn(p: Partition) -> Any:
            y = p[self.get_or_fail("input_col")]
            return np.array([table[str(v)] for v in y], dtype=np.float64)

        return df.with_column(self.get("output_col"), fn)


class EnsembleByKey(Transformer):
    """Aggregate columns by key (stages/EnsembleByKey.scala): strategy
    'mean' averages scalar/vector columns; collapse to one row per key."""

    keys = Param("key columns", default=[], type_=list)
    cols = Param("value columns to aggregate", default=[], type_=list)
    col_names = Param("output names (defaults to value names)", default=[], type_=list)
    strategy = Param("mean", default="mean", type_=str)
    collapse_group = Param("one row per key (else broadcast back)", default=True, type_=bool)
    vector_dims = Param("API parity; unused", default={}, type_=dict)

    def transform(self, df: DataFrame) -> DataFrame:
        keys = self.get("keys")
        cols = self.get("cols")
        names = self.get("col_names") or cols
        if self.get("strategy") != "mean":
            raise ValueError("only 'mean' strategy is supported (as in the reference)")
        if len(keys) != 1:
            # composite keys: synthesize a single key column
            data = df.to_dict()
            combo = np.array(
                ["".join(str(data[k][i]) for k in keys) for i in range(df.count())],
                dtype=object,
            )
            df = df.with_column("__key__", combo)
            key = "__key__"
        else:
            key = keys[0]

        def agg(kv: Any, grp: Partition) -> dict:
            row = {key: kv}
            for k in keys:
                row[k] = grp[k][0]
            for c, nm in zip(cols, names):
                row[nm] = np.asarray(grp[c], dtype=np.float64).mean(axis=0)
            return row

        out = df.group_apply(key, agg)
        if self.get("collapse_group"):
            return out.drop("__key__") if key == "__key__" else out
        # broadcast aggregated values back onto original rows (keyed on the
        # same — possibly synthesized — key column on both sides)
        ldata = out.to_dict()
        index = {str(v): i for i, v in enumerate(ldata[key])}
        kcol = df[key]
        for c, nm in zip(cols, names):
            vals = np.asarray(ldata[nm])
            picked = vals[[index[str(v)] for v in kcol]]
            df = df.with_column(nm, picked)
        return df.drop("__key__") if key == "__key__" else df
