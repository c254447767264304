"""Featurize / AssembleFeatures — automatic featurization to one dense column.

Reference: featurize/Featurize.scala + AssembleFeatures.scala — numeric
passthrough (+missing imputation), low-cardinality strings one-hot,
high-cardinality strings hashed, vectors concatenated; output is a single
fixed-width features column (FeaturizeUtilities defaults:
numFeaturesDefault=262144, numFeaturesTreeOrNNBased=numFeaturesDefault/5 —
LightGBMUtils.scala:50-63).

The dense fixed-width output is the device-friendly layout: every
downstream trainer sees a static (batch, num_features) matrix.

The PyTorch port of ``mmlspark_tpu.featurize.featurize``: fit and
transform are the same host numpy; the pipeline compiler's kernel (f32
cast, NaN fill, concatenation) is tensor ops on the segment's device.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.ops.hashing import hash_strings

NUM_FEATURES_DEFAULT = 262144
NUM_FEATURES_TREE_OR_NN = NUM_FEATURES_DEFAULT // 5
# Dense assembly caps the per-column hash block: the reference's 262144-wide
# space assumes sparse vectors; a dense (n, 262144) float32 block would be
# ~1MB/row. The full 2^b sparse space lives in the JAX package's VW module
# (its segment-sum path); here high-cardinality strings get a capped
# one-hot-hash block.
MAX_DENSE_HASH = 4096


class Featurize(Estimator, HasOutputCol):
    input_cols = Param("columns to featurize (default: all but output)", type_=list)
    output_col = Param("assembled features column", default="features", type_=str)
    number_of_features = Param(
        "hash space size for high-cardinality/text columns",
        default=NUM_FEATURES_TREE_OR_NN,
        type_=int,
    )
    one_hot_encode_categoricals = Param("one-hot low-cardinality strings", default=True, type_=bool)
    max_one_hot = Param("cardinality threshold for one-hot", default=100, type_=int)
    allow_images = Param("API parity; images featurized elsewhere", default=False, type_=bool)

    def fit(self, df: DataFrame) -> "FeaturizeModel":
        if df.count() == 0:
            raise ValueError("Featurize: cannot fit on an empty dataframe")
        cols = self.get("input_cols") or [
            c for c in df.columns if c != self.get("output_col")
        ]
        plans: list = []
        schema = df.schema
        for c in cols:
            info = schema.get(c)
            col = df[c]
            if info is None:
                raise KeyError(f"column {c!r} not in dataframe")
            if info.kind in ("vector", "tensor"):
                dim = int(np.prod(info.shape))
                plans.append({"col": c, "kind": "vector", "dim": dim})
            elif info.dtype != "object":
                x = col.astype(np.float64)
                mean = float(np.nanmean(x)) if len(x) else 0.0
                plans.append({"col": c, "kind": "numeric", "fill": mean})
            else:
                uniq = sorted({str(v) for v in col})
                if self.get("one_hot_encode_categoricals") and len(uniq) <= self.get("max_one_hot"):
                    plans.append({"col": c, "kind": "onehot", "levels": uniq})
                else:
                    plans.append(
                        {
                            "col": c,
                            "kind": "hash",
                            "dim": min(self.get("number_of_features"), MAX_DENSE_HASH),
                        }
                    )
        return FeaturizeModel(output_col=self.get("output_col"), plans=plans)


class FeaturizeModel(Model, HasOutputCol):
    plans = Param("per-column featurization plans", default=[], type_=list)

    @classmethod
    def from_jax_params(cls, params: dict, **kw: Any) -> "FeaturizeModel":
        """The JAX package's fitted model in the port: its set params
        (``plans``, a list of plain dicts, and ``output_col``)."""
        return cls(**kw).set(**params)

    def pipeline_io(self) -> tuple:
        """Exact column deps for the pipeline compiler's planner."""
        return (
            tuple(p["col"] for p in self.get("plans")),
            (self.get("output_col"),),
        )

    def fusable_kernel(self) -> Any:
        """Fusable when every plan is numeric or vector: the staged path
        then computes f64-upcast -> NaN-fill -> f32-cast and dense
        reshapes, which the kernel computes as f32 cast -> NaN-fill on
        the device: the same single rounding per value (the guard pins
        input dtypes for which the two cast chains agree), elementwise,
        so equal at every batch size. One-hot/hash plans walk object
        columns on host — those configurations classify host-bound."""
        import torch

        from mmlspark_tpu_torch.compiler.kernels import StageKernel, guard_f32_safe

        plans = self.get("plans")
        if not plans or any(p["kind"] not in ("numeric", "vector") for p in plans):
            return None
        oc = self.get("output_col")
        reads = tuple(dict.fromkeys(p["col"] for p in plans))
        fills = [np.float32(p.get("fill", 0.0)) for p in plans]

        def fn(cols: dict) -> dict:
            n = None
            blocks = []
            for plan, fill in zip(plans, fills):
                x = cols[plan["col"]]
                n = x.shape[0] if n is None else n
                if plan["kind"] == "numeric":
                    x = x.to(torch.float32)
                    x = torch.where(torch.isnan(x), float(fill), x)
                    blocks.append(x[:, None])
                else:  # vector
                    blocks.append(x.to(torch.float32).reshape(n, -1))
            return {oc: torch.cat(blocks, dim=1)}

        return StageKernel(reads=reads, writes=(oc,), fn=fn,
                           guard=guard_f32_safe, cost_hint=0.5)

    @property
    def feature_dim(self) -> int:
        d = 0
        for plan in self.get("plans"):
            if plan["kind"] == "numeric":
                d += 1
            elif plan["kind"] == "onehot":
                d += len(plan["levels"])
            else:
                d += plan["dim"]
        return d

    def transform(self, df: DataFrame) -> DataFrame:
        plans = self.get("plans")
        oc = self.get("output_col")

        def fn(p: Partition) -> Partition:
            n = len(next(iter(p.values()))) if p else 0
            blocks = []
            for plan in plans:
                col = p[plan["col"]]
                kind = plan["kind"]
                if kind == "numeric":
                    x = np.asarray(col, dtype=np.float64)
                    x = np.where(np.isnan(x), plan["fill"], x)
                    blocks.append(x[:, None].astype(np.float32))
                elif kind == "vector":
                    x = np.asarray(col)
                    if x.dtype == object and n:
                        # rows arriving from JSON (from_rows/from_dict) carry
                        # per-row python lists in an object column
                        x = np.stack([
                            np.asarray(v, dtype=np.float32).ravel() for v in col
                        ])
                    x = np.asarray(x, dtype=np.float32)
                    # reshape(-1) cannot infer a width from 0 rows
                    shape = (n, -1) if n else (0, plan["dim"])
                    blocks.append(x.reshape(shape))
                elif kind == "onehot":
                    levels = {v: i for i, v in enumerate(plan["levels"])}
                    out = np.zeros((n, len(levels)), dtype=np.float32)
                    for i, v in enumerate(col):
                        j = levels.get(str(v))
                        if j is not None:
                            out[i, j] = 1.0
                    blocks.append(out)
                elif kind == "hash":
                    out = np.zeros((n, plan["dim"]), dtype=np.float32)
                    idx = hash_strings([str(v) for v in col]) % np.uint32(plan["dim"])
                    out[np.arange(n), idx.astype(np.int64)] = 1.0
                    blocks.append(out)
            q = dict(p)
            q[oc] = (
                np.concatenate(blocks, axis=1) if blocks else np.zeros((n, 0), np.float32)
            )
            return q

        return df.map_partitions(fn)
