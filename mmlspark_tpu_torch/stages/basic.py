"""Generic dataflow stages (reference ``stages/`` package, SURVEY.md §2.10).

The PyTorch port of ``mmlspark_tpu.stages.basic``. Column plumbing, UDF
stages, repartitioners, caching and timing — the thin host-side stages
that glue device compute stages into pipelines. ``UDFTransformer`` with
``jit_compatible=True`` takes a ``vector_udf`` of tensors and runs it on
the stage's device (the JAX package runs a ``jnp`` function under
``jax.jit``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasInputCol,
    HasOutputCol,
    Param,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Transformer

log = logging.getLogger("mmlspark_tpu_torch")


class DropColumns(Transformer):
    """stages/DropColumns.scala analogue."""

    cols = Param("columns to drop", default=[], type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        return df.drop(*self.get("cols"))


class SelectColumns(Transformer):
    cols = Param("columns to keep", default=[], type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        return df.select(*self.get("cols"))


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    # removes its input column — column-level deps can't express that, so
    # the pipeline compiler must plan it as a barrier
    pipeline_opaque = True

    def transform(self, df: DataFrame) -> DataFrame:
        return df.rename({self.get_or_fail("input_col"): self.get_or_fail("output_col")})


class Repartition(Transformer):
    """stages/Repartition.scala analogue."""

    n = Param("target partition count", default=1, type_=int)
    disable = Param("no-op switch", default=False, type_=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        if self.get("disable"):
            return df
        return df.repartition(self.get("n"))


class Lambda(Transformer):
    """Arbitrary DataFrame -> DataFrame function as a stage
    (stages/Lambda.scala:21-36). The callable persists via cloudpickle."""

    transform_fn = ComplexParam("DataFrame -> DataFrame function")
    transform_schema_fn = ComplexParam("optional Schema -> Schema function")

    @staticmethod
    def of(fn: Callable[[DataFrame], DataFrame]) -> "Lambda":
        t = Lambda()
        t.set(transform_fn=fn)
        return t

    def transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_fail("transform_fn")(df)

    def transform_schema(self, schema: Any) -> Any:
        fn = self.get("transform_schema_fn")
        return fn(schema) if fn else schema


class UDFTransformer(Transformer, HasInputCol, HasOutputCol):
    """Column UDF stage (stages/UDFTransformer.scala analogue).

    ``udf`` maps one row value -> value; ``vector_udf`` maps the whole
    column array -> array (preferred: it can be vectorized). With
    ``jit_compatible`` the ``vector_udf`` is a function of tensors, run on
    ``device``; a float64 column reaches it as float32, as the JAX
    package's x64-disabled ``jax.jit`` sees it."""

    udf = ComplexParam("per-row function")
    vector_udf = ComplexParam("whole-column function (array -> array)")
    input_cols = Param("multiple input columns (passed as dict to udf)", type_=list)
    jit_compatible = Param(
        "author-declared: vector_udf is a pure, row-wise function of "
        "tensors. The staged path then runs it on the stage's device and "
        "the pipeline compiler may fuse it into adjacent stages (both "
        "sides run the identical ops, so compiled output stays "
        "element-wise equal)", default=False, type_=bool,
    )
    device = Param(
        "torch device of a jit_compatible vector_udf: 'cuda' (default; "
        "raises without a card) or 'cpu'", type_=str,
    )

    def transform(self, df: DataFrame) -> DataFrame:
        oc = self.get_or_fail("output_col")
        vec = self.get("vector_udf")
        cols = self.get("input_cols")
        if vec is not None:
            ic = self.get_or_fail("input_col")
            if self.get("jit_compatible"):
                dev = resolve_device(self.get("device"))

                def run(p: Partition) -> np.ndarray:
                    x = np.asarray(p[ic])
                    if x.dtype == np.float64:
                        x = x.astype(np.float32)
                    with torch.inference_mode():
                        return vec(torch.from_numpy(np.ascontiguousarray(x)).to(dev)).cpu().numpy()

                return df.with_column(oc, run)
            return df.with_column(oc, lambda p: vec(p[ic]))
        fn = self.get_or_fail("udf")
        if cols:
            return df.with_row_column(oc, lambda r: fn(**{c: r[c] for c in cols}))
        ic = self.get_or_fail("input_col")
        return df.with_row_column(oc, lambda r: fn(r[ic]))

    def fusable_kernel(self) -> Any:
        """Fusable only when the author set ``jit_compatible`` on a
        ``vector_udf`` (the fusability contract: pure, capturable,
        row-independent along axis 0)."""
        if not self.get("jit_compatible"):
            return None
        vec = self.get("vector_udf")
        if vec is None:
            return None
        from mmlspark_tpu_torch.compiler.kernels import StageKernel, guard_f32_safe

        ic = self.get_or_fail("input_col")
        oc = self.get_or_fail("output_col")

        def fn(cols: dict) -> dict:
            return {oc: vec(cols[ic])}

        return StageKernel(reads=(ic,), writes=(oc,), fn=fn,
                           guard=guard_f32_safe, cost_hint=0.2,
                           device=self.get("device"))


class Explode(Transformer, HasInputCol, HasOutputCol):
    """Explode an array column into one row per element."""

    # rewrites every column's rows — a planner barrier, not a column dep
    pipeline_opaque = True

    def transform(self, df: DataFrame) -> DataFrame:
        ic = self.get_or_fail("input_col")
        oc = self.get("output_col") or ic

        def fn(p: Partition) -> Partition:
            col = p[ic]
            lens = np.array([len(v) for v in col])
            idx = np.repeat(np.arange(len(col)), lens)
            out = {k: v[idx] for k, v in p.items() if k != ic or oc != ic}
            flat = np.concatenate([np.asarray(v) for v in col]) if len(col) else np.array([])
            out[oc] = flat
            return out

        return df.map_partitions(fn)


class Cacher(Transformer):
    """stages/Cacher.scala analogue. The DataFrame substrate is eager, so
    caching == materializing once; this stage is a marker/no-op that also
    coalesces object columns for cheap re-iteration."""

    disable = Param("no-op switch", default=False, type_=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        return df


class Timer(Transformer):
    """Wraps a stage and logs wall time per fit/transform
    (stages/Timer.scala:57-92)."""

    stage = ComplexParam("wrapped stage")
    log_to_scala = Param("kept for API parity; logs via python logging", default=True, type_=bool)
    disable_timer = Param("bypass timing", default=False, type_=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        inner = self.get_or_fail("stage")
        if self.get("disable_timer"):
            return inner.transform(df)
        t0 = time.perf_counter()
        out = inner.transform(df)
        log.info("%s.transform took %.3fs", type(inner).__name__, time.perf_counter() - t0)
        return out

    def fit(self, df: DataFrame) -> Any:
        inner = self.get_or_fail("stage")
        if isinstance(inner, Estimator):
            t0 = time.perf_counter()
            model = inner.fit(df)
            log.info("%s.fit took %.3fs", type(inner).__name__, time.perf_counter() - t0)
            wrapped = Timer()
            wrapped.set(stage=model, disable_timer=self.get("disable_timer"))
            return wrapped
        return self


# -- udfs.scala analogues ---------------------------------------------------


def get_value_at(col: np.ndarray, i: int) -> np.ndarray:
    """Vector column -> scalar column of element i (udfs.scala get_value_at)."""
    return np.asarray(col)[:, i]


def to_vector(col: np.ndarray) -> np.ndarray:
    """Array-of-list column -> dense 2D vector column (udfs.scala to_vector)."""
    return np.stack([np.asarray(v, dtype=np.float32) for v in col])
