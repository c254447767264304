"""Minibatching stages (stages/MiniBatchTransformer.scala:14-204).

Fixed-shape batching matters for compiled programs (the JAX package
compiles each distinct batch shape; the port's pipeline compiler captures a
CUDA graph per bucket). A "batched" DataFrame here is one where each
row holds an array of the original values (dense columns become one-higher-
rank tensors; object columns become object arrays of arrays). ``FlattenBatch``
is the inverse.

``DynamicBufferedBatcher``/``TimeIntervalBatcher`` (Batchers.scala) matter
for streaming/serving where arrival time dictates batch boundaries; the
serving layer reuses ``TimeIntervalMiniBatchTransformer`` semantics.

The PyTorch port's copy of ``mmlspark_tpu.stages.batching``: host numpy
code in both packages, with the same outputs.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import HasBatchSize, Param
from mmlspark_tpu_torch.core.pipeline import Transformer


def _batch_partition(p: Partition, sizes: Iterator[int]) -> Partition:
    n = len(next(iter(p.values()))) if p else 0
    bounds = [0]
    for s in sizes:
        if bounds[-1] >= n:
            break
        bounds.append(min(n, bounds[-1] + s))
    if bounds[-1] < n:
        bounds.append(n)
    out: Partition = {}
    for k, v in p.items():
        chunks = [v[bounds[i]: bounds[i + 1]] for i in range(len(bounds) - 1)]
        arr = np.empty(len(chunks), dtype=object)
        for i, c in enumerate(chunks):
            arr[i] = c
        out[k] = arr
    return out


class FixedMiniBatchTransformer(Transformer, HasBatchSize):
    """Group every ``batch_size`` rows into one batch row."""

    max_buffer_size = Param("API parity; unused (eager substrate)", default=2147483647, type_=int)
    buffered = Param("API parity; unused", default=False, type_=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        bs = self.get("batch_size")

        def sizes() -> Iterator[int]:
            while True:
                yield bs

        return df.map_partitions(lambda p: _batch_partition(p, sizes()))


class DynamicMiniBatchTransformer(Transformer):
    """One batch per partition (the dynamic batcher degenerates to
    'whatever is buffered now' — in the eager substrate that is the whole
    partition; max_batch_size caps it)."""

    max_batch_size = Param("maximum rows per batch", default=2147483647, type_=int)

    def transform(self, df: DataFrame) -> DataFrame:
        mx = self.get("max_batch_size")

        def sizes() -> Iterator[int]:
            while True:
                yield mx

        return df.map_partitions(lambda p: _batch_partition(p, sizes()))


class TimeIntervalMiniBatchTransformer(Transformer):
    """Batch by arrival-time windows (TimeIntervalBatcher analogue).

    Batch dataframes have no arrival times; rows carrying a ``millis_col``
    timestamp column are grouped into ``interval_ms`` windows. The serving
    layer uses the same windowing against wall-clock arrival."""

    interval_ms = Param("window length in ms", default=1000, type_=int)
    millis_col = Param("timestamp column (ms)", type_=str)
    max_batch_size = Param("cap rows per batch", default=2147483647, type_=int)

    def transform(self, df: DataFrame) -> DataFrame:
        tcol = self.get("millis_col")
        iv = self.get("interval_ms")
        mx = self.get("max_batch_size")

        def fn(p: Partition) -> Partition:
            if not p:
                return p
            n = len(next(iter(p.values())))
            if tcol and tcol in p:
                t = np.asarray(p[tcol], dtype=np.int64)
                window = (t - t.min()) // iv
            else:
                window = np.zeros(n, dtype=np.int64)
            sizes = []
            for w in np.unique(window):
                c = int((window == w).sum())
                while c > 0:
                    sizes.append(min(c, mx))
                    c -= mx
            order = np.argsort(window, kind="stable")
            q = {k: v[order] for k, v in p.items()}
            return _batch_partition(q, iter(sizes))

        return df.map_partitions(fn)


class FlattenBatch(Transformer):
    """Inverse of the minibatchers (MiniBatchTransformer.scala FlattenBatch)."""

    def transform(self, df: DataFrame) -> DataFrame:
        def fn(p: Partition) -> Partition:
            if not p:
                return p
            out: Partition = {}
            for k, v in p.items():
                if v.dtype == object:
                    parts = [np.asarray(x) for x in v]
                    out[k] = (
                        np.concatenate(parts, axis=0) if parts else np.array([])
                    )
                else:  # already-dense batched tensor: merge first two dims
                    out[k] = v.reshape(-1, *v.shape[2:])
            return out

        return df.map_partitions(fn)


class HasMiniBatcher(Transformer):
    """Mixin param carrying a batcher stage (HasMiniBatcher analogue)."""

    from mmlspark_tpu_torch.core.params import ComplexParam as _CP

    mini_batcher = _CP("batcher stage to apply before this stage")
