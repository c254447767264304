"""Partitioned columnar DataFrame — the dataflow substrate.

A copy of ``mmlspark_tpu.core.dataframe`` kept inside the PyTorch port so the
port never imports the JAX package. Columns are numpy arrays; stages move
them to the device themselves:

- A DataFrame is a list of *partitions*; a partition is a dict of
  column-name -> numpy array (all arrays share axis-0 length).
- Vector/tensor columns are dense ND arrays (not arrays-of-objects), so a
  partition can be handed to ``torch.from_numpy(...).to(device)`` with no
  host-side row marshalling — the analogue of the reference's per-partition native
  eval loops (cntk/CNTKModel.scala:515-520) without the row<->native copy.
- ``map_partitions`` is the SPMD primitive (Spark ``mapPartitions``
  analogue); partitions execute on a shared thread pool (numpy/torch release
  the GIL in the hot paths; HTTP stages overlap I/O).

This is deliberately eager: the device kernels are the optimizing layer
for compute.
"""

from __future__ import annotations

import concurrent.futures as _futures
import os
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from mmlspark_tpu_torch.core.schema import ColumnInfo, Schema, infer_schema

Partition = dict  # dict[str, np.ndarray]


class Row(dict):
    """A single row: dict with attribute access."""

    def __getattr__(self, item: str) -> Any:
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e


def _as_column(values: Any) -> np.ndarray:
    """Coerce python data to a column array (object fallback for ragged)."""
    if isinstance(values, np.ndarray):
        return values
    values = list(values)
    if values and isinstance(values[0], np.ndarray):
        shapes = {v.shape for v in values}
        if len(shapes) == 1:
            return np.stack(values)
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    if values and isinstance(values[0], (dict, bytes, list, tuple)):
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    arr = np.asarray(values)
    if arr.dtype.kind in ("U", "S"):
        arr = arr.astype(object)
    return arr


_pool: Optional[_futures.ThreadPoolExecutor] = None


def _get_pool() -> _futures.ThreadPoolExecutor:
    global _pool
    if _pool is None:
        n = int(os.environ.get("MMLSPARK_TPU_TASKS", str(min(16, (os.cpu_count() or 2) * 4))))
        _pool = _futures.ThreadPoolExecutor(max_workers=n, thread_name_prefix="mml-task")
    return _pool


class DataFrame:
    """Immutable partitioned columnar dataset."""

    def __init__(self, partitions: Sequence[Partition], metadata: Optional[dict] = None):
        parts = []
        names: Optional[list] = None
        for p in partitions:
            p = {k: _as_column(v) for k, v in p.items()}
            lens = {len(v) for v in p.values()}
            if len(lens) > 1:
                raise ValueError(f"ragged partition column lengths: { {k: len(v) for k, v in p.items()} }")
            if p:
                if names is None:
                    names = list(p.keys())
                elif set(p.keys()) != set(names):
                    raise ValueError(
                        f"partition columns {sorted(p.keys())} != {sorted(names)}"
                    )
                elif list(p.keys()) != names:
                    p = {k: p[k] for k in names}  # normalize order
            parts.append(p)
        if not parts:
            parts = [{}]
        # empty marker partitions adopt the shared column set (zero-length)
        if names is not None:
            proto = next(p for p in parts if p)
            empty = {k: proto[k][:0] for k in names}
            parts = [p if p else dict(empty) for p in parts]
        self._parts: list[Partition] = parts
        # per-column metadata (e.g. categorical levels), survives transforms
        self._metadata: dict = dict(metadata or {})

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_dict(data: dict, num_partitions: int = 1, metadata: Optional[dict] = None) -> "DataFrame":
        cols = {k: _as_column(v) for k, v in data.items()}
        lens = {k: len(v) for k, v in cols.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"ragged column lengths: {lens}")
        n = len(next(iter(cols.values()))) if cols else 0
        num_partitions = max(1, min(num_partitions, max(n, 1)))
        bounds = np.linspace(0, n, num_partitions + 1).astype(int)
        parts = [
            {k: v[bounds[i]: bounds[i + 1]] for k, v in cols.items()}
            for i in range(num_partitions)
        ]
        return DataFrame(parts, metadata=metadata)

    @staticmethod
    def from_rows(rows: Iterable[dict], num_partitions: int = 1) -> "DataFrame":
        rows = list(rows)
        if not rows:
            return DataFrame([{}])
        cols = {k: [r[k] for r in rows] for k in rows[0].keys()}
        return DataFrame.from_dict(cols, num_partitions)

    @staticmethod
    def from_pandas(pdf: Any, num_partitions: int = 1) -> "DataFrame":
        return DataFrame.from_dict({c: pdf[c].to_numpy() for c in pdf.columns}, num_partitions)

    # -- basic properties ----------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    @property
    def partitions(self) -> list:
        return self._parts

    @property
    def columns(self) -> list:
        for p in self._parts:
            if p:
                return list(p.keys())
        return []

    @property
    def schema(self) -> Schema:
        def merged(p: Partition) -> Schema:
            s = infer_schema(p)
            for name, info in s.items():
                md = self._metadata.get(name)
                if md:
                    s[name] = ColumnInfo(info.dtype, info.shape, dict(md))
            return s

        for p in self._parts:
            if p and len(next(iter(p.values()))):
                return merged(p)
        return merged(self._parts[0]) if self._parts[0] else Schema()

    def count(self) -> int:
        return sum(len(next(iter(p.values()))) if p else 0 for p in self._parts)

    def __len__(self) -> int:
        return self.count()

    def column_metadata(self, name: str) -> dict:
        return self._metadata.get(name, {})

    def with_column_metadata(self, name: str, md: dict) -> "DataFrame":
        new_md = dict(self._metadata)
        new_md[name] = dict(md)
        return DataFrame(self._parts, metadata=new_md)

    # -- column access -------------------------------------------------------

    def column(self, name: str) -> np.ndarray:
        """Materialize one column across all partitions."""
        arrs = [p[name] for p in self._parts if p]
        arrs = [a for a in arrs if len(a)]
        if not arrs:
            return np.array([])
        return np.concatenate(arrs, axis=0)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.column(name)

    def to_dict(self) -> dict:
        return {c: self.column(c) for c in self.columns}

    def collect(self) -> list:
        out = []
        for p in self._parts:
            if not p:
                continue
            n = len(next(iter(p.values())))
            for i in range(n):
                out.append(Row({k: v[i] for k, v in p.items()}))
        return out

    def head(self, n: int = 5) -> list:
        out = []
        for p in self._parts:
            if not p:
                continue
            m = len(next(iter(p.values())))
            for i in range(m):
                out.append(Row({k: v[i] for k, v in p.items()}))
                if len(out) >= n:
                    return out
        return out

    # -- transformations -----------------------------------------------------

    def map_partitions(
        self,
        fn: Callable[[Partition], Partition],
        parallel: bool = True,
    ) -> "DataFrame":
        parts = self._run(fn, parallel)
        return DataFrame(parts, metadata=self._metadata)

    def _run(self, fn: Callable[[Partition], Partition], parallel: bool = True) -> list:
        live = self._parts
        import threading

        # nested map_partitions (a partition fn using DataFrame ops) must not
        # re-enter the bounded pool: all workers could block waiting for
        # inner tasks that can never be scheduled -> deadlock. Pool workers
        # carry the "mml-task" thread-name prefix; inside one, run serially.
        in_worker = threading.current_thread().name.startswith("mml-task")
        if parallel and len(live) > 1 and not in_worker:
            return list(_get_pool().map(fn, live))
        return [fn(p) for p in live]

    def select(self, *names: str) -> "DataFrame":
        names = list(names)
        return DataFrame([{k: p[k] for k in names} for p in self._parts], metadata=self._metadata)

    def drop(self, *names: str) -> "DataFrame":
        drop = set(names)
        return DataFrame(
            [{k: v for k, v in p.items() if k not in drop} for p in self._parts],
            metadata=self._metadata,
        )

    def rename(self, mapping: dict) -> "DataFrame":
        return DataFrame(
            [{mapping.get(k, k): v for k, v in p.items()} for p in self._parts],
            metadata={mapping.get(k, k): v for k, v in self._metadata.items()},
        )

    def with_column(
        self, name: str, value: Union[np.ndarray, Callable[[Partition], Any]]
    ) -> "DataFrame":
        """Add/replace a column. ``value`` is a full-length array or a
        function partition -> column array."""
        if callable(value):
            def fn(p: Partition) -> Partition:
                q = dict(p)
                q[name] = _as_column(value(p))
                return q
            return self.map_partitions(fn)
        arr = _as_column(value)
        parts, off = [], 0
        for p in self._parts:
            n = len(next(iter(p.values()))) if p else 0
            q = dict(p)
            q[name] = arr[off: off + n]
            off += n
            parts.append(q)
        if off != len(arr):
            raise ValueError(f"column length {len(arr)} != dataframe length {off}")
        return DataFrame(parts, metadata=self._metadata)

    def with_row_column(self, name: str, fn: Callable[[Row], Any]) -> "DataFrame":
        """Per-row UDF column (convenience; prefer vectorized with_column)."""
        def part_fn(p: Partition) -> Partition:
            n = len(next(iter(p.values()))) if p else 0
            vals = [fn(Row({k: v[i] for k, v in p.items()})) for i in range(n)]
            q = dict(p)
            q[name] = _as_column(vals) if vals else np.array([])
            return q
        return self.map_partitions(part_fn)

    def filter(self, mask_fn: Callable[[Partition], np.ndarray]) -> "DataFrame":
        def fn(p: Partition) -> Partition:
            mask = np.asarray(mask_fn(p), dtype=bool)
            return {k: v[mask] for k, v in p.items()}
        return self.map_partitions(fn)

    def drop_na(self, cols: Optional[Sequence[str]] = None) -> "DataFrame":
        def fn(p: Partition) -> Partition:
            if not p:
                return p
            n = len(next(iter(p.values())))
            mask = np.ones(n, dtype=bool)
            for k in (cols or p.keys()):
                v = p[k]
                if v.dtype == object:
                    mask &= np.array([x is not None for x in v])
                elif v.dtype.kind == "f":
                    ax = tuple(range(1, v.ndim))
                    mask &= ~np.isnan(v).any(axis=ax) if v.ndim > 1 else ~np.isnan(v)
            return {k: v[mask] for k, v in p.items()}
        return self.map_partitions(fn)

    # -- partitioning --------------------------------------------------------

    def repartition(self, n: int) -> "DataFrame":
        """Round-robin-ish even split into n partitions (Repartition stage)."""
        cols = self.to_dict()
        return DataFrame.from_dict(cols, num_partitions=n, metadata=self._metadata)

    def coalesce(self, n: int) -> "DataFrame":
        if n < 1:
            raise ValueError(f"coalesce: n must be >= 1, got {n}")
        if n >= self.num_partitions:
            return self
        # contiguous runs preserve global row order
        bounds = np.linspace(0, len(self._parts), n + 1).astype(int)
        groups: list[list[Partition]] = [
            self._parts[bounds[i]: bounds[i + 1]] for i in range(n)
        ]
        parts = []
        for g in groups:
            g = [p for p in g if p]
            if not g:
                parts.append({})
                continue
            names = list(g[0].keys())
            parts.append({k: np.concatenate([p[k] for p in g], axis=0) for k in names})
        return DataFrame(parts, metadata=self._metadata)

    def union(self, other: "DataFrame") -> "DataFrame":
        my_cols = self.columns or other.columns
        if other.columns and set(other.columns) != set(my_cols):
            raise ValueError(
                f"union: column mismatch {sorted(my_cols)} vs {sorted(other.columns)}"
            )
        other_parts = [{k: p[k] for k in my_cols} for p in other._parts if p]
        md = {**other._metadata, **self._metadata}
        return DataFrame(self._parts + other_parts, metadata=md)

    def random_split(self, weights: Sequence[float], seed: int = 0) -> list:
        w = np.asarray(weights, dtype=float)
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        cols = self.to_dict()
        n = self.count()
        assign = rng.choice(len(w), size=n, p=w)
        out = []
        for i in range(len(w)):
            mask = assign == i
            out.append(
                DataFrame([{k: v[mask] for k, v in cols.items()}], metadata=self._metadata)
            )
        return out

    def sample(self, fraction: float, seed: int = 0) -> "DataFrame":
        rng = np.random.default_rng(seed)
        def fn(p: Partition) -> Partition:
            if not p:
                return p
            n = len(next(iter(p.values())))
            mask = rng.random(n) < fraction
            return {k: v[mask] for k, v in p.items()}
        return self.map_partitions(fn, parallel=False)

    def sort(self, by: str, ascending: bool = True) -> "DataFrame":
        cols = self.to_dict()
        order = np.argsort(cols[by], kind="stable")
        if not ascending:
            order = order[::-1]
        return DataFrame([{k: v[order] for k, v in cols.items()}], metadata=self._metadata)

    # -- aggregation ---------------------------------------------------------

    def group_apply(
        self, key: str, fn: Callable[[Any, Partition], dict]
    ) -> "DataFrame":
        """Group all rows by ``key`` column and apply fn(key_value, group) ->
        dict of scalar/array outputs (one row per group)."""
        cols = self.to_dict()
        keys = cols[key]
        uniq, inv = np.unique(keys.astype(str) if keys.dtype == object else keys, return_inverse=True)
        rows = []
        for gi, kv in enumerate(uniq):
            mask = inv == gi
            group = {c: v[mask] for c, v in cols.items()}
            rows.append(fn(kv, group))
        return DataFrame.from_rows(rows)

    # -- sugar (FluentAPI analogue: core/spark/FluentAPI.scala:25-30) --------

    def ml_transform(self, *stages: Any) -> "DataFrame":
        df = self
        for s in stages:
            df = s.transform(df)
        return df

    def ml_fit(self, estimator: Any) -> Any:
        return estimator.fit(self)

    def __repr__(self) -> str:
        return (
            f"DataFrame[{self.count()} rows x {len(self.columns)} cols, "
            f"{self.num_partitions} partitions]({', '.join(self.columns[:8])}"
            + ("..." if len(self.columns) > 8 else "") + ")"
        )
