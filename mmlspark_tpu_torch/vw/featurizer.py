"""VW-style feature hashing stages.

The PyTorch port of ``mmlspark_tpu.vw.featurizer`` (host numpy in both; the
rows are the JAX package's exactly). Rebuilds ``VowpalWabbitFeaturizer``
(vw/VowpalWabbitFeaturizer.scala, with the per-type featurizers of
vw/featurizer/*.scala) and ``VowpalWabbitInteractions``
(vw/VowpalWabbitInteractions.scala): columns are hashed into a 2^num_bits
index space with MurmurHash3 (the ``VowpalWabbitMurmurWithPrefix``
analogue lives in ``ops.hashing``), producing the sparse rows consumed by
the device SGD learner in ``vw.learner``.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import HasInputCols, HasOutputCol, HasSeed, Param
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.ops.hashing import hash_strings, murmur3_bytes
from mmlspark_tpu_torch.vw.sparse import (
    NUM_BITS_META,
    SPARSE_META,
    concat_sparse,
    make_sparse,
)

# FNV-style combine used for feature crossing (quadratic -q interactions).
_FNV_PRIME = np.int64(16777619)


class HasNumBits(HasSeed):
    num_bits = Param(
        "width of the hashed feature space in bits (vw/HasNumBits.scala)",
        default=18,
        type_=int,
        validator=lambda v: 1 <= v <= 30,
    )

    def _mask(self) -> np.int64:
        return np.int64((1 << self.get("num_bits")) - 1)


class VowpalWabbitFeaturizer(Transformer, HasInputCols, HasOutputCol, HasNumBits):
    """Hash heterogeneous columns into one sparse namespace.

    Per-type behavior (vw/featurizer/*.scala parity):
    - numeric / bool column -> one feature named after the column
    - string column         -> categorical feature ``col=value`` with value 1
    - list-of-strings cell  -> one feature per token
    - dict cell             -> one feature per ``col.key`` with numeric value
    - dense vector column   -> one feature per dimension (hashes precomputed
      once per column, so wide vectors cost one hash pass, not n*d)
    - columns in ``string_split_input_cols`` -> whitespace-split tokens
    """

    output_col = Param("output sparse-features column", default="features", type_=str)
    string_split_input_cols = Param(
        "string columns to whitespace-split into token features", default=[], type_=list
    )
    sum_collisions = Param(
        "sum values of colliding hashes (vs keep one)", default=True, type_=bool
    )

    def transform(self, df: DataFrame) -> DataFrame:
        cols = list(self.get_or_fail("input_cols"))
        split_cols = list(self.get("string_split_input_cols"))
        mask = self._mask()
        seed = self.get("seed")
        dedupe = self.get("sum_collisions")
        out_col = self.get("output_col")

        def fn(p: Partition) -> Partition:
            n = len(next(iter(p.values()))) if p else 0
            # per-row accumulators
            idx_acc: list = [[] for _ in range(n)]
            val_acc: list = [[] for _ in range(n)]
            for c in cols + split_cols:
                arr = p[c]
                if arr.dtype != object and np.issubdtype(arr.dtype, np.number) and arr.ndim == 2:
                    # dense vector column: hash the d names once
                    d = arr.shape[1]
                    h = (
                        hash_strings([f"{c}_{j}" for j in range(d)], seed).astype(np.int64)
                        & mask
                    )
                    for r in range(n):
                        idx_acc[r].append(h)
                        val_acc[r].append(np.asarray(arr[r], np.float32))
                    continue
                if arr.dtype != object and (
                    np.issubdtype(arr.dtype, np.number) or arr.dtype == bool
                ):
                    h = np.int64(murmur3_bytes(c.encode("utf-8"), seed)) & mask
                    one = np.array([h], np.int64)
                    for r in range(n):
                        v = float(arr[r])
                        if v != 0.0:
                            idx_acc[r].append(one)
                            val_acc[r].append(np.array([v], np.float32))
                    continue
                # object column: strings / token lists / dicts
                is_split = c in split_cols
                names: list = []
                row_of: list = []
                vals: list = []
                for r in range(n):
                    cell = arr[r]
                    if cell is None:
                        continue
                    if isinstance(cell, str):
                        toks = cell.split() if is_split else [f"{c}={cell}"]
                        for t in toks:
                            names.append(t)
                            row_of.append(r)
                            vals.append(1.0)
                    elif isinstance(cell, dict):
                        for k, v in cell.items():
                            names.append(f"{c}.{k}")
                            row_of.append(r)
                            vals.append(float(v))
                    elif isinstance(cell, (list, tuple, np.ndarray)):
                        for t in cell:
                            names.append(str(t))
                            row_of.append(r)
                            vals.append(1.0)
                    else:
                        names.append(f"{c}={cell}")
                        row_of.append(r)
                        vals.append(1.0)
                if names:
                    h = hash_strings(names, seed).astype(np.int64) & mask
                    for j, r in enumerate(row_of):
                        idx_acc[r].append(h[j : j + 1])
                        val_acc[r].append(np.array([vals[j]], np.float32))
            out = np.empty(n, dtype=object)
            for r in range(n):
                if idx_acc[r]:
                    out[r] = make_sparse(
                        np.concatenate(idx_acc[r]),
                        np.concatenate(val_acc[r]),
                        dedupe=dedupe,
                    )
                else:
                    out[r] = make_sparse(np.zeros(0, np.int64), np.zeros(0, np.float32))
            q = dict(p)
            q[out_col] = out
            return q

        out = df.map_partitions(fn)
        return out.with_column_metadata(
            out_col, {SPARSE_META: True, NUM_BITS_META: self.get("num_bits")}
        )


class VowpalWabbitInteractions(Transformer, HasInputCols, HasOutputCol, HasNumBits):
    """-q style feature crossing: the cartesian product of the input sparse
    namespaces, indices combined with an FNV-style hash, values multiplied
    (vw/VowpalWabbitInteractions.scala)."""

    output_col = Param("output crossed-features column", default="interactions", type_=str)

    def transform(self, df: DataFrame) -> DataFrame:
        cols = list(self.get_or_fail("input_cols"))
        if len(cols) < 2:
            raise ValueError("VowpalWabbitInteractions needs >= 2 input namespaces")
        mask = self._mask()
        out_col = self.get("output_col")

        def cross(a: dict, b: dict) -> dict:
            ia, va = a["i"], a["v"]
            ib, vb = b["i"], b["v"]
            if len(ia) == 0 or len(ib) == 0:
                return make_sparse(np.zeros(0, np.int64), np.zeros(0, np.float32))
            with np.errstate(over="ignore"):
                combined = ((ia[:, None] * _FNV_PRIME) ^ ib[None, :]) & mask
            return make_sparse(combined.ravel(), np.outer(va, vb).ravel(), dedupe=False)

        def fn(p: Partition) -> Partition:
            n = len(next(iter(p.values()))) if p else 0
            out = np.empty(n, dtype=object)
            for r in range(n):
                acc = p[cols[0]][r]
                for c in cols[1:]:
                    acc = cross(acc, p[c][r])
                out[r] = make_sparse(acc["i"], acc["v"])
            q = dict(p)
            q[out_col] = out
            return q

        out = df.map_partitions(fn)
        return out.with_column_metadata(
            out_col, {SPARSE_META: True, NUM_BITS_META: self.get("num_bits")}
        )


def combine_namespaces(columns: dict, cols: list) -> np.ndarray:
    """Row-wise concatenation of several sparse columns (the VW example =
    all namespaces of the row). ``columns`` maps column name -> object array
    of sparse rows; single-column requests pass through untouched."""
    if len(cols) == 1:
        return columns[cols[0]]
    n = len(columns[cols[0]])
    out = np.empty(n, dtype=object)
    for r in range(n):
        out[r] = concat_sparse([columns[c][r] for c in cols])
    return out
