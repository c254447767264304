"""Streaming quantile sketches for out-of-core bin-bound fitting.

The port's copy of ``mmlspark_tpu.models.gbdt.sketch`` (numpy on the host,
as there: counting is a host pass over each chunk as it streams in), whose
``to_binmapper`` gives the port's :class:`BinMapper`. The JAX package's
description follows.

The original :meth:`BinMapper.fit` needs the full feature matrix in one
place — in an elastic gang that meant gathering EVERY row to every host
(``GangContext.binning_rows``) before a single tree grew, which caps the
dataset at host memory and made "distributed" training need the whole
dataset resident anyway. This module replaces that gather with the
classic mergeable-sketch pattern:

- each host streams ITS OWN row slice once, counting values into a
  fixed-size per-feature histogram over the **monotone float32 key
  space** (sign-flipped IEEE bit patterns, the radix-sort trick: the
  uint32 key order equals the float order, so bucket = top ``bits`` of
  the key needs no data-dependent range pass);
- the per-host count tensors are **summed by the gang's reducer** (the
  only collective the sketch needs — counts are exact integers in f64
  far below 2^53);
- every member derives the identical bin upper bounds from the identical
  merged counts.

Determinism contract: the merged counts are a sum over rows, so they are
invariant to chunking AND to how rows are partitioned over hosts — the
fitted bins are a pure function of the global dataset, which is exactly
the world-size-invariance the elastic checkpoint contract needs (a
resumed shrunk-world run re-fits the same bins from its new slices).

Precision: with the default ``bits=16`` a bucket spans sign + exponent +
the top 7 mantissa bits, i.e. values inside one bucket agree to ~0.8%
relative — well inside the approximation LightGBM's own sampled
quantile binning already accepts (the bounds only decide histogram bin
edges, never split thresholds' correctness).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from mmlspark_tpu_torch.models.gbdt.binning import BinMapper


def _monotone_keys(col: np.ndarray) -> np.ndarray:
    """float32 -> uint32 keys whose unsigned order equals float order
    (NaNs must be masked out by the caller)."""
    u = col.astype(np.float32).view(np.uint32)
    neg = (u & np.uint32(0x80000000)) != 0
    return np.where(neg, ~u, u | np.uint32(0x80000000))


def _key_upper_value(bucket: np.ndarray, bits: int) -> np.ndarray:
    """Largest float32 whose key lands in ``bucket`` — the bucket's
    inclusive upper bound in value space (used as the bin threshold, so
    every value in the bucket satisfies ``x <= upper``)."""
    shift = 32 - bits
    key = ((bucket.astype(np.uint64) + 1) << shift) - 1
    key = key.astype(np.uint32)
    neg = (key & np.uint32(0x80000000)) == 0  # un-flipped sign bit
    u = np.where(neg, ~key, key & np.uint32(0x7FFFFFFF))
    vals = u.astype(np.uint32).view(np.float32).astype(np.float64)
    # keys at the very top of the space decode to inf/nan payloads —
    # clamp to +/- inf, which searchsorted handles as an open bound
    return np.where(np.isnan(vals), np.inf, vals)


class QuantileSketch:
    """Per-feature streaming value-distribution sketch.

    ``counts`` is a (d, 2**bits) f64 tensor of finite-value counts; NaNs
    are skipped (they ride the missing bin at transform time, exactly as
    in :meth:`BinMapper.fit`)."""

    def __init__(self, n_features: int, bits: int = 16):
        if not 8 <= int(bits) <= 20:
            raise ValueError(f"sketch bits must be in [8, 20], got {bits}")
        self.d = int(n_features)
        self.bits = int(bits)
        self.n_buckets = 1 << self.bits
        self.counts = np.zeros((self.d, self.n_buckets), np.float64)
        self.rows_seen = 0

    def update(self, chunk: np.ndarray) -> None:
        """Count one (n, d) float chunk (any float dtype; binning space
        is float32, matching BinMapper.transform)."""
        x = np.asarray(chunk, np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(
                f"chunk shape {x.shape} does not match d={self.d}"
            )
        self.rows_seen += x.shape[0]
        shift = 32 - self.bits
        for f in range(self.d):
            col = x[:, f]
            col = col[~np.isnan(col)]
            if not len(col):
                continue
            buckets = (_monotone_keys(col) >> np.uint32(shift)).astype(
                np.int64
            )
            self.counts[f] += np.bincount(
                buckets, minlength=self.n_buckets
            )

    def merge_counts(
        self, reduce: Optional[Callable[[np.ndarray], np.ndarray]] = None
    ) -> np.ndarray:
        """The gang-global counts: summed across hosts by ``reduce``
        (the elastic TcpReducer's allreduce — chunked through the ring)
        or returned as-is for world 1 / single-host fits."""
        if reduce is None:
            return self.counts
        return np.asarray(reduce(self.counts), np.float64)

    def to_binmapper(
        self,
        max_bin: int = 255,
        reduce: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ) -> BinMapper:
        """Quantile-cut bin uppers from the (merged) counts — the
        streaming analogue of :meth:`BinMapper.fit`'s percentile path.
        Deterministic: identical counts -> identical bounds on every
        member at every world size."""
        if not 2 <= max_bin <= 255:
            raise ValueError(f"max_bin must be in [2, 255], got {max_bin}")
        counts = self.merge_counts(reduce)
        uppers = []
        for f in range(self.d):
            c = counts[f]
            nz = np.flatnonzero(c)
            if len(nz) <= 1:
                # constant feature (one occupied bucket): a single bin
                uppers.append(np.array([], np.float64))
                continue
            if len(nz) <= max_bin - 1:
                # few distinct buckets: a bound after each occupied
                # bucket but the last (mirrors the unique-values path)
                bounds = _key_upper_value(nz[:-1], self.bits)
            else:
                # quantile cuts over the cumulative distribution: the
                # bucket where each target fraction is crossed supplies
                # its upper value as the bound
                cum = np.cumsum(c[nz])
                total = cum[-1]
                qs = np.linspace(0, 1, max_bin)[1:-1] * total
                idx = np.searchsorted(cum, qs, side="left")
                idx = np.minimum(idx, len(nz) - 1)
                bounds = np.unique(_key_upper_value(nz[idx], self.bits))
            uppers.append(np.asarray(bounds, np.float64))
        return BinMapper(uppers=uppers, max_bin=max_bin)


def sketch_chunks(
    chunks: Iterable[np.ndarray], n_features: int, bits: int = 16
) -> QuantileSketch:
    """One pass over an (n_i, d)-chunk stream -> a fitted sketch."""
    sk = QuantileSketch(n_features, bits=bits)
    for chunk in chunks:
        sk.update(chunk)
    return sk
