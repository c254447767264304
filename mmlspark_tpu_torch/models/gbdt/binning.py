"""Feature quantization for histogram GBDT, on the fit's device.

The port of ``mmlspark_tpu.models.gbdt.binning``: each feature is quantized
to at most ``max_bin`` bins by quantiles; training then runs on the uint8
bin matrix, which stays uint8 on the device (one byte per cell is what the
histogram kernels read). Bin 0 is reserved for missing values (NaN),
LightGBM's missing-bin handling.

Both halves run in PyTorch on the device of the fit (the card for a fit
on the card, the CPU for a fit on the CPU: one implementation), and give
the JAX package's bounds and bins bit for bit, which its numpy and native
paths give too:

- ``fit`` draws the row sample with ``numpy.random.default_rng(seed)``
  on the host (the draw is part of the contract), then sorts every
  sampled column on the device. Few distinct values: the midpoints of
  neighbours, averaged in the input's dtype before widening to f64, as
  ``(uniq[:-1] + uniq[1:]) / 2.0`` does. Otherwise numpy's
  ``percentile(method="linear")`` step by step: the f64 virtual index
  ``(n - 1) * q``, its floor and gamma, ``_lerp``'s two formulas (the
  difference in the input's dtype, the rest in f64, ``b - diff * (1 - t)``
  from ``t >= 0.5``), then ``np.unique`` (a zero bound is written +0.0:
  which signed zero numpy keeps depends on its sort's order of equal
  values; both bin every value alike).
- ``transform`` widens the f32 values to f64 and runs one batched
  ``torch.searchsorted(side="left")`` against the per-column f64 uppers
  padded with ``+inf``, then adds 1 and sends NaN to bin 0: the native
  kernel ``mml_bin_features`` (``e[mid] < (double)v``) exactly.

Upper-bound thresholds stay in original feature space, so trained trees
carry real-valued thresholds and prediction never needs the mapper.

Categorical features are binned by identity (category value v -> bin
v+1). Sparse input: ``fit``/``transform`` accept a scipy-style CSR/CSC
matrix (anything with ``data``/``indices``/``indptr``/``shape``); stored
values are binned per column and absent entries map to the missing bin
(LightGBM's ``zero_as_missing=true``), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device

MISSING_BIN = 0

# column groups are sized so one group's sorted sample stays under this
# many elements (bounds the device memory of a fit)
_GROUP_ELEMS = 1 << 25


def is_sparse(x: object) -> bool:
    return hasattr(x, "indptr") and hasattr(x, "indices") and hasattr(x, "data")


def densify_missing(x: object) -> np.ndarray:
    """Sparse -> dense float32 with ABSENT entries as NaN.

    Prediction-time companion of the zero_as_missing binning: a tree
    trained on sparse data routes absent entries through the missing bin,
    so scoring must present them as NaN, not 0.0."""
    n, d = x.shape
    out = np.full((n, d), np.nan, np.float32)
    xc = x.tocsc() if hasattr(x, "tocsc") else x
    indptr = np.asarray(xc.indptr)
    rows = np.asarray(xc.indices)
    data = np.asarray(xc.data, np.float32)
    for f in range(d):
        lo, hi = indptr[f], indptr[f + 1]
        if hi > lo:
            out[rows[lo:hi], f] = data[lo:hi]
    return out


def _csc_columns(x: object):
    """Yield (f, stored_values) for every column with stored entries."""
    xc = x.tocsc() if hasattr(x, "tocsc") else x
    indptr = np.asarray(xc.indptr)
    for f in range(x.shape[1]):
        lo, hi = indptr[f], indptr[f + 1]
        if hi > lo:
            yield f, np.asarray(xc.data[lo:hi], np.float64)


def _fit_dtype(x: Any) -> torch.dtype:
    """The dtype ``fit`` computes in: numpy's for the input (f32 stays f32,
    f64 stays f64; integers are exact in f64)."""
    dt = x.dtype if isinstance(x, torch.Tensor) else np.asarray(x[:0]).dtype
    if dt in (torch.float32, np.float32):
        return torch.float32
    return torch.float64


def _as_tensor(x: Any, dev: torch.device, dtype: "torch.dtype | None" = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x.to(dev)
    else:
        a = np.asarray(x)
        if a.dtype not in (np.float32, np.float64):
            a = a.astype(np.float64)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def _pos_nan(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(t), float("nan"), t)


def _neg_nan(dev: torch.device) -> torch.Tensor:
    """The f64 NaN with its sign bit set (0xfff8000000000000)."""
    return torch.tensor(-(1 << 51), dtype=torch.int64, device=dev).view(torch.float64)


def _column_bounds(cols: torch.Tensor, max_bin: int) -> list:
    """Bin uppers of every column of an (m, g) sample (NaN = no value), as
    g numpy f64 arrays: the JAX package's ``BinMapper.fit`` column rule,
    computed for all g columns at once on ``cols``' device. The work runs
    on the (g, m) transpose: sorts and running sums along the last dim,
    which the card scans in parallel over all rows (along the first dim it
    parallelises over the g columns only)."""
    m, g = cols.shape
    dev, dt = cols.device, cols.dtype
    f64 = torch.float64
    W = max_bin - 1
    rows = torch.arange(g, device=dev)[:, None]
    # every NaN as the quiet +NaN first: the card's sort orders floats by
    # their bits, and a NaN with its sign bit set would sort first
    s = torch.sort(_pos_nan(cols.T), dim=1).values       # (g, m), NaN last
    valid = ~torch.isnan(s)
    cnt = valid.sum(1)                                   # non-NaN values
    new = valid.clone()
    new[:, 1:] &= s[:, 1:] != s[:, :-1]
    n_uniq = new.sum(1)

    # few distinct values: midpoints of neighbours, in the input's dtype
    rank = torch.cumsum(new, 1) - 1
    slot = torch.where(new & (rank < W), rank, W)
    uniq = torch.full((g, W + 1), torch.nan, dtype=dt, device=dev)
    uniq.index_put_((rows.expand(g, m), slot), s)
    mids = ((uniq[:, : W - 1] + uniq[:, 1:W]) / 2.0).to(f64)   # (g, W - 1)
    # NaN only from -inf + inf, which numpy's x86 add makes the negative
    # "indefinite" NaN (the card's add makes another)
    mids = torch.where(torch.isnan(mids), _neg_nan(dev), mids)

    # many: numpy's percentile(method="linear"), then np.unique
    q = torch.from_numpy(np.linspace(0, 100, max_bin)[1:-1] / 100.0).to(dev)
    last = (cnt - 1).clamp_min(0)[:, None]
    vi = (cnt - 1).to(f64)[:, None] * q[None, :]         # (g, Q) virtual index
    above = vi >= (cnt - 1).to(f64)[:, None]
    prev_f = torch.where(above, -1.0, torch.floor(vi))
    gamma = vi - prev_f
    prev = torch.where(above, last, prev_f.long()).clamp(0, m - 1)
    nxt = torch.where(above, last, prev + 1).clamp(0, m - 1)
    a, b = s.gather(1, prev), s.gather(1, nxt)
    diff = (b - a).to(f64)
    lerp = torch.where(gamma >= 0.5, b.to(f64) - diff * (1 - gamma), a.to(f64) + diff * gamma)
    # np.unique's sort writes a NaN back as the quiet +NaN (inf - inf
    # leaves -NaN), and keeps one, last
    qs = torch.sort(_pos_nan(lerp), dim=1).values
    Q = qs.shape[1]
    qnew = torch.ones_like(qs, dtype=torch.bool)
    qnew[:, 1:] = ~((qs[:, 1:] == qs[:, :-1]) | (torch.isnan(qs[:, 1:]) & torch.isnan(qs[:, :-1])))
    qslot = torch.where(qnew, torch.cumsum(qnew, 1) - 1, Q)
    quant = torch.full((g, Q + 1), torch.nan, dtype=f64, device=dev)
    quant.index_put_((rows.expand(g, Q), qslot), qs)
    n_quant = qnew.sum(1)

    few = n_uniq <= W
    # a zero bound is +0.0 (on every device): which signed zero np.unique
    # keeps depends on the order its SIMD sort leaves equal values in
    table = torch.where(few[:, None], mids, quant[:, : W - 1]) + 0.0
    length = torch.where(n_uniq <= 1, 0, torch.where(few, n_uniq - 1, n_quant))
    table_h, length_h = table.cpu().numpy(), length.cpu().numpy()
    return [np.ascontiguousarray(table_h[j, : length_h[j]]) for j in range(g)]


def _groups(lengths: list) -> list:
    """Consecutive index groups whose (longest x count) stays under the
    element budget."""
    out, cur, longest = [], [], 1
    for j, ln in enumerate(lengths):
        ln = max(int(ln), 1)
        if cur and max(longest, ln) * (len(cur) + 1) > _GROUP_ELEMS:
            out.append(cur)
            cur, longest = [], 1
        cur.append(j)
        longest = max(longest, ln)
    return out + [cur] if cur else out


def _search_rows(table: torch.Tensor, col: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """For each value, how many entries of its column's sorted row of
    ``table`` are below it (``searchsorted(side="left")`` per value, with
    rows of different columns): a binary search in lockstep."""
    W = table.shape[1]
    lo = torch.zeros_like(col)
    hi = torch.full_like(col, W)
    for _ in range(max(W, 1).bit_length()):
        mid = (lo + hi) // 2
        active = lo < hi
        less = table[col, mid.clamp(max=max(W - 1, 0))] < vals
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


@dataclass
class BinMapper:
    # uppers[f] has length n_bins[f]-1: upper bound (inclusive) of each
    # non-missing bin except the last (which is +inf)
    uppers: list
    max_bin: int

    @property
    def num_features(self) -> int:
        return len(self.uppers)

    @staticmethod
    def fit(
        x: Any,
        max_bin: int = 255,
        sample: int = 200_000,
        seed: int = 0,
        categorical_features: tuple = (),
        device: "str | torch.device | None" = None,
    ) -> "BinMapper":
        """Quantile bin bounds per feature, from at most ``sample`` rows
        drawn with ``numpy.random.default_rng(seed)`` (the JAX package's
        draw, so both packages bin identically), computed on ``device``
        (``None``: the input's own, the CPU for a numpy array).

        ``categorical_features``: feature indices binned by identity
        (category value v -> bin v+1, through half-integer bounds), so a
        categorical split's bin set is a set of category values at
        prediction time. Values must be integers in [0, max_bin-2]; values
        outside raise, scanned over the full column (not the sample), so
        training and prediction never route a row differently. Categories
        unseen at fit time go right at prediction."""
        if not 2 <= max_bin <= 255:
            # bins live in a uint8 matrix (bin 0 = missing); larger values
            # would silently wrap mod 256
            raise ValueError(f"max_bin must be in [2, 255], got {max_bin}")
        dev = _fit_device(x, device)
        if is_sparse(x):
            if categorical_features:
                raise ValueError(
                    "categorical features require dense input (sparse "
                    "columns have no stable category<->bin identity for "
                    "absent entries)"
                )
            return BinMapper._fit_sparse(x, max_bin, sample=sample, seed=seed, device=dev)
        xt = _as_tensor(x, dev, _fit_dtype(x))
        n, d = xt.shape
        xs = xt
        if n > sample:
            idx = np.random.default_rng(seed).choice(n, sample, replace=False)
            xs = xt[torch.from_numpy(idx).to(dev)]
        cat = sorted(set(int(f) for f in categorical_features))
        uppers: list = [None] * d
        if cat:
            # full column, not the sample: hi must cover every category
            cols = xt[:, cat]
            nan = torch.isnan(cols)
            lo = torch.where(nan, torch.inf, cols).amin(0).cpu().numpy()
            hi = torch.where(nan, -torch.inf, cols).amax(0).cpu().numpy()
            present = (~nan).any(0).cpu().numpy()
            for j, f in enumerate(cat):
                if present[j] and (lo[j] < 0 or hi[j] > max_bin - 2):
                    raise ValueError(
                        f"categorical feature {f} has values outside "
                        f"[0, {max_bin - 2}] — re-index categories first"
                    )
                top = int(hi[j]) if present[j] else 0
                uppers[f] = np.arange(top, dtype=np.float64) + 0.5
        numeric = [f for f in range(d) if uppers[f] is None]
        for grp in _groups([xs.shape[0]] * len(numeric)):
            fs = [numeric[j] for j in grp]
            for f, u in zip(fs, _column_bounds(xs[:, fs], max_bin)):
                uppers[f] = u
        return BinMapper(uppers=uppers, max_bin=max_bin)

    @staticmethod
    def _fit_sparse(
        x: object, max_bin: int, sample: int = 200_000, seed: int = 0,
        device: "str | torch.device | None" = None,
    ) -> "BinMapper":
        """Quantile bounds from each column's STORED values only (capped at
        the same per-fit sampling budget as the dense path, drawn from one
        generator in column order, as the JAX package draws them)."""
        dev = _fit_device(x, device)
        d = x.shape[1]
        rng = np.random.default_rng(seed)
        cols = []
        for f, col in _csc_columns(x):
            if len(col) > sample:
                col = rng.choice(col, sample, replace=False)
            cols.append((f, col))
        uppers = [np.array([], dtype=np.float64)] * d
        for grp in _groups([len(c) for _, c in cols]):
            m = max(len(cols[j][1]) for j in grp)
            block = np.full((m, len(grp)), np.nan, np.float64)
            for k, j in enumerate(grp):
                block[: len(cols[j][1]), k] = cols[j][1]
            bounds = _column_bounds(torch.from_numpy(block).to(dev), max_bin)
            for k, j in enumerate(grp):
                uppers[cols[j][0]] = bounds[k]
        return BinMapper(uppers=uppers, max_bin=max_bin)

    def _table(self, dev: torch.device) -> torch.Tensor:
        """(d, W) f64 uppers, padded with +inf (a NaN bound, which numpy's
        search ranks above every value, becomes +inf, which does the
        same)."""
        d = self.num_features
        W = max([len(u) for u in self.uppers] + [1])
        tab = np.full((d, W), np.inf, np.float64)
        for f, u in enumerate(self.uppers):
            tab[f, : len(u)] = np.where(np.isnan(u), np.inf, u)
        return torch.from_numpy(tab).to(dev)

    def bin_tensor(self, x: Any, device: "str | torch.device | None" = None) -> torch.Tensor:
        """(n, d) float (or CSR) -> (n, d) uint8 bins on ``device``
        (``None``: the input's own, the CPU for a numpy array); NaN ->
        MISSING_BIN(0); real values start at bin 1. Binned at float32,
        as the JAX package does."""
        dev = _fit_device(x, device)
        if is_sparse(x):
            return self._transform_sparse(x, dev)
        xt = _as_tensor(x, dev)
        n, d = xt.shape
        table = self._table(dev)
        out = torch.empty((n, d), dtype=torch.uint8, device=dev)
        step = max(1, _GROUP_ELEMS // 4 // max(d, 1))
        for r0 in range(0, n, step):
            v = xt[r0: r0 + step].to(torch.float32).to(torch.float64).T.contiguous()
            b = torch.searchsorted(table, v, side="left") + 1
            b = torch.where(torch.isnan(v), MISSING_BIN, b)
            out[r0: r0 + step] = b.T.to(torch.uint8)
        return out

    def _transform_sparse(self, x: object, dev: torch.device) -> torch.Tensor:
        """CSR/CSC -> dense uint8 bins on ``dev``: the stored values
        searched against their columns' uppers, scattered into a zeroed
        (n, d) matrix; absent entries stay MISSING_BIN."""
        n, d = x.shape
        xc = x.tocsc() if hasattr(x, "tocsc") else x
        indptr = np.asarray(xc.indptr)
        rows = torch.from_numpy(np.asarray(xc.indices, np.int64)).to(dev)
        vals = torch.from_numpy(np.asarray(xc.data, np.float32)).to(dev).to(torch.float64)
        col = torch.from_numpy(
            np.repeat(np.arange(d, dtype=np.int64), np.diff(indptr))).to(dev)
        b = _search_rows(self._table(dev), col, vals) + 1
        b = torch.where(torch.isnan(vals), MISSING_BIN, b)
        out = torch.zeros((n, d), dtype=torch.uint8, device=dev)
        out[rows, col] = b.to(torch.uint8)
        return out

    def transform(self, x: Any) -> np.ndarray:
        """(n, d) float (or CSR) -> (n, d) uint8 bins as numpy, binned on
        the CPU (:meth:`bin_tensor` bins on a device)."""
        return self.bin_tensor(x, "cpu").numpy()

    def num_bins(self, f: int) -> int:
        return len(self.uppers[f]) + 2  # missing bin + len(uppers)+1 value bins

    def transform_into(self, x: Any, out: np.ndarray, row0: int) -> None:
        """Bin a chunk straight into ``out[row0:row0+len(x)]`` (chunked
        ingestion into a preallocated uint8 matrix)."""
        out[row0:row0 + x.shape[0]] = self.transform(x)

    def threshold_value(self, f: int, bin_idx: int) -> float:
        """Upper bound of value-bin ``bin_idx`` (split 'x <= thr')."""
        u = self.uppers[f]
        i = int(bin_idx) - 1  # value bins start at 1
        if i < 0:
            return -np.inf
        if i >= len(u):
            return np.inf
        return float(u[i])


def _fit_device(x: Any, device: "str | torch.device | None") -> torch.device:
    if device is not None:
        return resolve_device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


@dataclass
class BinnedDataset:
    """An already-quantized training input: the uint8 bin matrix plus the
    mapper that produced it. ``train()`` accepts one wherever it accepts a
    float matrix and skips its own fit/transform (the out-of-core path:
    rows binned chunk by chunk against a mapper fitted from streaming
    sketches, so the float matrix never exists in memory at once)."""

    bins: np.ndarray        # (n, d) uint8
    mapper: BinMapper

    def __post_init__(self) -> None:
        self.bins = np.ascontiguousarray(self.bins)
        if self.bins.dtype != np.uint8 or self.bins.ndim != 2:
            raise ValueError("BinnedDataset.bins must be a (n, d) uint8")
        if self.bins.shape[1] != self.mapper.num_features:
            raise ValueError(
                f"bins have {self.bins.shape[1]} features, mapper has "
                f"{self.mapper.num_features}"
            )

    @property
    def shape(self) -> tuple:
        return self.bins.shape
