"""Feature quantization for histogram GBDT (numpy, host side).

The port's copy of ``mmlspark_tpu.models.gbdt.binning.BinMapper``: each
feature is quantized to at most ``max_bin`` bins by quantiles; training
then runs on the uint8 bin matrix, which stays uint8 on the device (one
byte per cell is what the histogram kernels read). Bin 0 is reserved for
missing values (NaN), LightGBM's missing-bin handling.

Upper-bound thresholds stay in original feature space, so trained trees
carry real-valued thresholds and prediction never needs the mapper.

Categorical features are binned by identity (category value v -> bin
v+1), as in the JAX package. Only dense input is ported: CSR input, the
C++ binning kernel and the streaming sketch are not (ROADMAP.md, Queue A
item 3), and CSR input raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MISSING_BIN = 0


def is_sparse(x: object) -> bool:
    return hasattr(x, "indptr") and hasattr(x, "indices") and hasattr(x, "data")


def _require_dense(x: object) -> None:
    if is_sparse(x):
        raise NotImplementedError(
            "sparse (CSR) GBDT input is not ported to mmlspark_tpu_torch yet "
            "(ROADMAP.md Queue A item 3: CSR input); pass a dense array"
        )


@dataclass
class BinMapper:
    # uppers[f] has length n_bins[f]-1: upper bound (inclusive) of each
    # non-missing bin except the last (which is +inf)
    uppers: list
    max_bin: int

    @staticmethod
    def fit(
        x: np.ndarray,
        max_bin: int = 255,
        sample: int = 200_000,
        seed: int = 0,
        categorical_features: tuple = (),
    ) -> "BinMapper":
        """Quantile bin bounds per feature, from at most ``sample`` rows
        drawn with ``numpy.random.default_rng(seed)`` (the JAX package's
        draw, so both packages bin identically).

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
        if categorical_features and is_sparse(x):
            raise ValueError(
                "categorical features require dense input (sparse "
                "columns have no stable category<->bin identity for "
                "absent entries)"
            )
        _require_dense(x)
        n, d = x.shape
        if n > sample:
            idx = np.random.default_rng(seed).choice(n, sample, replace=False)
            xs = x[idx]
        else:
            xs = x
        cat = set(int(f) for f in categorical_features)
        uppers = []
        for f in range(d):
            if f in cat:
                col = x[:, f]
                col = col[~np.isnan(col)]
                if len(col) and (col.min() < 0 or col.max() > max_bin - 2):
                    raise ValueError(
                        f"categorical feature {f} has values outside "
                        f"[0, {max_bin - 2}] — re-index categories first"
                    )
                hi = int(col.max()) if len(col) else 0
                uppers.append(np.arange(hi, dtype=np.float64) + 0.5)
                continue
            col = xs[:, f]
            col = col[~np.isnan(col)]
            uniq = np.unique(col)
            if len(uniq) <= 1:
                uppers.append(np.array([], dtype=np.float64))
                continue
            if len(uniq) <= max_bin - 1:
                bounds = (uniq[:-1] + uniq[1:]) / 2.0
            else:
                qs = np.linspace(0, 100, max_bin)[1:-1]
                bounds = np.unique(np.percentile(col, qs, method="linear"))
            uppers.append(bounds.astype(np.float64))
        return BinMapper(uppers=uppers, max_bin=max_bin)

    def transform(self, x: np.ndarray) -> np.ndarray:
        """(n, d) float -> (n, d) uint8 bins; NaN -> MISSING_BIN(0); real
        values start at bin 1. Binned at float32, as the JAX package does."""
        _require_dense(x)
        x = np.asarray(x, np.float32)
        n, d = x.shape
        out = np.empty((n, d), dtype=np.uint8)
        for f in range(d):
            col = x[:, f]
            b = np.searchsorted(self.uppers[f], col, side="left") + 1
            b = np.where(np.isnan(col), MISSING_BIN, b)
            out[:, f] = b.astype(np.uint8)
        return out

    def threshold_value(self, f: int, bin_idx: int) -> float:
        """Upper bound of value-bin ``bin_idx`` (split 'x <= thr')."""
        u = self.uppers[f]
        i = int(bin_idx) - 1  # value bins start at 1
        if i < 0:
            return -np.inf
        if i >= len(u):
            return np.inf
        return float(u[i])
