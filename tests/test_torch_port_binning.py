"""The port's device binning (``BinMapper.fit`` / ``transform`` in PyTorch)
against the JAX package's ``BinMapper`` (numpy, and its native kernel where
the loader builds it), on the CPU.

Tolerance: none. Bounds are compared as f64 bit patterns and bins as uint8
values: the port copies numpy's few-values midpoints (in the input's
dtype), ``percentile(method="linear")`` (virtual index, gamma, ``_lerp``'s
two formulas, ``np.unique``) and ``searchsorted(side="left")`` in f64.
One exception: where a column's quantiles hit both -0.0 and +0.0, which
of the two ``np.unique`` keeps depends on the order its SIMD sort leaves
equal values in (measured: either, about half the time), so a zero bound
is compared as +0.0. Both zeros bin every value alike.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu_torch.models.gbdt import BinMapper
from mmlspark_tpu_torch.models.gbdt.binning import MISSING_BIN

DATA_DIR = os.path.join(os.path.dirname(__file__), "resources", "data")

torch.set_num_threads(1)


def load_x(name: str) -> np.ndarray:
    a = np.loadtxt(os.path.join(DATA_DIR, f"{name}.csv"), delimiter=",", skiprows=1)
    return a[:, :-1].astype(np.float32)


def _special(dtype) -> np.ndarray:
    """Columns with NaN, +-inf, a few distinct values, one value, all NaN,
    a value repeated in runs, and +-0."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6000, 8))
    x[::7, 0] = np.nan
    x[::11, 1] = np.inf
    x[::13, 1] = -np.inf
    x[:, 2] = np.round(x[:, 2] * 3)          # ~20 distinct values
    x[:, 3] = 1.5                            # one value
    x[:, 4] = np.nan                         # no value
    x[:, 5] = np.where(rng.random(6000) < 0.5, 0.0, rng.lognormal(size=6000))
    x[:, 6] = np.repeat(rng.normal(size=600), 10)
    x[:, 7] = np.where(rng.random(6000) < 0.3, -0.0, x[:, 7])
    x[:40, 7] = [np.inf, -np.inf] * 20
    return x.astype(dtype)


def _gate_cell() -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.normal(size=(125_000, 32)).astype(np.float32)[:100_000]


def _wide() -> np.ndarray:
    rng = np.random.default_rng(3)
    return rng.normal(size=(200_000, 64)).astype(np.float32)


def _ints() -> np.ndarray:
    return np.random.default_rng(5).integers(-20, 40, size=(3000, 4))


CASES = {
    **{f"{name}-255": (lambda name=name: load_x(name), 255)
       for name in ("breast_cancer", "diabetes", "digits", "iris", "wine")},
    **{f"special-{dt.__name__}-{mb}": (lambda dt=dt: _special(dt), mb)
       for dt in (np.float32, np.float64) for mb in (2, 63, 255)},
    "gate-63": (_gate_cell, 63),
    "gate-255": (_gate_cell, 255),
    "wide-255": (_wide, 255),
    "ints-16": (_ints, 16),
}


def _same_bounds(port: BinMapper, ref: JBinMapper) -> None:
    assert port.max_bin == ref.max_bin
    assert len(port.uppers) == len(ref.uppers)
    for f, (u, v) in enumerate(zip(port.uppers, ref.uppers)):
        assert u.dtype == v.dtype == np.float64, f
        assert u.shape == v.shape, (f, u.shape, v.shape)
        u, v = u + 0.0, v + 0.0      # -0.0 + 0.0 is +0.0; every other value stays
        assert np.array_equal(u.view(np.uint64), v.view(np.uint64)), f


def _numpy_bins(mapper, x) -> np.ndarray:
    """The JAX package's numpy transform, whatever its native loader does."""
    x = np.asarray(x, np.float32)
    out = np.empty(x.shape, np.uint8)
    for f in range(x.shape[1]):
        b = np.searchsorted(mapper.uppers[f], x[:, f], side="left") + 1
        out[:, f] = np.where(np.isnan(x[:, f]), MISSING_BIN, b)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_bins_and_bounds_bitwise_equal_the_jax_package(case):
    make, max_bin = CASES[case]
    x = make()
    ref = JBinMapper.fit(x, max_bin=max_bin, seed=4)
    port = BinMapper.fit(x, max_bin=max_bin, seed=4)
    _same_bounds(port, ref)
    bins = port.transform(x)
    assert bins.dtype == np.uint8 and bins.shape == x.shape
    np.testing.assert_array_equal(bins, ref.transform(x))
    np.testing.assert_array_equal(bins, _numpy_bins(ref, x))


def test_bin_tensor_and_tensor_input_equal_transform():
    x = _special(np.float32)
    port = BinMapper.fit(x, max_bin=63, seed=1)
    t = port.bin_tensor(x, "cpu")
    assert t.dtype == torch.uint8 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), port.transform(x))
    # a tensor input fits and bins on its own device, to the same result
    again = BinMapper.fit(torch.from_numpy(x), max_bin=63, seed=1)
    _same_bounds(again, JBinMapper.fit(x, max_bin=63, seed=1))
    np.testing.assert_array_equal(again.bin_tensor(torch.from_numpy(x)).numpy(), t.numpy())


def test_out_of_range_values_bin_as_numpy_searchsorted():
    """Values outside what the sample saw (and +-inf, NaN) bin as numpy's
    searchsorted bins them against the same bounds."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3000, 3)).astype(np.float32)
    ref = JBinMapper.fit(x, max_bin=31, seed=0)
    port = BinMapper.fit(x, max_bin=31, seed=0)
    probe = np.array([[-1e30, 1e30, np.nan], [np.inf, -np.inf, 0.0], [5.0, -5.0, 1e-30]],
                     np.float32)
    np.testing.assert_array_equal(port.transform(probe), ref.transform(probe))


def test_subsampled_fit_draws_the_jax_package_rows():
    """More rows than ``sample``: the row draw is numpy's default_rng(seed)
    choice, as in the JAX package."""
    x = np.random.default_rng(8).normal(size=(5000, 3)).astype(np.float32)
    for seed in (0, 9):
        _same_bounds(BinMapper.fit(x, max_bin=63, sample=1000, seed=seed),
                     JBinMapper.fit(x, max_bin=63, sample=1000, seed=seed))


def test_categorical_bounds_and_range_check_equal_the_jax_package():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4000, 4)).astype(np.float32)
    x[:, 1] = rng.integers(0, 30, 4000)
    x[::9, 1] = np.nan
    x[:, 3] = rng.integers(0, 5, 4000)
    cats = (1, 3)
    port = BinMapper.fit(x, max_bin=63, sample=500, seed=2, categorical_features=cats)
    _same_bounds(port, JBinMapper.fit(x, max_bin=63, sample=500, seed=2,
                                      categorical_features=cats))
    bad = x.copy()
    bad[-1, 1] = 62.0   # past max_bin - 2, outside the sample: the full column is checked
    with pytest.raises(ValueError, match="categorical feature 1"):
        BinMapper.fit(bad, max_bin=63, sample=500, categorical_features=cats)


def test_max_bin_out_of_range_raises():
    with pytest.raises(ValueError, match="max_bin"):
        BinMapper.fit(np.zeros((4, 2), np.float32), max_bin=256)
