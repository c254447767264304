"""CSR input, the streaming quantile sketch and pre-binned input in the port,
against the JAX package, on the CPU: the reference's sparse cases
(``tests/test_gbdt.py``) and its sketch and pre-binned cases
(``tests/test_elastic_ring.py``) as parity cases.

Tolerances: bins and bounds bitwise (as in test_torch_port_binning.py);
sketch counts exact (integer counts in f64); model strings byte-equal where
both packages' arithmetic is exact (L2 regression), AUC above the
reference's own gate elsewhere.
"""

from __future__ import annotations

import sys
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu.models.gbdt.binning import BinnedDataset as JBinnedDataset
from mmlspark_tpu.models.gbdt.binning import densify_missing as j_densify_missing
from mmlspark_tpu.models.gbdt.sketch import QuantileSketch as JQuantileSketch
from mmlspark_tpu.models.gbdt.train import TrainConfig as JConfig
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.core.metrics import binary_auc
from mmlspark_tpu_torch.models.gbdt import (
    BinMapper,
    BinnedDataset,
    QuantileSketch,
    TrainConfig,
    train,
)
from mmlspark_tpu_torch.models.gbdt.binning import MISSING_BIN, densify_missing
from mmlspark_tpu_torch.models.gbdt.sketch import sketch_chunks

sys.path.insert(0, os.path.dirname(__file__))
from test_gbdt import make_hashed_text  # noqa: E402  the reference's CSR data

torch.set_num_threads(1)


def _same_bounds(port, ref) -> None:
    assert len(port.uppers) == len(ref.uppers)
    for f, (u, v) in enumerate(zip(port.uppers, ref.uppers)):
        assert u.shape == v.shape, f
        assert np.array_equal((u + 0.0).view(np.uint64), (v + 0.0).view(np.uint64)), f


# -- CSR input (tests/test_gbdt.py:607-650) -------------------------------------


@pytest.mark.parametrize("case", ["quality", "bins_match_nan_dense", "categorical_rejected",
                                  "dart"])
def test_sparse_case(case):
    if case == "quality":
        # the reference's test_sparse_csr_training_quality gate, with its
        # data, on the port (the reference runs it in its slow tier)
        x, y = make_hashed_text()
        cfg = TrainConfig(objective="binary", num_iterations=20, num_leaves=15,
                          min_data_in_leaf=5, seed=0)
        b = train(x, y, cfg, device="cpu")
        p = b.predict(densify_missing(x), device="cpu")
        assert binary_auc(y, p) > 0.9
        _same_bounds(BinMapper.fit(x), JBinMapper.fit(x))
    elif case == "bins_match_nan_dense":
        x, _ = make_hashed_text(n=80, dim=512)
        m = BinMapper.fit(x, max_bin=16)
        _same_bounds(m, JBinMapper.fit(x, max_bin=16))
        b_sparse = m.transform(x)
        np.testing.assert_array_equal(b_sparse, m.transform(densify_missing(x)))
        np.testing.assert_array_equal(b_sparse, JBinMapper.fit(x, max_bin=16).transform(x))
        np.testing.assert_array_equal(densify_missing(x), j_densify_missing(x))
    elif case == "categorical_rejected":
        x, _ = make_hashed_text(n=40, dim=64)
        with pytest.raises(ValueError, match="dense"):
            BinMapper.fit(x, categorical_features=(0,))
        with pytest.raises(ValueError, match="dense"):
            JBinMapper.fit(x, categorical_features=(0,))
    else:
        x, y = make_hashed_text(n=200, dim=1024, seed=2)
        cfg = TrainConfig(objective="binary", num_iterations=10, num_leaves=7,
                          boosting_type="dart", drop_rate=0.5, skip_drop=0.0, seed=1)
        b = train(x, y, cfg, device="cpu")  # dart replays dropped trees on NaN-dense rows
        assert len(b.trees) == 10


def test_sparse_fit_subsamples_stored_values_as_the_jax_package():
    """Columns with more stored values than ``sample`` draw them from one
    generator in column order; values, NaN and explicit zeros included."""
    import scipy.sparse as sp

    rng = np.random.default_rng(4)
    dense = rng.normal(size=(3000, 6))
    dense[rng.random(dense.shape) < 0.6] = 0.0
    dense[::17, 2] = np.nan
    x = sp.csr_matrix(dense)
    x.data[::5] = 0.0    # stored zeros are values, absent ones missing
    for sample in (200, 200_000):
        _same_bounds(BinMapper.fit(x, max_bin=31, sample=sample, seed=3),
                     JBinMapper.fit(x, max_bin=31, sample=sample, seed=3))
    m = BinMapper.fit(x, max_bin=31, seed=3)
    np.testing.assert_array_equal(m.transform(x), JBinMapper.fit(x, max_bin=31, seed=3)
                                  .transform(x))


@pytest.fixture
def reference_device_grower(monkeypatch):
    """The JAX package's device grower (f32 histograms in row order, as the
    port's CPU path sums them), not its f64 host lowering."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")


def test_sparse_l2_fit_equals_the_jax_package(reference_device_grower):
    """A CSR regression fit: both packages' arithmetic is exact for L2, so
    the model strings are byte-equal."""
    x, y = make_hashed_text(n=300, dim=256, seed=5)
    yr = y * 2.0 + np.asarray(x.sum(axis=1)).ravel() * 0.1
    kw = dict(objective="regression", num_iterations=5, num_leaves=7, min_data_in_leaf=5,
              seed=2)
    ref = jtrain(x, yr, JConfig(**kw), shard=False)
    port = train(x, yr, TrainConfig(**kw), device="cpu")
    assert port.to_model_string() == ref.to_model_string()


# -- the streaming sketch (tests/test_elastic_ring.py:270-350) -----------------


def test_sketch_partition_and_chunk_invariant():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(997, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan  # missing values skipped

    whole = QuantileSketch(6)
    whole.update(x)
    chunked = sketch_chunks((x[lo:lo + 64] for lo in range(0, len(x), 64)), 6)
    assert np.array_equal(whole.counts, chunked.counts)
    a, b = QuantileSketch(6), QuantileSketch(6)
    a.update(x[:400])
    b.update(x[400:])
    assert np.array_equal(whole.counts, a.counts + b.counts)
    m1 = whole.to_binmapper(63)
    m2 = a.to_binmapper(63, reduce=lambda c: c + b.counts)
    for u1, u2 in zip(m1.uppers, m2.uppers):
        assert np.array_equal(u1, u2)
    # the JAX package's sketch counts the same and cuts the same bounds
    ref = JQuantileSketch(6)
    ref.update(x)
    assert np.array_equal(whole.counts, ref.counts)
    for bits in (8, 16):
        p, r = QuantileSketch(6, bits=bits), JQuantileSketch(6, bits=bits)
        p.update(x)
        r.update(x)
        for mb in (2, 16, 255):
            _same_bounds(p.to_binmapper(mb), r.to_binmapper(mb))


def test_sketch_binmapper_close_to_exact_quantiles():
    rng = np.random.default_rng(9)
    x = np.concatenate(
        [rng.normal(size=(4000, 4)), rng.lognormal(size=(4000, 4))], axis=1,
    ).astype(np.float32)
    x[:50, 0] = np.nan
    sk = QuantileSketch(8)
    sk.update(x)
    approx = sk.to_binmapper(31)
    exact = BinMapper.fit(x, max_bin=31)
    ba, be = approx.transform(x), exact.transform(x)
    assert np.array_equal(ba[:50, 0], np.full(50, MISSING_BIN))
    for f in range(8):
        qa = np.quantile(ba[:, f].astype(float), [0.25, 0.5, 0.75])
        qe = np.quantile(be[:, f].astype(float), [0.25, 0.5, 0.75])
        assert np.all(np.abs(qa - qe) <= 2), (f, qa, qe)
    assert sum(len(u) for u in approx.uppers) >= 8 * 20


def test_sketch_rejects_bad_shapes_and_bits():
    with pytest.raises(ValueError):
        QuantileSketch(4, bits=4)
    sk = QuantileSketch(4)
    with pytest.raises(ValueError):
        sk.update(np.zeros((3, 5), np.float32))
    with pytest.raises(ValueError, match="max_bin"):
        sk.to_binmapper(300)


# -- pre-binned input (tests/test_elastic_ring.py:352-400) ---------------------


def test_binned_dataset_guards_and_training():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 5)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float64)
    mapper = BinMapper.fit(x, max_bin=31)
    ds = BinnedDataset(mapper.transform(x), mapper)
    assert ds.shape == x.shape and mapper.num_features == 5
    cfg = TrainConfig(objective="binary", num_iterations=3, num_leaves=7,
                      min_data_in_leaf=5, seed=1, max_bin=31)
    ref = train(x, y, cfg, device="cpu")
    got = train(ds, y, cfg, device="cpu")
    assert got.to_model_string() == ref.to_model_string()
    with pytest.raises(ValueError, match="dart"):
        train(ds, y, TrainConfig(objective="binary", num_iterations=2, boosting_type="dart",
                                 max_bin=31), device="cpu")
    with pytest.raises(ValueError, match="init_booster"):
        train(ds, y, cfg, device="cpu", init_booster=ref)
    with pytest.raises(ValueError, match="categorical"):
        train(ds, y, TrainConfig(objective="binary", num_iterations=2,
                                 categorical_features=(0,), max_bin=31), device="cpu")
    with pytest.raises(ValueError, match="max_bin"):
        train(ds, y, TrainConfig(objective="binary", num_iterations=2, max_bin=16),
              device="cpu")
    with pytest.raises(ValueError):
        BinnedDataset(np.zeros((4, 3), np.int32), mapper)
    with pytest.raises(ValueError, match="features"):
        BinnedDataset(np.zeros((4, 3), np.uint8), mapper)


def test_sketch_binned_training_at_world_1_equals_the_jax_package(reference_device_grower):
    """The out-of-core shape at world 1: rows sketched in chunks, binned
    chunk by chunk into a preallocated matrix, trained as a BinnedDataset:
    the same model string in both packages (L2 regression)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2000, 6)).astype(np.float32)
    y = x[:, 0] * 2.0 + x[:, 1] * x[:, 2]
    chunks = [x[lo:lo + 256] for lo in range(0, len(x), 256)]
    port_map = sketch_chunks(chunks, 6).to_binmapper(63)
    ref_sk = JQuantileSketch(6)
    for c in chunks:
        ref_sk.update(c)
    ref_map = ref_sk.to_binmapper(63)
    _same_bounds(port_map, ref_map)
    bins = np.empty(x.shape, np.uint8)
    for lo, c in zip(range(0, len(x), 256), chunks):
        port_map.transform_into(c, bins, lo)
    np.testing.assert_array_equal(bins, ref_map.transform(x))
    kw = dict(objective="regression", num_iterations=4, num_leaves=7, min_data_in_leaf=5,
              seed=3, max_bin=63)
    port = train(BinnedDataset(bins, port_map), y, TrainConfig(**kw), device="cpu")
    ref = jtrain(JBinnedDataset(bins, ref_map), y, JConfig(**kw), shard=False)
    assert port.to_model_string() == ref.to_model_string()
