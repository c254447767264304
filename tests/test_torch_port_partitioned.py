"""The data-partitioned leaf-wise grower (``treegrow.grow_tree_partitioned``)
against the masked grower and the JAX package's partitioned grower, on the
CPU: the reference's cases (``tests/test_gbdt.py`` ``TestPartitionedGrower``
and ``TestPartitionedInteractions``) as parity cases.

Tolerances, the reference's own: the row partition, split leaves and
features exact; leaf values within 1e-5; gains within rtol 1e-3 (the
partitioned grower histograms the smaller child and derives the larger,
the masked grower the right child and derives the left, so their planes
round differently); end-to-end predictions within 1e-3 mean absolute
difference. The reference's tests do not compare thresholds; here a
threshold may differ only across bins that hold no weighted row of the
leaf (a tie in exact arithmetic that those f32 residues break), which
each numerical case checks.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.treegrow import grow_tree as j_grow_tree
from mmlspark_tpu_torch.models.gbdt import TrainConfig, train
from mmlspark_tpu_torch.models.gbdt.treegrow import (
    SplitParams,
    grow_tree,
    grow_tree_partitioned,
)

T = importlib.import_module("mmlspark_tpu_torch.models.gbdt.train")
torch.set_num_threads(1)


def _inputs(n, d, seed, weights=True):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 200, size=(n, d)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = (np.abs(rng.normal(size=n)) + 0.1).astype(np.float32)
    w = ((rng.random(n) > 0.1) if weights else np.ones(n)).astype(np.float32)
    return bins, g, h, w


def _grow_all(bins, g, h, w, cat=None, **over):
    kw = dict(num_leaves=31, max_depth=-1, min_data_in_leaf=20, num_bins=256)
    kw.update(over)
    d = bins.shape[1]
    sp = SplitParams.make("cpu", lambda_l2=1.0, lambda_l1=0.0, min_sum_hessian=1e-3,
                          min_gain=0.0, learning_rate=0.1)
    args = [torch.from_numpy(a) for a in (bins, g, h, w)]
    cm = None if cat is None else torch.from_numpy(cat)
    masked = grow_tree(*args, sp=sp, feature_mask=torch.ones(d), categorical_mask=cm, **kw)
    part = grow_tree_partitioned(*args, sp=sp, feature_mask=torch.ones(d),
                                 categorical_mask=cm, **kw)
    ref = j_grow_tree(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        lambda_l2=1.0, min_gain=0.0, learning_rate=0.1, feature_mask=jnp.ones(d),
        lambda_l1=0.0, min_sum_hessian=1e-3, partitioned=True,
        categorical_mask=None if cat is None else jnp.asarray(cat), **kw)
    return masked, part, ref


def _threshold_ties(bins, weight, a, b):
    """Each split at which ``a`` and ``b`` chose different thresholds, with
    the weighted rows of its leaf between the two (replaying ``a``'s
    records): 0 means both thresholds part the weighted rows alike."""
    bins, w = np.asarray(bins), np.asarray(weight) > 0
    rl, rf, ra = (np.asarray(t) for t in (a.rec_leaf, a.rec_feature, a.rec_active))
    ab, bb = np.asarray(a.rec_bin), np.asarray(b.rec_bin)
    leaf = np.zeros(len(bins), np.int64)
    out = []
    for k in np.flatnonzero(ra):
        col, in_leaf = bins[:, rf[k]], leaf == rl[k]
        if ab[k] != bb[k]:
            lo, hi = sorted((ab[k], bb[k]))
            out.append(int((in_leaf & w & (col > lo) & (col <= hi)).sum()))
        leaf[in_leaf & (col > ab[k])] = k + 1
    return out


def _assert_matches(a, b):
    """The reference's TestPartitionedGrower assertions."""
    np.testing.assert_array_equal(np.asarray(b.row_leaf), np.asarray(a.row_leaf))
    np.testing.assert_allclose(np.asarray(b.leaf_values), np.asarray(a.leaf_values), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(b.rec_leaf), np.asarray(a.rec_leaf))
    np.testing.assert_array_equal(np.asarray(b.rec_feature), np.asarray(a.rec_feature))
    np.testing.assert_allclose(np.asarray(b.rec_gain), np.asarray(a.rec_gain), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["plain", "categorical_depth", "small"])
def test_partitioned_matches_the_masked_grower_and_the_jax_package(case, monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")
    if case == "plain":
        bins, g, h, w = _inputs(4096, 10, 3)
        masked, part, ref = _grow_all(bins, g, h, w)
    elif case == "categorical_depth":
        bins, g, h, w = _inputs(3000, 8, 4, weights=False)
        rng = np.random.default_rng(4)
        cat = np.zeros(8, bool)
        cat[[1, 4]] = True
        bins[:, 1] = rng.integers(0, 16, size=3000)
        bins[:, 4] = rng.integers(0, 6, size=3000)
        masked, part, ref = _grow_all(bins, g, h, w, cat=cat, max_depth=4)
    else:
        # fewer rows than the smallest bucket, an odd count, more leaves
        # than the rows can fill
        bins, g, h, w = _inputs(301, 5, 8)
        masked, part, ref = _grow_all(bins, g, h, w, num_leaves=63, min_data_in_leaf=3)
    _assert_matches(masked, part)
    _assert_matches(ref, part)
    np.testing.assert_array_equal(part.leaf_counts.numpy(), masked.leaf_counts.numpy())
    np.testing.assert_array_equal(part.rec_active.numpy(), masked.rec_active.numpy())
    if case != "categorical_depth":   # the replay routes numerical splits
        assert all(n == 0 for n in _threshold_ties(bins, w, masked, part))


def _xy(n=3000, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    return x, y


def _both(monkeypatch, x, y, cfg, **kw):
    monkeypatch.setenv("MMLSPARK_TPU_GBDT_PARTITION", "1")
    part = train(x, y, cfg, device="cpu", **kw)
    monkeypatch.setenv("MMLSPARK_TPU_GBDT_PARTITION", "0")
    masked = train(x, y, cfg, device="cpu", **kw)
    return part, masked


@pytest.mark.parametrize("case", ["e2e", "goss", "bagging"])
def test_training_with_the_partitioned_grower_matches_the_masked(case, monkeypatch):
    if case == "e2e":
        x, y = _xy(2000, 5)
        cfg = TrainConfig(objective="binary", num_iterations=5, num_leaves=15,
                          min_data_in_leaf=5, seed=0)
    elif case == "goss":
        x, y = _xy()
        cfg = TrainConfig(objective="binary", num_iterations=6, num_leaves=15,
                          min_data_in_leaf=5, seed=0, boosting_type="goss")
    else:
        x, _ = _xy(seed=10)
        y = x[:, 0] * 2.0 + np.random.default_rng(0).normal(size=len(x)) * 0.1
        cfg = TrainConfig(objective="regression", num_iterations=6, num_leaves=15,
                          min_data_in_leaf=5, seed=0, bagging_fraction=0.7, bagging_freq=1)
    part, masked = _both(monkeypatch, x, y, cfg)
    pa, pb = part.predict_raw(x, device="cpu"), masked.predict_raw(x, device="cpu")
    assert np.mean(np.abs(pa - pb)) < 1e-3 * max(1.0, float(np.abs(pb).mean()))
    # the fused round carries the partitioned grower as it carries the masked
    monkeypatch.setenv("MMLSPARK_TPU_GBDT_PARTITION", "1")
    eager = train(x, y, cfg, device="cpu", fused_rounds=1)
    assert eager.to_model_string() == part.to_model_string()


def test_quantile_renewal_partitioned(monkeypatch):
    """Leaf renewal consumes the partitioned grower's row_leaf: the
    reference's pinball-loss coverage gate with partitioning forced on."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4000, 6)).astype(np.float32)
    y = x[:, 0] * 3.0 + rng.normal(size=4000) * (1.0 + np.abs(x[:, 1]))
    monkeypatch.setenv("MMLSPARK_TPU_GBDT_PARTITION", "1")
    cfg = TrainConfig(objective="quantile", alpha=0.8, num_iterations=40, num_leaves=15,
                      min_data_in_leaf=10, seed=0)
    pred = train(x, y, cfg, device="cpu").predict_raw(x, device="cpu")
    cov = float((y <= pred).mean())
    assert 0.74 < cov < 0.86, cov


def test_partitioned_is_off_by_default_and_lossguide_only(monkeypatch):
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return grow_tree_partitioned(*a, **kw)

    monkeypatch.setattr(T, "grow_tree_partitioned", spy)
    x, y = _xy(500, 1)
    cfg = TrainConfig(num_iterations=2, num_leaves=7, min_data_in_leaf=5)
    monkeypatch.delenv("MMLSPARK_TPU_GBDT_PARTITION", raising=False)
    train(x, y, cfg, device="cpu")
    for off in ("0", "false"):
        monkeypatch.setenv("MMLSPARK_TPU_GBDT_PARTITION", off)
        train(x, y, cfg, device="cpu")
    assert not calls
    monkeypatch.setenv("MMLSPARK_TPU_GBDT_PARTITION", "1")
    train(x, y, TrainConfig(num_iterations=2, num_leaves=7, growth_policy="depthwise"),
          device="cpu")
    assert not calls
    train(x, y, cfg, device="cpu")
    assert len(calls) == 2
