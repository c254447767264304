"""The port's ``isolationforest/`` against the JAX package's.

The fit is the JAX package's host numpy, so the trees are bitwise from one
seed; scoring gathers the same f32 table on the same comparisons, so path
lengths are bitwise (NaN features go right in both), and the mean and
score stay numpy on the host: scores, predictions and ``score_threshold``
bitwise too, empty partitions included. A port model built from the JAX
model's params scores as the JAX model does; models round-trip
``save``/``load``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mmlspark_tpu.isolationforest as J
from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu.isolationforest.forest import _batch_path_lengths
from mmlspark_tpu_torch import DataFrame, load_stage
from mmlspark_tpu_torch.isolationforest import IsolationForest, IsolationForestModel
from mmlspark_tpu_torch.isolationforest import forest as F

TREE_PARAMS = ("features", "thresholds", "leaves", "path_lens")


def _data(n_inliers: int = 300, n_outliers: int = 10, d: int = 4, seed: int = 0) -> tuple:
    rng = np.random.RandomState(seed)
    inliers = rng.randn(n_inliers, d).astype(np.float32)
    outliers = rng.randn(n_outliers, d).astype(np.float32) * 0.5 + 8.0
    x = np.vstack([inliers, outliers])
    return x, np.concatenate([np.zeros(n_inliers), np.ones(n_outliers)])


def _fit(x: np.ndarray, **kw) -> tuple:
    jm = J.IsolationForest(**kw).fit(JDataFrame.from_dict({"features": x}))
    pm = IsolationForest(device="cpu", **kw).fit(DataFrame.from_dict({"features": x}))
    return jm, pm


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kw", [
    dict(num_estimators=40, random_seed=3),
    dict(num_estimators=25, max_samples=64, max_features=0.5, random_seed=0),
    dict(num_estimators=30, bootstrap=True, random_seed=7),
    dict(num_estimators=20, max_samples=1000, random_seed=1),
], ids=["default", "subset", "bootstrap", "psi_all"])
def test_trees_and_scores_bitwise(kw):
    x, _ = _data()
    jm, pm = _fit(x, **kw)
    for name in TREE_PARAMS:
        assert _same(jm.get(name), pm.get(name)), name
    assert pm.get("depth_cap") == jm.get("depth_cap")
    assert pm.get("subsample_size") == jm.get("subsample_size")
    a = jm.transform(JDataFrame.from_dict({"features": x}))
    b = pm.transform(DataFrame.from_dict({"features": x}))
    for col in ("outlierScore", "prediction"):
        assert _same(a[col], b[col]), col


def test_path_lengths_bitwise_with_nan_features():
    x, _ = _data(200, 5, d=6, seed=2)
    jm, _ = _fit(x, num_estimators=30, random_seed=4)
    probe = np.random.RandomState(5).randn(300, 6).astype(np.float32) * 3
    probe[::7, 2] = np.nan
    probe[3] = np.nan
    trees = [jm.get(n) for n in TREE_PARAMS]
    import jax.numpy as jnp

    want = np.asarray(_batch_path_lengths(jnp.asarray(probe), *map(jnp.asarray, trees),
                                          jm.get("depth_cap")))
    t = [torch.as_tensor(np.array(a)) for a in trees]
    got = F.batch_path_lengths(torch.as_tensor(probe), t[0].long(), *t[1:],
                               jm.get("depth_cap")).T.numpy()
    assert _same(np.ascontiguousarray(got), want)
    pm = IsolationForestModel(device="cpu", **{p: jm.get(p) for p in (
        *TREE_PARAMS, "depth_cap", "subsample_size")})
    assert _same(pm._scores(probe), jm._scores(probe))


@pytest.mark.parametrize("contamination", [15 / 315, 0.1])
def test_contamination_threshold_and_predictions_bitwise(contamination):
    x, y = _data(300, 15, seed=1)
    jm, pm = _fit(x, num_estimators=50, contamination=contamination, random_seed=0)
    assert pm.get("score_threshold") == jm.get("score_threshold")
    a = jm.transform(JDataFrame.from_dict({"features": x}))["prediction"]
    b = pm.transform(DataFrame.from_dict({"features": x}))["prediction"]
    assert _same(a, b)
    assert b[y == 1].mean() > 0.8


def test_row_blocks_and_partitions_keep_the_bits(monkeypatch):
    x, _ = _data(400, 12, seed=3)
    jm, pm = _fit(x, num_estimators=16, random_seed=2)
    want = jm.transform(JDataFrame.from_dict({"features": x}, num_partitions=3))
    monkeypatch.setattr(F, "SCORE_BLOCK_ENTRIES", 16 * 50)
    got = pm.transform(DataFrame.from_dict({"features": x}, num_partitions=3))
    assert _same(got["outlierScore"], want["outlierScore"])


def test_empty_partition():
    x, _ = _data(50, 2)
    jm, pm = _fit(x, num_estimators=10)
    empty = np.zeros((0, 4), np.float32)
    a = jm.transform(JDataFrame.from_dict({"features": empty}))
    b = pm.transform(DataFrame.from_dict({"features": empty}))
    assert b.count() == a.count() == 0
    for col in ("outlierScore", "prediction"):
        assert _same(a[col], b[col])


def test_carried_params_score_as_the_jax_model():
    x, _ = _data(seed=4)
    jm, _ = _fit(x, num_estimators=30, contamination=0.05, random_seed=9)
    pm = IsolationForestModel(device="cpu", **{p: jm.get(p) for p in (
        *TREE_PARAMS, "depth_cap", "subsample_size", "score_threshold")})
    probe = np.random.RandomState(1).randn(100, 4).astype(np.float32) * 4
    a = jm.transform(JDataFrame.from_dict({"features": probe}))
    b = pm.transform(DataFrame.from_dict({"features": probe}))
    for col in ("outlierScore", "prediction"):
        assert _same(a[col], b[col])


def test_reference_checks_on_the_port():
    """tests/test_isolationforest.py's quality checks, on the port."""
    x, y = _data()
    _, pm = _fit(x, num_estimators=50, random_seed=3)
    s = pm.transform(DataFrame.from_dict({"features": x}))["outlierScore"]
    assert s.min() >= 0.0 and s.max() <= 1.0
    assert s[y == 1].mean() > s[y == 0].mean() + 0.15
    assert s[y == 1].min() > np.median(s[y == 0])
    u = np.random.RandomState(1).rand(256, 3).astype(np.float32)
    _, pm = _fit(u, num_estimators=30)
    assert 0.3 < pm.transform(DataFrame.from_dict({"features": u}))["outlierScore"].mean() < 0.6


def test_save_load(tmp_path):
    x, _ = _data(100, 5)
    _, pm = _fit(x, num_estimators=20, contamination=0.05)
    pm.save(str(tmp_path / "iforest"))
    back = load_stage(str(tmp_path / "iforest"))
    df = DataFrame.from_dict({"features": x})
    for col in ("outlierScore", "prediction"):
        assert _same(back.transform(df)[col], pm.transform(df)[col])
    est = IsolationForest(num_estimators=7, device="cpu")
    est.save(str(tmp_path / "est"))
    assert load_stage(str(tmp_path / "est")).get("num_estimators") == 7


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    x, _ = _data(60, 2)
    df = DataFrame.from_dict({"features": x})
    for kw in ({}, {"contamination": 0.1}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            IsolationForest(num_estimators=5, **kw).fit(df)
    model = IsolationForest(num_estimators=5, device="cpu").fit(df)
    model.set(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.transform(df)
