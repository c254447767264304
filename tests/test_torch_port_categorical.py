"""The port's categorical splits against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages. Tolerances: bins,
split records (leaf, feature, threshold, active, counts, ``is_cat``,
``catmask``), leaf indices and model strings equal; leaf values and gains
within RTOL=1e-4, ATOL=1e-6; raw scores within ATOL=1e-6. Fits of the
binary and multiclass objectives route their gradients through the JAX
package's functions (XLA's and PyTorch's f32 ``exp`` differ in the last
bit, ``tests/test_torch_port_gbdt.py``); regression fits need no help.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import objectives as JO
from mmlspark_tpu.models.gbdt import treegrow as JG
from mmlspark_tpu.models.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core.metrics import binary_auc
from mmlspark_tpu_torch.models.gbdt import (
    BinMapper,
    Booster,
    LightGBMClassifier,
    TrainConfig,
    booster_from_reference,
    objectives as PO,
    train,
)
from mmlspark_tpu_torch.models.gbdt import treegrow as PG

JT = importlib.import_module("mmlspark_tpu.models.gbdt.train")

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
CPU = torch.device("cpu")


@pytest.fixture
def reference_device_grower(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")


@pytest.fixture
def jax_gradients(monkeypatch):
    import jax.numpy as jnp

    def route(jfn):
        def fn(scores, y):
            g, h = jfn(jnp.asarray(scores.numpy()), jnp.asarray(y.numpy()))
            return torch.from_numpy(np.array(g)), torch.from_numpy(np.array(h))
        return fn

    monkeypatch.setattr(PO, "binary_grad_hess", route(JO.binary_grad_hess))
    monkeypatch.setattr(PO, "multiclass_grad_hess", route(JO.multiclass_grad_hess))


def make_mixed(n=600, seed=0, objective="binary"):
    """Numerical columns 0-2; categorical columns 3 (12 levels, 5% NaN),
    4 (5 levels) and 5 (40 levels) with a per-level effect."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[:, 3] = rng.integers(0, 12, n)
    x[:, 4] = rng.integers(0, 5, n)
    x[:, 5] = rng.integers(0, 40, n)
    x[rng.random(n) < 0.05, 3] = np.nan
    e = rng.normal(size=40)
    f = x[:, 0] + e[x[:, 5].astype(int)] + 0.5 * np.isin(x[:, 4], (1, 3))
    if objective == "regression":
        y = f + rng.normal(size=n) * 0.3
    elif objective == "multiclass":
        y = np.digitize(f, [-0.5, 0.5]).astype(np.float64)
    else:
        y = (f + rng.normal(size=n) * 0.3 > 0).astype(np.float64)
    return x, y.astype(np.float64)


def make_categorical(n=1200, seed=3):
    """The JAX package's test data: the label is membership of a 12-way
    category in {2, 5, 7, 11}, 5% flipped."""
    r = np.random.default_rng(seed)
    cat = r.integers(0, 12, size=n).astype(np.float32)
    noise = r.normal(size=(n, 3)).astype(np.float32)
    y = np.isin(cat, [2, 5, 7, 11]).astype(np.float64)
    y = np.where(r.random(n) < 0.05, 1 - y, y)
    return np.column_stack([cat, noise]).astype(np.float32), y


def assert_same_cat_trees(ref, port):
    assert len(port.trees) == len(ref.trees) > 0
    for i, (a, b) in enumerate(zip(ref.trees, port.trees)):
        for f in ("leaf", "feature", "active", "threshold", "counts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"tree {i} {f}")
        np.testing.assert_allclose(b.values, a.values, rtol=RTOL, atol=ATOL, err_msg=f"tree {i}")
        np.testing.assert_allclose(b.gain, a.gain, rtol=RTOL, atol=ATOL, err_msg=f"tree {i}")
        assert (a.is_cat is None) == (b.is_cat is None), f"tree {i}"
        if a.is_cat is not None:
            np.testing.assert_array_equal(b.is_cat, a.is_cat, err_msg=f"tree {i}")
            np.testing.assert_array_equal(b.catmask, a.catmask, err_msg=f"tree {i}")


# -- identity bins ---------------------------------------------------------------


@pytest.mark.parametrize("max_bin", [255, 63, 16])
def test_identity_bins_equal_jax(max_bin):
    x, _ = make_mixed(n=3000, seed=1)
    x[:, 5] = np.minimum(x[:, 5], max_bin - 2)
    cats = (3, 4, 5)
    ref = JBinMapper.fit(x, max_bin=max_bin, seed=2, categorical_features=cats)
    port = BinMapper.fit(x, max_bin=max_bin, seed=2, categorical_features=cats)
    np.testing.assert_array_equal(port.transform(x), ref.transform(x))
    for f in cats:
        np.testing.assert_array_equal(port.uppers[f], ref.uppers[f])
        col = x[:, f]
        ok = ~np.isnan(col)
        np.testing.assert_array_equal(port.transform(x)[ok, f], col[ok].astype(np.int64) + 1)


@pytest.mark.parametrize("values,match", [
    ([0, 1, 2, 300], "categorical feature 0"),
    ([-1, 0, 1, 2], "re-index"),
    ([0, 1, 2, 254], "outside"),
], ids=["above", "negative", "one_past_max"])
def test_out_of_range_categories_raise_as_in_jax(values, match):
    x = np.column_stack([np.array(values, np.float32), np.zeros(4, np.float32)])
    with pytest.raises(ValueError, match=match):
        JBinMapper.fit(x, max_bin=255, categorical_features=(0,))
    with pytest.raises(ValueError, match=match):
        BinMapper.fit(x, max_bin=255, categorical_features=(0,))


def test_out_of_range_is_scanned_over_the_full_column():
    """The bad value sits outside the binning sample; it still raises."""
    x = np.zeros((5000, 2), np.float32)
    x[:, 0] = np.arange(5000) % 7
    x[4321, 0] = 999
    with pytest.raises(ValueError, match="categorical feature 0"):
        BinMapper.fit(x, max_bin=255, sample=100, categorical_features=(0,))


def test_sparse_categorical_rejected():
    from scipy.sparse import csr_matrix

    x = csr_matrix(np.eye(6, dtype=np.float32))
    with pytest.raises(ValueError, match="dense"):
        JBinMapper.fit(x, categorical_features=(0,))
    with pytest.raises(ValueError, match="dense"):
        BinMapper.fit(x, categorical_features=(0,))


@pytest.mark.parametrize("B", [256, 64])
def test_category_bin_slot_equals_jax(B):
    vals = np.array([np.nan, -np.inf, -1e30, -3.0, -1.0, -0.6, -0.4, 0.0, 0.4, 0.6, 2.5,
                     3.5, 11.0, 61.7, 62.0, 252.0, 253.0, 253.6, 254.0, 300.0, 1e30, np.inf],
                    np.float32)
    want = JG.category_bin_slot(vals, B, np)
    np.testing.assert_array_equal(PG.category_bin_slot(vals, B), want)
    got_t = PG.category_bin_slot(torch.from_numpy(vals), B)
    np.testing.assert_array_equal(got_t.numpy(), want)


# -- split search -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_leaf_best_equals_jax(seed):
    """Random planes with empty bins, zero gradients (+0.0 and -0.0) and
    exact ties: gain, feature, bin (prefix length - 1) and left set equal
    the JAX package's ``make_leaf_best``."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    P, d, B = 4, 5, 32
    c = rng.integers(0, 6, size=(P, d, B)).astype(np.float32)
    c[rng.random((P, d, B)) < 0.3] = 0.0
    g = np.round(rng.normal(size=(P, d, B)), 1).astype(np.float32) * (c > 0)
    g[rng.random((P, d, B)) < 0.2] = -0.0
    h = (c * 0.25).astype(np.float32)
    planes = np.stack([g, h, c], -1).reshape(P, d * B, 3)
    fm = np.ones(d, np.float32)
    fm[1] = 0.0
    cat_f = np.array([True, False, True, True, False])
    kw = dict(lambda_l2=1.0, lambda_l1=0.1, min_sum_hessian=1e-3)
    ref_fn = JG.make_leaf_best(d, jnp.asarray(fm), 3, kw["min_sum_hessian"], kw["lambda_l2"],
                               kw["lambda_l1"], jnp.asarray(cat_f), True, num_bins=B)
    rg, rf, rb, rc = (np.array(a) for a in jax.vmap(ref_fn)(jnp.asarray(planes)))
    sp = PG.SplitParams.make(CPU, min_gain=0.0, learning_rate=0.1, **kw)
    port_fn = PG.make_leaf_best(d, torch.from_numpy(fm), 3, sp, num_bins=B,
                                cat_f=torch.from_numpy(cat_f))
    pg_, pf, pb, pc = port_fn(torch.from_numpy(planes))
    np.testing.assert_array_equal(pg_.numpy(), rg)
    np.testing.assert_array_equal(pf.numpy(), rf)
    np.testing.assert_array_equal(pb.numpy(), rb)
    np.testing.assert_array_equal(pc.numpy(), rc)


def test_leaf_best_without_categorical_returns_no_mask():
    planes = torch.rand(2, 3 * 16, 3)
    sp = PG.SplitParams.make(CPU, lambda_l2=1.0, lambda_l1=0.0, min_sum_hessian=1e-3,
                             min_gain=0.0, learning_rate=0.1)
    out = PG.make_leaf_best(3, torch.ones(3), 1, sp, num_bins=16)(planes)
    assert len(out) == 4 and out[3] is None


# -- whole fits ----------------------------------------------------------------------


FITS = [
    ("binary", "lossguide", 255, {}),
    ("binary", "depthwise", 255, {}),
    ("binary", "lossguide", 63, {}),
    ("regression", "lossguide", 255, {}),
    ("regression", "depthwise", 63, {}),
    ("multiclass", "lossguide", 255, {}),
    ("multiclass", "depthwise", 255, {}),
    ("regression", "lossguide", 255, dict(boosting_type="dart", drop_rate=0.5,
                                          skip_drop=0.2)),
    ("binary", "depthwise", 255, dict(boosting_type="goss")),
    ("regression", "depthwise", 255, dict(bagging_fraction=0.7, bagging_freq=1,
                                          feature_fraction=0.8)),
]


@pytest.mark.parametrize("objective,policy,max_bin,extra", FITS)
def test_categorical_fit_equals_jax(reference_device_grower, jax_gradients, objective,
                                    policy, max_bin, extra):
    x, y = make_mixed(objective=objective)
    k = 3 if objective == "multiclass" else 1
    cfg = dict(objective=objective, num_class=k, num_iterations=5, num_leaves=15,
               min_data_in_leaf=5, growth_policy=policy, max_bin=max_bin,
               categorical_features=(3, 4, 5), seed=2, **extra)
    ref = JT.train(x, y, JT.TrainConfig(**cfg), shard=False)
    port = train(x, y, TrainConfig(**cfg), device="cpu")
    assert_same_cat_trees(ref, port)
    assert any(t.has_categorical for t in port.trees)
    if not extra:
        # the same records give the same JSON and LightGBM text, byte for byte
        assert port.to_model_string() == ref.to_model_string()
        assert port.to_lightgbm_string() == ref.to_lightgbm_string()
    np.testing.assert_allclose(port.predict_raw(x, device="cpu"), ref.predict_raw(x),
                               rtol=RTOL, atol=ATOL)


def _unusual_rows(x: np.ndarray) -> np.ndarray:
    """Rows whose categorical values are NaN, never seen in training (40 is
    above column 3's levels), fractional, negative, past the bin space, or
    +-1e30 and +-inf."""
    rows = np.repeat(x[:12], 12, axis=0).copy()
    odd = np.array([np.nan, 40.0, 2.4, 2.6, -3.0, 253.0, 254.0, 300.0, 1e30, -1e30,
                     np.inf, -np.inf], np.float32)
    for f in (3, 4, 5):
        rows[:, f] = np.tile(odd, 12)
    rows[::5, 0] = np.nan
    return rows


@pytest.mark.parametrize("policy", ["lossguide", "depthwise"])
def test_predict_leaves_equals_jax_on_unusual_categories(reference_device_grower, policy):
    x, y = make_mixed(objective="regression", seed=3)
    cfg = dict(objective="regression", num_iterations=4, num_leaves=15, min_data_in_leaf=5,
               growth_policy=policy, categorical_features=(3, 4, 5))
    ref = JT.train(x, y, JT.TrainConfig(**cfg), shard=False)
    port = Booster.from_model_string(ref.to_model_string())
    rows = np.concatenate([x[:50], _unusual_rows(x)])
    np.testing.assert_array_equal(port.predict_leaf(rows, device="cpu"), ref.predict_leaf(rows))
    np.testing.assert_array_equal(port.predict_raw(rows, device="cpu"), ref.predict_raw(rows))


def test_unseen_category_routes_right():
    """A category absent at fit time takes the right branch of every
    categorical split ("the other categories")."""
    x, y = make_categorical(n=600)
    seen = x[:, 0] != 9.0
    cfg = TrainConfig(objective="binary", num_iterations=3, num_leaves=4, min_data_in_leaf=5,
                      categorical_features=(0,))
    b = train(x[seen], y[seen], cfg, device="cpu")
    assert any(t.has_categorical for t in b.trees)
    for t in b.trees:
        if t.has_categorical:
            assert not t.catmask[t.is_cat][:, 10].any()   # category 9 is bin 10
    p = b.predict_raw(x[~seen], device="cpu")
    assert np.isfinite(p).all()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_json_model_strings_cross_load(reference_device_grower, jax_gradients, direction):
    x, y = make_mixed(seed=5)
    cfg = dict(objective="binary", num_iterations=4, num_leaves=7, min_data_in_leaf=5,
               categorical_features=(3, 4, 5))
    rows = np.concatenate([x, _unusual_rows(x)])
    if direction == "jax_to_port":
        src = JT.train(x, y, JT.TrainConfig(**cfg), shard=False, base_score=0.1)
        back = Booster.from_model_string(src.to_model_string())
        got, want = back.predict_raw(rows, device="cpu"), src.predict_raw(rows)
    else:
        src = train(x, y, TrainConfig(**cfg), device="cpu", base_score=0.1)
        back = JBooster.from_model_string(src.to_model_string())
        got, want = back.predict_raw(rows), src.predict_raw(rows, device="cpu")
    assert '"cat_splits"' in src.to_model_string()
    assert back.to_model_string() == src.to_model_string()
    np.testing.assert_array_equal(got, want)


def test_booster_from_reference_carries_catmasks(reference_device_grower):
    x, y = make_mixed(objective="regression", seed=6)
    ref = JT.train(x, y, JT.TrainConfig(objective="regression", num_iterations=3,
                                        num_leaves=7, min_data_in_leaf=5,
                                        categorical_features=(3, 4, 5)), shard=False)
    fields = ("leaf", "feature", "threshold", "active", "gain", "values", "counts")
    trees = []
    for t in ref.trees:
        tr = {f: getattr(t, f) for f in fields}
        if t.has_categorical:
            # a narrower mask (histogram space) is padded to the record space
            tr.update(is_cat=t.is_cat, catmask=t.catmask[:, :64])
        trees.append(tr)
    port = booster_from_reference(trees, objective="regression", num_class=1,
                                  num_features=x.shape[1], base_score=ref.base_score)
    assert port.to_model_string() == ref.to_model_string()
    rows = np.concatenate([x, _unusual_rows(x)])
    np.testing.assert_array_equal(port.predict_raw(rows, device="cpu"), ref.predict_raw(rows))


# -- the JAX package's categorical cases, on the port ------------------------------


def test_categorical_split_beats_numeric():
    x, y = make_categorical()
    split = 900
    tr = DataFrame.from_dict({"features": x[:split], "label": y[:split]})
    te_y = y[split:]
    te = DataFrame.from_dict({"features": x[split:], "label": te_y})

    def auc_of(**kw):
        m = LightGBMClassifier(num_iterations=8, num_leaves=4, min_data_in_leaf=5, seed=7,
                               device="cpu", **kw).fit(tr)
        return binary_auc(te_y, m.transform(te)["probability"][:, 1]), m

    auc_cat, model_cat = auc_of(categorical_slot_indexes=[0])
    auc_num, _ = auc_of()
    assert auc_cat > 0.93, f"categorical AUC {auc_cat:.3f}"
    assert auc_cat > auc_num + 0.02, f"cat {auc_cat:.3f} vs num {auc_num:.3f}"
    assert any(t.has_categorical for t in Booster.from_model_string(
        model_cat.get("model_string")).trees)


def test_categorical_model_string_roundtrip():
    x, y = make_categorical(n=600)
    cfg = TrainConfig(objective="binary", num_iterations=5, num_leaves=4, min_data_in_leaf=5,
                      categorical_features=(0,))
    b = train(x, y, cfg, device="cpu")
    assert any(t.has_categorical for t in b.trees)
    b2 = Booster.from_model_string(b.to_model_string())
    assert b2.to_model_string() == b.to_model_string()
    np.testing.assert_array_equal(b2.predict_raw(x, device="cpu"), b.predict_raw(x, device="cpu"))
    for t1, t2 in zip(b.trees, b2.trees):
        if t1.has_categorical:
            np.testing.assert_array_equal(t1.is_cat, t2.is_cat)
            np.testing.assert_array_equal(t1.catmask, t2.catmask)


def test_categorical_training_prediction_consistency():
    """Scoring from raw values routes the training rows as the fit did
    from their bins: the training rows' leaves are the grown ones."""
    x, y = make_categorical(n=800)
    cfg = TrainConfig(objective="binary", num_iterations=3, num_leaves=6, min_data_in_leaf=5,
                      categorical_features=(0,))
    b = train(x, y, cfg, device="cpu")
    p = 1.0 / (1.0 + np.exp(-b.predict_raw(x, device="cpu")))
    assert binary_auc(y, p) > 0.9
    leaves = b.predict_leaf(x, device="cpu")
    for i, t in enumerate(b.trees):
        np.testing.assert_array_equal(np.bincount(leaves[:, i], minlength=len(t.counts)),
                                      t.counts)
