"""The port's LightGBM text format and SHAP contributions against the JAX
package's, on the CPU.

Each case is a booster the JAX package fit (or parsed), carried into the
port through its JSON model string. Tolerances: LightGBM text byte-equal;
parsed ``Tree`` arrays equal; contributions within 1e-9 of the JAX
package's (both are host numpy in f64); contribution rows sum to
``predict_raw`` within 1e-5 (f32 scores); round-trips score within 1e-6
(exact where both sides replay the same f32 values).
"""

from __future__ import annotations

import functools
import importlib
import logging

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import (
    Booster,
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
    TrainConfig,
    train,
)
from mmlspark_tpu_torch.models.gbdt.treeshap import _BinaryTree, shap_values

JT = importlib.import_module("mmlspark_tpu.models.gbdt.train")

torch.set_num_threads(1)

SHAP_TOL = 1e-9
SUM_TOL = 1e-5
ATOL = 1e-6
TREE_FIELDS = ("leaf", "feature", "threshold", "active", "gain", "values", "counts")


def _xy(n=400, d=6, seed=0, classes=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if classes == 2:
        y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    else:
        y = np.digitize(x[:, 0], [-0.5, 0.5]).astype(np.float64)
    return x, y


def _cat_xy(n=500, seed=4):
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 6, size=n).astype(np.float32)
    cat[rng.random(n) < 0.2] = np.nan
    x = np.stack([cat, rng.normal(size=n).astype(np.float32),
                  rng.integers(0, 4, size=n).astype(np.float32)], 1)
    y = (np.isin(np.nan_to_num(cat, nan=1.0), (1.0, 4.0)) | (x[:, 1] > 1.0)).astype(np.float64)
    return x, y


def _one_split_model(decision_type: int, objective: str = "regression") -> str:
    return "\n".join([
        "tree", "version=v3", "num_class=1", "num_tree_per_iteration=1", "label_index=0",
        "max_feature_idx=1", f"objective={objective}", "feature_names=f0 f1",
        "feature_infos=[-1e308:1e308] [-1e308:1e308]", "", "Tree=0", "num_leaves=2",
        "num_cat=0", "split_feature=0", "split_gain=1.0", "threshold=0.5",
        f"decision_type={decision_type}", "left_child=-1", "right_child=-2",
        "leaf_value=1.0 3.0", "leaf_count=5 5", "internal_value=2.0", "internal_count=10",
        "shrinkage=1", "", "end of trees", "",
    ])


def _jfit(x, y, base_score=0.0, valid_mask=None, **cfg):
    kw = dict(num_iterations=8, num_leaves=15, min_data_in_leaf=5, seed=1)
    kw.update(cfg)
    return JT.train(x, y, JT.TrainConfig(**kw), shard=False, base_score=base_score,
                    valid_mask=valid_mask)


@functools.lru_cache(maxsize=None)
def jax_case(name: str):
    """(JAX booster, rows to score) of each case."""
    x, y = _xy()
    if name == "binary":
        return _jfit(x, y, 0.37, objective="binary"), x
    if name == "rf":
        return _jfit(x, y, 0.2, objective="binary", boosting_type="rf"), x
    if name == "dart":
        return _jfit(x, y, objective="binary", boosting_type="dart", drop_rate=0.5,
                     skip_drop=0.2), x
    if name == "multiclass":
        x3, y3 = _xy(classes=3)
        return _jfit(x3, y3, np.array([0.1, -0.2, 0.05], np.float32), objective="multiclass",
                     num_class=3, num_iterations=5, num_leaves=7), x3
    if name == "regression":
        yr = (x[:, 0] * 2 + np.sin(x[:, 1])).astype(np.float64)
        return _jfit(x, yr, float(yr.mean()), objective="regression"), x
    if name == "quantile":
        yr = (x[:, 0] * 2 + np.sin(x[:, 1])).astype(np.float64)
        return _jfit(x, yr, float(np.median(yr)), objective="quantile", alpha=0.7), x
    if name == "categorical":
        xc, yc = _cat_xy()
        return _jfit(xc, yc, objective="binary", num_iterations=4, num_leaves=7,
                     categorical_features=(0, 2)), xc
    if name == "early_stopped":
        vm = np.random.default_rng(5).random(len(y)) < 0.3
        b = _jfit(x, y, objective="binary", num_iterations=40, num_leaves=7,
                  early_stopping_round=2, valid_mask=vm)
        assert b.best_iteration > 0
        return b, x
    if name == "missing":
        xn = x.copy()
        xn[::7, 0] = np.nan
        return _jfit(xn, y, objective="binary", num_iterations=6), xn
    if name == "default_right":
        xd = np.array([[np.nan, 0.0], [0.1, 0.0], [0.9, np.nan], [0.5, 1.0]], np.float32)
        return JBooster.from_lightgbm_string(_one_split_model(8)), xd
    raise KeyError(name)


CASES = ["binary", "rf", "dart", "multiclass", "regression", "quantile", "categorical",
         "early_stopped", "missing", "default_right"]


def port_of(ref) -> Booster:
    b = Booster.from_model_string(ref.to_model_string())
    b.best_iteration = ref.best_iteration
    return b


def assert_same_tree_arrays(port_trees, ref_trees):
    assert len(port_trees) == len(ref_trees)
    for i, (a, b) in enumerate(zip(ref_trees, port_trees)):
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"tree {i} {f}")
        for f in ("is_cat", "catmask", "default_left"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None), f"tree {i} {f}"
            if va is not None:
                np.testing.assert_array_equal(vb, va, err_msg=f"tree {i} {f}")


# -- LightGBM's text format ------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_lightgbm_text_byte_equal_to_jax(name):
    ref, _ = jax_case(name)
    assert port_of(ref).to_lightgbm_string() == ref.to_lightgbm_string()


@pytest.mark.parametrize("name", CASES)
def test_jax_written_text_parses_to_equal_trees(name):
    ref, x = jax_case(name)
    text = ref.to_lightgbm_string()
    want = JBooster.from_lightgbm_string(text)
    got = Booster.from_lightgbm_string(text)
    assert_same_tree_arrays(got.trees, want.trees)
    for f in ("objective", "num_class", "num_features", "boosting_type", "sigmoid",
              "objective_param", "feature_names"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(np.asarray(got.base_score), np.asarray(want.base_score))
    assert got.to_lightgbm_string() == want.to_lightgbm_string()
    assert got.to_model_string() == want.to_model_string()
    np.testing.assert_array_equal(got.predict_raw(x, device="cpu"), want.predict_raw(x))


@pytest.mark.parametrize("name", CASES)
def test_text_round_trip_scores_the_same(name):
    """The port's own round trip: an early-stopped booster exports exactly
    its best prefix, so both score the same."""
    ref, x = jax_case(name)
    b = port_of(ref)
    b2 = Booster.from_model_string(b.to_lightgbm_string())   # the text path of from_model_string
    if b.best_iteration > 0:
        assert len(b2.trees) == b.best_iteration * b.num_class
    np.testing.assert_allclose(b2.predict_raw(x, device="cpu"), b.predict_raw(x, device="cpu"),
                               rtol=1e-5, atol=1e-5)


def test_numerical_export_declares_nan_missing_type():
    text = port_of(jax_case("binary")[0]).to_lightgbm_string()
    dt_line = next(ln for ln in text.splitlines() if ln.startswith("decision_type="))
    assert set(dt_line.split("=", 1)[1].split()) == {"10"}


def test_categorical_export_carries_cat_threshold():
    text = port_of(jax_case("categorical")[0]).to_lightgbm_string()
    assert "num_cat=" in text and "cat_threshold=" in text and "cat_boundaries=" in text


FIXTURE = """tree
version=v3
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=1
objective=binary sigmoid:1
feature_names=f0 f1
feature_infos=[-3:3] [-3:3]
tree_sizes=327

Tree=0
num_leaves=3
num_cat=0
split_feature=0 1
split_gain=10 5
threshold=0.5 -1.25
decision_type=2 2
left_child=1 -2
right_child=-1 -3
leaf_value=0.3 -0.2 0.1
leaf_weight=50 30 20
leaf_count=50 30 20
internal_value=0.05 -0.08
internal_weight=100 50
internal_count=100 50
shrinkage=1


end of trees

feature_importances:
f0=1
f1=1

parameters:
[boosting: gbdt]
end of parameters

pandas_categorical:null
"""


def test_native_fixture_parse_and_route():
    b = Booster.from_lightgbm_string(FIXTURE)
    assert b.objective == "binary" and b.num_features == 2 and b.feature_names == ["f0", "f1"]
    x = np.array([[1.0, 0.0], [0.0, -2.0], [0.0, 0.0], [np.nan, 0.0]], np.float32)
    np.testing.assert_allclose(b.predict_raw(x, device="cpu"), [0.3, -0.2, 0.1, 0.1], atol=1e-6)
    assert_same_tree_arrays(b.trees, JBooster.from_lightgbm_string(FIXTURE).trees)


def test_model_string_param_accepts_native_text():
    m = LightGBMClassificationModel(features_col="features", device="cpu")
    m.set(model_string=FIXTURE)
    out = m.transform(DataFrame.from_dict(
        {"features": np.array([[1.0, 0.0], [0.0, -2.0]], np.float32)}))
    np.testing.assert_array_equal(out["prediction"], [1.0, 0.0])


def test_default_left_bit_routes_nan():
    x = np.array([[0.2, 0.0], [0.9, 0.0], [np.nan, 0.0]], np.float32)
    left = Booster.from_lightgbm_string(_one_split_model(10))
    right = Booster.from_lightgbm_string(_one_split_model(8))
    np.testing.assert_allclose(left.predict(x, device="cpu"), [1.0, 3.0, 1.0])
    np.testing.assert_allclose(right.predict(x, device="cpu"), [1.0, 3.0, 3.0])


def test_default_right_roundtrips_all_formats():
    x = np.array([[np.nan, 0.0], [0.1, 0.0]], np.float32)
    m = Booster.from_lightgbm_string(_one_split_model(8))
    want = m.predict(x, device="cpu")
    back = Booster.from_model_string(m.to_model_string())
    np.testing.assert_allclose(back.predict(x, device="cpu"), want)
    text = m.to_lightgbm_string()
    assert "decision_type=8" in text
    np.testing.assert_allclose(Booster.from_lightgbm_string(text).predict(x, device="cpu"), want)


def test_missing_type_warning_once_per_model(caplog):
    one = _one_split_model(2)
    two_trees = one.replace("end of trees", "").rstrip() + "\n"
    two_trees += "\nTree=1\n" + one.split("Tree=0\n", 1)[1].replace(
        "end of trees", "").rstrip() + "\n\nend of trees\n"
    with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch.gbdt"):
        Booster.from_lightgbm_string(two_trees)
    assert len([r for r in caplog.records if "missing_type" in r.message]) == 1


def test_imported_sigmoid_slope_applied():
    text = _one_split_model(10, objective="binary sigmoid:2")
    model = LightGBMClassificationModel.load_native_model_from_string(text, device="cpu")
    assert model.booster.sigmoid == 2.0
    x = np.array([[0.2, 0.0], [0.9, 0.0]], np.float32)
    out = model.transform(DataFrame.from_dict({"features": x}))
    raw = model.booster.predict_raw(x, device="cpu")
    np.testing.assert_allclose(out["probability"][:, 1], 1.0 / (1.0 + np.exp(-2.0 * raw)),
                               rtol=1e-6)


def test_malformed_native_text_fails_at_load():
    with pytest.raises(ValueError, match="LightGBM model string"):
        LightGBMRegressionModel.load_native_model_from_string("tree\nversion=v3\n")


@pytest.mark.parametrize("estimator,model_cls,label", [
    (LightGBMClassifier, LightGBMClassificationModel, "binary"),
    (LightGBMRegressor, LightGBMRegressionModel, "regression"),
])
def test_save_and_load_native_model(tmp_path, estimator, model_cls, label):
    x, y = _xy()
    if label == "regression":
        y = (x[:, 0] * 2).astype(np.float64)
    df = DataFrame.from_dict({"features": x, "label": y})
    m = estimator(num_iterations=6, num_leaves=15, seed=3, device="cpu").fit(df)
    path = str(tmp_path / "model.txt")
    m.save_native_model(path)
    with open(path) as f:
        text = f.read()
    assert text.startswith("tree\nversion=v3")
    assert text == JBooster.from_model_string(m.get("model_string")).to_lightgbm_string()
    m2 = model_cls.load_native_model_from_file(path, features_col="features", device="cpu")
    col = "probability" if label == "binary" else "prediction"
    np.testing.assert_allclose(m2.transform(df)[col], m.transform(df)[col], rtol=1e-5,
                               atol=1e-5)


def test_ranker_model_loads_native_text(tmp_path):
    ref, x = jax_case("regression")
    path = str(tmp_path / "rank.txt")
    with open(path, "w") as f:
        f.write(ref.to_lightgbm_string())
    m = LightGBMRankerModel.load_native_model_from_file(path, features_col="features",
                                                        device="cpu")
    np.testing.assert_allclose(m.booster.predict_raw(x, device="cpu"), ref.predict_raw(x),
                               rtol=0, atol=ATOL)


# -- SHAP ----------------------------------------------------------------------------


@pytest.mark.parametrize("approximate", [False, True], ids=["exact", "saabas"])
@pytest.mark.parametrize("name", CASES)
def test_feature_contribs_equal_jax(name, approximate):
    ref, x = jax_case(name)
    rows = x[:40]
    got = port_of(ref).feature_contribs(rows, approximate=approximate)
    want = ref.feature_contribs(rows, approximate=approximate)
    assert got.dtype == np.float64 and got.shape == (len(rows), x.shape[1] + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHAP_TOL)
    raw = port_of(ref).predict_raw(rows, device="cpu")
    if raw.ndim == 2:   # multiclass: one row of contributions over every class's trees
        raw = raw.astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(got.sum(axis=1), raw, rtol=SUM_TOL, atol=SUM_TOL)


def test_features_shap_on_the_model_equals_jax():
    ref, x = jax_case("categorical")
    m = LightGBMClassificationModel(features_col="features", device="cpu")
    m.set(model_string=ref.to_model_string())
    np.testing.assert_allclose(m.features_shap(x[:30]), ref.feature_contribs(x[:30]),
                               rtol=0, atol=SHAP_TOL)
    np.testing.assert_allclose(m.features_shap(x[:30], approximate=True),
                               ref.feature_contribs(x[:30], approximate=True),
                               rtol=0, atol=SHAP_TOL)
    np.testing.assert_array_equal(m.predict_leaf(x[:30]), ref.predict_leaf(x[:30]))


@pytest.mark.parametrize("kind", ["split", "gain"])
def test_feature_importances_equal_jax(kind):
    ref, _ = jax_case("multiclass")
    np.testing.assert_array_equal(port_of(ref).feature_importances(kind),
                                  ref.feature_importances(kind))


def test_dump_model_equals_jax():
    ref, _ = jax_case("categorical")
    assert port_of(ref).dump_model() == ref.dump_model()


def _small_model(d=4, n=300, leaves=8, iters=3, seed=0, cat=()):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    for f in cat:
        x[:, f] = r.integers(0, 4, size=n)
    y = (x[:, 0] + 0.5 * x[:, 1] * (x[:, 2] > 0) > 0).astype(np.float64)
    cfg = TrainConfig(objective="binary", num_iterations=iters, num_leaves=leaves,
                      min_data_in_leaf=10, seed=seed, categorical_features=cat)
    return train(x, y, cfg, device="cpu"), x


def _brute_shapley(tree, x_row, d):
    """Shapley values from their definition, with TreeSHAP's cover-weighted
    conditional expectation."""
    import itertools
    import math

    bt = _BinaryTree(tree)

    def cond_exp(node, subset):
        if bt.left[node] < 0:
            return bt.value[node]
        f = int(bt.feature[node])
        left, right = bt.left[node], bt.right[node]
        if f in subset:
            return cond_exp(left if bt.goes_left(x_row, node) else right, subset)
        c = bt.cover[node]
        return (bt.cover[left] / c * cond_exp(left, subset)
                + bt.cover[right] / c * cond_exp(right, subset))

    phi = np.zeros(d + 1)
    phi[d] = cond_exp(0, frozenset())
    for j in range(d):
        others = [f for f in range(d) if f != j]
        for k in range(len(others) + 1):
            for s in itertools.combinations(others, k):
                s = frozenset(s)
                w = math.factorial(len(s)) * math.factorial(d - len(s) - 1) / math.factorial(d)
                phi[j] += w * (cond_exp(0, s | {j}) - cond_exp(0, s))
    return phi


@pytest.mark.parametrize("cat", [(), (3,)], ids=["numerical", "categorical"])
def test_exact_shap_matches_brute_force(cat):
    booster, x = _small_model(cat=cat)
    tree = booster.trees[0]
    got = shap_values(tree, x[:5].astype(np.float64))
    for i in range(5):
        np.testing.assert_allclose(got[i], _brute_shapley(tree, x[i], x.shape[1]),
                                   rtol=1e-6, atol=1e-8)


def test_saabas_and_exact_share_sum_but_differ():
    booster, x = _small_model(iters=4)
    exact = booster.feature_contribs(x[:30])
    approx = booster.feature_contribs(x[:30], approximate=True)
    np.testing.assert_allclose(exact.sum(axis=1), approx.sum(axis=1), rtol=1e-4, atol=1e-4)
    assert np.abs(exact[:, :-1] - approx[:, :-1]).max() > 1e-6


def test_exact_shap_nan_and_best_iteration():
    booster, x = _small_model(iters=5)
    xt = x[:8].astype(np.float64).copy()
    xt[:, 0] = np.nan
    np.testing.assert_allclose(booster.feature_contribs(xt).sum(axis=1),
                               booster.predict_raw(xt.astype(np.float32), device="cpu"),
                               rtol=SUM_TOL, atol=SUM_TOL)
    booster.best_iteration = 2
    np.testing.assert_allclose(booster.feature_contribs(x[:12]).sum(axis=1),
                               booster.predict_raw(x[:12], device="cpu"),
                               rtol=SUM_TOL, atol=SUM_TOL)
