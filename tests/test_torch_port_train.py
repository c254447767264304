"""The port's ``train/`` (TrainClassifier, TrainRegressor, OneVsRest,
ComputeModelStatistics, ComputePerInstanceStatistics) against the JAX
package's, on the CPU.

The same seeded frame (numeric and string columns, a string label, as
UCI Adult has) goes through both packages; the port's inner learners run
with ``device="cpu"``. Tolerances, the same as the inner learner's own
parity tests hold it to:

- label levels, the featurizer's plans and its output: equal, bitwise;
- LightGBM inner models (``tests/test_torch_port_gbdt.py``, with the JAX
  package's gradients and device grower): split records equal, leaf values
  and gains within RTOL=1e-4, ATOL=1e-6; probabilities within
  ``PROB_ATOL``, predictions equal;
- LogisticRegression (``tests/test_torch_port_pipeline.py``, 30 GD
  steps): weights within ``2e-6 * max |w|``; a carried model's logits
  within ``1e-6 * max |logit|``, probabilities within 1e-6, predictions
  equal except at near ties;
- LinearRegression: weights within ``1e-5 * max |w|``, a carried model's
  predictions bitwise;
- the statistics stages (host numpy in f64 on both sides): equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mmlspark_tpu as J
from mmlspark_tpu.core.pipeline import PipelineStage as JStage
from mmlspark_tpu.models.gbdt import LightGBMClassifier as JLightGBMClassifier
from mmlspark_tpu.models.gbdt import objectives as JO
from mmlspark_tpu.models.linear import LogisticRegression as JLogisticRegression
from mmlspark_tpu.train import ComputeModelStatistics as JStats
from mmlspark_tpu.train import ComputePerInstanceStatistics as JPerInstance
from mmlspark_tpu.train import OneVsRest as JOneVsRest
from mmlspark_tpu.train import TrainClassifier as JTrainClassifier
from mmlspark_tpu.train import TrainRegressor as JTrainRegressor

import mmlspark_tpu_torch as P
from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier
from mmlspark_tpu_torch.models.gbdt import objectives as PO
from mmlspark_tpu_torch.models.linear import LinearRegression, LogisticRegression
from mmlspark_tpu_torch.train import (
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
    OneVsRest,
    OneVsRestModel,
    TrainClassifier,
    TrainedClassifierModel,
    TrainedRegressorModel,
    TrainRegressor,
)

from conftest import make_tabular_df

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
PROB_ATOL = 1e-6
FIT_RTOL = 2e-6
LOGIT_RTOL = 1e-6
LINREG_RTOL = 1e-5
GBDT = dict(num_iterations=8, num_leaves=7, min_data_in_leaf=5, seed=3)


def adult_like(n: int = 600, seed: int = 0) -> dict:
    """UCI Adult's column kinds at a small size: numeric columns, string
    columns of a few levels, a string label planted on both."""
    r = np.random.default_rng(seed)
    cols = {
        "age": r.integers(17, 90, n).astype(np.float64),
        "hours_per_week": np.round(r.normal(40, 12, n)),
        "capital_gain": np.where(r.random(n) < 0.1, r.exponential(5000, n), 0.0),
        "workclass": np.array(r.choice(["Private", "Self-emp", "Gov", "?"], n), dtype=object),
        "education": np.array(r.choice(["HS", "Some-college", "Bachelors", "Masters"], n),
                              dtype=object),
        "sex": np.array(r.choice(["Male", "Female"], n), dtype=object),
    }
    score = (cols["age"] - 40) / 15 + (cols["education"] == "Masters") * 1.2 \
        + (cols["capital_gain"] > 0) * 1.5 + r.normal(0, 0.7, n)
    cols["income"] = np.where(score > 0.8, ">50K", "<=50K").astype(object)
    return cols


def frames(cols: dict, parts: int = 2) -> tuple:
    return (J.DataFrame.from_dict(cols, num_partitions=parts),
            P.DataFrame.from_dict(cols, num_partitions=parts))


def jax_parts(stage) -> dict:
    """A JAX fitted stage as ``{"class", "params"}`` of numpy arrays,
    strings and plain values, nested stages included."""
    def conv(v):
        if isinstance(v, JStage):
            return jax_parts(v)
        if isinstance(v, list) and v and all(isinstance(x, JStage) for x in v):
            return [jax_parts(x) for x in v]
        if hasattr(v, "__array__") and not isinstance(v, (np.ndarray, list, dict)):
            return np.asarray(v)
        return v
    return {"class": type(stage).__name__,
            "params": {k: conv(v) for k, _, v in stage.iter_set_params()}}


@pytest.fixture
def parity(monkeypatch):
    """The JAX package's device grower on the CPU, and the port's
    sigmoid/softmax gradients routed through the JAX package's functions
    (XLA's and PyTorch's f32 ``exp`` differ in the last bit)."""
    import jax.numpy as jnp

    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")

    def route(jfn):
        def fn(scores, y):
            g, h = jfn(jnp.asarray(scores.numpy()), jnp.asarray(y.numpy()))
            return torch.from_numpy(np.array(g)), torch.from_numpy(np.array(h))
        return fn

    monkeypatch.setattr(PO, "binary_grad_hess", route(JO.binary_grad_hess))
    monkeypatch.setattr(PO, "multiclass_grad_hess", route(JO.multiclass_grad_hess))


def assert_same_trees(ref, port) -> None:
    assert len(port.trees) == len(ref.trees) > 0
    for i, (a, b) in enumerate(zip(ref.trees, port.trees)):
        for f in ("leaf", "feature", "active", "threshold", "counts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"tree {i} {f}")
        np.testing.assert_allclose(b.values, a.values, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b.gain, a.gain, rtol=RTOL, atol=ATOL)


def assert_featurizers_equal(jm, pm, jdf, pdf) -> None:
    jf, pf = jm.get("featurizer"), pm.get("featurizer")
    assert pf.get("plans") == jf.get("plans")
    assert pf.get("output_col") == jf.get("output_col")
    want = jf.transform(jdf.drop(jm.get("label_col")))["features"]
    got = pf.transform(pdf.drop(pm.get("label_col")))["features"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def adult():
    return adult_like()


def test_train_classifier_lightgbm_equals_jax(parity, adult):
    jdf, pdf = frames(adult)
    jm = JTrainClassifier(label_col="income", model=JLightGBMClassifier(**GBDT)).fit(jdf)
    pm = TrainClassifier(label_col="income",
                         model=LightGBMClassifier(device="cpu", **GBDT)).fit(pdf)
    assert pm.get("levels") == jm.get("levels") == ["<=50K", ">50K"]
    assert_featurizers_equal(jm, pm, jdf, pdf)
    assert_same_trees(jm.get("inner_model").booster, pm.get("inner_model").booster)
    want, got = jm.transform(jdf), pm.transform(pdf)
    assert got.columns == want.columns
    np.testing.assert_array_equal(got["income"], want["income"])
    np.testing.assert_allclose(got["probability"], want["probability"], rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    assert got._metadata["prediction"] == want._metadata["prediction"]
    np.testing.assert_array_equal(pm.get_scored_labels(got)["scored_labels"],
                                  jm.get_scored_labels(want)["scored_labels"])


def test_carried_lightgbm_classifier_scores_as_the_jax_model(adult):
    """A JAX-fitted TrainClassifier model, carried over by its parts,
    scores the JAX package's raw margins bitwise."""
    jdf, pdf = frames(adult)
    jm = JTrainClassifier(label_col="income", model=JLightGBMClassifier(**GBDT)).fit(jdf)
    carried = TrainedClassifierModel.from_jax_params(jax_parts(jm)["params"], device="cpu")
    assert carried.get("inner_model").get("device") == "cpu"
    want, got = jm.transform(jdf), carried.transform(pdf)
    np.testing.assert_array_equal(got["raw_prediction"], want["raw_prediction"])
    np.testing.assert_allclose(got["probability"], want["probability"], rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])


def test_train_classifier_default_learner_is_the_cards_logistic_regression(adult):
    _, pdf = frames(adult)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainClassifier(label_col="income").fit(pdf)
    assert "device" not in TrainClassifier.params()


def test_train_classifier_logistic_within_tolerance(adult):
    jdf, pdf = frames(adult)
    jm = JTrainClassifier(label_col="income", model=JLogisticRegression(max_iter=30)).fit(jdf)
    pm = TrainClassifier(label_col="income",
                         model=LogisticRegression(max_iter=30, device="cpu")).fit(pdf)
    assert_featurizers_equal(jm, pm, jdf, pdf)
    ji, pi = jm.get("inner_model"), pm.get("inner_model")
    for name in ("weights", "bias"):
        want, got = np.asarray(ji.get(name)), pi.get(name)
        assert float(np.abs(got - want).max()) <= FIT_RTOL * float(np.abs(want).max())
    carried = TrainedClassifierModel.from_jax_params(jax_parts(jm)["params"], device="cpu")
    want, got = jm.transform(jdf), carried.transform(pdf)
    tol = LOGIT_RTOL * float(np.abs(want["raw_prediction"]).max())
    assert float(np.abs(got["raw_prediction"] - want["raw_prediction"]).max()) <= tol
    assert float(np.abs(got["probability"] - want["probability"]).max()) <= PROB_ATOL
    top2 = np.sort(want["raw_prediction"], axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * tol
    assert not ((got["prediction"] != want["prediction"]) & ~near_tie).any()


def test_train_classifier_numeric_label_without_reindex():
    r = np.random.default_rng(4)
    cols = {"a": r.normal(size=300), "b": np.array(r.choice(["x", "y"], 300), dtype=object)}
    cols["label"] = ((cols["a"] > 0) ^ (cols["b"] == "x")).astype(np.float64)
    jdf, pdf = frames(cols)
    kw = dict(label_col="label", reindex_label=False, number_of_features=64)
    jm = JTrainClassifier(model=JLogisticRegression(max_iter=30), **kw).fit(jdf)
    pm = TrainClassifier(model=LogisticRegression(max_iter=30, device="cpu"), **kw).fit(pdf)
    assert pm.get("levels") is None and jm.get("levels") is None
    assert_featurizers_equal(jm, pm, jdf, pdf)


def test_train_regressor_within_tolerance_and_carried_bitwise():
    """Numeric columns: a one-hot block beside the solve's intercept would
    make the f32 normal equations singular, where two solvers part."""
    r = np.random.default_rng(6)
    x = r.standard_normal((500, 4))
    cols = {f"x{i}": x[:, i] for i in range(4)}
    cols["y"] = x @ r.standard_normal(4) + 0.5 + 0.01 * r.standard_normal(500)
    jdf, pdf = frames(cols)
    jm = JTrainRegressor(label_col="y").fit(jdf)
    pm = TrainRegressor(label_col="y", model=LinearRegression(device="cpu")).fit(pdf)
    assert_featurizers_equal(jm, pm, jdf, pdf)
    ji, pi = jm.get("inner_model"), pm.get("inner_model")
    jw = np.append(np.asarray(ji.get("weights")), ji.get("bias"))
    pw = np.append(pi.get("weights"), pi.get("bias"))
    assert float(np.abs(pw - jw).max()) <= LINREG_RTOL * float(np.abs(jw).max())
    carried = TrainedRegressorModel.from_jax_params(jax_parts(jm)["params"])
    np.testing.assert_array_equal(carried.transform(pdf)["prediction"],
                                  jm.transform(jdf)["prediction"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainRegressor(label_col="y").fit(pdf)


def _multiclass(n: int = 400, seed: int = 0) -> dict:
    """``conftest.make_tabular_df``'s three-class frame, labels as floats."""
    jdf = make_tabular_df(n=n, d=6, n_classes=3, num_partitions=1, seed=seed)
    return {"features": jdf["features"], "label": jdf["label"].astype(np.float64)}


def test_one_vs_rest_equals_jax_and_carries(parity):
    cols = _multiclass()
    jdf, pdf = frames(cols, parts=1)
    jm = JOneVsRest(classifier=JLightGBMClassifier(**GBDT), label_col="label").fit(jdf)
    pm = OneVsRest(classifier=LightGBMClassifier(device="cpu", **GBDT),
                   label_col="label").fit(pdf)
    assert pm.get("classes") == jm.get("classes") == [0.0, 1.0, 2.0]
    for a, b in zip(jm.get("models"), pm.get("models")):
        assert_same_trees(a.booster, b.booster)
    want = jm.transform(jdf)["prediction"]
    np.testing.assert_array_equal(pm.transform(pdf)["prediction"], want)
    carried = OneVsRestModel.from_jax_params(jax_parts(jm)["params"], device="cpu")
    assert [m.get("device") for m in carried.get("models")] == ["cpu"] * 3
    np.testing.assert_array_equal(carried.transform(pdf)["prediction"], want)


def test_one_vs_rest_over_train_classifier_scores_unlabeled_rows(parity):
    r = np.random.default_rng(1)
    x1, x2 = r.normal(size=300), r.normal(size=300)
    y = ((x1 > 0).astype(int) + (x2 > 0.5).astype(int)).astype(np.float64)
    jdf, pdf = frames({"x1": x1, "x2": x2, "label": y}, parts=1)
    jm = JOneVsRest(classifier=JTrainClassifier(model=JLightGBMClassifier(**GBDT)),
                    label_col="label").fit(jdf)
    pm = OneVsRest(classifier=TrainClassifier(model=LightGBMClassifier(device="cpu", **GBDT)),
                   label_col="label").fit(pdf)
    ju, pu = frames({"x1": x1, "x2": x2}, parts=1)
    np.testing.assert_array_equal(pm.transform(pu)["prediction"], jm.transform(ju)["prediction"])


def test_trained_classifier_save_load(tmp_path, adult):
    _, pdf = frames(adult)
    m = TrainClassifier(label_col="income",
                        model=LightGBMClassifier(device="cpu", **GBDT)).fit(pdf)
    m.save(str(tmp_path / "m"))
    back = TrainedClassifierModel.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(back.transform(pdf)["probability"],
                                  m.transform(pdf)["probability"])


def _scored(n: int = 500, k: int = 2, seed: int = 5) -> dict:
    r = np.random.default_rng(seed)
    p = r.dirichlet(np.ones(k), n)
    y = np.where(r.random(n) < 0.8, p.argmax(1), r.integers(0, k, n)).astype(np.int64)
    return {"label": y, "prediction": p.argmax(1).astype(np.float64), "probability": p}


@pytest.mark.parametrize("metric", ["classification", "all", "AUC", "accuracy", "f1_score"])
@pytest.mark.parametrize("k", [2, 3])
def test_compute_model_statistics_equals_jax(metric, k):
    jdf, pdf = frames(_scored(k=k))
    kw = dict(label_col="label", evaluation_metric=metric, scored_probabilities_col="probability")
    want = JStats(**kw).transform(jdf).collect()[0]
    got = ComputeModelStatistics(**kw).transform(pdf).collect()[0]
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("metric", ["regression", "all", "mean_squared_error",
                                    "root_mean_squared_error", "R^2", "mean_absolute_error"])
def test_compute_model_statistics_regression_equals_jax(metric):
    r = np.random.default_rng(2)
    y = r.normal(size=200)
    jdf, pdf = frames({"label": y, "prediction": y + r.normal(0, 0.3, 200)})
    want = JStats(label_col="label", evaluation_metric=metric).transform(jdf).collect()[0]
    got = ComputeModelStatistics(label_col="label", evaluation_metric=metric).transform(pdf)
    assert got.collect()[0] == want


def test_compute_model_statistics_string_labels_equal_jax():
    r = np.random.default_rng(3)
    lab = np.array(r.choice(["cat", "dog", "eel"], 100), dtype=object)
    pred = np.where(r.random(100) < 0.7, lab, "dog").astype(object)
    jdf, pdf = frames({"label": lab, "prediction": pred})
    want = JStats(label_col="label").transform(jdf).collect()[0]
    got = ComputeModelStatistics(label_col="label").transform(pdf).collect()[0]
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
    with pytest.raises(ValueError, match="numeric"):
        ComputeModelStatistics(label_col="label", evaluation_metric="regression").transform(pdf)


def test_per_instance_statistics_equal_jax():
    jdf, pdf = frames(_scored(k=3))
    kw = dict(label_col="label", scored_probabilities_col="probability")
    want, got = JPerInstance(**kw).transform(jdf), ComputePerInstanceStatistics(**kw).transform(pdf)
    assert got.columns == want.columns
    for c in ("log_loss", "L1_loss", "L2_loss"):
        np.testing.assert_array_equal(got[c], want[c])
