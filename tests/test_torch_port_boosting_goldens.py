"""The JAX package's goldens (``tests/resources``) through the port's
LightGBM estimators on the CPU: each boosting type on the real datasets,
the diabetes regression, and validation rows stopping early.

Split from ``tests/test_torch_port_boosting.py`` (its loaders), so the
test workers can share the two out.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core.metrics import binary_auc
from mmlspark_tpu_torch.models.gbdt import Booster, LightGBMClassifier, LightGBMRegressor

from benchmarks import assert_golden, load_goldens
from test_torch_port_boosting import load_xy

torch.set_num_threads(1)


# -- the JAX package's goldens through the port's estimators ---------------------


def stratified_split(x, y, test_frac=0.3, seed=7):
    rng = np.random.default_rng(seed)
    test = np.zeros(len(y), bool)
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        test[rng.permutation(idx)[: max(1, int(round(test_frac * len(idx))))]] = True
    return x[~test], x[test], y[~test], y[test]


def _matrix_params(dataset: str) -> dict:
    if dataset == "iris":
        return dict(num_iterations=40, num_leaves=15, min_data_in_leaf=3)
    return dict(num_iterations=50 if dataset == "digits_binary" else 60,
                num_leaves=15 if dataset == "wine" else 31,
                min_data_in_leaf=3 if dataset == "wine" else 5)


# the JAX suite's matrix (tests/test_real_datasets.py): breast_cancer and
# digits run in the slow tier there, and here
MATRIX = [
    pytest.param(ds, mode, marks=[pytest.mark.slow] if ds in ("breast_cancer", "digits_binary")
                 else [])
    for ds in ("breast_cancer", "digits_binary", "wine", "iris")
    for mode in ("goss", "dart", "rf")
]


@pytest.mark.parametrize("dataset,mode", MATRIX)
def test_dataset_mode_golden(dataset, mode):
    goldens = load_goldens("VerifyRealDatasets")
    x, y = load_xy("digits" if dataset == "digits_binary" else dataset)
    if dataset == "digits_binary":
        y = (y >= 5).astype(np.float64)
    xtr, xte, ytr, yte = stratified_split(x, y)
    m = LightGBMClassifier(seed=7, boosting_type=mode, device="cpu",
                           **_matrix_params(dataset)).fit(
        DataFrame.from_dict({"features": xtr, "label": ytr}))
    out = m.transform(DataFrame.from_dict({"features": xte, "label": yte}))
    if dataset in ("wine", "iris"):
        assert_golden(goldens, f"{dataset}.{mode}.accuracy",
                      float((out["prediction"] == yte).mean()))
    else:
        assert_golden(goldens, f"{dataset}.{mode}.AUC", binary_auc(yte, out["probability"][:, 1]))


@pytest.mark.parametrize("mode", ["gbdt", "goss", "dart", "rf"])
def test_diabetes_regression_golden(mode):
    goldens = load_goldens("VerifyLightGBMRegressor")
    x, y = load_xy("diabetes")
    mask = np.zeros(len(y), bool)
    mask[np.random.default_rng(7).permutation(len(y))[: int(0.3 * len(y))]] = True
    m = LightGBMRegressor(num_iterations=60, num_leaves=15, min_data_in_leaf=5, seed=7,
                          boosting_type=mode, device="cpu").fit(
        DataFrame.from_dict({"features": x[~mask], "label": y[~mask]}))
    pred = m.transform(DataFrame.from_dict({"features": x[mask], "label": y[mask]}))["prediction"]
    r2 = 1 - np.sum((y[mask] - pred) ** 2) / np.sum((y[mask] - y[mask].mean()) ** 2)
    assert_golden(goldens, f"diabetes.{mode}.R2", r2)


def test_classifier_validation_indicator_col_early_stops():
    """``validation_indicator_col`` reaches ``train``: the held-out rows
    drive early stopping and ``best_iteration`` survives the model string."""
    x, y = load_xy("breast_cancer")
    valid = np.arange(len(y)) % 4 == 0
    df = DataFrame.from_dict({"features": x, "label": y, "is_val": valid})
    m = LightGBMClassifier(num_iterations=60, learning_rate=0.5, num_leaves=31,
                           min_data_in_leaf=3, early_stopping_round=3,
                           validation_indicator_col="is_val", device="cpu").fit(df)
    b = m.booster
    assert 0 < b.best_iteration < len(b.trees)
    assert len(b.evals["binary_logloss"]) == len(b.trees)
    assert Booster.from_model_string(m.get("model_string")).best_iteration == b.best_iteration
