"""The port's GBDT ``train`` against the JAX package's on the real
datasets' cases, on the CPU: split records equal with the JAX package's
gradients, and the port's own gradients by quality.

The fixtures, tolerances and loaders are ``tests/test_torch_port_gbdt.py``'s
(its docstring says why the gradients are routed); these cases live in a
file of their own so the test workers can share them out.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.train import TrainConfig as JConfig
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.core.metrics import binary_auc
from mmlspark_tpu_torch.models.gbdt import TrainConfig, train

from test_torch_port_gbdt import (  # noqa: F401  fixtures, tolerances, loaders
    ATOL,
    RTOL,
    jax_gradients,
    load_xy,
    reference_device_grower,
)

torch.set_num_threads(1)


# (dataset, objective, growth policy, num_leaves, max_bin, feature_fraction)
CASES = [
    ("breast_cancer", "binary", "lossguide", 31, 255, 1.0),
    ("breast_cancer", "binary", "depthwise", 15, 63, 1.0),
    ("digits", "multiclass", "lossguide", 15, 63, 1.0),
    ("digits", "multiclass", "depthwise", 31, 255, 1.0),
    ("wine", "multiclass", "lossguide", 15, 63, 0.8),
    ("wine", "multiclass", "depthwise", 31, 255, 1.0),
    ("iris", "multiclass", "lossguide", 31, 255, 1.0),
    ("iris", "multiclass", "depthwise", 15, 63, 0.8),
    ("diabetes", "regression", "lossguide", 15, 63, 1.0),
    ("diabetes", "regression", "depthwise", 31, 255, 1.0),
]


def _fit_both(name, objective, policy, L, max_bin, ff, **extra):
    x, y = load_xy(name)
    k = int(y.max()) + 1 if objective == "multiclass" else 1
    kw = dict(objective=objective, num_class=k, num_iterations=10, num_leaves=L,
              growth_policy=policy, max_bin=max_bin, min_data_in_leaf=5,
              feature_fraction=ff, seed=3)
    fit_kw = {}
    rng = np.random.default_rng(len(y))
    if objective == "binary":
        fit_kw["sample_weight"] = rng.uniform(0.5, 2.0, len(y)).astype(np.float32)
        fit_kw["base_score"] = 0.4
    elif objective == "multiclass":
        fit_kw["base_score"] = np.log(np.bincount(y.astype(int)) / len(y)).astype(np.float32)
    else:
        fit_kw["init_score"] = rng.normal(size=len(y)).astype(np.float32)
        fit_kw["base_score"] = float(y.mean())
    fit_kw.update(extra)
    ref = jtrain(x, y, JConfig(**kw), shard=False, **fit_kw)
    port = train(x, y, TrainConfig(**kw), device="cpu", **fit_kw)
    return x, ref, port


@pytest.mark.parametrize("name,objective,policy,L,max_bin,ff", CASES)
def test_train_matches_reference(
    reference_device_grower, jax_gradients, name, objective, policy, L, max_bin, ff
):
    x, ref, port = _fit_both(name, objective, policy, L, max_bin, ff)
    assert len(port.trees) == len(ref.trees) > 0
    for i, (a, b) in enumerate(zip(ref.trees, port.trees)):
        for f in ("leaf", "feature", "active", "threshold", "counts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"tree {i} {f}")
        np.testing.assert_allclose(b.values, a.values, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b.gain, a.gain, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        port.predict_raw(x, device="cpu"), ref.predict_raw(x), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("name,objective,policy", [
    ("breast_cancer", "binary", "lossguide"),
    ("wine", "multiclass", "depthwise"),
])
def test_train_with_own_gradients_tracks_reference(
    reference_device_grower, name, objective, policy
):
    """The port's own torch gradients: the first round's trees equal the
    reference's, and the fitted models score the same to 0.005."""
    x, ref, port = _fit_both(name, objective, policy, 31, 255, 1.0)
    k = ref.num_class
    for a, b in zip(ref.trees[:k], port.trees[:k]):
        np.testing.assert_array_equal(b.feature, a.feature)
        np.testing.assert_array_equal(b.threshold, a.threshold)
    _, y = load_xy(name)
    rp, pp = ref.predict_raw(x), port.predict_raw(x, device="cpu")
    if k == 1:
        assert abs(binary_auc(y, rp) - binary_auc(y, pp)) <= 0.005
    else:
        assert abs((rp.argmax(1) == y).mean() - (pp.argmax(1) == y).mean()) <= 0.005
