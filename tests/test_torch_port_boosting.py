"""The port's boosting types, bagging, validation and early stopping
against the JAX package's, on the CPU.

The same numpy inputs go through the JAX ``train(..., shard=False)`` with
its device grower (``MMLSPARK_TPU_HIST_HOST=0``) and through the port's
``train(..., device="cpu")``. The row draws need no help: the port's
``sampling.uniform`` computes the JAX package's Threefry draws bit for bit
(``tests/test_torch_port_sampling.py``). One thing differs by design and is
routed through the JAX package here, so the fits can be held to equal
split records: sigmoid/softmax gradients, since XLA's f32 ``exp`` and
PyTorch's differ in the last bit (``tests/test_torch_port_gbdt.py``).

Tolerances: split records (leaf, feature, threshold, active, counts) and
dart's drop sets equal; leaf values and gains within RTOL=1e-4, ATOL=1e-6;
per-round validation metrics within 1e-6 relative of the JAX package's
device metric on the JAX model's own scores; ``best_iteration`` and the tree
count equal.

The JAX package's goldens through the port's estimators are in
``tests/test_torch_port_boosting_goldens.py``.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import objectives as JO
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu_torch.models.gbdt import (
    Booster,
    TrainConfig,
    booster_from_reference,
    evaluation as PE,
    objectives as PO,
    sampling as PS,
    train,
)


# the train modules (each package's ``train`` name is the function)
JT = importlib.import_module("mmlspark_tpu.models.gbdt.train")
PT = importlib.import_module("mmlspark_tpu_torch.models.gbdt.train")

DATA_DIR = os.path.join(os.path.dirname(__file__), "resources", "data")

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
METRIC_RTOL = 1e-6


def load_xy(name: str):
    a = np.loadtxt(os.path.join(DATA_DIR, f"{name}.csv"), delimiter=",", skiprows=1)
    return a[:, :-1].astype(np.float32), a[:, -1]


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


@pytest.fixture
def parity(reference_device_grower, jax_gradients):
    return None


def _config(name, objective, policy, **extra):
    _, y = load_xy(name)
    k = int(y.max()) + 1 if objective == "multiclass" else 1
    kw = dict(objective=objective, num_class=k, num_iterations=8, num_leaves=15,
              growth_policy=policy, min_data_in_leaf=5, seed=3)
    kw.update(extra)
    return kw


def _fit_both(name, kw, **fit_kw):
    x, y = load_xy(name)
    ref = JT.train(x, y, JT.TrainConfig(**kw), shard=False, **fit_kw)
    port = train(x, y, TrainConfig(**kw), device="cpu", **fit_kw)
    return x, y, ref, port


def assert_same_trees(ref, port):
    assert len(port.trees) == len(ref.trees) > 0
    for i, (a, b) in enumerate(zip(ref.trees, port.trees)):
        for f in ("leaf", "feature", "active", "threshold", "counts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"tree {i} {f}")
        np.testing.assert_allclose(b.values, a.values, rtol=RTOL, atol=ATOL, err_msg=f"tree {i}")
        np.testing.assert_allclose(b.gain, a.gain, rtol=RTOL, atol=ATOL, err_msg=f"tree {i}")
    assert port.best_iteration == ref.best_iteration
    assert port.boosting_type == ref.boosting_type


# -- bagging, GOSS, RF --------------------------------------------------------

SAMPLED = [
    ("breast_cancer", "binary", "lossguide", dict(bagging_fraction=0.7, bagging_freq=2)),
    ("iris", "multiclass", "depthwise", dict(bagging_fraction=0.6, bagging_freq=1)),
    ("diabetes", "regression", "lossguide", dict(bagging_fraction=0.5, bagging_freq=3,
                                                 feature_fraction=0.7)),
    ("diabetes", "regression", "depthwise", dict(boosting_type="goss")),
    ("iris", "multiclass", "lossguide", dict(boosting_type="goss", top_rate=0.3,
                                             other_rate=0.2)),
    ("breast_cancer", "binary", "depthwise", dict(boosting_type="goss")),
    ("diabetes", "regression", "lossguide", dict(boosting_type="rf")),
    ("breast_cancer", "binary", "depthwise", dict(boosting_type="rf", bagging_fraction=0.5,
                                                   bagging_freq=1)),
    ("iris", "multiclass", "lossguide", dict(boosting_type="rf", feature_fraction=0.75)),
]


@pytest.mark.parametrize("name,objective,policy,extra", SAMPLED)
def test_sampled_boosting_matches_reference(parity, name, objective, policy, extra):
    x, _, ref, port = _fit_both(name, _config(name, objective, policy, **extra))
    assert_same_trees(ref, port)
    np.testing.assert_allclose(
        port.predict_raw(x, device="cpu"), ref.predict_raw(x), rtol=RTOL, atol=ATOL
    )


def test_goss_weights_match_reference():
    """Ties at the threshold admit every tied row; ineligible rows (w = 0)
    never count; the same uniforms give the same weights."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n = 500
    g_abs = np.round(rng.exponential(size=n), 1).astype(np.float32)  # many ties
    w = (rng.random(n) < 0.8).astype(np.float32) * rng.integers(1, 3, n).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    for top, other in ((0.2, 0.1), (0.3, 0.7), (0.05, 0.5)):
        want = np.array(JT._goss_weights(jnp.asarray(g_abs), jnp.asarray(w), jnp.asarray(u),
                                         top, other))
        got = PS.goss_weights(torch.from_numpy(g_abs), torch.from_numpy(w),
                              torch.from_numpy(u), top, other).numpy()
        np.testing.assert_array_equal(got, want)


def test_uniform_depends_on_seed_round_and_stream_only():
    a = PS.uniform(7, 3, PS.BAGGING_STREAM, 1000, torch.device("cpu"))
    PS.uniform(7, 2, PS.BAGGING_STREAM, 1000, torch.device("cpu"))  # another round between
    b = PS.uniform(7, 3, PS.BAGGING_STREAM, 1000, torch.device("cpu"))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    for other in (PS.uniform(7, 3, PS.GOSS_STREAM, 1000, torch.device("cpu")),
                  PS.uniform(7, 4, PS.BAGGING_STREAM, 1000, torch.device("cpu")),
                  PS.uniform(8, 3, PS.BAGGING_STREAM, 1000, torch.device("cpu"))):
        assert not torch.equal(a, other)


def test_goss_refuses_rates_over_one():
    x, y = load_xy("iris")
    with pytest.raises(ValueError, match="top_rate"):
        train(x, y, TrainConfig(objective="multiclass", num_class=3, boosting_type="goss",
                                top_rate=0.6, other_rate=0.5), device="cpu")


# -- DART ---------------------------------------------------------------------


@pytest.mark.parametrize("name,objective,policy", [
    ("diabetes", "regression", "lossguide"),
    ("breast_cancer", "binary", "depthwise"),
])
def test_dart_matches_reference(parity, monkeypatch, name, objective, policy):
    """The same rounds dropped in the same order, equal records, values
    within tolerance (dropped trees rescaled on the device)."""
    ref_drops, port_drops = [], []
    contrib = JT._iterations_contrib

    def record_ref(booster, x, iterations, k):
        ref_drops.append(list(iterations))
        return contrib(booster, x, iterations, k)

    draw = PS.draw_rounds

    def record_port(*a, **kw):
        out = draw(*a, **kw)
        port_drops.extend(s for s in out.drops if s)
        return out

    monkeypatch.setattr(JT, "_iterations_contrib", record_ref)
    monkeypatch.setattr(PS, "draw_rounds", record_port)
    kw = _config(name, objective, policy, boosting_type="dart", num_iterations=10,
                 drop_rate=0.5, skip_drop=0.2, max_drop=3, feature_fraction=0.8)
    x, _, ref, port = _fit_both(name, kw)
    assert port_drops == ref_drops and len(ref_drops) >= 3
    assert max(len(s) for s in ref_drops) == 3  # max_drop's choice ran
    assert_same_trees(ref, port)
    np.testing.assert_allclose(
        port.predict_raw(x, device="cpu"), ref.predict_raw(x), rtol=RTOL, atol=ATOL
    )


def test_pairwise_sum_matches_numpy():
    rng = np.random.default_rng(1)
    for m in (1, 2, 5, 7, 8, 9, 17, 64, 127, 128, 129, 300):
        a = (rng.normal(size=(200, m)) * 10.0 ** rng.integers(-3, 4, (200, m))).astype(np.float32)
        got = PT.pairwise_sum(list(torch.from_numpy(a).unbind(1)))
        np.testing.assert_array_equal(got.numpy(), a.sum(axis=1))


# -- validation rows and early stopping -----------------------------------------


def _reference_metric(ref, x, y, valid, kind, p1=0.0):
    """The JAX package's device metric on the JAX model's scores after
    each round (prefix predictions; rf averages its prefix)."""
    import jax.numpy as jnp

    k = ref.num_class
    y_eval = np.eye(k, dtype=np.float32)[y.astype(int)] if k > 1 else y.astype(np.float32)
    out = []
    for r in range(1, len(ref.trees) // k + 1):
        s = ref.predict_raw(x, num_iteration=r)
        out.append(float(JT._device_metric(jnp.asarray(s), jnp.asarray(y_eval),
                                           jnp.asarray(valid.astype(np.float32)), kind, p1)))
    return np.array(out)


EARLY = [
    ("breast_cancer", "binary", "lossguide", dict(), "binary_logloss"),
    ("breast_cancer", "binary", "depthwise", dict(metric="auc", boosting_type="goss"), "auc"),
    ("breast_cancer", "binary", "lossguide", dict(metric="binary_error", boosting_type="rf"),
     "binary_error"),
    ("iris", "multiclass", "depthwise", dict(bagging_fraction=0.7, bagging_freq=1),
     "multi_logloss"),
]


@pytest.mark.parametrize("name,objective,policy,extra,kind", EARLY)
def test_early_stopping_matches_reference(parity, name, objective, policy, extra, kind):
    x, y = load_xy(name)
    valid = np.random.default_rng(11).random(len(y)) < 0.3
    kw = _config(name, objective, policy, num_iterations=14, learning_rate=0.5,
                 early_stopping_round=2, **extra)
    _, _, ref, port = _fit_both(name, kw, valid_mask=valid)
    assert_same_trees(ref, port)
    assert 0 < port.best_iteration <= len(port.trees) // port.num_class
    got = np.array(port.evals[kind])
    assert len(got) == len(port.trees) // port.num_class
    want = _reference_metric(ref, x, y, valid, kind)
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=1e-7)
    higher = kind in PE.HIGHER_METRICS
    assert port.best_iteration == 1 + int(np.argmax(got) if higher else np.argmin(got))


def test_early_stopping_over_several_chunks(parity):
    """More rounds than one chunk of metric reads (16): the stop lands in a
    later chunk, the surplus rounds of that chunk are dropped."""
    name = "diabetes"
    valid = np.random.default_rng(5).random(442) < 0.3
    kw = _config(name, "regression", "lossguide", num_iterations=60, learning_rate=0.1,
                 num_leaves=7, min_data_in_leaf=3, early_stopping_round=4)
    _, y = load_xy(name)
    _, _, ref, port = _fit_both(name, kw, valid_mask=valid, base_score=float(y.mean()))
    assert_same_trees(ref, port)
    assert 16 < len(port.trees) < 60
    assert port.best_iteration == ref.best_iteration


def test_early_stopping_replay_is_chunk_independent():
    vals = list(np.random.default_rng(2).normal(size=50).cumsum())
    for higher_kind in ("auc", "l2"):
        whole = PE.EarlyStopping(higher_kind, 3)
        keep = whole.replay(vals, 0)
        for c in (1, 4, 16):
            es, got = PE.EarlyStopping(higher_kind, 3), None
            for i0 in range(0, 50, c):
                got = es.replay(vals[i0: i0 + c], i0)
                if got is not None:
                    got += i0
                    break
            assert got == keep and es.best_iter == whole.best_iter


def test_validation_without_early_stopping_records_best_iteration(parity):
    x, y = load_xy("iris")
    valid = np.arange(len(y)) % 3 == 0
    kw = _config("iris", "multiclass", "lossguide", num_iterations=6)
    _, _, ref, port = _fit_both("iris", kw, valid_mask=valid)
    assert_same_trees(ref, port)
    assert port.best_iteration > 0 and len(port.trees) == 18


def test_dart_turns_early_stopping_off(parity):
    x, y = load_xy("breast_cancer")
    valid = np.arange(len(y)) % 4 == 0
    kw = _config("breast_cancer", "binary", "lossguide", boosting_type="dart",
                 early_stopping_round=1, num_iterations=6)
    _, _, ref, port = _fit_both("breast_cancer", kw, valid_mask=valid)
    assert_same_trees(ref, port)
    assert port.best_iteration == -1 and len(port.trees) == 6


@pytest.mark.parametrize("kind", ["binary_logloss", "binary_error", "auc", "multi_logloss",
                                  "regression", "quantile", "poisson"])
def test_device_metrics_match_reference(kind):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 400
    vw = (rng.random(n) < 0.4).astype(np.float32)
    if kind == "multi_logloss":
        s = rng.normal(size=(n, 4)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    else:
        s = np.round(rng.normal(size=n), 1).astype(np.float32)  # ties for auc
        y = (rng.random(n) < 0.4).astype(np.float32)
        if kind in ("regression", "quantile", "poisson"):
            y = rng.poisson(2.0, n).astype(np.float32)
    want = float(JT._device_metric(jnp.asarray(s), jnp.asarray(y), jnp.asarray(vw), kind, 0.7))
    got = float(PE.device_metric(torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(vw),
                                 kind, torch.tensor(0.7)))
    assert got == pytest.approx(want, rel=METRIC_RTOL)
    if kind == "auc":
        one = np.zeros(n, np.float32)
        assert float(PE.device_metric(torch.from_numpy(s), torch.from_numpy(one),
                                      torch.from_numpy(vw), kind)) == 0.5


# -- interop: model strings and booster_from_reference --------------------------


@pytest.mark.parametrize("mode", ["dart", "rf", "early_stopped"])
def test_model_strings_interoperate(parity, mode):
    name = "breast_cancer"
    x, y = load_xy(name)
    extra = (dict(early_stopping_round=2, learning_rate=0.5, num_iterations=40)
             if mode == "early_stopped" else dict(boosting_type=mode, num_iterations=10))
    kw = _config(name, "binary", "lossguide", **extra)
    valid = np.arange(len(y)) % 3 == 0 if mode == "early_stopped" else None
    _, _, ref, port = _fit_both(name, kw, valid_mask=valid, base_score=0.3)
    if mode == "early_stopped":
        assert 0 < port.best_iteration < len(port.trees)
    port_from_ref = Booster.from_model_string(ref.to_model_string())
    assert port_from_ref.to_model_string() == ref.to_model_string()
    np.testing.assert_array_equal(port_from_ref.predict_raw(x, device="cpu"), ref.predict_raw(x))
    ref_from_port = JBooster.from_model_string(port.to_model_string())
    assert ref_from_port.to_model_string() == port.to_model_string()
    np.testing.assert_array_equal(ref_from_port.predict_raw(x), port.predict_raw(x, device="cpu"))


def test_booster_from_reference_carries_best_iteration_and_objective_param(
        reference_device_grower):
    x, y = load_xy("diabetes")
    valid = np.arange(len(y)) % 3 == 0
    ref = JT.train(x, y, JT.TrainConfig(objective="quantile", alpha=0.7, num_iterations=30,
                                        learning_rate=0.5, num_leaves=15,
                                        early_stopping_round=2),
                   shard=False, valid_mask=valid, base_score=float(np.median(y)))
    assert 0 < ref.best_iteration < len(ref.trees)
    trees = [{f: getattr(t, f) for f in ("leaf", "feature", "threshold", "active", "gain",
                                         "values", "counts")} for t in ref.trees]
    port = booster_from_reference(
        trees, objective=ref.objective, num_class=ref.num_class,
        num_features=ref.num_features, base_score=ref.base_score,
        best_iteration=ref.best_iteration, objective_param=ref.objective_param,
    )
    assert port.best_iteration == ref.best_iteration and port.objective_param == 0.7
    assert port.to_model_string() == ref.to_model_string()
    # scores the best prefix, not every tree
    np.testing.assert_array_equal(port.predict_raw(x, device="cpu"), ref.predict_raw(x))
