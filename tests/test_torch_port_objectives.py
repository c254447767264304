"""The port's objectives (the regression zoo with leaf renewal, LambdaRank
and ``LightGBMRanker``) against the JAX package's, on the CPU.

Gradients, hessians and losses of the same numpy inputs within 1e-6
(relative; XLA's and PyTorch's f32 ``exp``/``log`` may differ in the last
bit). ``leaf_quantile_renewal`` equal (integer weights: every running
weight is exact in both). The host LambdaRank gradients and NDCG equal; the
device ones within 1e-5 relative (f32 sums in another order). Whole fits
see the JAX package's gradient functions (routed as in
``tests/test_torch_port_gbdt.py``) and are held to equal split records,
values within RTOL=1e-4, ATOL=1e-6, equal ``best_iteration`` and
per-round validation metrics within 1e-6 relative of the JAX package's
device metric on the JAX model's scores.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import objectives as JO
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import (
    Booster,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressor,
    TrainConfig,
    objectives as PO,
    sampling as PS,
    train,
)

JT = importlib.import_module("mmlspark_tpu.models.gbdt.train")

DATA_DIR = os.path.join(os.path.dirname(__file__), "resources", "data")

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
P1 = {"quantile": 0.7, "huber": 30.0, "fair": 2.0, "poisson": 0.7, "tweedie": 1.3}


def load_xy(name: str):
    a = np.loadtxt(os.path.join(DATA_DIR, f"{name}.csv"), delimiter=",", skiprows=1)
    return a[:, :-1].astype(np.float32), a[:, -1]


@pytest.fixture
def reference_device_grower(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")


@pytest.fixture
def jax_gradients(monkeypatch):
    """The port's regression and LambdaRank gradient functions (and its
    bagging draws) routed through the JAX package's, so both trainers see
    equal gradients and rows."""
    import jax
    import jax.numpy as jnp

    def t2j(t):
        return jnp.asarray(t.numpy())

    def j2t(a):
        return torch.from_numpy(np.array(a))

    def regression(kind, s, y, p1):
        g, h = JO.regression_grad_hess(kind, t2j(s), t2j(y), jnp.float32(float(p1)))
        return j2t(g), j2t(h)

    rank_jit = jax.jit(JO.lambdarank_grad_hess_device)  # compiled, as inside the scan

    def rank(s, rel, pad_idx, valid):
        g, h = rank_jit(t2j(s), t2j(rel), t2j(pad_idx), t2j(valid))
        return j2t(g), j2t(h)

    def uniform(seed, it, stream, n, device):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), it), stream)
        return j2t(jax.random.uniform(key, (n,))).to(device)

    monkeypatch.setattr(PO, "regression_grad_hess", regression)
    monkeypatch.setattr(PO, "lambdarank_grad_hess_device", rank)
    monkeypatch.setattr(PS, "uniform", uniform)


def _reference_metric(ref, x, y, valid, kind, p1=0.0):
    import jax.numpy as jnp

    out = []
    for r in range(1, len(ref.trees) + 1):
        s = ref.predict_raw(x, num_iteration=r)
        out.append(float(JT._device_metric(
            jnp.asarray(s), jnp.asarray(y.astype(np.float32)),
            jnp.asarray(valid.astype(np.float32)), kind, p1)))
    return np.array(out)


def assert_same_trees(ref, port):
    assert len(port.trees) == len(ref.trees) > 0
    for i, (a, b) in enumerate(zip(ref.trees, port.trees)):
        for f in ("leaf", "feature", "active", "threshold", "counts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"tree {i} {f}")
        np.testing.assert_allclose(b.values, a.values, rtol=RTOL, atol=ATOL, err_msg=f"tree {i}")
        np.testing.assert_allclose(b.gain, a.gain, rtol=RTOL, atol=ATOL, err_msg=f"tree {i}")
    assert port.best_iteration == ref.best_iteration
    assert port.objective_param == ref.objective_param


# -- the regression zoo ----------------------------------------------------------


def _regression_inputs(kind, n=300, seed=0):
    rng = np.random.default_rng(seed)
    if kind in PO.LOG_LINK_KINDS:
        s = rng.normal(0.5, 0.8, n).astype(np.float32)   # log space
        y = rng.gamma(2.0, 1.5, n).astype(np.float32)
        y[::7] = 0.0
    else:
        s = rng.normal(0, 20, n).astype(np.float32)
        y = np.round(rng.normal(0, 20, n)).astype(np.float32)
        y[::5] = s[::5]                                   # residual exactly 0
    return s, y


@pytest.mark.parametrize("kind", PO.REGRESSION_KINDS)
def test_regression_gradients_and_loss_match_reference(kind):
    import jax.numpy as jnp

    s, y = _regression_inputs(kind)
    p1 = P1.get(kind, 0.0)
    g_j, h_j = JO.regression_grad_hess(kind, jnp.asarray(s), jnp.asarray(y), jnp.float32(p1))
    g_p, h_p = PO.regression_grad_hess(kind, torch.from_numpy(s), torch.from_numpy(y),
                                       torch.tensor(p1, dtype=torch.float32))
    np.testing.assert_allclose(g_p.numpy(), np.array(g_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h_p.numpy(), np.array(h_j), rtol=1e-6, atol=1e-6)
    loss_j = JO.regression_loss(kind, jnp.asarray(s), jnp.asarray(y), jnp.float32(p1), xp=jnp)
    loss_p = PO.regression_loss(kind, torch.from_numpy(s), torch.from_numpy(y),
                                torch.tensor(p1, dtype=torch.float32))
    np.testing.assert_allclose(loss_p.numpy(), np.array(loss_j), rtol=1e-6, atol=1e-5)
    assert PO.regression_metric_name(kind) == JO.regression_metric_name(kind)


@pytest.mark.parametrize("alpha", [0.5, 0.9, 0.25])
def test_leaf_quantile_renewal_matches_reference(alpha):
    """Tied residuals, zero-weight rows, an empty leaf and a leaf with only
    zero-weight rows; integer weights."""
    import jax.numpy as jnp

    rng = np.random.default_rng(int(alpha * 100))
    n, L = 400, 9
    row_leaf = rng.integers(0, L - 1, n).astype(np.int32)   # leaf L-1 stays empty
    resid = np.round(rng.normal(size=n), 1).astype(np.float32)
    w = rng.integers(0, 4, n).astype(np.float32)
    w[row_leaf == 3] = 0.0
    want = np.array(JO.leaf_quantile_renewal(jnp.asarray(row_leaf), jnp.asarray(resid),
                                             jnp.asarray(w), L, jnp.float32(alpha)))
    got = PO.leaf_quantile_renewal(torch.from_numpy(row_leaf), torch.from_numpy(resid),
                                   torch.from_numpy(w), L,
                                   torch.tensor(alpha, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[L - 1] == 0.0 and got[3] == 0.0


# (objective, growth policy): every regression objective trains with
# validation rows and early stopping on its own metric
ZOO = [
    ("regression", "depthwise"), ("regression_l1", "lossguide"),
    ("quantile", "depthwise"), ("huber", "lossguide"), ("fair", "depthwise"),
    ("poisson", "lossguide"), ("tweedie", "depthwise"), ("gamma", "lossguide"),
    ("mape", "lossguide"),
]


@pytest.mark.parametrize("objective,policy", ZOO)
def test_regression_zoo_fit_matches_reference(reference_device_grower, jax_gradients,
                                              objective, policy):
    x, y = load_xy("diabetes")
    valid = np.random.default_rng(4).random(len(y)) < 0.3
    p1 = P1.get(objective, 0.0)
    kw = dict(objective=objective, num_iterations=8, num_leaves=7, min_data_in_leaf=5,
              growth_policy=policy, learning_rate=0.3, early_stopping_round=2, seed=1,
              bagging_fraction=0.8, bagging_freq=2)
    if objective in ("quantile", "huber"):
        kw["alpha"] = p1
    elif objective == "fair":
        kw["fair_c"] = p1
    elif objective == "poisson":
        kw["poisson_max_delta_step"] = p1
    elif objective == "tweedie":
        kw["tweedie_variance_power"] = p1
    base = (float(np.log(y.mean())) if objective in PO.LOG_LINK_KINDS
            else float(np.median(y)))
    fit = dict(valid_mask=valid, base_score=base)
    ref = JT.train(x, y, JT.TrainConfig(**kw), shard=False, **fit)
    port = train(x, y, TrainConfig(**kw), device="cpu", **fit)
    assert_same_trees(ref, port)
    name = PO.regression_metric_name(objective)
    np.testing.assert_allclose(port.evals[name],
                               _reference_metric(ref, x, y, valid, objective, p1),
                               rtol=1e-6, atol=1e-6)
    assert port.best_iteration == 1 + int(np.argmin(port.evals[name]))


def test_log_link_objectives_refuse_negative_labels():
    x, y = load_xy("diabetes")
    for objective in PO.LOG_LINK_KINDS:
        with pytest.raises(ValueError, match="non-negative"):
            train(x, y - 100.0, TrainConfig(objective=objective), device="cpu")


def test_regressor_boost_from_average_per_objective():
    """The regressor's starting score per objective family, as the JAX
    package's estimator sets it; predictions of a log-link model are exp
    of its raw scores."""
    x, y = load_xy("diabetes")
    df = DataFrame.from_dict({"features": x, "label": y})
    want = {"poisson": np.log(y.mean()), "quantile": np.percentile(y, 80.0),
            "regression_l1": np.median(y), "huber": y.mean()}
    for objective, base in want.items():
        m = LightGBMRegressor(objective=objective, alpha=0.8, num_iterations=2, num_leaves=4,
                              device="cpu").fit(df)
        assert m.booster.base_score == pytest.approx(float(base))
        raw = m.booster.predict_raw(x, device="cpu")
        link = np.exp if objective == "poisson" else (lambda r: r)
        np.testing.assert_allclose(m.transform(df)["prediction"], link(raw), rtol=1e-6)


@pytest.mark.parametrize("objective", ["quantile", "tweedie", "lambdarank"])
def test_model_strings_interoperate(reference_device_grower, objective):
    x, y = load_xy("diabetes")
    fit = dict(base_score=float(np.log(y.mean())) if objective == "tweedie"
               else float(np.median(y)))
    if objective == "lambdarank":
        y = np.digitize(y, np.percentile(y, [40, 70, 90])).astype(np.float64)
        fit = dict(group_ids=np.arange(len(y)) // 13)
    kw = dict(objective=objective, num_iterations=6, num_leaves=7, alpha=0.3,
              tweedie_variance_power=1.4)
    ref = JT.train(x, y, JT.TrainConfig(**kw), shard=False, **fit)
    port = train(x, y, TrainConfig(**kw), device="cpu", **fit)
    assert port.objective_param == ref.objective_param
    back = Booster.from_model_string(ref.to_model_string())
    assert back.to_model_string() == ref.to_model_string()
    np.testing.assert_allclose(back.predict(x, device="cpu"), ref.predict(x), rtol=1e-6)
    ref_from_port = JBooster.from_model_string(port.to_model_string())
    assert ref_from_port.to_model_string() == port.to_model_string()
    np.testing.assert_allclose(ref_from_port.predict(x), port.predict(x, device="cpu"),
                               rtol=1e-6)


# -- LambdaRank -----------------------------------------------------------------


def make_ranking(n_groups=30, per_group=12, d=6, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    sizes = (rng.integers(2, per_group + 1, n_groups) if ragged
             else np.full(n_groups, per_group))
    n = int(sizes.sum())
    x = rng.normal(size=(n, d)).astype(np.float32)
    rel = np.clip(x[:, 0] * 1.5 + x[:, 1] + 0.3 * rng.normal(size=n), 0, None)
    y = np.digitize(rel, [0.5, 1.2, 2.0]).astype(np.float64)  # grades 0..3
    groups = np.repeat(np.arange(n_groups), sizes)
    return x, y, groups


def test_lambdarank_host_gradients_and_pads_equal_reference():
    x, y, g = make_ranking(ragged=True)
    s = np.random.default_rng(1).normal(size=len(y))
    for a, b in zip(PO.lambdarank_grad_hess(s, y, g), JO.lambdarank_grad_hess(s, y, g)):
        np.testing.assert_array_equal(a, b)
    keep = np.arange(len(y)) % 3 != 0
    for a, b in zip(PO.lambdarank_pad_groups(g, keep), JO.lambdarank_pad_groups(g, keep)):
        np.testing.assert_array_equal(a, b)


def test_lambdarank_device_gradients_match_reference():
    """Ragged groups (padding), a group of one row and an all-zero group;
    the device gradients equal the JAX package's device ones and its f64
    host ones to f32 rounding."""
    import jax.numpy as jnp

    x, y, g = make_ranking(ragged=True, seed=2)
    y[g == 3] = 0.0
    g = np.where(np.arange(len(g)) == len(g) - 1, g.max() + 1, g)   # a one-row group
    s = np.round(np.random.default_rng(3).normal(size=len(y)), 1).astype(np.float32)
    pi, va = JO.lambdarank_pad_groups(g)
    gj, hj = JO.lambdarank_grad_hess_device(jnp.asarray(s), jnp.asarray(y.astype(np.float32)),
                                            jnp.asarray(pi), jnp.asarray(va))
    gp, hp = PO.lambdarank_grad_hess_device(torch.from_numpy(s),
                                            torch.from_numpy(y.astype(np.float32)),
                                            torch.from_numpy(pi), torch.from_numpy(va))
    np.testing.assert_allclose(gp.numpy(), np.array(gj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(hp.numpy(), np.array(hj), rtol=1e-5, atol=1e-7)
    gh, hh = JO.lambdarank_grad_hess(s.astype(np.float64), y, g)
    np.testing.assert_allclose(gp.numpy(), gh, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hp.numpy(), hh, rtol=1e-5, atol=1e-6)


def test_grouped_ndcg_matches_reference():
    import jax.numpy as jnp

    x, y, g = make_ranking(ragged=True, seed=5)
    y[g == 2] = 0.0
    s = np.round(np.random.default_rng(6).normal(size=len(y)), 1).astype(np.float32)
    keep = np.random.default_rng(7).random(len(y)) < 0.6
    for k in (1, 5, 20):
        want = JT.grouped_ndcg(s[keep], y[keep], g[keep], k=k)
        assert PO.grouped_ndcg(s[keep], y[keep], g[keep], k=k) == want
        pi, va = JO.lambdarank_pad_groups(g, keep=keep)
        dj = float(JO.grouped_ndcg_device(jnp.asarray(s), jnp.asarray(y.astype(np.float32)),
                                          jnp.asarray(pi), jnp.asarray(va), k=k))
        dp = float(PO.grouped_ndcg_device(torch.from_numpy(s),
                                          torch.from_numpy(y.astype(np.float32)),
                                          torch.from_numpy(pi), torch.from_numpy(va), k=k))
        assert dp == pytest.approx(dj, rel=1e-6) and dp == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("layout,boosting", [
    ("contiguous", "gbdt"),     # device gradients and device NDCG
    ("shuffled", "gbdt"),       # non-contiguous ids: host gradients and NDCG
    ("contiguous", "rf"),
])
def test_ranker_fit_matches_reference(reference_device_grower, jax_gradients, layout,
                                      boosting):
    x, y, g = make_ranking(seed=4)
    if layout == "shuffled":
        perm = np.random.default_rng(0).permutation(len(y))
        x, y, g = x[perm], y[perm], g[perm]
    valid = g >= 24
    kw = dict(objective="lambdarank", num_iterations=12, num_leaves=15, min_data_in_leaf=3,
              learning_rate=0.3, early_stopping_round=2, eval_at=5, boosting_type=boosting)
    fit = dict(valid_mask=valid, group_ids=g)
    ref = JT.train(x, y, JT.TrainConfig(**kw), shard=False, **fit)
    port = train(x, y, TrainConfig(**kw), device="cpu", **fit)
    assert_same_trees(ref, port)
    assert port.best_iteration > 0 and len(port.evals["ndcg@5"]) == len(port.trees)
    assert port.best_iteration == 1 + int(np.argmax(port.evals["ndcg@5"]))


def test_lightgbm_ranker_fits_and_scores():
    x, y, g = make_ranking(n_groups=40, seed=8)
    qid = np.array([f"q{i:03d}" for i in g], dtype=object)   # string query ids
    train_rows = g < 30
    df = DataFrame.from_dict({"features": x[train_rows], "label": y[train_rows],
                              "query": qid[train_rows]})
    m = LightGBMRanker(group_col="query", num_iterations=20, num_leaves=7, min_data_in_leaf=3,
                       device="cpu").fit(df)
    assert isinstance(m, LightGBMRankerModel) and m.booster.objective == "lambdarank"
    test = DataFrame.from_dict({"features": x[~train_rows], "label": y[~train_rows]})
    pred = m.transform(test)["prediction"]
    ndcg = PO.grouped_ndcg(pred, y[~train_rows], g[~train_rows], k=5)
    rand = np.random.default_rng(0).normal(size=len(pred))
    assert ndcg > PO.grouped_ndcg(rand, y[~train_rows], g[~train_rows], k=5)
    ref = JBooster.from_model_string(m.get("model_string"))
    np.testing.assert_allclose(ref.predict_raw(x[~train_rows]), pred, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="group_col"):
        LightGBMRanker(device="cpu").fit(df)
    with pytest.raises(ValueError, match="group_ids"):
        train(x, y, TrainConfig(objective="lambdarank"), device="cpu")
