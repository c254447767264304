"""The port's continued training (``init_booster``, ``model_string``,
``num_batches``), checkpoint/resume and delegates against the JAX
package's, on the CPU.

Tolerances: split records (leaf, feature, threshold, active, counts,
``is_cat``, ``catmask``) equal; leaf values and gains within RTOL=1e-4,
ATOL=1e-6; a resumed fit's model string byte-identical to the
uninterrupted fit's; checkpoint files equal to the JAX package's, the best
validation metric within 1e-6 relative (both are f32 device metrics,
summed in another order). Binary and multiclass fits held against the JAX
package route their gradients through its functions (XLA's and PyTorch's
f32 ``exp`` differ in the last bit, ``tests/test_torch_port_gbdt.py``).
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import objectives as JO
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.checkpoint import load_checkpoint as jload_checkpoint
from mmlspark_tpu.models.gbdt.estimators import LightGBMRegressor as JRegressor
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import (
    Booster,
    LightGBMClassifier,
    LightGBMDelegate,
    LightGBMRegressor,
    TrainConfig,
    objectives as PO,
    train,
)
from mmlspark_tpu_torch.models.gbdt import checkpoint as PC

JT = importlib.import_module("mmlspark_tpu.models.gbdt.train")

DATA_DIR = os.path.join(os.path.dirname(__file__), "resources", "data")

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def load_xy(name: str):
    a = np.loadtxt(os.path.join(DATA_DIR, f"{name}.csv"), delimiter=",", skiprows=1)
    return a[:, :-1].astype(np.float32), a[:, -1]


def make_binary(n=400, seed=0, noise=0.1):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 8)).astype(np.float32)
    logits = np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.5 * x[:, 3]
    return x, (logits + noise * r.normal(size=n) > 0).astype(np.float64)


def make_cat_regression(n=500, seed=1):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 3] = r.integers(0, 10, n)
    e = r.normal(size=10)
    return x, (x[:, 0] + e[x[:, 3].astype(int)] + 0.2 * r.normal(size=n)).astype(np.float64)


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


def assert_same_trees(ref, port):
    assert len(port.trees) == len(ref.trees) > 0
    for i, (a, b) in enumerate(zip(ref.trees, port.trees)):
        for f in ("leaf", "feature", "active", "threshold", "counts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"tree {i} {f}")
        np.testing.assert_allclose(b.values, a.values, rtol=RTOL, atol=ATOL, err_msg=f"tree {i}")
        np.testing.assert_allclose(b.gain, a.gain, rtol=RTOL, atol=ATOL, err_msg=f"tree {i}")
        assert (a.is_cat is None) == (b.is_cat is None), f"tree {i}"
        if a.is_cat is not None:
            np.testing.assert_array_equal(b.catmask, a.catmask, err_msg=f"tree {i}")
    assert port.best_iteration == ref.best_iteration
    assert port.boosting_type == ref.boosting_type


class Stop(Exception):
    """Raised by a delegate to stop a fit mid-run, as a preemption would."""


class Recorder(LightGBMDelegate):
    """Records every hook call; optionally raises before round ``stop_at``
    and decays the learning rate by ``decay`` each round."""

    def __init__(self, stop_at=None, decay=None):
        self.events, self.metrics = [], []
        self.stop_at, self.decay = stop_at, decay

    def before_train_batch(self, batch_index, n_rows, previous_booster):
        self.events.append(("before_batch", batch_index, n_rows, previous_booster is None))

    def after_train_batch(self, batch_index, booster):
        self.events.append(("after_batch", batch_index, len(booster.trees)))

    def before_train_iteration(self, iteration):
        self.events.append(("before", iteration))
        if iteration == self.stop_at:
            raise Stop(iteration)

    def after_train_iteration(self, iteration, eval_result, is_finished):
        self.events.append(("after", iteration, None if eval_result is None
                            else (eval_result[0], eval_result[2]), is_finished))
        self.metrics.append(None if eval_result is None else eval_result[1])

    def get_learning_rate(self, iteration, previous_rate):
        self.events.append(("lr", iteration, previous_rate))
        return previous_rate if self.decay is None else previous_rate * self.decay


# -- continued training --------------------------------------------------------------


INIT_CASES = [
    ("diabetes", dict(objective="regression")),
    ("diabetes", dict(objective="regression", growth_policy="depthwise")),
    ("breast_cancer", dict(objective="binary")),
    ("iris", dict(objective="multiclass", num_class=3)),
    ("categorical", dict(objective="regression", categorical_features=(3,))),
    ("diabetes", dict(objective="regression", bagging_fraction=0.7, bagging_freq=1)),
]


@pytest.mark.parametrize("name,extra", INIT_CASES)
def test_init_booster_equals_jax(parity, name, extra):
    x, y = make_cat_regression() if name == "categorical" else load_xy(name)
    cfg = dict(num_iterations=4, num_leaves=7, min_data_in_leaf=5, seed=2, **extra)
    base = 0.0 if extra["objective"] != "regression" else float(y.mean())
    first = JT.train(x, y, JT.TrainConfig(**cfg), shard=False, base_score=base)
    ref = JT.train(x, y, JT.TrainConfig(**cfg), shard=False, init_booster=first)
    port = train(x, y, TrainConfig(**cfg), device="cpu",
                 init_booster=Booster.from_model_string(first.to_model_string()))
    assert len(port.trees) == len(ref.trees) == 2 * len(first.trees)
    assert_same_trees(ref, port)
    np.testing.assert_array_equal(np.asarray(port.base_score), np.asarray(ref.base_score))
    np.testing.assert_allclose(port.predict_raw(x, device="cpu"), ref.predict_raw(x),
                               rtol=RTOL, atol=ATOL)


def test_init_booster_best_iteration_counts_from_the_merged_front(parity):
    x, y = make_binary(n=600, noise=2.0)
    valid = np.zeros(600, bool)
    valid[::3] = True
    cfg = dict(objective="binary", num_iterations=60, num_leaves=31, min_data_in_leaf=2,
               early_stopping_round=3, learning_rate=0.3)
    first = JT.train(x, y, JT.TrainConfig(objective="binary", num_iterations=5, num_leaves=7),
                     shard=False)
    ref = JT.train(x, y, JT.TrainConfig(**cfg), shard=False, init_booster=first,
                   valid_mask=valid)
    port = train(x, y, TrainConfig(**cfg), device="cpu", valid_mask=valid,
                 init_booster=Booster.from_model_string(first.to_model_string()))
    assert ref.best_iteration > 5
    assert_same_trees(ref, port)


def test_merge_keeps_the_first_boosters_settings():
    x, y = load_xy("diabetes")
    a = train(x, y, TrainConfig(objective="quantile", alpha=0.3, num_iterations=2,
                                num_leaves=4), device="cpu", base_score=5.0)
    b = train(x, y, TrainConfig(objective="quantile", alpha=0.3, num_iterations=3,
                                num_leaves=4), device="cpu")
    m = a.merge(b)
    ja = JBooster.from_model_string(a.to_model_string())
    jb = JBooster.from_model_string(b.to_model_string())
    assert m.to_model_string() == ja.merge(jb).to_model_string()
    with pytest.raises(ValueError, match="classes"):
        a.merge(Booster(trees=[], objective="multiclass", num_class=3, num_features=10))


NUM_BATCHES = [
    (JRegressor, LightGBMRegressor, "diabetes", {}),
    (JRegressor, LightGBMRegressor, "diabetes", dict(growth_policy="depthwise",
                                                     bagging_fraction=0.8, bagging_freq=1)),
]


@pytest.mark.parametrize("jcls,pcls,name,extra", NUM_BATCHES)
def test_num_batches_equals_jax(reference_device_grower, jcls, pcls, name, extra):
    x, y = load_xy(name)
    df_kw = {"features": x, "label": y}
    params = dict(num_iterations=3, num_leaves=7, min_data_in_leaf=5, num_batches=3, seed=1,
                  **extra)
    from mmlspark_tpu import DataFrame as JDataFrame

    jd, pd = Recorder(), Recorder()
    ref = jcls(delegate=jd, **params).fit(JDataFrame.from_dict(df_kw)).booster
    port = pcls(delegate=pd, device="cpu", **params).fit(DataFrame.from_dict(df_kw)).booster
    assert len(port.trees) == 9
    assert_same_trees(ref, port)
    assert pd.events == jd.events


def test_classifier_num_batches_and_model_string_equal_jax(parity):
    from mmlspark_tpu import DataFrame as JDataFrame
    from mmlspark_tpu.models.gbdt import LightGBMClassifier as JClassifier

    x, y = make_binary()
    df_kw = {"features": x, "label": y}
    params = dict(num_iterations=3, num_leaves=7, num_batches=2, seed=4)
    ref = JClassifier(**params).fit(JDataFrame.from_dict(df_kw))
    port = LightGBMClassifier(device="cpu", **params).fit(DataFrame.from_dict(df_kw))
    assert_same_trees(ref.booster, port.booster)
    more = dict(num_iterations=2, num_leaves=7, boost_from_average=False)
    ref2 = JClassifier(model_string=ref.get("model_string"), **more).fit(
        JDataFrame.from_dict(df_kw))
    port2 = LightGBMClassifier(model_string=port.get("model_string"), device="cpu",
                               **more).fit(DataFrame.from_dict(df_kw))
    assert len(port2.booster.trees) == 8
    assert_same_trees(ref2.booster, port2.booster)


def test_continued_training_merge():
    x, y = make_binary()
    df = DataFrame.from_dict({"features": x, "label": y})
    m1 = LightGBMClassifier(num_iterations=10, num_leaves=7, device="cpu").fit(df)
    m2 = LightGBMClassifier(num_iterations=10, num_leaves=7, device="cpu",
                            model_string=m1.get("model_string"),
                            boost_from_average=False).fit(df)
    assert len(m2.booster.trees) == 20
    p1 = m1.transform(df)["probability"][:, 1]
    p2 = m2.transform(df)["probability"][:, 1]

    def logloss(p):
        return -np.mean(y * np.log(p + 1e-12) + (1 - y) * np.log(1 - p + 1e-12))

    assert logloss(p2) < logloss(p1)


def test_model_string_accepts_lightgbm_text():
    x, y = make_binary()
    df = DataFrame.from_dict({"features": x, "label": y})
    m1 = LightGBMClassifier(num_iterations=3, num_leaves=7, device="cpu").fit(df)
    text = m1.booster.to_lightgbm_string()
    m2 = LightGBMClassifier(num_iterations=2, num_leaves=7, device="cpu", model_string=text,
                            boost_from_average=False).fit(df)
    assert len(m2.booster.trees) == 5


def test_num_batches_training():
    x, y = make_binary()
    df = DataFrame.from_dict({"features": x, "label": y})
    model = LightGBMClassifier(num_iterations=5, num_leaves=7, num_batches=2,
                               device="cpu").fit(df)
    assert len(model.booster.trees) == 10


def test_best_iteration_survives_merge():
    x, y = make_binary(n=600, noise=2.0)
    valid = np.zeros(600, bool)
    valid[::3] = True
    df = DataFrame.from_dict({"features": x, "label": y, "isVal": valid})
    m1 = LightGBMClassifier(num_iterations=5, num_leaves=7, device="cpu").fit(df)
    m2 = LightGBMClassifier(num_iterations=200, num_leaves=31, min_data_in_leaf=2,
                            validation_indicator_col="isVal", early_stopping_round=5,
                            model_string=m1.get("model_string"), boost_from_average=False,
                            device="cpu").fit(df)
    b = m2.booster
    assert 5 < b.best_iteration <= len(b.trees)


# -- checkpoint/resume ------------------------------------------------------------------


RESUME_MODES = {
    "gbdt": dict(objective="binary"),
    "bagging": dict(objective="binary", bagging_fraction=0.7, bagging_freq=2),
    "goss": dict(objective="binary", boosting_type="goss", top_rate=0.3, other_rate=0.2),
    "dart": dict(objective="binary", boosting_type="dart", drop_rate=0.5, skip_drop=0.2,
                 feature_fraction=0.8),
    "categorical": dict(objective="regression", categorical_features=(3,),
                        bagging_fraction=0.8, bagging_freq=1, growth_policy="depthwise"),
    "multiclass": dict(objective="multiclass", num_class=3, feature_fraction=0.7),
}


def _resume_data(mode):
    if mode == "categorical":
        return make_cat_regression()
    if mode == "multiclass":
        x, y = load_xy("iris")
        return x, y
    return make_binary(noise=1.5)


@pytest.mark.parametrize("early_stopping", [False, True], ids=["full", "early_stopping"])
@pytest.mark.parametrize("mode", list(RESUME_MODES))
def test_resume_is_byte_identical(tmp_path, mode, early_stopping):
    x, y = _resume_data(mode)
    valid = None
    kw = dict(num_iterations=14, num_leaves=7, min_data_in_leaf=5, seed=3, **RESUME_MODES[mode])
    if early_stopping:
        valid = np.arange(len(y)) % 4 == 0
        # stops after the cut (dart never stops: it runs all 30 rounds)
        kw.update(num_iterations=30, early_stopping_round=3, learning_rate=0.3)
    plain = train(x, y, TrainConfig(**kw), device="cpu", valid_mask=valid)
    full = train(x, y, TrainConfig(**kw), device="cpu", valid_mask=valid,
                 checkpoint_dir=str(tmp_path / "full"), checkpoint_every=3)
    assert full.to_model_string() == plain.to_model_string()   # checkpoints change nothing
    stop_at = min(7, len(full.trees) // full.num_class - 1)
    assert stop_at >= 3
    ck = str(tmp_path / "cut")
    with pytest.raises(Stop):
        train(x, y, TrainConfig(delegate=Recorder(stop_at=stop_at), **kw), device="cpu",
              valid_mask=valid, checkpoint_dir=ck, checkpoint_every=3)
    assert PC.load_checkpoint(ck).round == stop_at // 3 * 3
    resumed = train(x, y, TrainConfig(**kw), device="cpu", valid_mask=valid,
                    checkpoint_dir=ck, checkpoint_every=3, resume_from=ck)
    assert resumed.to_model_string() == full.to_model_string()
    assert resumed.best_iteration == full.best_iteration


def test_resume_from_an_empty_directory_is_a_fresh_fit(tmp_path):
    x, y = make_binary()
    cfg = TrainConfig(objective="binary", num_iterations=4, num_leaves=7)
    ck = str(tmp_path / "auto")
    a = train(x, y, cfg, device="cpu", checkpoint_dir=ck, resume_from=ck)
    assert a.to_model_string() == train(x, y, cfg, device="cpu").to_model_string()
    assert PC.load_checkpoint(ck).round == 4
    # a finished run resumed: nothing left to grow, the same model
    assert train(x, y, cfg, device="cpu", checkpoint_dir=ck,
                 resume_from=ck).to_model_string() == a.to_model_string()


def test_resume_refuses_another_configuration_or_bag(tmp_path):
    x, y = make_binary()
    kw = dict(objective="binary", num_iterations=6, num_leaves=7, bagging_fraction=0.7,
              bagging_freq=1)
    ck = str(tmp_path / "ck")
    with pytest.raises(Stop):
        train(x, y, TrainConfig(delegate=Recorder(stop_at=4), **kw), device="cpu",
              checkpoint_dir=ck, checkpoint_every=2)
    with pytest.raises(ValueError, match="fingerprint"):
        train(x, y, TrainConfig(**{**kw, "num_leaves": 15}), device="cpu", resume_from=ck)
    rdir = os.path.join(ck, open(os.path.join(ck, "LATEST")).read().strip())
    with np.load(os.path.join(rdir, "arrays.npz")) as z:
        scores, bag = z["scores"], z["bag"]
    np.savez(os.path.join(rdir, "arrays.npz"), scores=scores, bag=1.0 - bag)
    with pytest.raises(ValueError, match="bagging mask"):
        train(x, y, TrainConfig(**kw), device="cpu", resume_from=ck)


@pytest.mark.parametrize("kw", [
    dict(objective="regression"),
    dict(objective="regression", bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8),
    dict(objective="regression", early_stopping_round=2, learning_rate=0.5),
], ids=["gbdt", "bagging", "early_stopping"])
def test_checkpoint_files_equal_jax(reference_device_grower, tmp_path, kw):
    """The same fit writes the same round directories, booster.json byte
    for byte, the same state.json and arrays."""
    x, y = load_xy("diabetes")
    cfg = dict(num_iterations=10, num_leaves=7, min_data_in_leaf=5, seed=2, **kw)
    valid = np.arange(len(y)) % 3 == 0 if "early_stopping_round" in kw else None
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = JT.train(x, y, JT.TrainConfig(**cfg), shard=False, checkpoint_dir=jd,
                   checkpoint_every=4, valid_mask=valid)
    port = train(x, y, TrainConfig(**cfg), device="cpu", checkpoint_dir=pd, checkpoint_every=4,
                 valid_mask=valid)
    assert port.to_model_string() == ref.to_model_string()
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    for r in (e for e in os.listdir(jd) if e.startswith("round-")):
        for name in ("booster.json",):
            assert open(os.path.join(pd, r, name)).read() == open(os.path.join(jd, r, name)).read()
        sj = json.load(open(os.path.join(jd, r, "state.json")))
        sp = json.load(open(os.path.join(pd, r, "state.json")))
        bj, bp = sj.pop("best_val"), sp.pop("best_val")
        assert sp == sj
        assert (bj is None) == (bp is None)
        if bj is not None:
            np.testing.assert_allclose(bp, bj, rtol=1e-6)
        with np.load(os.path.join(jd, r, "arrays.npz")) as zj, \
                np.load(os.path.join(pd, r, "arrays.npz")) as zp:
            assert sorted(zj.files) == sorted(zp.files)
            np.testing.assert_allclose(zp["scores"], zj["scores"], rtol=RTOL, atol=ATOL)
            if "bag" in zj.files:
                np.testing.assert_array_equal(zp["bag"], zj["bag"])


@pytest.mark.parametrize("kw", [
    dict(objective="regression"),
    dict(objective="regression", bagging_fraction=0.7, bagging_freq=2),
], ids=["gbdt", "bagging"])
def test_jax_written_checkpoint_resumes_in_the_port(reference_device_grower, tmp_path, kw):
    x, y = load_xy("diabetes")
    cfg = dict(num_iterations=10, num_leaves=7, min_data_in_leaf=5, seed=2, **kw)
    ref = JT.train(x, y, JT.TrainConfig(**cfg), shard=False)
    ck = str(tmp_path / "jax")
    with pytest.raises(Stop):
        JT.train(x, y, JT.TrainConfig(delegate=Recorder(stop_at=7), **cfg), shard=False,
                 checkpoint_dir=ck, checkpoint_every=3)
    want = jload_checkpoint(ck)
    got = PC.load_checkpoint(ck)
    assert got.round == want.round == 6
    assert got.fingerprint == want.fingerprint == PC.config_fingerprint(
        TrainConfig(**cfg), len(y), x.shape[1], 1)
    assert got.booster.to_model_string() == want.booster.to_model_string()
    assert got.rng_state == want.rng_state
    np.testing.assert_array_equal(got.scores, want.scores)
    resumed = train(x, y, TrainConfig(**cfg), device="cpu", resume_from=ck)
    assert_same_trees(ref, resumed)
    assert resumed.to_model_string() == ref.to_model_string()


# -- delegates --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(objective="regression", early_stopping_round=2, learning_rate=0.5),
    dict(objective="regression", boosting_type="dart", drop_rate=0.4),
    dict(objective="regression"),
], ids=["early_stopping", "dart", "no_validation"])
def test_delegate_hooks_fire_in_jax_order(reference_device_grower, kw):
    x, y = load_xy("diabetes")
    cfg = dict(num_iterations=12, num_leaves=7, min_data_in_leaf=5, seed=2, **kw)
    valid = None if kw == dict(objective="regression") else np.arange(len(y)) % 3 == 0
    jd, pd = Recorder(), Recorder()
    ref = JT.train(x, y, JT.TrainConfig(delegate=jd, **cfg), shard=False, valid_mask=valid)
    port = train(x, y, TrainConfig(delegate=pd, **cfg), device="cpu", valid_mask=valid)
    assert pd.events == jd.events
    assert pd.events[-1][-1] is True     # the last round says so
    for a, b in zip(jd.metrics, pd.metrics):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=1e-6)
    assert_same_trees(ref, port)


@pytest.mark.parametrize("policy", ["lossguide", "depthwise"])
def test_delegate_learning_rate_changes_leaves_as_in_jax(reference_device_grower, policy):
    x, y = load_xy("diabetes")
    cfg = dict(objective="regression", num_iterations=6, num_leaves=7, min_data_in_leaf=5,
               growth_policy=policy, learning_rate=0.3)
    ref = JT.train(x, y, JT.TrainConfig(delegate=Recorder(decay=0.5), **cfg), shard=False)
    port = train(x, y, TrainConfig(delegate=Recorder(decay=0.5), **cfg), device="cpu")
    assert_same_trees(ref, port)
    plain = train(x, y, TrainConfig(**cfg), device="cpu")
    ratio = np.abs(port.trees[3].values).sum() / np.abs(plain.trees[3].values).sum()
    assert ratio < 0.5


def test_learning_rate_survives_resume(tmp_path):
    """A checkpoint keeps the delegate's current rate; the resumed fit
    starts from it."""
    x, y = load_xy("diabetes")
    cfg = dict(objective="regression", num_iterations=8, num_leaves=7, min_data_in_leaf=5,
               learning_rate=0.4)
    full = train(x, y, TrainConfig(delegate=Recorder(decay=0.8), **cfg), device="cpu")
    ck = str(tmp_path / "ck")
    with pytest.raises(Stop):
        train(x, y, TrainConfig(delegate=Recorder(stop_at=5, decay=0.8), **cfg), device="cpu",
              checkpoint_dir=ck, checkpoint_every=2)
    state = PC.load_checkpoint(ck)
    assert state.round == 4
    np.testing.assert_allclose(state.lr, 0.4 * 0.8 ** 4)
    resumed = train(x, y, TrainConfig(delegate=Recorder(decay=0.8), **cfg), device="cpu",
                    resume_from=ck)
    assert resumed.to_model_string() == full.to_model_string()
