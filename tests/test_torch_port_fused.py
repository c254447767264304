"""Fused rounds (``fused_rounds``) in the port, on the CPU.

On the CPU the fused round runs eagerly (no CUDA graph), through the same
static buffers, device-side round index, Threefry keys, feature-mask
gather, bag carry and record/metric buffers the card's captured round
uses; so these tests exercise the restructured round, and the card tests
(test_torch_port_cuda.py) its capture.

Tolerance: none. Model strings are byte-identical with ``fused_rounds`` 0
(auto), 1 (the same round run eagerly, one chunk per read) and 4, and
with a no-op delegate (which sends the fit through the per-round loop),
for every fit type; the device-side
round key equals ``sampling.round_key`` (and ``jax.random.fold_in``) bit for
bit; a fused L2 fit's model string equals the JAX package's (whose default
is its scan-fused path).
"""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.train import TrainConfig as JConfig
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import (
    LightGBMClassifier,
    LightGBMDelegate,
    LightGBMRanker,
    LightGBMRegressor,
    TrainConfig,
    sampling,
    train,
)

T = importlib.import_module("mmlspark_tpu_torch.models.gbdt.train")
torch.set_num_threads(1)


def _data(n=1500, d=8, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    flip = rng.random(n) < 0.15
    y_noisy = np.where(flip, 1 - y, y)
    yr = x[:, 0] * 2.0 + rng.normal(size=n)
    ym = np.digitize(x[:, 0], [-0.5, 0.5]).astype(np.float64)
    x_cat = x.copy()
    x_cat[:, 7] = rng.integers(0, 12, n)
    y_cat = ((x_cat[:, 7] % 3 == 0) ^ (x[:, 0] > 0)).astype(np.float64)
    return x, y, y_noisy, yr, ym, x_cat, y_cat


X, Y, Y_NOISY, YR, YM, X_CAT, Y_CAT = _data()
VALID = np.zeros(len(Y), bool)
VALID[1100:] = True

CASES = {
    "gbdt": (X, Y, dict(), {}),
    "depthwise": (X, Y, dict(growth_policy="depthwise"), {}),
    "goss": (X, Y, dict(boosting_type="goss"), {}),
    "rf": (X, Y, dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1), {}),
    "bagged": (X, Y, dict(bagging_fraction=0.7, bagging_freq=3, feature_fraction=0.6), {}),
    "multiclass": (X, YM, dict(objective="multiclass", num_class=3), {}),
    "categorical": (X_CAT, Y_CAT, dict(categorical_features=(7,)), {}),
    "early_stopped": (X, Y_NOISY, dict(early_stopping_round=2, learning_rate=0.5,
                                       num_leaves=31, min_data_in_leaf=2),
                      {"valid_mask": VALID}),
    "rf_early_stopped": (X, Y_NOISY, dict(boosting_type="rf", early_stopping_round=3,
                                          metric="auc"), {"valid_mask": VALID}),
    "quantile_renewal": (X, YR, dict(objective="quantile", alpha=0.3,
                                     bagging_fraction=0.8, bagging_freq=1), {}),
    "l1_goss_renewal": (X, YR, dict(objective="l1", boosting_type="goss"), {}),
}


def _fit(case, fused_rounds, delegate=None, **extra):
    x, y, kw, fit_kw = CASES[case]
    cfg = TrainConfig(**{**dict(num_iterations=14, num_leaves=7, min_data_in_leaf=5, seed=4),
                         **kw}, delegate=delegate)
    return train(x, y, cfg, device="cpu", fused_rounds=fused_rounds, **{**fit_kw, **extra})


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_strings_byte_identical_across_fused_rounds(case):
    strings = []
    for fr in (0, 1, 4):
        b = _fit(case, fr)
        strings.append(b.to_model_string())
        assert (T.fused["chunks"] == 0) == (fr == 1)
    per_round = _fit(case, 0, delegate=LightGBMDelegate())
    assert T.fused["chunks"] == 0
    assert strings[0] == strings[1] == strings[2] == per_round.to_model_string()
    if case.endswith("early_stopped"):
        assert 0 < b.best_iteration < 14 and len(b.trees) < 14


@pytest.mark.parametrize("case", ["gbdt", "bagged"])
def test_checkpointed_and_resumed_fits_byte_identical(case, tmp_path):
    """A fused fit checkpoints at its chunk ends and gives the plain fit's
    model; a fit interrupted at round 7 (the per-round loop, through a
    delegate) or ended at round 10 (fused) and resumed, fused or not, gives
    the uninterrupted fit's model."""
    x, y, kw, _ = CASES[case]
    base = dict(num_leaves=7, min_data_in_leaf=5, seed=4, **kw)
    full = _fit(case, 1).to_model_string()

    class Stop(LightGBMDelegate):
        def before_train_iteration(self, iteration):
            if iteration == 7:
                raise KeyboardInterrupt

    for fr in (0, 4, 1):
        eager = str(tmp_path / f"eager{fr}")
        with pytest.raises(KeyboardInterrupt):
            train(x, y, TrainConfig(num_iterations=14, delegate=Stop(), **base), device="cpu",
                  checkpoint_dir=eager, checkpoint_every=5)
        fused = str(tmp_path / f"fused{fr}")
        train(x, y, TrainConfig(num_iterations=10, **base), device="cpu", fused_rounds=fr,
              checkpoint_dir=fused, checkpoint_every=5)
        for d in (eager, fused):
            resumed = _fit(case, fr, checkpoint_dir=d, checkpoint_every=5, resume_from=d)
            assert resumed.to_model_string() == full, (case, fr, d)
        checkpointed = _fit(case, fr, checkpoint_dir=str(tmp_path / f"plain{fr}"),
                            checkpoint_every=5)
        assert checkpointed.to_model_string() == full


def test_continued_and_ranker_fits_byte_identical():
    base = _fit("gbdt", 1)
    a = _fit("gbdt", 0, init_booster=base).to_model_string()
    assert a == _fit("gbdt", 1, init_booster=base).to_model_string()
    rng = np.random.default_rng(2)
    xq = rng.normal(size=(600, 5)).astype(np.float32)
    rel = (xq[:, 0] > 0).astype(np.float64) + (xq[:, 1] > 0.5)
    gid = np.repeat(np.arange(30), 20)
    vm = np.zeros(600, bool)
    vm[-100:] = True
    cfg = TrainConfig(objective="lambdarank", num_iterations=8, num_leaves=7,
                      min_data_in_leaf=5, seed=0, early_stopping_round=3)
    out = [train(xq, rel, cfg, group_ids=gid, valid_mask=vm, device="cpu", fused_rounds=fr)
           .to_model_string() for fr in (0, 1)]
    assert T.fused["chunks"] == 0 and out[0] == out[1]


def test_chunk_rule_and_eligibility():
    """The JAX package's chunk rule (train.py:1347-1391) and its ``fast``
    predicate: delegates and dart take the per-round loop."""
    _fit("gbdt", 0)
    assert T.fused == {"chunks": 1, "captures": 0, "replays": 0}
    _fit("gbdt", 4)
    assert T.fused["chunks"] == 4                  # 14 rounds in chunks of 4
    _fit("early_stopped", 0)
    assert T.fused["chunks"] == 1                  # min(T, max(16, patience)) = 14
    x, y, kw, _ = CASES["gbdt"]
    train(x, y, TrainConfig(num_iterations=4, num_leaves=7, boosting_type="dart", seed=1),
          device="cpu")
    assert T.fused["chunks"] == 0
    train(x, y, TrainConfig(num_iterations=4, num_leaves=7, delegate=LightGBMDelegate()),
          device="cpu")
    assert T.fused["chunks"] == 0


def test_checkpoint_chunks_align_to_checkpoint_every(tmp_path):
    _fit("gbdt", 0, checkpoint_dir=str(tmp_path / "c"), checkpoint_every=5)
    assert T.fused["chunks"] == 3                  # rounds 0-4, 5-9, 10-13


@pytest.mark.parametrize("est", ["classifier", "regressor", "ranker"])
def test_estimators_take_fused_rounds(est):
    x, y, *_ = CASES["gbdt"]
    df = DataFrame.from_dict({"features": x, "label": y, "q": np.arange(len(y)) // 10})
    make = {"classifier": LightGBMClassifier, "regressor": LightGBMRegressor,
            "ranker": lambda **kw: LightGBMRanker(group_col="q", **kw)}[est]
    strings = []
    for fr in (0, 1):
        m = make(num_iterations=4, num_leaves=7, device="cpu", fused_rounds=fr).fit(df)
        strings.append(m.get("model_string"))
        assert T.fused["chunks"] == (1 if fr == 0 else 0)
    assert strings[0] == strings[1]


def test_device_round_key_equals_the_host_key():
    """The round key from a device scalar (what the captured round
    computes) is ``sampling.round_key`` for rounds 0-1000, and JAX's
    ``fold_in(fold_in(PRNGKey(seed), it), stream)``."""
    for seed in (0, 7, 2**32 + 5):
        its = torch.arange(1001, dtype=torch.int64)
        for stream in (sampling.BAGGING_STREAM, sampling.GOSS_STREAM):
            k1, k2 = sampling.round_key(seed, its, stream)
            want = np.array([sampling.round_key(seed, i, stream) for i in range(1001)])
            np.testing.assert_array_equal(k1.numpy(), want[:, 0])
            np.testing.assert_array_equal(k2.numpy(), want[:, 1])
        for it in (0, 1, 999):
            jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), it), 1)
            got = sampling.round_key(seed, torch.tensor(it), 1)
            assert [int(v) for v in got] == [int(v) for v in np.asarray(jk)]
    u_dev = sampling.uniform(3, torch.tensor(17), sampling.GOSS_STREAM, 1000, "cpu")
    assert torch.equal(u_dev, sampling.uniform(3, 17, sampling.GOSS_STREAM, 1000, "cpu"))


@pytest.mark.parametrize("policy", ["lossguide", "depthwise"])
def test_fused_l2_fit_equals_the_jax_package(policy, monkeypatch):
    """The JAX package's default fit is its scan-fused path; the port's
    fused fit gives its model string (L2: both packages' arithmetic exact)."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")
    kw = dict(objective="regression", num_iterations=6, num_leaves=7, min_data_in_leaf=5,
              seed=2, growth_policy=policy, bagging_fraction=0.8, bagging_freq=2)
    ref = jtrain(X, YR, JConfig(**kw), shard=False)
    port = train(X, YR, TrainConfig(**kw), device="cpu")
    assert T.fused["chunks"] == 1
    assert port.to_model_string() == ref.to_model_string()


def test_entry_point_without_a_card_raises_before_fusing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(X, Y, TrainConfig(num_iterations=2), fused_rounds=4)
