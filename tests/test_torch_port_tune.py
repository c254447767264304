"""The port's ``automl/tune.py`` (TuneHyperparameters, FindBestModel,
EvaluationUtils) against the JAX package's, on the CPU.

The same seeded frame (``conftest.make_tabular_df``), models, spaces and
seed go through both packages; the port's learners run with
``device="cpu"``. Tolerances:

- the candidates' draws (``best_params`` and the order of
  ``all_metrics``): equal;
- LightGBM candidates' CV AUC, with the JAX package's gradients and
  device grower (``tests/test_torch_port_train.py``'s ``parity``): within
  ``GBDT_METRIC_ATOL`` = 1e-6. Split records are equal there, leaf values
  agree within 1e-4 relative (``tests/test_torch_port_gbdt.py``), and a
  fold's AUC moves only where two scores swap order (measured: 0.0, and
  0.0 with the port's own gradients too);
- LogisticRegression candidates' CV AUC: within ``LR_METRIC_ATOL`` = 1e-6
  (weights within ``2e-6 * max |w|``, ``tests/test_torch_port_pipeline.py``;
  measured: 0.0);
- a carried model's FindBestModel metrics: within the same tolerances;
- the port at ``parallelism`` 1 and 2: equal, number for number.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import mmlspark_tpu as J
from mmlspark_tpu.automl import FindBestModel as JFindBestModel
from mmlspark_tpu.automl import TuneHyperparameters as JTune
from mmlspark_tpu.automl.hyperparams import DiscreteHyperParam as JDiscrete
from mmlspark_tpu.automl.hyperparams import RangeHyperParam as JRange
from mmlspark_tpu.models.gbdt import LightGBMClassifier as JLightGBMClassifier
from mmlspark_tpu.models.linear import LogisticRegression as JLogisticRegression

import mmlspark_tpu_torch as P
from mmlspark_tpu_torch.automl import (
    DiscreteHyperParam,
    EvaluationUtils,
    FindBestModel,
    FindBestModelResult,
    RangeHyperParam,
    TuneHyperparameters,
    tune,
)
from mmlspark_tpu_torch.core.device import HasDevice
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier
from mmlspark_tpu_torch.models.linear import LogisticRegression
from mmlspark_tpu_torch.train import TrainedClassifierModel
from mmlspark_tpu_torch.train.train import stage_from_jax_parts

from conftest import make_tabular_df
from test_torch_port_train import jax_parts, parity  # noqa: F401  the parity fixture

torch.set_num_threads(1)

GBDT_METRIC_ATOL = 1e-6
LR_METRIC_ATOL = 1e-6
GBDT = dict(num_iterations=5, min_data_in_leaf=5, seed=3)


def _frames(n: int = 300, seed: int = 0) -> tuple:
    jdf = make_tabular_df(n=n, d=6, n_classes=2, num_partitions=2, seed=seed)
    cols = {"features": jdf["features"], "label": jdf["label"]}
    return jdf, P.DataFrame.from_dict(cols, num_partitions=2)


def _spaces(discrete, rng_cls) -> list:
    return [
        [("num_leaves", discrete([5, 7])), ("learning_rate", rng_cls(0.05, 0.2))],
        [("reg_param", rng_cls(1e-4, 1e-2, log=True))],
    ]


def _jax_tune(jdf, parallelism: int = 1):
    t = JTune(label_col="label", evaluation_metric="AUC", number_of_folds=3,
              number_of_runs=2, parallelism=parallelism, seed=11)
    t.set(models=[JLightGBMClassifier(**GBDT), JLogisticRegression(max_iter=30)],
          hyperparams=_spaces(JDiscrete, JRange))
    return t.fit(jdf)


def _port_tune(pdf, parallelism: int = 1):
    t = TuneHyperparameters(label_col="label", evaluation_metric="AUC", number_of_folds=3,
                            number_of_runs=2, parallelism=parallelism, seed=11)
    t.set(models=[LightGBMClassifier(device="cpu", **GBDT),
                  LogisticRegression(max_iter=30, device="cpu")],
          hyperparams=_spaces(DiscreteHyperParam, RangeHyperParam))
    return t.fit(pdf)


def test_tune_equals_jax(parity):  # noqa: F811
    jdf, pdf = _frames()
    jm, pm = _jax_tune(jdf), _port_tune(pdf)
    assert pm.get("best_params") == jm.get("best_params")
    want, got = np.array(jm.get("all_metrics")), np.array(pm.get("all_metrics"))
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=GBDT_METRIC_ATOL)
    np.testing.assert_allclose(got[2:], want[2:], rtol=0, atol=LR_METRIC_ATOL)
    assert abs(pm.get("best_metric") - jm.get("best_metric")) <= GBDT_METRIC_ATOL
    assert type(pm.get("best_model")).__name__ == type(jm.get("best_model")).__name__


def test_tune_parallelism_two_equals_one():
    """Host-bound candidates run concurrently on the CPU; the results
    are the same number for number."""
    _, pdf = _frames(seed=1)
    one, two = _port_tune(pdf, 1), _port_tune(pdf, 2)
    assert two.get("all_metrics") == one.get("all_metrics")
    assert two.get("best_params") == one.get("best_params")
    assert two.get("best_metric") == one.get("best_metric")


def test_tune_rejects_an_unknown_param_as_jax_does():
    jdf, pdf = _frames()
    jt = JTune(label_col="label", number_of_runs=1, number_of_folds=2)
    jt.set(models=[JLogisticRegression()], hyperparams=[("num_leaves", JDiscrete([7]))])
    pt = TuneHyperparameters(label_col="label", number_of_runs=1, number_of_folds=2)
    pt.set(models=[LogisticRegression(device="cpu")],
           hyperparams=[("num_leaves", DiscreteHyperParam([7]))])
    with pytest.raises(ValueError, match="num_leaves.*LogisticRegression") as pe:
        pt.fit(pdf)
    with pytest.raises(ValueError) as je:
        jt.fit(jdf)
    assert str(pe.value) == str(je.value)


class _Probe(Estimator, HasDevice):
    """Records how many fits overlap; scores a constant prediction."""

    live = 0
    most = 0
    lock = threading.Lock()

    def fit(self, df):
        cls = type(self)
        with cls.lock:
            cls.live += 1
            cls.most = max(cls.most, cls.live)
        time.sleep(0.1)
        with cls.lock:
            cls.live -= 1
        return _ProbeModel()


class _ProbeModel(Model):
    def transform(self, df):
        return df.with_column("prediction", lambda p: np.zeros(len(p["label"])))


@pytest.mark.parametrize("device,card", [
    ("cuda", True),    # card fits overlap: the GBDT trainer serialises its captures alone
    ("cpu", True),     # host-bound fits overlap
    ("cuda", False),   # no card
])
def test_candidates_overlap_at_every_device(monkeypatch, device, card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    _Probe.live = _Probe.most = 0
    _, pdf = _frames(n=60)
    t = TuneHyperparameters(label_col="label", number_of_runs=8, number_of_folds=2,
                            parallelism=4, evaluation_metric="accuracy")
    t.set(models=[_Probe(device=device)], hyperparams=[("device", DiscreteHyperParam([device]))])
    t.fit(pdf)
    assert _Probe.most > 1


def test_graph_captures_share_one_process_lock():
    """The GBDT trainer's and the pipeline compiler's CUDA graph captures
    take the same lock, so a tuning run's concurrent card fits capture one
    at a time."""
    import importlib

    from mmlspark_tpu_torch.compiler import fuser
    from mmlspark_tpu_torch.core import device

    gbdt_train = importlib.import_module("mmlspark_tpu_torch.models.gbdt.train")

    assert gbdt_train.CAPTURE_LOCK is device.CAPTURE_LOCK
    assert fuser._CAPTURE_LOCK is device.CAPTURE_LOCK
    assert not hasattr(tune, "_CARD_LOCK")


def test_concurrent_gbdt_fits_equal_sequential_fits():
    """Two LightGBM fits on two threads give the models they give one
    after the other, byte for byte."""
    frames = [_frames(seed=s)[1] for s in (2, 3)]
    est = LightGBMClassifier(device="cpu", **GBDT)
    alone = [est.fit(f).get("model_string") for f in frames]
    out = [None, None]

    def fit(i):
        out[i] = est.fit(frames[i]).get("model_string")

    threads = [threading.Thread(target=fit, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert out == alone


def test_find_best_model_equals_jax_on_carried_models():
    jdf, pdf = _frames()
    jms = [JLogisticRegression(max_iter=m).fit(jdf) for m in (3, 30)]
    pms = [stage_from_jax_parts(jax_parts(m), device="cpu") for m in jms]
    for metric in ("accuracy", "AUC", "f1_score"):
        jb = JFindBestModel(models=jms, evaluation_metric=metric).fit(jdf)
        pb = FindBestModel(models=pms, evaluation_metric=metric).fit(pdf)
        assert isinstance(pb, FindBestModelResult)
        np.testing.assert_allclose(pb.get("all_model_metrics"), jb.get("all_model_metrics"),
                                   rtol=0, atol=LR_METRIC_ATOL)
        assert pb.get("best_model") is pms[jms.index(jb.get("best_model"))]
        assert list(pb.get("best_model_metrics")) == [metric]


def test_find_best_model_over_tuned_and_trained_models(parity):  # noqa: F811
    """The chip script's flow: FindBestModel over a tuned model and a
    TrainClassifier model, each carried from the JAX package's fit."""
    from mmlspark_tpu.train import TrainClassifier as JTrainClassifier

    jdf, pdf = _frames()
    jt = _jax_tune(jdf)
    jc = JTrainClassifier(label_col="label", model=JLightGBMClassifier(num_leaves=7, **GBDT)).fit(jdf)
    pc = TrainedClassifierModel.from_jax_params(jax_parts(jc)["params"], device="cpu")
    pt = stage_from_jax_parts(jax_parts(jt.get("best_model")), device="cpu")
    jb = JFindBestModel(models=[jt.get("best_model"), jc], evaluation_metric="AUC").fit(jdf)
    pb = FindBestModel(models=[pt, pc], evaluation_metric="AUC").fit(pdf)
    np.testing.assert_allclose(pb.get("all_model_metrics"), jb.get("all_model_metrics"),
                               rtol=0, atol=GBDT_METRIC_ATOL)


def test_evaluation_utils_equal_jax():
    from mmlspark_tpu.automl.tune import EvaluationUtils as JEval

    for m in ("accuracy", "AUC", "R^2", "root_mean_squared_error", "mean_absolute_error"):
        assert EvaluationUtils.is_higher_better(m) == JEval.is_higher_better(m)
    for task in ("classification", "classifier", "regression"):
        assert EvaluationUtils.default_metric(task) == JEval.default_metric(task)
    r = np.random.default_rng(0)
    p = r.dirichlet([1, 1], 50)
    cols = {"label": r.integers(0, 2, 50), "prediction": p.argmax(1).astype(np.float64),
            "probability": p}
    for m in ("accuracy", "AUC", "mean_squared_error"):
        assert EvaluationUtils.evaluate(P.DataFrame.from_dict(cols), "label", m) == \
            JEval.evaluate(J.DataFrame.from_dict(cols), "label", m)
