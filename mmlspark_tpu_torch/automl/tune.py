"""TuneHyperparameters + FindBestModel (automl/TuneHyperparameters.scala:97-150,
automl/FindBestModel.scala).

Randomized search over one or more estimators with k-fold CV. The reference
parallelizes fits with a thread pool over the Spark cluster; here
``parallelism`` candidates are cross-validated at once on a thread pool.

The PyTorch port of ``mmlspark_tpu.automl.tune``. Candidates run on the
thread pool whatever their device. On a card the GBDT trainer captures
its fused rounds as CUDA graphs one capture at a time, in thread-local
mode (``core.device.CAPTURE_LOCK``), so concurrent fits do not break one
another's launches; each fit is deterministic, so ``all_metrics`` and
``best_params`` are the same at every ``parallelism``.
"""

from __future__ import annotations

import concurrent.futures as _futures
from typing import Any, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.metrics import MetricConstants, classification_metrics, regression_metrics
from mmlspark_tpu_torch.core.params import ComplexParam, HasLabelCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.automl.hyperparams import RandomSpace


class EvaluationUtils:
    """automl/EvaluationUtils.scala analogue: metric resolution helpers
    shared by TuneHyperparameters / FindBestModel."""

    @staticmethod
    def is_higher_better(metric: str) -> bool:
        return metric in MetricConstants.HIGHER_IS_BETTER

    @staticmethod
    def default_metric(task: str) -> str:
        return (
            MetricConstants.ACCURACY
            if task in ("classification", "classifier")
            else MetricConstants.RMSE
        )

    @staticmethod
    def evaluate(df: DataFrame, label_col: str, metric: str) -> float:
        return _evaluate(df, label_col, metric)


def _evaluate(df: DataFrame, label_col: str, metric: str) -> float:
    y = df[label_col]
    pred = df["prediction"]
    if metric in MetricConstants.ALL_REGRESSION:
        return regression_metrics(y, pred)[metric]
    scores = None
    if "probability" in df.columns:
        probs = df["probability"]
        if probs.ndim == 2 and probs.shape[1] == 2:
            scores = probs[:, 1]
    return classification_metrics(y, pred, scores)[metric]


class TuneHyperparameters(Estimator, HasLabelCol):
    models = ComplexParam("estimators to search over")
    hyperparams = ComplexParam("list of (estimator_index, spaces) or shared spaces list")
    evaluation_metric = Param("metric name", default=MetricConstants.ACCURACY, type_=str)
    number_of_folds = Param("k-fold count", default=3, type_=int)
    number_of_runs = Param("random draws per estimator", default=8, type_=int)
    parallelism = Param("concurrent fits (host-bound estimators only)", default=1, type_=int)
    seed = Param("search seed", default=0, type_=int)

    def fit(self, df: DataFrame) -> "TuneHyperparametersModel":
        estimators: Sequence[Estimator] = self.get_or_fail("models")
        spaces = self.get_or_fail("hyperparams")
        metric = self.get("evaluation_metric")
        higher = metric in MetricConstants.HIGHER_IS_BETTER
        k = self.get("number_of_folds")
        folds = df.random_split([1.0] * k, seed=self.get("seed"))

        candidates: list = []
        for ei, est in enumerate(estimators):
            est_spaces = spaces[ei] if isinstance(spaces[0], list) else spaces
            draws = RandomSpace(est_spaces, seed=self.get("seed") + ei).param_maps(
                self.get("number_of_runs")
            )
            for pm in draws:
                unknown = sorted(k_ for k_ in pm if k_ not in est.params())
                if unknown:
                    raise ValueError(
                        f"hyperparameter(s) {', '.join(map(repr, unknown))} "
                        f"are not params of estimator "
                        f"{type(est).__name__}; a sampled param that the "
                        "estimator ignores silently searches nothing"
                    )
                candidates.append((est, dict(pm)))

        def cv_score(est: Estimator, pm: dict) -> float:
            scores = []
            for i in range(k):
                train = None
                for j in range(k):
                    if j == i:
                        continue
                    train = folds[j] if train is None else train.union(folds[j])
                model = est.copy(pm).fit(train)
                scores.append(_evaluate(model.transform(folds[i]), self.get("label_col"), metric))
            return float(np.nanmean(scores))

        par = self.get("parallelism")
        if par > 1:
            with _futures.ThreadPoolExecutor(max_workers=par) as pool:
                results = list(pool.map(lambda c: cv_score(*c), candidates))
        else:
            results = [cv_score(est, pm) for est, pm in candidates]

        arr = np.asarray(results, dtype=np.float64)
        if np.isnan(arr).all():
            raise ValueError(
                f"all {len(arr)} candidates scored NaN for metric "
                f"{metric!r}; check folds contain every class"
            )
        best_i = int(np.nanargmax(arr) if higher else np.nanargmin(arr))
        best_est, best_pm = candidates[best_i]
        best_model = best_est.copy(best_pm).fit(df)
        out = TuneHyperparametersModel(label_col=self.get("label_col"))
        out.set(
            best_model=best_model,
            best_metric=float(results[best_i]),
            best_params=dict(best_pm),
            all_metrics=[float(r) for r in results],
        )
        return out


class TuneHyperparametersModel(Model, HasLabelCol):
    best_model = ComplexParam("winning fitted model")
    best_metric = Param("winning CV metric", type_=float)
    best_params = Param("winning param map", default={}, type_=dict)
    all_metrics = Param("metric per candidate", default=[], type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_fail("best_model").transform(df)


class FindBestModel(Estimator):
    """Evaluate fitted models on a dataset, keep the best
    (automl/FindBestModel.scala)."""

    models = ComplexParam("fitted Transformer models to compare")
    evaluation_metric = Param("metric name", default=MetricConstants.ACCURACY, type_=str)
    label_col = Param("label column", default="label", type_=str)

    def fit(self, df: DataFrame) -> "FindBestModelResult":
        metric = self.get("evaluation_metric")
        higher = metric in MetricConstants.HIGHER_IS_BETTER
        models = self.get_or_fail("models")
        scores = [
            _evaluate(m.transform(df), self.get("label_col"), metric) for m in models
        ]
        best_i = int(np.nanargmax(scores) if higher else np.nanargmin(scores))
        out = FindBestModelResult()
        out.set(
            best_model=models[best_i],
            best_model_metrics={metric: float(scores[best_i])},
            all_model_metrics=[float(s) for s in scores],
        )
        return out


class FindBestModelResult(Model):
    best_model = ComplexParam("best fitted model")
    best_model_metrics = Param("metrics of the winner", default={}, type_=dict)
    all_model_metrics = Param("metric per candidate", default=[], type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.get_or_fail("best_model").transform(df)
