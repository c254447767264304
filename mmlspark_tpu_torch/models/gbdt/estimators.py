"""LightGBM-compatible estimator facades on the port's GBDT.

The port of ``mmlspark_tpu.models.gbdt.estimators`` for the first slice:
``LightGBMClassifier`` / ``LightGBMClassificationModel`` and
``LightGBMRegressor`` / ``LightGBMRegressionModel`` — ``fit(DataFrame)``
trains on the device, ``transform(DataFrame)`` scores on the device.

The params are the JAX package's, plus ``device`` (``"cuda"`` by default;
``"cpu"`` runs the plain PyTorch histogram versions). A param whose
feature is not ported yet must keep its default: ``fit`` raises
``NotImplementedError`` naming the ROADMAP.md item otherwise. The ranker,
``num_batches`` and the pipeline-compiler hooks (``fusable_kernel``) are not
ported (ROADMAP.md, Queue A items 3 and 6).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasFeaturesCol,
    HasInitScoreCol,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasValidationIndicatorCol,
    HasWeightCol,
    Param,
    Params,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.models.gbdt import objectives
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.train import TrainConfig, train


class HasDevice(Params):
    device = Param(
        "torch device to train/score on: 'cuda' (default; raises without a "
        "card) or 'cpu'", default="cuda", type_=str,
        validator=lambda v: v.split(":")[0] in ("cuda", "cpu"),
    )


# params whose feature the port has not ported: name -> ROADMAP item.
# They must keep their defaults.
_UNPORTED_PARAMS = {
    "num_batches": "num_batches",
    "checkpoint_dir": "checkpoint/resume",
    "resume_from": "checkpoint/resume",
    "model_string": "continued training",
    "delegate": "delegates",
    "validation_indicator_col": "validation and early stopping",
    "categorical_slot_indexes": "categorical splits",
}


class _LightGBMParams(
    HasFeaturesCol,
    HasLabelCol,
    HasWeightCol,
    HasValidationIndicatorCol,
    HasInitScoreCol,
    HasDevice,
):
    num_iterations = Param("boosting rounds", default=100, type_=int)
    learning_rate = Param("shrinkage", default=0.1, type_=float)
    num_leaves = Param("max leaves per tree", default=31, type_=int)
    max_depth = Param("max tree depth (-1 = unlimited)", default=-1, type_=int)
    lambda_l2 = Param("L2 leaf regularization", default=0.0, type_=float)
    lambda_l1 = Param("L1 leaf regularization (ThresholdL1)", default=0.0, type_=float)
    min_sum_hessian_in_leaf = Param(
        "min child hessian mass for a valid split", default=1e-3, type_=float
    )
    min_gain_to_split = Param("min split gain", default=0.0, type_=float)
    min_data_in_leaf = Param("min rows per leaf", default=20, type_=int)
    max_bin = Param(
        "histogram bins (max 255: uint8 bin matrix)",
        default=255,
        type_=int,
        validator=lambda v: 2 <= v <= 255,
    )
    feature_fraction = Param("feature subsample per tree", default=1.0, type_=float)
    bagging_fraction = Param("row subsample (not ported: keep 1.0)", default=1.0, type_=float)
    bagging_freq = Param("bagging frequency (0=off; not ported)", default=0, type_=int)
    early_stopping_round = Param("early stopping patience (0=off; not ported)", default=0, type_=int)
    metric = Param("eval metric name ('' = objective default)", default="", type_=str)
    parallelism = Param(
        "data_parallel (voting_parallel is not ported)",
        default="data_parallel",
        type_=str,
    )
    growth_policy = Param(
        "lossguide (LightGBM leaf-wise, default) | depthwise (level-wise; "
        "one multi-leaf histogram pass per level)",
        default="lossguide",
        type_=str,
        validator=lambda v: v in ("lossguide", "depthwise"),
    )
    default_listen_port = Param("parity no-op (no sockets)", default=12400, type_=int)
    use_barrier_execution_mode = Param("parity no-op", default=False, type_=bool)
    top_k = Param("voting_parallel K (parity)", default=20, type_=int)
    boost_from_average = Param("init score from label average", default=True, type_=bool)
    boosting_type = Param(
        "gbdt (goss | dart | rf are not ported)",
        default="gbdt",
        type_=str,
        validator=lambda v: v in ("gbdt", "goss", "dart", "rf"),
    )
    drop_rate = Param("dart: per-iteration tree dropout rate", default=0.1, type_=float)
    max_drop = Param("dart: max trees dropped per iteration", default=50, type_=int)
    skip_drop = Param("dart: probability of skipping dropout", default=0.5, type_=float)
    top_rate = Param("goss: large-gradient retain fraction", default=0.2, type_=float)
    other_rate = Param("goss: small-gradient sample fraction", default=0.1, type_=float)
    eval_at = Param("ranking eval truncation (ndcg@k)", default=5, type_=int)
    categorical_slot_indexes = Param(
        "feature indices treated as categorical (not ported)", default=None,
    )
    model_string = Param("initial model for continued training (not ported)", default="", type_=str)
    alpha = Param("quantile level / huber delta", default=0.9, type_=float)
    tweedie_variance_power = Param("tweedie variance power in (1, 2)", default=1.5, type_=float)
    poisson_max_delta_step = Param(
        "poisson hessian stabilizer exp(score + step)", default=0.7, type_=float
    )
    fair_c = Param("fair-loss scale c", default=1.0, type_=float)
    num_batches = Param("fold training into k sequential batches (not ported)", default=0, type_=int)
    checkpoint_dir = Param("round-level checkpoints (not ported)", default="", type_=str)
    checkpoint_every = Param("boosting rounds between checkpoints", default=10, type_=int)
    resume_from = Param("checkpoint directory to resume from (not ported)", default="", type_=str)
    delegate = ComplexParam("LightGBMDelegate (not ported)")
    seed = Param("rng seed", default=0, type_=int)
    verbosity = Param("log level", default=-1, type_=int)

    def _check_ported(self) -> None:
        for name, item in _UNPORTED_PARAMS.items():
            value = self.get(name)
            if value not in (None, "", 0):
                raise NotImplementedError(
                    f"param {name}={value!r} is not ported to mmlspark_tpu_torch "
                    f"yet (ROADMAP.md Queue A item 3: {item})"
                )

    def _config(self, objective: str, num_class: int = 1) -> TrainConfig:
        return TrainConfig(
            objective=objective,
            num_class=num_class,
            num_iterations=self.get("num_iterations"),
            learning_rate=self.get("learning_rate"),
            num_leaves=self.get("num_leaves"),
            max_depth=self.get("max_depth"),
            lambda_l2=self.get("lambda_l2"),
            lambda_l1=self.get("lambda_l1"),
            min_sum_hessian_in_leaf=self.get("min_sum_hessian_in_leaf"),
            min_gain_to_split=self.get("min_gain_to_split"),
            min_data_in_leaf=self.get("min_data_in_leaf"),
            max_bin=self.get("max_bin"),
            feature_fraction=self.get("feature_fraction"),
            bagging_fraction=self.get("bagging_fraction"),
            bagging_freq=self.get("bagging_freq"),
            early_stopping_round=self.get("early_stopping_round"),
            metric=self.get("metric"),
            seed=self.get("seed"),
            parallelism=self.get("parallelism"),
            growth_policy=self.get("growth_policy"),
            top_k=self.get("top_k"),
            verbosity=self.get("verbosity"),
            boosting_type=self.get("boosting_type"),
            drop_rate=self.get("drop_rate"),
            max_drop=self.get("max_drop"),
            skip_drop=self.get("skip_drop"),
            top_rate=self.get("top_rate"),
            other_rate=self.get("other_rate"),
            eval_at=self.get("eval_at"),
            alpha=self.get("alpha"),
            tweedie_variance_power=self.get("tweedie_variance_power"),
            poisson_max_delta_step=self.get("poisson_max_delta_step"),
            fair_c=self.get("fair_c"),
        )

    def _gather(self, df: DataFrame) -> dict:
        out = {
            "x": df[self.get("features_col")].astype(np.float32),
            "y": df[self.get("label_col")].astype(np.float64),
        }
        wc = self.get("weight_col")
        out["w"] = df[wc].astype(np.float32) if wc else None
        ic = self.get("init_score_col")
        out["init"] = df[ic].astype(np.float32) if ic else None
        return out

    def _train(self, data: dict, cfg: TrainConfig, base_score: Any) -> Booster:
        return train(
            data["x"], data["y"], cfg, sample_weight=data["w"],
            init_score=data["init"], base_score=base_score,
            device=self.get("device"),
        )


class _BoosterModel(Model, HasFeaturesCol, HasDevice):
    model_string = Param("serialized booster", default="", type_=str)

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        self._booster: Optional[Booster] = None
        self._booster_src: Optional[str] = None

    @property
    def booster(self) -> Booster:
        s = self.get_or_fail("model_string")
        if self._booster is None or self._booster_src != s:
            self._booster = Booster.from_model_string(s)
            self._booster_src = s
        return self._booster

    def _raw(self, p: Partition) -> np.ndarray:
        x = np.asarray(p[self.get("features_col")], np.float32)
        return self.booster.predict_raw(x, device=self.get("device"))


class LightGBMClassifier(Estimator, _LightGBMParams, HasProbabilityCol, HasRawPredictionCol, HasPredictionCol):
    objective = Param("binary | multiclass", default="binary", type_=str)

    def fit(self, df: DataFrame) -> "LightGBMClassificationModel":
        self._check_ported()
        data = self._gather(df)
        y = data["y"].astype(np.int64)
        n_classes = int(y.max()) + 1 if len(y) else 2
        objective = self.get("objective")
        if objective == "binary" and n_classes > 2:
            objective = "multiclass"
        num_class = n_classes if objective == "multiclass" else 1
        data["y"] = y.astype(np.float64)
        base: Any = 0.0
        if self.get("boost_from_average") and data["init"] is None and len(y):
            if objective == "binary":
                p = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
                base = float(np.log(p / (1 - p)))
            else:  # multiclass: per-class log prior
                priors = np.bincount(y, minlength=num_class) / len(y)
                base = np.log(np.clip(priors, 1e-6, None)).astype(np.float32)
        booster = self._train(data, self._config(objective, num_class), base)
        m = LightGBMClassificationModel(
            features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
            probability_col=self.get("probability_col"),
            raw_prediction_col=self.get("raw_prediction_col"),
            device=self.get("device"),
        )
        m.set(model_string=booster.to_model_string())
        return m


class LightGBMClassificationModel(
    _BoosterModel, HasPredictionCol, HasProbabilityCol, HasRawPredictionCol
):
    def transform(self, df: DataFrame) -> DataFrame:
        booster = self.booster

        def fn(p: Partition) -> Partition:
            raw = self._raw(p)
            q = dict(p)
            if booster.num_class == 1:
                probs1 = objectives.sigmoid(booster.sigmoid * raw)
                probs = np.stack([1 - probs1, probs1], axis=1)
                raw2 = np.stack([-raw, raw], axis=1)
            else:
                probs = objectives.softmax(raw)
                raw2 = raw
            q[self.get("raw_prediction_col")] = raw2.astype(np.float64)
            q[self.get("probability_col")] = probs.astype(np.float64)
            q[self.get("prediction_col")] = probs.argmax(axis=1).astype(np.float64)
            return q

        return df.map_partitions(fn, parallel=False)


class LightGBMRegressor(Estimator, _LightGBMParams, HasPredictionCol):
    objective = Param("regression (L2; the other kinds are not ported)", default="regression", type_=str)

    def fit(self, df: DataFrame) -> "LightGBMRegressionModel":
        self._check_ported()
        data = self._gather(df)
        obj = objectives.canonical_objective(self.get("objective"))
        base = 0.0
        y = data["y"]
        if self.get("boost_from_average") and data["init"] is None and len(y):
            base = float(y.mean())
        booster = self._train(data, self._config(obj), base)
        m = LightGBMRegressionModel(
            features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
            device=self.get("device"),
        )
        m.set(model_string=booster.to_model_string())
        return m


class LightGBMRegressionModel(_BoosterModel, HasPredictionCol):
    def transform(self, df: DataFrame) -> DataFrame:
        booster = self.booster
        fc = self.get("features_col")
        return df.with_column(
            self.get("prediction_col"),
            lambda p: booster.predict(
                np.asarray(p[fc], np.float32), device=self.get("device")
            ).astype(np.float64),
        )
