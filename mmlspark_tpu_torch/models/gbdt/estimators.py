"""LightGBM-compatible estimator facades on the port's GBDT.

The port of ``mmlspark_tpu.models.gbdt.estimators``:
``LightGBMClassifier`` / ``LightGBMClassificationModel``,
``LightGBMRegressor`` / ``LightGBMRegressionModel`` and ``LightGBMRanker``
/ ``LightGBMRankerModel`` — ``fit(DataFrame)`` trains on the device,
``transform(DataFrame)`` scores on the device.

The params are the JAX package's, plus ``device`` (``"cuda"`` by default;
``"cpu"`` runs the plain PyTorch histogram versions): categorical features,
continued training (``model_string``, ``num_batches``), checkpoint/resume
and delegates included. Every model reads and writes LightGBM's own text
format (``save_native_model``, ``load_native_model_from_string`` /
``_file``) and explains itself (``features_shap``, ``predict_leaf``,
``get_feature_importances``). Over two or more ``torch.distributed`` ranks
each rank fits its own rows and gets the same model (``train``:
``data_parallel`` or ``voting_parallel``); the label statistics behind
``boost_from_average`` are then taken over all the ranks. The classification
and regression models are fusable by the pipeline compiler
(``fusable_kernel``): the tree traversal, the leaf-value gather and the
numpy-order tree sum run in the fused segment on the device, and the
staged path's numpy epilogue (sigmoid/softmax/argmax, ``exp`` of the
log-link objectives, the float64 casts) runs on the host as ``finalize``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.device import HasDevice
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasFeaturesCol,
    HasGroupCol,
    HasInitScoreCol,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasValidationIndicatorCol,
    HasWeightCol,
    Param,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.models.gbdt import objectives, treegrow
from mmlspark_tpu_torch.models.gbdt.booster import Booster
from mmlspark_tpu_torch.models.gbdt.train import TrainConfig, train
from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel.mesh import group_rank_size


def _over_ranks(local: np.ndarray, op: str = "sum") -> np.ndarray:
    """An int64 or f64 statistic of this rank's labels summed (or maxed)
    over the ranks of the default group; itself with one rank."""
    if group_rank_size()[1] == 1:
        return local
    fn = collectives.allreduce_sum if op == "sum" else collectives.allreduce_max
    return fn(torch.from_numpy(np.ascontiguousarray(local))).numpy()


def _rows_over_ranks(local: np.ndarray) -> np.ndarray:
    """Every rank's rows of ``local`` in rank order (the labels a
    percentile is taken over); their copy with one rank."""
    return collectives.all_gather_rows(torch.from_numpy(np.ascontiguousarray(local))).numpy()


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
    bagging_fraction = Param("row subsample", default=1.0, type_=float)
    bagging_freq = Param("bagging frequency (0=off)", default=0, type_=int)
    early_stopping_round = Param("early stopping patience (0=off)", default=0, type_=int)
    metric = Param("eval metric name ('' = objective default)", default="", type_=str)
    parallelism = Param(
        "data_parallel | voting_parallel (PV-Tree: each rank votes its top_k "
        "features, only the candidates' histogram columns are all-reduced; "
        "with one rank it falls back to data_parallel)",
        default="data_parallel",
        type_=str,
        validator=lambda v: v in ("data_parallel", "voting_parallel"),
    )
    growth_policy = Param(
        "lossguide (LightGBM leaf-wise, default) | depthwise (level-wise; "
        "one multi-leaf histogram pass per level — O(depth) row passes)",
        default="lossguide",
        type_=str,
        validator=lambda v: v in ("lossguide", "depthwise"),
    )
    default_listen_port = Param("parity no-op (no sockets)", default=12400, type_=int)
    use_barrier_execution_mode = Param("parity no-op", default=False, type_=bool)
    top_k = Param("voting_parallel: features each rank nominates per split (PV-Tree K)",
                  default=20, type_=int)
    boost_from_average = Param("init score from label average", default=True, type_=bool)
    boosting_type = Param(
        "gbdt | goss | dart | rf (LightGBMParams boostingType)",
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
        "feature indices treated as categorical (subset splits; "
        "LightGBMParams categoricalSlotIndexes analogue). Values must be "
        "non-negative integers < max_bin-1.",
        default=None,
    )
    model_string = Param("initial model for continued training", default="", type_=str)
    alpha = Param(
        "quantile level (objective=quantile) / huber delta (objective=huber)",
        default=0.9, type_=float,
    )
    tweedie_variance_power = Param("tweedie variance power in (1, 2)", default=1.5, type_=float)
    poisson_max_delta_step = Param(
        "poisson hessian stabilizer exp(score + step)", default=0.7, type_=float
    )
    fair_c = Param("fair-loss scale c", default=1.0, type_=float)
    num_batches = Param("fold training into k sequential batches", default=0, type_=int)
    checkpoint_dir = Param(
        "directory for round-level preemption-safe checkpoints ('' = off); "
        "see docs/robustness.md", default="", type_=str,
    )
    checkpoint_every = Param(
        "boosting rounds between checkpoints (each save re-serializes the "
        "full booster — small values trade training throughput for a "
        "tighter recovery window)", default=10, type_=int
    )
    resume_from = Param(
        "checkpoint directory to resume training from ('' = fresh run); "
        "point it at checkpoint_dir for crash-loop-safe auto-resume",
        default="", type_=str,
    )
    delegate = ComplexParam("LightGBMDelegate: lifecycle callbacks + dynamic learning rate")
    seed = Param("rng seed", default=0, type_=int)
    verbosity = Param("log level", default=-1, type_=int)
    fused_rounds = Param(
        "fused chunk size: 0 = auto (the whole run, bounded chunks under early "
        "stopping; one CUDA graph per round on the card), 1 = the same rounds "
        "run eagerly, no graph (identical model), N > 1 = cap chunks at N rounds",
        default=0, type_=int,
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
            categorical_features=tuple(self.get("categorical_slot_indexes") or ()),
            delegate=self.get("delegate"),
        )

    def _gather(self, df: DataFrame) -> dict:
        out = {
            "x": df[self.get("features_col")].astype(np.float32),
            "y": df[self.get("label_col")].astype(np.float64),
        }
        wc = self.get("weight_col")
        out["w"] = df[wc].astype(np.float32) if wc else None
        vc = self.get("validation_indicator_col")
        out["valid"] = df[vc].astype(bool) if vc else None
        ic = self.get("init_score_col")
        out["init"] = df[ic].astype(np.float32) if ic else None
        return out

    def _fit_batches(self, data: dict, cfg: TrainConfig, base_score: Any = 0.0,
                     group_ids: Optional[np.ndarray] = None) -> Booster:
        """Train on the device, continuing ``model_string`` when set.
        ``num_batches`` > 1 splits the rows into that many contiguous
        batches trained in turn, each continuing the booster of the one
        before (``base_score`` only for the first fit of the chain). Over
        ranks every rank cuts its own rows into ``num_batches`` batches, as
        each JAX process does: batch i of the fit is every rank's i-th."""
        s = self.get("model_string")
        booster = Booster.from_model_string(s) if s else None
        nb = self.get("num_batches")
        delegate = self.get("delegate")
        kw: dict = {"device": self.get("device"), "fused_rounds": self.get("fused_rounds")}
        if not (nb and nb > 1):
            kw.update(checkpoint_dir=self.get("checkpoint_dir") or None,
                      checkpoint_every=self.get("checkpoint_every"),
                      resume_from=self.get("resume_from") or None)
        elif self.get("checkpoint_dir") or self.get("resume_from"):
            # the batches' round numbers would collide in one directory
            raise ValueError(
                "checkpoint_dir/resume_from are incompatible with num_batches > 1 "
                "(per-segment round indices would collide in one checkpoint directory)"
            )
        n = len(data["y"])
        bounds = np.linspace(0, n, nb + 1).astype(int) if nb and nb > 1 else np.array([0, n])
        for i in range(len(bounds) - 1):
            sl = slice(bounds[i], bounds[i + 1])
            part = {k: (None if v is None else v[sl]) for k, v in data.items()}
            if delegate is not None and len(bounds) > 2:
                delegate.before_train_batch(i, bounds[i + 1] - bounds[i], booster)
            booster = train(
                part["x"], part["y"], cfg, sample_weight=part["w"],
                init_score=part["init"], valid_mask=part["valid"],
                group_ids=None if group_ids is None else group_ids[sl],
                init_booster=booster,
                base_score=0.0 if booster is not None else base_score, **kw,
            )
            if delegate is not None and len(bounds) > 2:
                delegate.after_train_batch(i, booster)
        return booster


class _BoosterModel(Model, HasFeaturesCol, HasDevice):
    """A fitted booster: scoring on the device, LightGBM's text format in
    and out (``save_native_model``, ``load_native_model_from_string`` /
    ``_file``: ``model_string`` takes the JSON string or LightGBM's text),
    and the explanations (host numpy, f64)."""

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

    def _keep(self, booster: Booster) -> None:
        """Hold the fitted booster itself (its ``evals`` are not in the
        model string)."""
        self.set(model_string=booster.to_model_string())
        self._booster, self._booster_src = booster, self.get("model_string")

    def save_native_model(self, path: str) -> None:
        """Write the booster in LightGBM's own text format."""
        with open(path, "w") as f:
            f.write(self.booster.to_lightgbm_string())

    @classmethod
    def load_native_model_from_string(cls, text: str, **kw: Any) -> "_BoosterModel":
        m = cls(**kw)
        m.set(model_string=text)
        m.booster  # parse now: malformed text fails here, not at transform
        return m

    @classmethod
    def load_native_model_from_file(cls, path: str, **kw: Any) -> "_BoosterModel":
        with open(path) as f:
            return cls.load_native_model_from_string(f.read(), **kw)

    def predict_leaf(self, x: np.ndarray) -> np.ndarray:
        return self.booster.predict_leaf(np.asarray(x, np.float32), device=self.get("device"))

    def features_shap(self, x: np.ndarray, approximate: bool = False) -> np.ndarray:
        """Exact TreeSHAP by default; ``approximate=True`` = the Saabas
        walk (much faster on large batches)."""
        return self.booster.feature_contribs(np.asarray(x, np.float32), approximate=approximate)

    def get_feature_importances(self, importance_type: str = "split") -> np.ndarray:
        return self.booster.feature_importances(importance_type)


class LightGBMClassifier(Estimator, _LightGBMParams, HasProbabilityCol, HasRawPredictionCol, HasPredictionCol):
    objective = Param("binary | multiclass", default="binary", type_=str)

    def fit(self, df: DataFrame) -> "LightGBMClassificationModel":
        data = self._gather(df)
        y = data["y"].astype(np.int64)
        n_classes = int(_over_ranks(np.array([y.max() + 1 if len(y) else 0]), "max")[0]) or 2
        objective = self.get("objective")
        if objective == "binary" and n_classes > 2:
            objective = "multiclass"
        num_class = n_classes if objective == "multiclass" else 1
        data["y"] = y.astype(np.float64)
        base: Any = 0.0
        # class counts over all the ranks: integers, so the prior is the
        # one-device fit's exactly
        counts = _over_ranks(np.bincount(y, minlength=max(num_class, 2)).astype(np.int64))
        total = int(counts.sum())
        if self.get("boost_from_average") and data["init"] is None and total:
            if objective == "binary":
                p = float(np.clip(counts[1] / total, 1e-6, 1 - 1e-6))
                base = float(np.log(p / (1 - p)))
            else:  # multiclass: per-class log prior
                priors = counts / total
                base = np.log(np.clip(priors, 1e-6, None)).astype(np.float32)
        booster = self._fit_batches(data, self._config(objective, num_class), base)
        m = LightGBMClassificationModel(
            features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
            probability_col=self.get("probability_col"),
            raw_prediction_col=self.get("raw_prediction_col"),
            device=self.get("device"),
        )
        m._keep(booster)
        return m


def _booster_raw_device_fn(booster: Booster, features_col: str, raw_key: str) -> Any:
    """``cols -> {raw_key: predict_raw(x)}`` on the segment's device,
    bit-matching :meth:`Booster.predict_raw` for the pipeline compiler: the
    same traversal (``treegrow.predict_scores``: integer leaf indices and a
    gather, exact under any batch shape) and the same numpy-order tree sum
    (:meth:`Booster.raw_scores`, elementwise adds), so each row's score is
    the staged one at any bucket. Returns None for an empty booster (the
    staged path covers the broadcast-base case)."""
    n_trees = len(booster._trees(None))
    if not n_trees:
        return None

    def fn(cols: dict) -> dict:
        x = cols[features_col].to(torch.float32)
        leaf, feat, thr, active, values, dleft, is_cat, catmask = booster._device_trees(
            n_trees, x.device)
        per_tree = treegrow.predict_scores(x, leaf, feat, thr, active, values, dleft,
                                           is_cat, catmask)
        return {raw_key: booster.raw_scores(per_tree)}

    return fn


def _classifier_outputs(booster: Booster, raw: np.ndarray) -> tuple:
    """The staged classifier's host epilogue: (raw, probabilities,
    prediction) as float64 from the f32 raw scores."""
    if booster.num_class == 1:
        probs1 = objectives.sigmoid(booster.sigmoid * raw)
        probs = np.stack([1 - probs1, probs1], axis=1)
        raw2 = np.stack([-raw, raw], axis=1)
    else:
        probs = objectives.softmax(raw)
        raw2 = raw
    return (raw2.astype(np.float64), probs.astype(np.float64),
            probs.argmax(axis=1).astype(np.float64))


class LightGBMClassificationModel(
    _BoosterModel, HasPredictionCol, HasProbabilityCol, HasRawPredictionCol
):
    def transform(self, df: DataFrame) -> DataFrame:
        booster = self.booster
        cols = (self.get("raw_prediction_col"), self.get("probability_col"),
                self.get("prediction_col"))

        def fn(p: Partition) -> Partition:
            q = dict(p)
            q.update(zip(cols, _classifier_outputs(booster, self._raw(p))))
            return q

        return df.map_partitions(fn, parallel=False)

    def fusable_kernel(self) -> Any:
        """Device traversal + gather + numpy-order summed scores in the
        fused segment; the sigmoid/softmax/argmax/float64 epilogue replays
        the staged numpy code as a host ``finalize``."""
        from mmlspark_tpu_torch.compiler.kernels import StageKernel, guard_f32_safe

        booster = self.booster
        writes = (self.get("raw_prediction_col"), self.get("probability_col"),
                  self.get("prediction_col"))
        raw_key = f"__device_raw__{writes[0]}"
        fn = _booster_raw_device_fn(booster, self.get("features_col"), raw_key)
        if fn is None:
            return None

        def finalize(host: dict) -> dict:
            return dict(zip(writes, _classifier_outputs(booster, host[raw_key])))

        return StageKernel(
            reads=(self.get("features_col"),),
            writes=writes,
            fn=fn,
            guard=guard_f32_safe,
            finalize=finalize,
            device_writes=(raw_key,),
            cost_hint=1.0 + len(booster.trees) / 100.0,
            device=self.get("device"),
        )


class LightGBMRegressor(Estimator, _LightGBMParams, HasPredictionCol):
    objective = Param(
        "regression | regression_l1 | quantile | huber | fair | poisson | "
        "tweedie | gamma | mape (LightGBM objective passthrough, "
        "TrainParams.scala:8-40)",
        default="regression", type_=str,
    )

    def fit(self, df: DataFrame) -> "LightGBMRegressionModel":
        data = self._gather(df)
        obj = objectives.canonical_objective(self.get("objective"))
        base = 0.0
        y = data["y"]
        # the mean over all the ranks' labels (one rank: numpy's own mean)
        sum_n = _over_ranks(np.array([y.sum(), len(y)], np.float64))
        mean = float(y.mean()) if group_rank_size()[1] == 1 else float(sum_n[0] / sum_n[1])
        if self.get("boost_from_average") and data["init"] is None and sum_n[1]:
            # LightGBM's BoostFromScore per objective family: log-link
            # objectives start at log(mean), quantile at the alpha
            # percentile, l1/mape at the median
            if obj in objectives.LOG_LINK_KINDS:
                base = float(np.log(np.clip(mean, 1e-9, None)))
            elif obj == "quantile":
                # over ranks: the percentile of every rank's labels
                base = float(np.percentile(_rows_over_ranks(y), self.get("alpha") * 100.0))
            elif obj in ("regression_l1", "mape"):
                base = float(np.median(_rows_over_ranks(y)))
            else:
                base = mean
        booster = self._fit_batches(data, self._config(obj), base)
        m = LightGBMRegressionModel(
            features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
            device=self.get("device"),
        )
        m._keep(booster)
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

    def fusable_kernel(self) -> Any:
        """Like the classifier's kernel: scores on the device, the
        objective's output transform (log-link ``np.exp``) and the float64
        cast on the host."""
        from mmlspark_tpu_torch.compiler.kernels import StageKernel, guard_f32_safe

        booster = self.booster
        pred_c = self.get("prediction_col")
        raw_key = f"__device_raw__{pred_c}"
        fn = _booster_raw_device_fn(booster, self.get("features_col"), raw_key)
        if fn is None:
            return None

        def finalize(host: dict) -> dict:
            raw = host[raw_key]
            if booster.objective in objectives.LOG_LINK_KINDS:
                raw = np.exp(raw)
            return {pred_c: raw.astype(np.float64)}

        return StageKernel(
            reads=(self.get("features_col"),),
            writes=(pred_c,),
            fn=fn,
            guard=guard_f32_safe,
            finalize=finalize,
            device_writes=(raw_key,),
            cost_hint=1.0 + len(booster.trees) / 100.0,
            device=self.get("device"),
        )


class LightGBMRanker(Estimator, _LightGBMParams, HasGroupCol, HasPredictionCol):
    objective = Param("lambdarank", default="lambdarank", type_=str)
    evaluate_at = Param("NDCG truncation positions", default=[1, 3, 5, 10], type_=list)

    def fit(self, df: DataFrame) -> "LightGBMRankerModel":
        gc = self.get("group_col")
        if not gc:
            raise ValueError("LightGBMRanker requires group_col (query column)")
        data = self._gather(df)
        groups_raw = df[gc]
        _, group_ids = np.unique(
            groups_raw.astype(str) if groups_raw.dtype == object else groups_raw,
            return_inverse=True,
        )
        booster = self._fit_batches(data, self._config("lambdarank"), group_ids=group_ids)
        m = LightGBMRankerModel(
            features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
            device=self.get("device"),
        )
        m._keep(booster)
        return m


class LightGBMRankerModel(_BoosterModel, HasPredictionCol):
    def transform(self, df: DataFrame) -> DataFrame:
        booster = self.booster
        fc = self.get("features_col")
        return df.with_column(
            self.get("prediction_col"),
            lambda p: booster.predict_raw(
                np.asarray(p[fc], np.float32), device=self.get("device")
            ).astype(np.float64),
        )
