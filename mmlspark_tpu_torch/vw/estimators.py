"""VW-style classifier / regressor estimators and models.

The PyTorch port of ``mmlspark_tpu.vw.estimators``. Facade parity with
vw/VowpalWabbitClassifier.scala and VowpalWabbitRegressor.scala; the online
pass runs in ``vw.learner`` on the stage's ``device`` (the card by
default: two hand-written kernels per minibatch). One device, so no
per-pass weight allreduce yet (VowpalWabbitBase.scala:313-429; ROADMAP.md,
A4). Training diagnostics mirror ``TrainingStats``
(VowpalWabbitBase.scala:27-46,431-457).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasWeightCol,
    Param,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.ops.hashing import murmur3_bytes
from mmlspark_tpu_torch.vw.featurizer import HasNumBits, combine_namespaces
from mmlspark_tpu_torch.vw.learner import (
    LOSS_HINGE,
    LOSS_LOGISTIC,
    LOSS_POISSON,
    LOSS_SQUARED,
    LOSSES,
    predict_margin,
    train_sparse_sgd,
)
from mmlspark_tpu_torch.vw.sparse import NUM_BITS_META, pad_sparse_batch


class _PlacedWeights(HasDevice):
    """A fitted model's numpy ``weights`` (saved and loaded as the JAX
    package's) placed on its device once per weights array and kept, so
    scoring does not upload them again for each partition."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._placed: dict = {}

    def _device_weights(self) -> "tuple[torch.device, torch.Tensor]":
        w = self.get_or_fail("weights")
        dev = resolve_device(self.get("device"))
        key = (str(dev), id(w))
        hit = self._placed.get(key)
        if hit is None:
            self._placed.clear()
            hit = self._placed[key] = (
                w, torch.from_numpy(np.array(w, np.float32)).to(dev))
        return dev, hit[1]


class _VowpalWabbitBase(
    Estimator, HasFeaturesCol, HasLabelCol, HasWeightCol, HasNumBits, HasDevice
):
    """Shared trainer params (the arg-string builder analogue of
    VowpalWabbitBase.scala:139-169 — params map 1:1 to VW flags)."""

    num_passes = Param("passes over the data (--passes)", default=1, type_=int)
    loss_function = Param(
        "logistic | squared | quantile | hinge | poisson "
        "('' = estimator default; --loss_function)", default="", type_=str,
    )
    quantile_tau = Param(
        "pinball level for loss_function=quantile (--quantile_tau)",
        default=0.5, type_=float,
    )
    pass_through_args = Param(
        "VW-style argument string (passThroughArgs, "
        "VowpalWabbitBase.scala:77-81): recognized flags (--loss_function, "
        "--quantile_tau, -l/--learning_rate, --power_t, --l2, --passes, "
        "--adaptive, -b/--bit_precision) override the matching params; "
        "unknown flags warn and are ignored",
        default="", type_=str,
    )
    learning_rate = Param("initial learning rate (-l)", default=0.5, type_=float)
    power_t = Param("lr decay exponent (--power_t)", default=0.5, type_=float)
    l2 = Param("L2 regularization (--l2)", default=0.0, type_=float)
    adaptive = Param("AdaGrad per-coordinate rates (--adaptive)", default=True, type_=bool)
    batch_size = Param(
        "device minibatch size (0 = auto: 1024 on the card, 64 on the "
        "CPU)", default=0, type_=int,
    )
    additional_features = Param(
        "extra sparse namespace columns concatenated into the example",
        default=[],
        type_=list,
    )
    initial_model = ComplexParam("continue training from these weights (array)")
    use_barrier_execution_mode = Param(
        "gang-launch flag (no-op: SPMD launch is always gang-scheduled)",
        default=False,
        type_=bool,
    )
    no_constant = Param(
        "drop VW's always-present intercept feature (--noconstant)",
        default=False, type_=bool,
    )

    _loss = LOSS_LOGISTIC

    def _resolve_args(self) -> dict:
        """Param values with the pass-through arg string folded in."""
        out = {
            "loss": self.get("loss_function") or self._loss,
            "tau": self.get("quantile_tau"),
            "lr": self.get("learning_rate"),
            "power_t": self.get("power_t"),
            "l2": self.get("l2"),
            "passes": self.get("num_passes"),
            "adaptive": self.get("adaptive"),
            "bits": None,
        }
        args = (self.get("pass_through_args") or "").split()
        i = 0
        import logging

        log = logging.getLogger("mmlspark_tpu.vw")
        flag_map = {
            "--loss_function": ("loss", str),
            "--quantile_tau": ("tau", float),
            "-l": ("lr", float), "--learning_rate": ("lr", float),
            "--power_t": ("power_t", float),
            "--l2": ("l2", float),
            "--passes": ("passes", int),
            "-b": ("bits", int), "--bit_precision": ("bits", int),
        }
        while i < len(args):
            # both VW syntaxes: "--flag value" and "--flag=value"
            a, eq, inline = args[i].partition("=")
            if a == "--adaptive":
                out["adaptive"] = True
                i += 1
            elif a == "--no_adaptive":
                out["adaptive"] = False
                i += 1
            elif a in flag_map and eq:
                if not inline:
                    raise ValueError(f"pass_through_args: {a} requires a value")
                key, conv = flag_map[a]
                out[key] = conv(inline)
                i += 1
            elif a in flag_map and i + 1 < len(args):
                key, conv = flag_map[a]
                out[key] = conv(args[i + 1])
                i += 2
            elif a in flag_map:
                # a recognized flag with no value is a semantic error, not
                # noise — silently ignoring it would train with defaults
                raise ValueError(f"pass_through_args: {a} requires a value")
            else:
                log.warning("pass_through_args: ignoring unrecognized %r", args[i])
                i += 1
        if out["loss"] not in LOSSES:
            raise ValueError(
                f"loss_function must be one of {LOSSES}, got {out['loss']!r}"
            )
        return out

    def _gather(self, df: DataFrame, bits_override: Optional[int] = None) -> tuple:
        fc = self.get("features_col")
        cols = [fc] + list(self.get("additional_features"))
        sparse_rows = combine_namespaces({c: df[c] for c in cols}, cols)
        feat_bits = int(
            df.column_metadata(fc).get(NUM_BITS_META) or self.get("num_bits")
        )
        num_bits = feat_bits
        if bits_override is not None:
            # -b/--bit_precision resizes the weight table, but features
            # were already hashed into the featurizer's space — a smaller
            # table would silently alias every overflowing index
            if bits_override < feat_bits:
                raise ValueError(
                    f"bit_precision {bits_override} is smaller than the "
                    f"featurized space ({feat_bits} bits); re-featurize "
                    "with the smaller num_bits instead"
                )
            num_bits = int(bits_override)
        idx, val = pad_sparse_batch(sparse_rows)
        if not self.get("no_constant"):
            # VW's intercept: every example carries the hashed "Constant"
            # feature with value 1 unless --noconstant (vw core behavior;
            # without it, e.g. quantile loss cannot shift its level).
            # Hashed in the FINAL bit space so training and scoring (which
            # reads the model's num_bits) agree on the slot.
            idx, val = _append_constant(idx, val, num_bits)
        y = df[self.get("label_col")].astype(np.float32)
        wc = self.get("weight_col")
        wt = df[wc].astype(np.float32) if wc else None
        return idx, val, y, wt, num_bits

    def _train_weights(self, df: DataFrame) -> tuple:
        """Returns (weights, num_bits, stats, resolved_args)."""
        if df.count() == 0:
            raise ValueError(f"{type(self).__name__}: empty training dataframe")
        args = self._resolve_args()
        idx, val, y, wt, num_bits = self._gather(df, bits_override=args["bits"])
        if args["loss"] in (LOSS_LOGISTIC, LOSS_HINGE):
            y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        t0 = time.perf_counter_ns()
        w = train_sparse_sgd(
            idx,
            val,
            y,
            wt,
            num_bits,
            loss=args["loss"],
            num_passes=args["passes"],
            batch=self.get("batch_size"),
            lr=args["lr"],
            power_t=args["power_t"],
            l2=args["l2"],
            adaptive=args["adaptive"],
            initial_weights=self.get("initial_model"),
            quantile_tau=args["tau"],
            device=self.get("device"),
        )
        t1 = time.perf_counter_ns()
        stats = DataFrame.from_dict(
            {
                "partition_id": [0],
                "rows": [int(len(y))],
                "time_total_ns": [t1 - t0],
                "time_learn_ns": [t1 - t0],
                "num_devices": [1],
                "passes": [self.get("num_passes")],
            }
        )
        return w, num_bits, stats, args

    def _apply_common(self, m: "_VowpalWabbitBaseModel", w: np.ndarray, num_bits: int, stats: DataFrame) -> None:
        m.set(
            weights=w,
            num_bits=num_bits,
            features_col=self.get("features_col"),
            additional_features=self.get("additional_features"),
            no_constant=self.get("no_constant"),
            performance_statistics=stats,
            device=self.get("device"),
        )


def _constant_slot(num_bits: int) -> int:
    """The hashed index of VW's intercept feature in this bit space."""
    return int(murmur3_bytes(b"Constant", 0)) & ((1 << num_bits) - 1)


def _append_constant(idx: np.ndarray, val: np.ndarray, num_bits: int) -> tuple:
    n = len(idx)
    c = np.full((n, 1), _constant_slot(num_bits), idx.dtype)
    v = np.ones((n, 1), val.dtype)
    return np.concatenate([idx, c], axis=1), np.concatenate([val, v], axis=1)


class _VowpalWabbitBaseModel(Model, HasFeaturesCol, HasPredictionCol, _PlacedWeights):
    """Scoring through the ``vw_margin`` kernel on the card
    (VowpalWabbitBaseModel.scala:28 analogue)."""

    weights = ComplexParam("(2^num_bits,) learned weights")
    num_bits = Param("hashed space width", default=18, type_=int)
    additional_features = Param("extra namespace columns", default=[], type_=list)
    no_constant = Param("intercept feature absent (--noconstant)", default=False, type_=bool)
    performance_statistics = ComplexParam("per-shard training diagnostics DataFrame")

    def get_performance_statistics(self) -> DataFrame:
        return self.get("performance_statistics")

    def get_readable_model(self) -> DataFrame:
        """Nonzero (index, weight) pairs — the --readable_model analogue."""
        w = np.asarray(self.get_or_fail("weights"))
        nz = np.nonzero(w)[0]
        return DataFrame.from_dict({"index": nz, "weight": w[nz]})

    def _margins(self, p: dict) -> np.ndarray:
        cols = [self.get("features_col")] + list(self.get("additional_features"))
        idx, val = pad_sparse_batch(combine_namespaces(p, cols))
        if not self.get("no_constant"):
            idx, val = _append_constant(idx, val, self.get("num_bits"))
        dev, w = self._device_weights()
        return predict_margin(idx, val, w, device=dev)


class VowpalWabbitClassifier(_VowpalWabbitBase):
    """Binary classifier, logistic loss (vw/VowpalWabbitClassifier.scala)."""

    _loss = LOSS_LOGISTIC

    def fit(self, df: DataFrame) -> "VowpalWabbitClassificationModel":
        w, num_bits, stats, args = self._train_weights(df)
        m = VowpalWabbitClassificationModel()
        self._apply_common(m, w, num_bits, stats)
        m.set(loss_function=args["loss"])
        return m


class VowpalWabbitClassificationModel(
    _VowpalWabbitBaseModel, HasProbabilityCol, HasRawPredictionCol
):
    loss_function = Param("loss the model was trained with", default="", type_=str)

    def transform(self, df: DataFrame) -> DataFrame:
        # hinge margins are NOT log-odds: sigmoid(margin) would masquerade
        # as a calibrated probability. Map them monotonically into [0, 1]
        # via the standard (margin+1)/2 clip instead (uncalibrated, like
        # VW's own hinge scores)
        hinge = self.get("loss_function") == LOSS_HINGE

        def fn(p: dict) -> dict:
            margin = self._margins(p)
            if hinge:
                prob = np.clip((margin + 1.0) / 2.0, 0.0, 1.0)
            else:
                prob = 1.0 / (1.0 + np.exp(-margin))
            q = dict(p)
            q[self.get("raw_prediction_col")] = margin.astype(np.float64)
            q[self.get("probability_col")] = prob.astype(np.float64)
            q[self.get("prediction_col")] = (margin > 0).astype(np.float64)
            return q

        return df.map_partitions(fn, parallel=False)


class VowpalWabbitRegressor(_VowpalWabbitBase):
    """Squared-loss regressor (vw/VowpalWabbitRegressor.scala)."""

    _loss = LOSS_SQUARED

    def fit(self, df: DataFrame) -> "VowpalWabbitRegressionModel":
        w, num_bits, stats, args = self._train_weights(df)
        m = VowpalWabbitRegressionModel()
        self._apply_common(m, w, num_bits, stats)
        m.set(loss_function=args["loss"])
        return m


class VowpalWabbitRegressionModel(_VowpalWabbitBaseModel):
    loss_function = Param("loss the model was trained with", default="", type_=str)

    def transform(self, df: DataFrame) -> DataFrame:
        # poisson trains in log space: predictions are rates (VW's
        # link=poisson convert-output behavior)
        exp_link = self.get("loss_function") == LOSS_POISSON

        def fn(p: dict) -> dict:
            q = dict(p)
            m = self._margins(p).astype(np.float64)
            if exp_link:
                # same clamp as the training link: rates, never inf
                m = np.exp(np.clip(m, -30.0, 30.0))
            q[self.get("prediction_col")] = m
            return q

        return df.map_partitions(fn, parallel=False)
