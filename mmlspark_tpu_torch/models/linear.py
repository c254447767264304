"""Baseline linear learners on the card: logistic + linear regression.

The PyTorch port of ``mmlspark_tpu.models.linear``. The reference leans on
SparkML's LogisticRegression/linear models as the default learners inside
TrainClassifier/TuneHyperparameters (train/TrainClassifier.scala:106-128,
automl/DefaultHyperparams). The JAX package trains them as full-batch GD
in one ``lax.scan``; here the same GD steps run as a loop of device ops
with no host read until the weights come back.

Scoring differs from the JAX package in one deliberate way: the logistic
head computes each row's logits in one fixed order — the products
``x[:, j] * W[j]`` summed over ``j`` in numpy's pairwise order
(``compiler.kernels.pairwise_sum``), then ``+ b`` — and its softmax from
``max``, ``exp`` and the same sum, instead of one ``x @ W`` whose library
kernel (tile shape, split-K) is picked by the batch's shape. So each row's
bits do not depend on how many rows its batch holds, which is what lets
the pipeline compiler pad and chunk batches and stay element-wise equal to
staged scoring. The head agrees with the JAX package's ``x @ W + b``
within f32 rounding (tests/test_torch_port_pipeline.py states the
tolerance), not bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.compiler.kernels import pairwise_sum
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


class _HasDevice(HasDevice):
    """``HasDevice`` without a default: a model that names no device runs
    its fused kernel where the ``CompiledPipeline`` runs (``fit`` and
    ``transform`` resolve None to the card)."""

    device = Param(HasDevice.device.doc, type_=str, validator=HasDevice.device.validator)


def _device_fit_logistic(
    x: np.ndarray,
    y: np.ndarray,
    w: Optional[np.ndarray],
    n_classes: int,
    reg: float,
    lr: float,
    iters: int,
    dev: torch.device,
) -> tuple:
    """Full-batch GD with momentum on ``dev``; returns (W, b) as numpy.
    The loss is the JAX package's: weighted mean cross-entropy of
    ``softmax(x @ W + b)`` plus ``reg * |W|^2``; its gradient is written
    out (``wd * (softmax - onehot)``)."""
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    yd = torch.nn.functional.one_hot(
        torch.from_numpy(np.asarray(y, np.int64)).to(dev), n_classes).to(torch.float32)
    wd = (torch.from_numpy(np.asarray(w, np.float32)).to(dev) if w is not None
          else torch.ones(x.shape[0], dtype=torch.float32, device=dev))
    wd = (wd / wd.sum())[:, None]
    W = torch.zeros((x.shape[1], n_classes), dtype=torch.float32, device=dev)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=dev)
    vW, vb = torch.zeros_like(W), torch.zeros_like(b)
    for _ in range(iters):
        g = wd * (torch.softmax(xd @ W + b, dim=-1) - yd)
        gW = xd.T @ g + (2.0 * reg) * W
        gb = g.sum(0)
        vW = 0.9 * vW - lr * gW
        vb = 0.9 * vb - lr * gb
        W, b = W + vW, b + vb
    return W.cpu().numpy(), b.cpu().numpy()


class LogisticRegression(Estimator, HasFeaturesCol, HasLabelCol, HasWeightCol, _HasDevice):
    reg_param = Param("L2 regularization", default=1e-4, type_=float)
    learning_rate = Param("GD learning rate", default=0.5, type_=float)
    max_iter = Param("GD iterations", default=200, type_=int)

    def fit(self, df: DataFrame) -> "LogisticRegressionModel":
        if df.count() == 0:
            raise ValueError("LogisticRegression: cannot fit on an empty dataframe")
        x = df[self.get("features_col")].astype(np.float32)
        y = df[self.get("label_col")].astype(np.int64)
        w = df[self.get("weight_col")] if self.get("weight_col") else None
        n_classes = int(y.max()) + 1 if len(y) else 2
        n_classes = max(n_classes, 2)
        W, b = _device_fit_logistic(
            x, y, w, n_classes,
            self.get("reg_param"), self.get("learning_rate"), self.get("max_iter"),
            resolve_device(self.get("device")),
        )
        m = LogisticRegressionModel(
            features_col=self.get("features_col"), num_classes=n_classes,
            device=self.get("device"),
        )
        m.set(weights=W, bias=b)
        return m


def logistic_head(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> tuple:
    """(logits, probabilities, argmax) of ``x @ W + b``, each row computed
    in one fixed order whatever the batch's size: the products summed over
    the features in numpy's pairwise order, a row-wise softmax from
    ``max``, ``exp`` and the same sum."""
    logits = pairwise_sum(x[:, :, None] * W[None]) + b
    e = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    return logits, e / pairwise_sum(e)[:, None], torch.argmax(logits, dim=1)


class LogisticRegressionModel(
    Model, HasFeaturesCol, HasPredictionCol, HasProbabilityCol, HasRawPredictionCol,
    _HasDevice,
):
    weights = ComplexParam("(d, k) weight matrix")
    bias = ComplexParam("(k,) bias")
    num_classes = Param("number of classes", default=2, type_=int)

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        self._placed: dict = {}

    @classmethod
    def from_jax_params(cls, params: dict, **kw: Any) -> "LogisticRegressionModel":
        """The JAX package's fitted model in the port: ``params`` are its
        set params (``weights`` (d, k), ``bias`` (k,), ``num_classes``,
        the column names) as numpy arrays and plain values; ``kw`` the
        port's own (``device``)."""
        return cls(**kw).set(**params)

    def _weights(self, dev: torch.device) -> tuple:
        """(W, b) as f32 tensors on ``dev``, placed once per weights and
        kept: a captured CUDA graph reads them by address."""
        W, b = self.get_or_fail("weights"), self.get_or_fail("bias")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (str(dev), id(W), id(b))
        hit = self._placed.get(key)
        if hit is None:
            hit = self._placed[key] = (
                torch.tensor(np.asarray(W, np.float32), device=dev),
                torch.tensor(np.asarray(b, np.float32), device=dev),
            )
        return hit

    def transform(self, df: DataFrame) -> DataFrame:
        dev = resolve_device(self.get("device"))
        W, b = self._weights(dev)
        fc = self.get("features_col")

        def fn(p: dict) -> dict:
            x = torch.from_numpy(np.ascontiguousarray(p[fc], np.float32)).to(dev)
            with torch.inference_mode():
                logits, probs, pred = logistic_head(x, W, b)
            q = dict(p)
            q[self.get("raw_prediction_col")] = logits.cpu().numpy()
            q[self.get("probability_col")] = probs.cpu().numpy()
            q[self.get("prediction_col")] = pred.cpu().numpy().astype(np.float64)
            return q

        return df.map_partitions(fn, parallel=False)

    def fusable_kernel(self) -> Any:
        """The staged transform's ops on the segment's tensors: the same
        head (each row in one fixed order), so exact-mode output is
        bit-equal at every bucket and chunk size."""
        from mmlspark_tpu_torch.compiler.kernels import StageKernel, guard_f32_safe

        self.get_or_fail("weights")
        fc = self.get("features_col")
        raw_c = self.get("raw_prediction_col")
        prob_c = self.get("probability_col")
        pred_c = self.get("prediction_col")

        def fn(cols: dict) -> dict:
            x = cols[fc].to(torch.float32)
            logits, probs, pred = logistic_head(x, *self._weights(x.device))
            return {raw_c: logits, prob_c: probs, pred_c: pred}

        return StageKernel(
            reads=(fc,),
            writes=(raw_c, prob_c, pred_c),
            fn=fn,
            # staged prediction is argmax cast to float64 on host
            out_dtypes={pred_c: np.dtype(np.float64)},
            guard=guard_f32_safe,
            cost_hint=1.0,
            device=self.get("device"),
        )


class LinearRegression(Estimator, HasFeaturesCol, HasLabelCol, HasWeightCol, _HasDevice):
    """Ridge regression by normal equations on the device (one solve)."""

    reg_param = Param("L2 regularization", default=1e-6, type_=float)

    def fit(self, df: DataFrame) -> "LinearRegressionModel":
        dev = resolve_device(self.get("device"))
        x = torch.from_numpy(df[self.get("features_col")].astype(np.float32)).to(dev)
        y = torch.from_numpy(df[self.get("label_col")].astype(np.float32)).to(dev)
        xb = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=dev)], dim=1)
        gram = xb.T @ xb + self.get("reg_param") * torch.eye(xb.shape[1], device=dev)
        wb = torch.linalg.solve(gram, xb.T @ y).cpu().numpy()
        m = LinearRegressionModel(features_col=self.get("features_col"))
        m.set(weights=wb[:-1], bias=float(wb[-1]))
        return m


class LinearRegressionModel(Model, HasFeaturesCol, HasPredictionCol):
    weights = ComplexParam("(d,) weights")
    bias = Param("intercept", default=0.0, type_=float)

    @classmethod
    def from_jax_params(cls, params: dict, **kw: Any) -> "LinearRegressionModel":
        """The JAX package's fitted model in the port (``weights`` (d,),
        ``bias``, the column names)."""
        return cls(**kw).set(**params)

    def pipeline_io(self) -> tuple:
        """Declared I/O for the pipeline compiler: the staged transform is
        a float64 host matmul, so this model plans host-bound, with exact
        DAG edges."""
        return (self.get("features_col"),), (self.get("prediction_col"),)

    def transform(self, df: DataFrame) -> DataFrame:
        W = np.asarray(self.get_or_fail("weights"))
        b = self.get("bias")
        fc = self.get("features_col")
        return df.with_column(
            self.get("prediction_col"),
            lambda p: np.asarray(p[fc], np.float64) @ W + b,
        )
