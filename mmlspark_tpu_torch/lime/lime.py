"""TabularLIME / ImageLIME stages: the port of ``mmlspark_tpu.lime.lime``.

Reference flow (lime/LIME.scala:30-106): per explained row, sample
perturbed inputs, score them with the wrapped model (held in a
TransformerParam), fit a lasso from perturbation states to predictions,
emit the coefficient vector. TabularLIME samples feature vectors from
per-column train statistics; ImageLIME samples binary on/off states over
superpixels and censors the image accordingly.

Sampling, censoring, SLIC and the lasso run on the stage's ``device`` (the
card unless ``device="cpu"``); the wrapped model sees one DataFrame of all
samples per call. The draws are the JAX package's: ``jax.random``'s
partitionable Threefry from ``PRNGKey(seed)`` (``normal`` for TabularLIME;
``split`` then ``bernoulli`` per image for ImageLIME), so one seed gives
the same explanation in both packages (normal draws within 2 ulp, XLA's
``log1p`` rounding; the on/off states bit for bit).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasInputCol,
    HasOutputCol,
    HasPredictionCol,
    Param,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.lime.lasso import batched_lasso, lasso
from mmlspark_tpu_torch.lime.superpixel import slic
from mmlspark_tpu_torch.models.gbdt import sampling
from mmlspark_tpu_torch.models.resnet import normal


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` as two uint32s."""
    return 0, int(seed) & 0xFFFFFFFF


def split(key: tuple) -> tuple:
    """``jax.random.split(key)`` (partitionable Threefry): key i is
    ``threefry2x32(key, (0, i))``."""
    return tuple(sampling._threefry2x32(key[0], key[1], 0, i) for i in (0, 1))


def bernoulli(key: tuple, p: float, shape: tuple, device: torch.device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: the f32 uniform below f32 ``p``."""
    n = int(np.prod(shape))
    u = sampling.bits_to_unit(sampling.random_bits(key, n, device))
    return (u < torch.tensor(np.float32(p), device=device)).reshape(shape)


def _make_tabular_samples(key: tuple, rows: torch.Tensor, stds: torch.Tensor,
                          n_samp: int) -> tuple:
    """(R, d) rows -> (R, S, d) gaussian perturbations + standardized states."""
    eps = normal(key, (rows.shape[0], n_samp, rows.shape[1]), device=rows.device)
    return rows[:, None, :] + eps * stds[None, None, :], eps


def _censor_images(img: torch.Tensor, labels: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
    """states (S, K) {0, 1}, labels (H, W) -> (S, H, W, C) censored images."""
    return img[None] * states[:, labels.long()][..., None]


class _LIMEParams(HasInputCol, HasOutputCol, HasPredictionCol, HasDevice):
    model = ComplexParam("inner Transformer to explain")
    n_samples = Param("perturbed samples per explained row", default=512, type_=int)
    regularization = Param("lasso L1 strength", default=0.001, type_=float)
    seed = Param("PRNG seed", default=0, type_=int)

    def _predict_samples(self, samples_df: DataFrame) -> np.ndarray:
        """Run the wrapped model; reduce its prediction column to (n,) floats."""
        inner = self.get_or_fail("model")
        scored = inner.transform(samples_df)
        # follow the wrapped model's own prediction column unless overridden
        if self.is_set("prediction_col"):
            pc = self.get("prediction_col")
        else:
            try:
                pc = inner.get("prediction_col") or self.get("prediction_col")
            except KeyError:  # inner stage declares no prediction_col param
                pc = self.get("prediction_col")
        pred = np.asarray(scored[pc])
        if pred.ndim == 2:  # probability vector: explain class 1 like the reference
            pred = pred[:, min(1, pred.shape[1] - 1)]
        return pred.astype(np.float32)


class TabularLIME(Estimator, _LIMEParams):
    """fit() learns per-column sampling statistics (mean/std of each
    feature over the train set); the model does the per-row explanations."""

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "output_col" not in self._paramMap:
            self.set(output_col="weights")

    def fit(self, df: DataFrame) -> "TabularLIMEModel":
        x = np.asarray(df[self.get_or_fail("input_col")], np.float64)
        m = TabularLIMEModel(**{k: v for k, v in self._paramMap.items()})
        m.set(feature_stds=(x.std(axis=0) + 1e-9).astype(np.float32))
        return m


class TabularLIMEModel(Model, _LIMEParams):
    feature_stds = ComplexParam("(d,) train-set feature stds (sampling scale)")

    def transform(self, df: DataFrame) -> DataFrame:
        ic = self.get_or_fail("input_col")
        n_samp = self.get("n_samples")
        lam = self.get("regularization")
        dev = resolve_device(self.get("device"))
        stds = torch.as_tensor(np.asarray(self.get_or_fail("feature_stds"), np.float32),
                               device=dev)
        rows = np.asarray(df[ic], np.float32)
        if len(rows) == 0:
            return df.with_column(self.get("output_col"), np.empty(0, dtype=object))
        # every row's perturbations in one draw, one inner-model call over
        # the flattened (R * S, d) samples, one batched lasso solve
        samples, states = _make_tabular_samples(
            prng_key(self.get("seed")), torch.as_tensor(rows, device=dev), stds, n_samp)
        flat = samples.reshape(len(rows) * n_samp, rows.shape[1]).cpu().numpy()
        preds = self._predict_samples(DataFrame.from_dict({ic: flat}))
        preds = torch.as_tensor(preds, device=dev).reshape(len(rows), n_samp)
        coefs = batched_lasso(states, preds, lam, 300).cpu().numpy()
        out = np.empty(len(rows), dtype=object)
        for i in range(len(rows)):
            out[i] = coefs[i]
        return df.with_column(self.get("output_col"), out)


class ImageLIME(Transformer, _LIMEParams):
    """Explain an image model by superpixel on/off lasso
    (lime/ImageLIME in the reference). Emits the per-superpixel
    coefficient vector plus the label map used."""

    cell_size = Param("approximate superpixel diameter", default=16.0, type_=float)
    compactness = Param("SLIC compactness", default=10.0, type_=float)
    sampling_fraction = Param("P(superpixel stays on) per sample", default=0.7, type_=float)
    superpixel_col = Param("output column for the label map", default="superpixels")

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "output_col" not in self._paramMap:
            self.set(output_col="weights")

    def transform(self, df: DataFrame) -> DataFrame:
        ic = self.get_or_fail("input_col")
        n_samp = self.get("n_samples")
        frac = self.get("sampling_fraction")
        lam = self.get("regularization")
        cell = self.get("cell_size")
        dev = resolve_device(self.get("device"))

        images = df[ic]
        weights_out = np.empty(len(images), dtype=object)
        labels_out = np.empty(len(images), dtype=object)
        key = prng_key(self.get("seed"))
        for i, img in enumerate(images):
            img = torch.as_tensor(np.asarray(img, np.float32), device=dev)
            n_seg = max(2, int((img.shape[0] * img.shape[1]) / (cell * cell)))
            labels = slic(img, n_seg, self.get("compactness"))
            k = int(labels.max()) + 1
            key, sub = split(key)
            states = bernoulli(sub, frac, (n_samp, k), dev).float()
            censored = _censor_images(img, labels, states).cpu().numpy()
            preds = self._predict_samples(DataFrame.from_dict({ic: censored}))
            weights_out[i] = lasso(states, torch.as_tensor(preds, device=dev), lam).cpu().numpy()
            labels_out[i] = labels.cpu().numpy()

        out = df.with_column(self.get("output_col"), weights_out)
        return out.with_column(self.get("superpixel_col"), labels_out)
