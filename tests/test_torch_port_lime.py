"""The port's ``lime/`` against the JAX package's.

- ``slic``: the label maps equal the JAX package's exactly (the distance's
  inner products as XLA's fused chain, segment sums in pixel order);
- ``lasso`` / ``batched_lasso``: coefficients within 1e-4 * max|coef|;
- the draws: ``prng_key``/``split``/``bernoulli`` bit for bit
  ``jax.random``'s; ``normal`` within 4 ulp (XLA's f32 ``log1p``);
- ``TabularLIME`` and ``ImageLIME`` on one seed give the JAX package's
  explanation: the same states and label maps, coefficients within 1e-4 *
  max|coef|; plus ``tests/test_lime.py``'s behaviour checks, on the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.lime as J
from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu.core.params import HasInputCol as JHasInputCol
from mmlspark_tpu.core.params import HasPredictionCol as JHasPredictionCol
from mmlspark_tpu.core.params import Param as JParam
from mmlspark_tpu.core.pipeline import Transformer as JTransformer
from mmlspark_tpu_torch import DataFrame, load_stage
from mmlspark_tpu_torch.core.params import HasInputCol, HasPredictionCol, Param
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.lime import (
    ImageLIME,
    Superpixel,
    SuperpixelTransformer,
    TabularLIME,
    batched_lasso,
    lasso,
    slic,
)
from mmlspark_tpu_torch.lime import lime as L

COEF_REL = 1e-4


def _close(got, want) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= COEF_REL * max(np.abs(want).max(), 1e-12)


# -- SLIC -------------------------------------------------------------------------------


def _slic_images() -> list:
    rng = np.random.default_rng(0)
    out = []
    for i, h in enumerate((24, 32, 48, 64, 96)):
        img = rng.random((h, h, 3)).astype(np.float32) * 255
        out.append((np.round(img) if i % 2 else img, max(2, h * h // 256)))
    halves = np.zeros((32, 32, 3), np.float32)
    halves[:, 16:] = 255.0
    out += [(halves, 4), (np.full((24, 24, 3), 128.0, np.float32), 4)]
    return out


@pytest.mark.parametrize("case", range(7))
def test_slic_label_maps_equal_jax(case):
    img, n = _slic_images()[case]
    want = np.asarray(J.slic(jnp.asarray(img), n, 10.0))
    got = slic(img, n, 10.0, device="cpu").numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_slic_partitions_image():
    img = np.zeros((32, 32, 3), np.float32)
    img[:, 16:] = 255.0
    labels = Superpixel.cluster(img, 4, compactness=10.0, device="cpu")
    assert labels.shape == (32, 32)
    assert not (set(labels[:, :14].ravel()) & set(labels[:, 18:].ravel()))


def test_mask_image():
    img = np.ones((8, 8, 3), np.float32)
    labels = np.zeros((8, 8), np.int64)
    labels[4:] = 1
    out = Superpixel.mask_image(img, labels, np.array([1, 0]))
    np.testing.assert_array_equal(out, J.Superpixel.mask_image(img, labels, np.array([1, 0])))
    assert out[:4].all() and not out[4:].any()


def test_superpixel_transformer_equals_jax():
    imgs = np.empty(2, dtype=object)
    for i in range(2):
        imgs[i] = np.random.RandomState(i).rand(24, 24, 3).astype(np.float32)
    got = SuperpixelTransformer(input_col="image", cell_size=8.0, device="cpu").transform(
        DataFrame.from_dict({"image": imgs}))["superpixels"]
    want = J.SuperpixelTransformer(input_col="image", cell_size=8.0).transform(
        JDataFrame.from_dict({"image": imgs}))["superpixels"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(np.unique(got[0])) > 1


# -- lasso ------------------------------------------------------------------------------


@pytest.mark.parametrize("lam", [0.0, 0.01, 100.0])
def test_lasso_equals_jax(lam):
    rng = np.random.RandomState(0)
    x = rng.randn(200, 10).astype(np.float32)
    true = np.zeros(10, np.float32)
    true[[2, 7]] = [3.0, -2.0]
    y = x @ true + 0.01 * rng.randn(200).astype(np.float32)
    got = lasso(x, y, lam).numpy()
    want = np.asarray(J.lasso(jnp.asarray(x), jnp.asarray(y), lam))
    _close(got, want)
    if lam == 0.01:
        assert abs(got[2] - 3.0) < 0.1 and abs(got[7] + 2.0) < 0.1
    if lam == 100.0:
        assert np.abs(got).max() < 1e-6


def test_batched_lasso_equals_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 50, 6).astype(np.float32)
    beta = rng.randn(4, 6).astype(np.float32)
    y = np.einsum("bnd,bd->bn", x, beta)
    got = batched_lasso(x, y, 0.001, 300).numpy()
    _close(got, np.asarray(J.batched_lasso(jnp.asarray(x), jnp.asarray(y), 0.001, 300)))
    np.testing.assert_allclose(got, beta, atol=0.15)


# -- the draws --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_draws_are_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in np.asarray(key)) == L.prng_key(seed)
    want_split = np.asarray(jax.random.split(key))
    got_split = L.split(L.prng_key(seed))
    assert [tuple(int(v) for v in k) for k in want_split] == [tuple(k) for k in got_split]
    want = np.asarray(jax.random.bernoulli(want_split[1], 0.7, (37, 13)))
    got = L.bernoulli(got_split[1], 0.7, (37, 13), torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    eps = np.asarray(jax.random.normal(key, (3, 17, 5), jnp.float32))
    mine = L.normal(L.prng_key(seed), (3, 17, 5)).numpy()
    ulp = np.abs(eps.view(np.int32).astype(np.int64) - mine.view(np.int32).astype(np.int64))
    assert int(ulp.max()) <= 4


# -- LIME -------------------------------------------------------------------------------


class _LinearModel(Transformer, HasInputCol, HasPredictionCol):
    """Deterministic inner model: pred = x @ w (w fixed)."""

    w_list = Param("weights as list", default=None)

    def transform(self, df):
        w = np.asarray(self.get("w_list"), np.float32)
        x = np.asarray(df[self.get_or_fail("input_col")], np.float32)
        return df.with_column(self.get("prediction_col"), x @ w)


class _JLinearModel(JTransformer, JHasInputCol, JHasPredictionCol):
    w_list = JParam("weights as list", default=None)

    def transform(self, df):
        w = np.asarray(self.get("w_list"), np.float32)
        x = np.asarray(df[self.get_or_fail("input_col")], np.float32)
        return df.with_column(self.get("prediction_col"), x @ w)


def _quadrant(imgs) -> np.ndarray:
    return np.array([np.asarray(im)[:12, :12].mean() for im in imgs], np.float32)


class _SegmentSumModel(Transformer, HasInputCol, HasPredictionCol):
    """Image model whose score is the mean of one image quadrant."""

    def transform(self, df):
        return df.with_column(self.get("prediction_col"),
                              _quadrant(df[self.get_or_fail("input_col")]))


class _JSegmentSumModel(JTransformer, JHasInputCol, JHasPredictionCol):
    def transform(self, df):
        return df.with_column(self.get("prediction_col"),
                              _quadrant(df[self.get_or_fail("input_col")]))


@pytest.mark.parametrize("n_samples,lam", [(2048, 0.0003), (64, 0.001)])
def test_tabular_lime_equals_jax(n_samples, lam):
    rng = np.random.RandomState(0)
    x = rng.randn(100, 4).astype(np.float32)
    w = [2.0, -1.0, 0.0, 0.5]
    got = TabularLIME(input_col="features", model=_LinearModel(input_col="features", w_list=w),
                      n_samples=n_samples, regularization=lam, device="cpu").fit(
        DataFrame.from_dict({"features": x})).transform(
        DataFrame.from_dict({"features": x[:3]}))["weights"]
    want = J.TabularLIME(input_col="features", model=_JLinearModel(input_col="features",
                                                                   w_list=w),
                         n_samples=n_samples, regularization=lam).fit(
        JDataFrame.from_dict({"features": x})).transform(
        JDataFrame.from_dict({"features": x[:3]}))["weights"]
    for a, b in zip(got, want):
        _close(a, b)
    if n_samples == 2048:  # the states are standardized: coefficients = w * std
        for row in got:
            np.testing.assert_allclose(np.asarray(row) / x.std(axis=0), w, atol=0.2)


def test_tabular_lime_save_load(tmp_path):
    x = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    inner = _LinearModel(input_col="features", w_list=[1.0, 0.0, -1.0])
    model = TabularLIME(input_col="features", model=inner, n_samples=64, device="cpu").fit(
        DataFrame.from_dict({"features": x}))
    p = str(tmp_path / "lime")
    model.save(p)
    m2 = load_stage(p)
    a = model.transform(DataFrame.from_dict({"features": x[:2]}))["weights"]
    b = m2.transform(DataFrame.from_dict({"features": x[:2]}))["weights"]
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra, rb)


@pytest.mark.parametrize("seed", [3, 11])
def test_image_lime_equals_jax(seed):
    """Two images (the key is split per image): the same label maps and
    on/off states as the JAX package's, so the same explanation."""
    rng = np.random.default_rng(seed)
    imgs = np.empty(2, dtype=object)
    imgs[0] = np.full((24, 24, 3), 128.0, np.float32)
    imgs[1] = (rng.random((24, 24, 3)) * 255).astype(np.float32)
    kw = dict(input_col="image", n_samples=256, cell_size=12.0, regularization=0.0001,
              seed=seed)
    got = ImageLIME(model=_SegmentSumModel(input_col="image"), device="cpu", **kw).transform(
        DataFrame.from_dict({"image": imgs}))
    want = J.ImageLIME(model=_JSegmentSumModel(input_col="image"), **kw).transform(
        JDataFrame.from_dict({"image": imgs}))
    for i in range(2):
        np.testing.assert_array_equal(got["superpixels"][i], np.asarray(want["superpixels"][i]))
        _close(got["weights"][i], want["weights"][i])
    weights, labels = got["weights"][0], got["superpixels"][0]
    active = set(labels[:12, :12].ravel())
    inactive = set(labels.ravel()) - active
    w_active = max(weights[list(active)])
    w_inactive = max(abs(weights[j]) for j in inactive) if inactive else 0.0
    assert w_active > 5 * max(w_inactive, 1e-6)
