"""The pipeline slice's stages against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
stage and through its port (``device="cpu"``). Tolerances, each measured
on these inputs:

- hashing (``murmur3_bytes``, ``hash_strings``, ``hashing_tf``), the
  ``Featurize`` fit (its plans) and transform, the carried
  ``FeaturizeModel`` and ``LinearRegressionModel`` transforms: bitwise;
- ``UDFTransformer`` with ``tanh(0.5 x)``: within 4 ulp (XLA's f32 ``tanh``
  and PyTorch's round differently; 4 ulp was the largest difference seen);
- ``LogisticRegression`` after 30 GD steps: weights and bias within
  ``2e-6 * max |w|`` (the products ``x @ W`` associate differently;
  measured 1.7e-7 and 8.3e-7);
- the carried ``LogisticRegressionModel``: logits within
  ``1e-6 * max |logit|`` (the port sums each row in numpy's pairwise order,
  XLA's dot in its own; measured 1.1e-7), probabilities within 1e-6,
  predictions equal except where a row's top two logits lie within twice
  that tolerance;
- ``LinearRegression``: weights and bias within ``1e-5 * max |w|`` (two
  f32 solves of the normal equations; measured 7e-7);
- ``Booster.predict_raw`` of a model loaded from the JAX package's model
  string: bitwise, for binary, multiclass, regression and rf.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import mmlspark_tpu as J
from mmlspark_tpu.featurize.featurize import Featurize as JFeaturize
from mmlspark_tpu.models.linear import LinearRegression as JLinearRegression
from mmlspark_tpu.models.linear import LogisticRegression as JLogisticRegression
from mmlspark_tpu.ops import hashing as JH
from mmlspark_tpu.stages.basic import UDFTransformer as JUDFTransformer

import mmlspark_tpu_torch as P
from mmlspark_tpu_torch.compiler.kernels import pairwise_sum
from mmlspark_tpu_torch.featurize import Featurize, FeaturizeModel
from mmlspark_tpu_torch.models.gbdt import Booster
from mmlspark_tpu_torch.models.linear import (
    LinearRegression,
    LinearRegressionModel,
    LogisticRegression,
    LogisticRegressionModel,
    logistic_head,
)
from mmlspark_tpu_torch.ops import hashing as PH
from mmlspark_tpu_torch.stages import UDFTransformer

JT = importlib.import_module("mmlspark_tpu.models.gbdt.train")

TANH_ULP = 4
FIT_RTOL = 2e-6
LOGIT_RTOL = 1e-6
PROB_ATOL = 1e-6
LINREG_RTOL = 1e-5


def _cell(n: int = 2048, seed: int = 7, parts: int = 2) -> tuple:
    """The bench's pipeline cell at a small row count: x0..x15 f64, vec
    (16,) f32, label in 0..3; the same columns as a DataFrame of each
    package."""
    rng = np.random.default_rng(seed)
    cols = {f"x{i}": rng.standard_normal(n) for i in range(16)}
    cols["vec"] = rng.standard_normal((n, 16)).astype(np.float32)
    cols["label"] = rng.integers(0, 4, n)
    return (cols, J.DataFrame.from_dict(cols, num_partitions=parts),
            P.DataFrame.from_dict(cols, num_partitions=parts))


INPUTS = [f"x{i}" for i in range(16)] + ["vec"]


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# -- hashing ---------------------------------------------------------------------------------


def test_murmur3_bitwise_on_random_byte_strings():
    rng = np.random.default_rng(3)
    blobs = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(0, 40, 300)]
    for seed in (0, 42, 0xDEADBEEF):
        got = [PH.murmur3_bytes(b, seed) for b in blobs]
        assert got == [JH.murmur3_bytes(b, seed) for b in blobs]
    words = ["", "a", "ab", "abc", "abcd", "héllo wörld", "日本語テキスト"] + [
        "w%d" % i for i in range(200)]
    np.testing.assert_array_equal(PH.hash_strings(words, 7), JH.hash_strings(words, 7))
    assert PH.hash_feature_index("feat", 18, 1) == JH.hash_feature_index("feat", 18, 1)


@pytest.mark.parametrize("binary", [False, True])
def test_hashing_tf_bitwise(binary):
    rng = np.random.default_rng(4)
    vocab = ["t%d" % i for i in range(50)]
    docs = [list(rng.choice(vocab, int(k))) for k in rng.integers(0, 12, 40)]
    np.testing.assert_array_equal(PH.hashing_tf(docs, 64, seed=3, binary=binary),
                                  JH.hashing_tf(docs, 64, seed=3, binary=binary))


# -- Featurize ------------------------------------------------------------------------------


def _mixed_columns(n: int = 300, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    f64 = rng.standard_normal(n)
    f64[rng.random(n) < 0.1] = np.nan
    return {
        "f64": f64,
        "f32": rng.standard_normal(n).astype(np.float32),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
        "vec": rng.standard_normal((n, 3)).astype(np.float32),
        "cat": np.array(rng.choice(["red", "green", "blue"], n), dtype=object),
        "txt": np.array(["id%d" % i for i in rng.integers(0, 500, n)], dtype=object),
    }


def test_featurize_fit_and_transform_bitwise():
    cols = _mixed_columns()
    ins = list(cols)
    jm = JFeaturize(input_cols=ins, output_col="f", max_one_hot=10,
                    number_of_features=64).fit(J.DataFrame.from_dict(cols, num_partitions=2))
    pm = Featurize(input_cols=ins, output_col="f", max_one_hot=10,
                   number_of_features=64).fit(P.DataFrame.from_dict(cols, num_partitions=2))
    assert pm.get("plans") == jm.get("plans")
    assert [p["kind"] for p in pm.get("plans")] == [
        "numeric", "numeric", "numeric", "vector", "onehot", "hash"]
    assert pm.feature_dim == jm.feature_dim
    want = jm.transform(J.DataFrame.from_dict(cols, num_partitions=3))["f"]
    got = pm.transform(P.DataFrame.from_dict(cols, num_partitions=3))["f"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the carried model transforms alike
    carried = FeaturizeModel.from_jax_params({k: v for k, _, v in jm.iter_set_params()})
    np.testing.assert_array_equal(carried.transform(P.DataFrame.from_dict(cols))["f"], want)


def test_featurize_kernel_equals_its_staged_transform_bitwise():
    cols = _mixed_columns()
    del cols["cat"], cols["txt"]
    pm = Featurize(input_cols=list(cols), output_col="f").fit(P.DataFrame.from_dict(cols))
    k = pm.fusable_kernel()
    assert k is not None and k.reads == tuple(cols)
    staged = pm.transform(P.DataFrame.from_dict(cols))["f"]
    host = {c: (a.astype(np.float32) if a.dtype == np.float64 else a) for c, a in cols.items()}
    got = k.fn({c: torch.from_numpy(a) for c, a in host.items()})["f"].numpy()
    np.testing.assert_array_equal(got, staged)
    # one-hot/hash plans stay host-bound
    assert Featurize(input_cols=["cat"], output_col="f").fit(
        P.DataFrame.from_dict(_mixed_columns())).fusable_kernel() is None


# -- UDFTransformer ---------------------------------------------------------------------------


def test_udf_tanh_within_measured_ulp_of_xla():
    import jax.numpy as jnp

    cols, jdf, pdf = _cell()
    jf = JFeaturize(input_cols=INPUTS, output_col="features").fit(jdf)
    feats = jf.transform(jdf)
    ju = JUDFTransformer(input_col="features", output_col="s", jit_compatible=True,
                         vector_udf=lambda x: jnp.tanh(x * jnp.float32(0.5)))
    pu = UDFTransformer(input_col="features", output_col="s", jit_compatible=True,
                        vector_udf=lambda x: torch.tanh(x * 0.5), device="cpu")
    want = ju.transform(feats)["s"]
    got = pu.transform(P.DataFrame.from_dict({"features": feats["features"]}))["s"]
    assert got.dtype == want.dtype == np.float32
    assert int(_ulp(got, want).max()) <= TANH_ULP
    # a float64 column reaches the udf as float32, as under the JAX package's jit
    x = np.random.default_rng(1).standard_normal((50, 3))
    out = pu.transform(P.DataFrame.from_dict({"features": x}))["s"]
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, torch.tanh(torch.from_numpy(x.astype(np.float32)) * 0.5))


def test_udf_plain_paths_match_the_jax_package():
    df_cols = {"a": np.arange(6.0), "b": np.arange(6) * 2}
    pd, jd = P.DataFrame.from_dict(df_cols), J.DataFrame.from_dict(df_cols)
    pu = UDFTransformer(input_col="a", output_col="o", vector_udf=lambda x: x * 3)
    ju = JUDFTransformer(input_col="a", output_col="o", vector_udf=lambda x: x * 3)
    np.testing.assert_array_equal(pu.transform(pd)["o"], ju.transform(jd)["o"])
    pr = UDFTransformer(input_cols=["a", "b"], output_col="o", udf=lambda a, b: a + b)
    jr = JUDFTransformer(input_cols=["a", "b"], output_col="o", udf=lambda a, b: a + b)
    np.testing.assert_array_equal(pr.transform(pd)["o"], jr.transform(jd)["o"])
    assert pu.fusable_kernel() is None  # not declared jit_compatible


# -- LogisticRegression / LinearRegression -------------------------------------------------------


@pytest.fixture(scope="module")
def fitted_logistic():
    import jax.numpy as jnp

    cols, jdf, _ = _cell()
    jfeat = JFeaturize(input_cols=INPUTS, output_col="features").fit(jdf).transform(jdf)
    js = JUDFTransformer(input_col="features", output_col="fs", jit_compatible=True,
                         vector_udf=lambda x: jnp.tanh(x * jnp.float32(0.5))).transform(jfeat)
    jm = JLogisticRegression(features_col="fs", label_col="label", max_iter=30).fit(js)
    return js["fs"], cols["label"], jm


def test_logistic_fit_within_tolerance_of_the_jax_weights(fitted_logistic):
    x, y, jm = fitted_logistic
    pm = LogisticRegression(features_col="fs", label_col="label", max_iter=30,
                            device="cpu").fit(P.DataFrame.from_dict({"fs": x, "label": y}))
    assert pm.get("num_classes") == jm.get("num_classes") == 4
    for name in ("weights", "bias"):
        want, got = np.asarray(jm.get(name)), pm.get(name)
        assert got.shape == want.shape and got.dtype == np.float32
        assert float(np.abs(got - want).max()) <= FIT_RTOL * float(np.abs(want).max())


def test_carried_logistic_transform_within_tolerance(fitted_logistic):
    x, _, jm = fitted_logistic
    carried = LogisticRegressionModel.from_jax_params(
        {k: v for k, _, v in jm.iter_set_params()}, device="cpu")
    want = jm.transform(J.DataFrame.from_dict({"fs": x}, num_partitions=2))
    got = carried.transform(P.DataFrame.from_dict({"fs": x}, num_partitions=2))
    assert got.columns == want.columns
    for c in got.columns:
        assert got[c].dtype == want[c].dtype, c
    tol = LOGIT_RTOL * float(np.abs(want["raw_prediction"]).max())
    assert float(np.abs(got["raw_prediction"] - want["raw_prediction"]).max()) <= tol
    assert float(np.abs(got["probability"] - want["probability"]).max()) <= PROB_ATOL
    top2 = np.sort(want["raw_prediction"], axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * tol
    differ = got["prediction"] != want["prediction"]
    assert not (differ & ~near_tie).any()


def test_logistic_head_sums_each_row_in_numpy_order_at_any_batch_size():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((257, 33)).astype(np.float32)
    W = rng.standard_normal((33, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    logits, probs, pred = logistic_head(torch.from_numpy(x), torch.from_numpy(W),
                                        torch.from_numpy(b))
    prods = np.ascontiguousarray((x[:, :, None] * W[None]).transpose(0, 2, 1))
    np.testing.assert_array_equal(logits.numpy(), prods.sum(axis=2) + b)
    for n in (1, 2, 3, 5, 64, 100):
        lo, pr, pd = logistic_head(torch.from_numpy(x[:n]), torch.from_numpy(W),
                                   torch.from_numpy(b))
        np.testing.assert_array_equal(lo.numpy(), logits.numpy()[:n])
        np.testing.assert_array_equal(pr.numpy(), probs.numpy()[:n])
        np.testing.assert_array_equal(pd.numpy(), pred.numpy()[:n])
    np.testing.assert_allclose(probs.numpy().sum(1), 1.0, rtol=1e-6)


def test_linear_regression_within_tolerance_and_carried_bitwise():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((500, 6)).astype(np.float32)
    y = x @ rng.standard_normal(6) + 0.5 + 0.01 * rng.standard_normal(500)
    jm = JLinearRegression(features_col="f", label_col="y").fit(
        J.DataFrame.from_dict({"f": x, "y": y}))
    pm = LinearRegression(features_col="f", label_col="y", device="cpu").fit(
        P.DataFrame.from_dict({"f": x, "y": y}))
    jw = np.append(np.asarray(jm.get("weights")), jm.get("bias"))
    pw = np.append(pm.get("weights"), pm.get("bias"))
    assert float(np.abs(pw - jw).max()) <= LINREG_RTOL * float(np.abs(jw).max())
    carried = LinearRegressionModel.from_jax_params({k: v for k, _, v in jm.iter_set_params()})
    assert carried.pipeline_io() == (("f",), ("prediction",))
    np.testing.assert_array_equal(
        carried.transform(P.DataFrame.from_dict({"f": x}))["prediction"],
        jm.transform(J.DataFrame.from_dict({"f": x}))["prediction"])


# -- the predict_raw repair -------------------------------------------------------------------


_BOOSTERS = {
    "binary": (dict(objective="binary"), lambda x: (x[:, 0] + x[:, 1] * x[:, 2] > 0)),
    "multiclass": (dict(objective="multiclass", num_class=3),
                   lambda x: np.digitize(x[:, 0], [-0.5, 0.5])),
    "regression": (dict(objective="regression"), lambda x: 2 * x[:, 0] + np.sin(x[:, 1])),
    "rf": (dict(objective="binary", boosting_type="rf", bagging_fraction=0.8, bagging_freq=1,
                feature_fraction=0.8), lambda x: (x[:, 0] + x[:, 1] > 0)),
}


@pytest.mark.parametrize("kind", sorted(_BOOSTERS))
def test_predict_raw_of_a_carried_booster_is_bitwise_the_reference(kind):
    """4,000 x 8 rows, 60 trees of 15 leaves a class, loaded from the JAX
    package's model string: the tree sum is numpy's pairwise f32 order per
    class, then / the rf tree count and + base_score in f32."""
    cfg, target = _BOOSTERS[kind]
    x = np.random.default_rng(0).standard_normal((4000, 8)).astype(np.float32)
    ref = JT.train(x, target(x).astype(np.float64),
                   JT.TrainConfig(num_iterations=60, num_leaves=15, **cfg),
                   shard=False, base_score=0.3)
    port = Booster.from_model_string(ref.to_model_string())
    want = ref.predict_raw(x)
    got = port.predict_raw(x, device="cpu")
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the device sum is numpy's: (n, T) per-tree outputs summed per class
    per = port._per_tree(x, None, "cpu").numpy()
    k = port.num_class
    cols = [per[:, c::k].sum(axis=1) for c in range(k)]
    np.testing.assert_array_equal(
        pairwise_sum(torch.from_numpy(per[:, ::k].copy())).numpy(), cols[0])


@pytest.mark.parametrize("t", [1, 2, 5, 7, 8, 9, 17, 64, 127, 128, 129, 300])
def test_pairwise_sum_matches_numpy_bitwise(t):
    rng = np.random.default_rng(t)
    a = (rng.standard_normal((57, t)) * 100).astype(np.float32)
    np.testing.assert_array_equal(pairwise_sum(a), a.sum(axis=1))
    np.testing.assert_array_equal(pairwise_sum(torch.from_numpy(a)).numpy(), a.sum(axis=1))
    neg_zero = np.full((3, t), -0.0, np.float32)
    assert np.array_equal(np.signbit(pairwise_sum(neg_zero)), np.signbit(neg_zero.sum(axis=1)))
