"""The port's stages, featurizers and VW stages against the JAX package.

Every entry of ``tests/test_fuzzing.py``'s catalog whose stage lives in the
packages this slice completes (``stages``, ``featurize`` and ``vw``) is
built in both packages with the same params and inputs. The outputs must
be equal (values, dtypes, column order and metadata; bit for bit), and the
port's stage must survive a save/load round trip with an equal output.
The learners elsewhere in the catalog (linear, GBDT, train, automl) have
their own parity files. The VW learners run on the CPU (``device="cpu"``)
and the JAX ones on a one-device mesh; the logistic classifier routes its
loss derivative through the JAX function (XLA's sigmoid rounds differently:
``tests/test_torch_port_vw.py`` states that tolerance).
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch


def _num_df(M, n=20, d=4, parts=2, seed=0):
    r = np.random.default_rng(seed)
    return M.DataFrame.from_dict(
        {
            "features": r.normal(size=(n, d)).astype(np.float32),
            "x": r.normal(size=n),
            "label": (r.random(n) > 0.5).astype(np.int32),
            "text": np.array([f"word{i % 5} token{i % 3} filler" for i in range(n)], dtype=object),
            "cat": np.array([["red", "green", "blue"][i % 3] for i in range(n)], dtype=object),
        },
        num_partitions=parts,
    )


def _nan_df(M):
    return M.DataFrame.from_dict({"x": [1.0, np.nan, 3.0, np.nan], "y": [np.nan, 2.0, 2.0, 4.0]})


def _array_df(M):
    arrs = np.empty(4, dtype=object)
    for i in range(4):
        arrs[i] = np.arange(i + 1, dtype=np.float64)
    return M.DataFrame.from_dict({"k": ["a", "a", "b", "b"], "arr": arrs, "v": [1.0, 2.0, 3.0, 4.0]})


def _toks_df(M):
    toks = np.empty(3, dtype=object)
    for i in range(3):
        toks[i] = [f"t{j}" for j in range(i + 2)]
    return M.DataFrame.from_dict({"toks": toks})


def _cb_df(M):
    acts = np.empty(8, dtype=object)
    shared = np.empty(8, dtype=object)
    for i in range(8):
        acts[i] = [M.V.make_sparse([10 + a], [1.0]) for a in range(2)]
        shared[i] = M.V.make_sparse([5], [1.0])
    return M.DataFrame.from_dict(
        {
            "shared": shared,
            "features": acts,
            "chosen_action": np.ones(8, np.int64) + (np.arange(8) % 2),
            "probability": np.full(8, 0.5),
            "label": np.arange(8) % 2 * 1.0,
        }
    )


def _vw_df(M):
    text_df = _num_df(M).select("text", "label", "x", "features")
    feat = M.V.VowpalWabbitFeaturizer(input_cols=[], string_split_input_cols=["text"],
                                      num_bits=12)
    return text_df, feat.transform(text_df)


# id -> M -> (stage, input DataFrame); M holds DataFrame, S, F, V and dev,
# the VW learners' extra params (the port's device)
CATALOG = {
    "DropColumns": lambda M: (M.S.DropColumns(cols=["x"]), _num_df(M)),
    "SelectColumns": lambda M: (M.S.SelectColumns(cols=["x", "label"]), _num_df(M)),
    "RenameColumn": lambda M: (M.S.RenameColumn(input_col="x", output_col="x2"), _num_df(M)),
    "Repartition": lambda M: (M.S.Repartition(n=1), _num_df(M)),
    "Lambda": lambda M: (M.S.Lambda.of(_select_x), _num_df(M)),
    "UDFTransformer_udf": lambda M: (
        M.S.UDFTransformer(input_col="x", output_col="x2").set(udf=_double), _num_df(M)),
    "UDFTransformer_vector_udf": lambda M: (
        M.S.UDFTransformer(input_col="x", output_col="x2").set(vector_udf=_double_col),
        _num_df(M)),
    "Explode": lambda M: (M.S.Explode(input_col="arr", output_col="el"), _array_df(M)),
    "Cacher": lambda M: (M.S.Cacher(), _num_df(M)),
    "Timer": lambda M: (M.S.Timer().set(stage=M.S.DropColumns(cols=["x"])), _num_df(M)),
    "FixedMiniBatchTransformer": lambda M: (M.S.FixedMiniBatchTransformer(batch_size=8),
                                            _num_df(M)),
    "DynamicMiniBatchTransformer": lambda M: (M.S.DynamicMiniBatchTransformer(), _num_df(M)),
    "TimeIntervalMiniBatchTransformer": lambda M: (
        M.S.TimeIntervalMiniBatchTransformer(interval_ms=10, max_batch_size=4), _num_df(M)),
    "StratifiedRepartition": lambda M: (M.S.StratifiedRepartition(label_col="label", n=2),
                                        _num_df(M)),
    "ClassBalancer": lambda M: (M.S.ClassBalancer(input_col="label"), _num_df(M)),
    "EnsembleByKey": lambda M: (
        M.S.EnsembleByKey(keys=["k"], cols=["v"], col_names=["mean_v"]), _array_df(M)),
    "SummarizeData": lambda M: (M.S.SummarizeData(), _num_df(M).select("x", "label")),
    "TextPreprocessor": lambda M: (
        M.S.TextPreprocessor(input_col="text", output_col="clean", map={"word1": "ONE"}),
        _num_df(M)),
    "UnicodeNormalize": lambda M: (M.S.UnicodeNormalize(input_col="text", output_col="norm"),
                                   _num_df(M)),
    "CleanMissingData_mean": lambda M: (M.F.CleanMissingData(input_cols=["x", "y"]),
                                        _nan_df(M)),
    "CleanMissingData_median": lambda M: (
        M.F.CleanMissingData(input_cols=["x"], cleaning_mode="Median"), _nan_df(M)),
    "DataConversion": lambda M: (M.F.DataConversion(cols=["label"], convert_to="double"),
                                 _num_df(M)),
    "Featurize": lambda M: (M.F.Featurize(input_cols=["x", "cat", "features"]), _num_df(M)),
    "ValueIndexer": lambda M: (M.F.ValueIndexer(input_col="cat", output_col="cat_idx"),
                               _num_df(M)),
    "TextFeaturizer_idf": lambda M: (
        M.F.TextFeaturizer(input_col="text", output_col="tf", num_features=64), _num_df(M)),
    "TextFeaturizer_ngram": lambda M: (
        M.F.TextFeaturizer(input_col="text", output_col="tf", num_features=64,
                           use_ngram=True, use_idf=False), _num_df(M)),
    "PageSplitter": lambda M: (
        M.F.PageSplitter(input_col="text", output_col="pages", maximum_page_length=10,
                         minimum_page_length=5), _num_df(M)),
    "FlattenBatch": lambda M: (
        M.S.FlattenBatch(), M.S.FixedMiniBatchTransformer(batch_size=8).transform(_num_df(M))),
    "MultiNGram": lambda M: (
        M.F.MultiNGram(input_col="toks", output_col="ngrams", lengths=[1, 2]), _toks_df(M)),
    "IndexToValue": lambda M: (
        M.F.IndexToValue(input_col="cat_idx", output_col="cat2"),
        M.F.ValueIndexer(input_col="cat", output_col="cat_idx").fit(_num_df(M))
        .transform(_num_df(M))),
    "VectorZipper": lambda M: (M.S.VectorZipper(input_cols=["x", "label"], output_col="z"),
                               _num_df(M)),
    "FastVectorAssembler": lambda M: (
        M.S.FastVectorAssembler(input_cols=["x", "label"], output_col="fv"), _num_df(M)),
    "MultiColumnAdapter": lambda M: (
        M.S.MultiColumnAdapter(base_stage=M.F.ValueIndexer(), input_cols=["cat"],
                               output_cols=["cat_idx"]), _num_df(M)),
    "VowpalWabbitFeaturizer_split": lambda M: (
        M.V.VowpalWabbitFeaturizer(input_cols=[], string_split_input_cols=["text"],
                                   num_bits=12), _vw_df(M)[0]),
    "VowpalWabbitFeaturizer_dense": lambda M: (
        M.V.VowpalWabbitFeaturizer(input_cols=["x", "features"], num_bits=12), _vw_df(M)[0]),
    "VowpalWabbitClassifier": lambda M: (
        M.V.VowpalWabbitClassifier(num_bits=12, num_passes=2, **M.dev), _vw_df(M)[1]),
    "VowpalWabbitRegressor": lambda M: (
        M.V.VowpalWabbitRegressor(num_bits=12, **M.dev),
        _vw_df(M)[1].rename({"label": "y", "x": "label"})),
    "VowpalWabbitInteractions": lambda M: (
        M.V.VowpalWabbitInteractions(input_cols=["features", "f2"], num_bits=12),
        M.V.VowpalWabbitFeaturizer(input_cols=["x"], output_col="f2", num_bits=12)
        .transform(_vw_df(M)[1])),
    "VowpalWabbitContextualBandit": lambda M: (
        M.V.VowpalWabbitContextualBandit(num_bits=10, **M.dev), _cb_df(M)),
}


def _select_x(df):
    return df.select("x")


def _double(v):
    return v * 2


def _double_col(col):
    return np.asarray(col) * 2


def _package(jax_side: bool) -> types.SimpleNamespace:
    if jax_side:
        import mmlspark_tpu as root
        from mmlspark_tpu import featurize as F
        from mmlspark_tpu import stages as S
        from mmlspark_tpu import vw as V

        return types.SimpleNamespace(DataFrame=root.DataFrame, S=S, F=F, V=V, dev={})
    import mmlspark_tpu_torch as root
    from mmlspark_tpu_torch import featurize as F
    from mmlspark_tpu_torch import stages as S
    from mmlspark_tpu_torch import vw as V

    return types.SimpleNamespace(DataFrame=root.DataFrame, S=S, F=F, V=V,
                                 dev={"device": "cpu"})


def _run(stage, df):
    """(fitted stage, its output): an estimator is fitted on ``df`` first."""
    is_estimator = any(c.__name__ == "Estimator" for c in type(stage).__mro__)
    fitted = stage.fit(df) if is_estimator else stage
    return fitted, fitted.transform(df)


def assert_values_equal(x, y, where):
    assert type(x) is type(y) or (np.isscalar(x) and np.isscalar(y)), (where, type(x), type(y))
    if isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and x.shape == y.shape, (where, x.dtype, y.dtype)
        if x.dtype == object:
            for i, (a, b) in enumerate(zip(x.ravel(), y.ravel())):
                assert_values_equal(a, b, f"{where}[{i}]")
        else:
            assert np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"), where
    elif isinstance(x, dict):
        assert list(x) == list(y), where
        for k in x:
            assert_values_equal(x[k], y[k], f"{where}.{k}")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), where
        for i, (a, b) in enumerate(zip(x, y)):
            assert_values_equal(a, b, f"{where}[{i}]")
    elif isinstance(x, float) and np.isnan(x):
        assert np.isnan(y), where
    else:
        assert x == y, (where, x, y)


def assert_frames_equal(a, b):
    assert a.columns == b.columns
    assert a.num_partitions == b.num_partitions
    for c in a.columns:
        assert_values_equal(a[c], b[c], c)
        assert a.column_metadata(c) == b.column_metadata(c), c


@pytest.fixture
def one_device_mesh_and_jax_dloss(monkeypatch):
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.parallel import mesh as M
    from mmlspark_tpu.vw import learner as JL
    from mmlspark_tpu_torch.ops import sgd as PS

    def dloss(loss, m, y, tau):
        out = JL._dloss(loss, jnp.asarray(m.numpy()), jnp.asarray(y.numpy()),
                        jnp.float32(tau))
        return torch.from_numpy(np.array(out, np.float32))

    monkeypatch.setattr(PS, "dloss_plain", dloss)
    old = M._default_mesh
    M.set_mesh(M.make_mesh(devices=jax.devices()[:1]))
    yield
    M.set_mesh(old)


@pytest.mark.parametrize("case", sorted(CATALOG))
def test_stage_equals_the_jax_package_and_round_trips(one_device_mesh_and_jax_dloss,
                                                      case, tmp_path):
    from mmlspark_tpu_torch.core.pipeline import Estimator, load_stage

    J, P = _package(True), _package(False)
    j_stage, j_df = CATALOG[case](J)
    p_stage, p_df = CATALOG[case](P)
    assert type(p_stage).__name__ == type(j_stage).__name__
    _, j_out = _run(j_stage, j_df)
    p_fitted, p_out = _run(p_stage, p_df)
    assert_frames_equal(j_out, p_out)

    p_stage.save(str(tmp_path / "stage"))
    back = load_stage(str(tmp_path / "stage"))
    assert type(back) is type(p_stage)
    if isinstance(p_stage, Estimator):
        p_fitted.save(str(tmp_path / "model"))
        back = load_stage(str(tmp_path / "model"))
        assert type(back) is type(p_fitted)
    assert_frames_equal(back.transform(p_df), p_out)
