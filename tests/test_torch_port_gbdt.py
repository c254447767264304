"""The port's GBDT (``mmlspark_tpu_torch.models.gbdt``) against the JAX
package's, on the CPU.

The same numpy inputs go through the JAX ``train(..., shard=False)`` with its
device grower (``MMLSPARK_TPU_HIST_HOST=0``, the XLA scatter lowering) and
through the port's ``train(..., device="cpu")`` (the plain PyTorch histogram
versions). Both sum histograms in f32 in row order and take the split
prefix sums in the same order (``treegrow.prefix_sum``), so the split
records agree exactly.

One thing differs by design: XLA's f32 ``exp`` (inside sigmoid/softmax) and
PyTorch's round differently in the last bit, and a near-tie split can flip
on one ulp of gradient. The exact-parity tests therefore route the port's
gradient functions through the JAX package's own (L2 regression needs no
routing: its gradients are exact), and one test holds the port's own
gradients to the reference by quality.

The exact-parity fits of the datasets' cases
(``test_train_matches_reference``,
``test_train_with_own_gradients_tracks_reference``) are in
``tests/test_torch_port_gbdt_parity.py``, so the test workers can share
them out.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import objectives as JO
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.train import TrainConfig as JConfig
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core.metrics import binary_auc
from mmlspark_tpu_torch.core.pipeline import STAGE_REGISTRY as PORT_REGISTRY
from mmlspark_tpu_torch.models.gbdt import (
    Booster,
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRegressor,
    TrainConfig,
    booster_from_reference,
    objectives as PO,
    train,
)

from benchmarks import assert_golden, load_goldens

DATA_DIR = os.path.join(os.path.dirname(__file__), "resources", "data")

# the suite runs one worker process per core: PyTorch's intra-op threads
# would only oversubscribe them (these tensors are small)
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def load_xy(name: str):
    a = np.loadtxt(os.path.join(DATA_DIR, f"{name}.csv"), delimiter=",", skiprows=1)
    return a[:, :-1].astype(np.float32), a[:, -1]


def stratified_split(x, y, test_frac=0.3, seed=7):
    rng = np.random.default_rng(seed)
    test = np.zeros(len(y), bool)
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        test[rng.permutation(idx)[: max(1, int(round(test_frac * len(idx))))]] = True
    return x[~test], x[test], y[~test], y[test]


@pytest.fixture
def reference_device_grower(monkeypatch):
    """The JAX package's device grower on the CPU (not its host grower)."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")


@pytest.fixture
def jax_gradients(monkeypatch):
    """Route the port's sigmoid/softmax gradients through the JAX package's
    functions, so both trainers see bitwise-equal gradients."""
    import jax.numpy as jnp

    def route(jfn):
        def fn(scores, y):
            g, h = jfn(jnp.asarray(scores.numpy()), jnp.asarray(y.numpy()))
            return torch.from_numpy(np.array(g)), torch.from_numpy(np.array(h))
        return fn

    monkeypatch.setattr(PO, "binary_grad_hess", route(JO.binary_grad_hess))
    monkeypatch.setattr(PO, "multiclass_grad_hess", route(JO.multiclass_grad_hess))


# -- estimators -------------------------------------------------------------


def test_classifier_breast_cancer_golden():
    """DataFrame -> fit -> transform on the CPU; the VerifyRealDatasets
    breast_cancer AUC golden (the reference's VerifyLightGBMClassifier
    semantics) holds with the JAX package's own test settings."""
    goldens = load_goldens("VerifyRealDatasets")
    x, y = load_xy("breast_cancer")
    xtr, xte, ytr, yte = stratified_split(x, y)
    m = LightGBMClassifier(
        num_iterations=60, num_leaves=31, min_data_in_leaf=5, seed=7, device="cpu"
    ).fit(DataFrame.from_dict({"features": xtr, "label": ytr}))
    out = m.transform(DataFrame.from_dict({"features": xte, "label": yte}))
    proba = out["probability"]
    assert proba.shape == (len(yte), 2)
    np.testing.assert_allclose(proba.sum(1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(out["prediction"], proba.argmax(1))
    assert_golden(goldens, "breast_cancer.gbdt.AUC", binary_auc(yte, proba[:, 1]))


def test_classifier_multiclass_and_regressor_goldens():
    goldens = load_goldens("VerifyRealDatasets")
    x, y = load_xy("wine")
    xtr, xte, ytr, yte = stratified_split(x, y)
    m = LightGBMClassifier(
        num_iterations=60, num_leaves=15, min_data_in_leaf=3, seed=7, device="cpu"
    ).fit(DataFrame.from_dict({"features": xtr, "label": ytr}))
    pred = m.transform(DataFrame.from_dict({"features": xte, "label": yte}))["prediction"]
    assert_golden(goldens, "wine.gbdt.accuracy", float((pred == yte).mean()))

    goldens = load_goldens("VerifyLightGBMRegressor")
    x, y = load_xy("diabetes")
    test = np.random.default_rng(7).permutation(len(y))[: int(0.3 * len(y))]
    mask = np.zeros(len(y), bool)
    mask[test] = True
    r = LightGBMRegressor(
        num_iterations=60, num_leaves=15, min_data_in_leaf=5, seed=7, device="cpu"
    ).fit(DataFrame.from_dict({"features": x[~mask], "label": y[~mask]}))
    p = r.transform(DataFrame.from_dict({"features": x[mask], "label": y[mask]}))["prediction"]
    r2 = 1 - np.sum((y[mask] - p) ** 2) / np.sum((y[mask] - y[mask].mean()) ** 2)
    assert_golden(goldens, "diabetes.gbdt.R2", r2)


def test_model_save_load_round_trip(tmp_path):
    x, y = load_xy("iris")
    df = DataFrame.from_dict({"features": x, "label": y})
    m = LightGBMClassifier(num_iterations=5, num_leaves=7, min_data_in_leaf=3,
                           device="cpu").fit(df)
    m.save(str(tmp_path / "m"))
    back = LightGBMClassificationModel.load(str(tmp_path / "m"))
    assert back.get("device") == "cpu"
    np.testing.assert_array_equal(back.transform(df)["probability"], m.transform(df)["probability"])


def test_pipeline_and_tensor_codec(tmp_path):
    from mmlspark_tpu_torch import Pipeline, PipelineModel
    from mmlspark_tpu_torch.core import serialize

    x, y = load_xy("iris")
    df = DataFrame.from_dict({"features": x, "label": y})
    pm = Pipeline([LightGBMClassifier(num_iterations=3, num_leaves=7, min_data_in_leaf=3,
                                      device="cpu")]).fit(df)
    assert isinstance(pm, PipelineModel)
    assert pm.transform(df)["prediction"].shape == (len(y),)
    comp = pm.compile()  # the classifier's device="cpu" places the segment
    assert comp.num_fused_stages == 1
    staged, fused = pm.transform(df), comp.transform(df)
    assert fused.columns == staged.columns
    for c in staged.columns:
        np.testing.assert_array_equal(fused[c], staged[c])
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    serialize.write_complex_value(t, str(tmp_path / "t"))
    back = serialize.read_complex_value(str(tmp_path / "t"))
    assert isinstance(back, torch.Tensor) and torch.equal(back, t)


def test_port_has_its_own_stage_registry():
    from mmlspark_tpu.core.pipeline import STAGE_REGISTRY as JAX_REGISTRY
    from mmlspark_tpu.models.gbdt import LightGBMClassifier as JClassifier

    assert PORT_REGISTRY["LightGBMClassifier"] is LightGBMClassifier
    assert JAX_REGISTRY["LightGBMClassifier"] is JClassifier


def _fit_with(x, y, cfg_kw=None, **train_kw):
    return train(x, y, TrainConfig(**(cfg_kw or {})), device="cpu", **train_kw)


def _init_booster(x, y):
    """A 3-class booster: a binary fit cannot continue it."""
    return _fit_with(x, y * 2, dict(objective="multiclass", num_class=3, num_iterations=1,
                                    num_leaves=4))


def _csr_input(x, y):
    from scipy.sparse import csr_matrix

    return _fit_with(csr_matrix(x), y, dict(categorical_features=(0,)))


def _estimator_num_batches(x, y):
    df = DataFrame.from_dict({"features": x, "label": y})
    return LightGBMClassifier(num_batches=2, resume_from="unused", device="cpu").fit(df)


def _categorical_csr(x, y):
    from scipy.sparse import csr_matrix

    from mmlspark_tpu_torch.models.gbdt import BinMapper

    return BinMapper.fit(csr_matrix(x), categorical_features=(0,))


@pytest.mark.parametrize("run,exc,match", [
    (lambda x, y: _fit_with(x, y, dict(delegate=object())), TypeError, "LightGBMDelegate"),
    (_csr_input, ValueError, "dense"),
    (lambda x, y: _fit_with(x, y, init_booster=_init_booster(x, y)), ValueError, "class count"),
    (_estimator_num_batches, ValueError, "num_batches"),
    (_categorical_csr, ValueError, "dense"),
    (lambda x, y: _fit_with(x, y, dict(parallelism="voting_parallel",
                                       growth_policy="depthwise")), ValueError, "voting"),
], ids=["delegate", "csr_input", "init_booster", "num_batches", "categorical", "voting"])
def test_unported_options_raise(run, exc, match):
    """What the port refuses raises, naming why: the ported options refuse
    what the JAX package cannot do either (a delegate without the hooks,
    continuing a booster of another class count, checkpoints across
    ``num_batches``, categorical columns of sparse input, to ``BinMapper``
    and to ``train``, and the leaf-wise voting grower asked to grow
    level-wise)."""
    x, y = load_xy("iris")
    with pytest.raises(exc, match=match):
        run(x, (y > 0).astype(float))


def test_unported_estimator_params_raise():
    """Every estimator param of the JAX package is ported (``fused_rounds``
    too); malformed values of the new ones raise at ``fit``."""
    from mmlspark_tpu.models.gbdt import estimators as J
    from mmlspark_tpu_torch.models.gbdt import estimators as P

    for name in ("LightGBMClassifier", "LightGBMRegressor", "LightGBMRanker"):
        def params(cls):
            return {n for n in dir(cls) if type(getattr(cls, n)).__name__.endswith("Param")}
        assert params(getattr(J, name)) - params(getattr(P, name)) == set()
    x, y = load_xy("iris")
    df = DataFrame.from_dict({"features": x, "label": y})
    with pytest.raises(ValueError, match="num_batches"):
        LightGBMClassifier(num_batches=2, checkpoint_dir="unused", device="cpu").fit(df)
    with pytest.raises(ValueError, match="LightGBM model string"):
        LightGBMClassifier(model_string="not a model", device="cpu").fit(df)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    x, y = load_xy("iris")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(x, y, TrainConfig(objective="multiclass", num_class=3))
    assert LightGBMClassifier().get("device") == "cuda"
    df = DataFrame.from_dict({"features": x, "label": y, "q": np.arange(len(y)) // 10})
    for est in (LightGBMRanker(group_col="q"), LightGBMRegressor(objective="quantile"),
                LightGBMClassifier(boosting_type="goss")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            est.fit(df)


# -- interop with the JAX package's models -----------------------------------


@pytest.mark.parametrize("name,objective", [("breast_cancer", "binary"), ("wine", "multiclass")])
def test_model_strings_interoperate(reference_device_grower, name, objective):
    x, y = load_xy(name)
    k = int(y.max()) + 1 if objective == "multiclass" else 1
    cfg = dict(objective=objective, num_class=k, num_iterations=8, num_leaves=15,
               min_data_in_leaf=5)
    ref = jtrain(x, y, JConfig(**cfg), shard=False, base_score=0.25)
    port_from_ref = Booster.from_model_string(ref.to_model_string())
    assert port_from_ref.to_model_string() == ref.to_model_string()
    np.testing.assert_array_equal(port_from_ref.predict_raw(x, device="cpu"), ref.predict_raw(x))

    port = train(x, y, TrainConfig(**cfg), device="cpu", base_score=0.25)
    ref_from_port = JBooster.from_model_string(port.to_model_string())
    assert ref_from_port.to_model_string() == port.to_model_string()
    np.testing.assert_array_equal(ref_from_port.predict_raw(x), port.predict_raw(x, device="cpu"))
    np.testing.assert_array_equal(
        port.predict_leaf(x, device="cpu"), ref_from_port.predict_leaf(x)
    )


@pytest.mark.parametrize("name,objective", [("breast_cancer", "binary"), ("iris", "multiclass")])
def test_booster_from_reference_parameters(reference_device_grower, name, objective):
    x, y = load_xy(name)
    k = int(y.max()) + 1 if objective == "multiclass" else 1
    ref = jtrain(x, y, JConfig(objective=objective, num_class=k, num_iterations=6,
                               num_leaves=15, min_data_in_leaf=5), shard=False)
    trees = [
        {f: getattr(t, f) for f in ("leaf", "feature", "threshold", "active", "gain",
                                    "values", "counts")}
        for t in ref.trees
    ]
    port = booster_from_reference(
        trees, objective=ref.objective, num_class=ref.num_class,
        num_features=ref.num_features, base_score=ref.base_score,
    )
    np.testing.assert_allclose(
        port.predict_raw(x, device="cpu"), ref.predict_raw(x), rtol=0, atol=ATOL
    )
    assert port.to_model_string() == ref.to_model_string()
