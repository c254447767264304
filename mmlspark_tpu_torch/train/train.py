"""TrainClassifier / TrainRegressor — auto-featurize + fit any predictor.

Reference: train/TrainClassifier.scala:94-130 (label reindex via
ValueIndexer, auto Featurize, classifier fit), train/TrainRegressor.scala.
The model wraps (featurizer, value-indexer, inner model) and exposes
original label values on output.

The PyTorch port of ``mmlspark_tpu.train.train``. Featurization and label
indexing are the port's host ``featurize`` stages; the inner estimator
keeps its own ``device`` (the default learners, ``LogisticRegression``
and ``LinearRegression``, fit on the card unless given
``device="cpu"``), and these stages add no device knob of their own.
``from_jax_params`` rebuilds a model the JAX package fitted from its
parts (numpy arrays and strings), so both packages can score one model.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    Param,
)
from mmlspark_tpu_torch.core.pipeline import STAGE_REGISTRY, Estimator, Model
from mmlspark_tpu_torch.core.schema import CATEGORICAL_KEY
from mmlspark_tpu_torch.featurize import Featurize, ValueIndexer
from mmlspark_tpu_torch.featurize.featurize import NUM_FEATURES_DEFAULT, NUM_FEATURES_TREE_OR_NN


def stage_from_jax_parts(parts: dict, **kw: Any) -> Model:
    """A fitted stage of the port from a JAX model's parts:
    ``{"class": <stage name>, "params": {<set param>: value}}``, where a
    value is a numpy array, a plain value, a LightGBM/JSON model string,
    or itself such a parts dict (or a list of them) for a nested stage.
    ``kw`` (``device``) goes to every nested stage that has the param."""
    if parts["class"] not in STAGE_REGISTRY:
        # the learners a trained model wraps register on import
        import mmlspark_tpu_torch.models.gbdt  # noqa: F401
        import mmlspark_tpu_torch.models.linear  # noqa: F401
        import mmlspark_tpu_torch.vw  # noqa: F401
    cls = STAGE_REGISTRY[parts["class"]]
    params = {k: _from_parts(v, kw) for k, v in parts["params"].items()}
    own = {k: v for k, v in kw.items() if k in cls.params()}
    if hasattr(cls, "from_jax_params"):
        return cls.from_jax_params(params, **own)
    return cls(**own).set(**params)


def _from_parts(v: Any, kw: dict) -> Any:
    if isinstance(v, dict) and set(v) == {"class", "params"}:
        return stage_from_jax_parts(v, **kw)
    if isinstance(v, list) and v and all(isinstance(x, dict) and set(x) == {"class", "params"} for x in v):
        return [stage_from_jax_parts(x, **kw) for x in v]
    return v


# ``from_jax_params`` of the trained models, which nest fitted stages (no
# docstring: the models' own docs stay those they inherit, as in the JAX
# package, which codegen reflects)
class _FromJaxParts:
    @classmethod
    def from_jax_params(cls, params: dict, **kw: Any) -> Any:
        """The JAX package's fitted model in the port: ``params`` are its
        set params, each nested fitted stage (the featurizer, the inner
        model, each per-class model) given as
        ``{"class": name, "params": {...}}`` of numpy arrays, strings
        (a GBDT model's ``model_string``) and plain values; ``kw`` the
        port's own params of the nested stages (``device``)."""
        return cls().set(**{k: _from_parts(v, kw) for k, v in params.items()})


class TrainClassifier(Estimator, HasLabelCol):
    model = ComplexParam("inner classifier estimator (defaults to LogisticRegression)")
    number_of_features = Param("hash space for featurization", default=NUM_FEATURES_TREE_OR_NN, type_=int)
    reindex_label = Param("reindex labels via ValueIndexer", default=True, type_=bool)

    def fit(self, df: DataFrame) -> "TrainedClassifierModel":
        label = self.get("label_col")
        inner = self.get("model")
        if inner is None:
            from mmlspark_tpu_torch.models.linear import LogisticRegression

            inner = LogisticRegression()
        levels: Optional[list] = None
        work = df
        if self.get("reindex_label"):
            vi = ValueIndexer(input_col=label, output_col="__label_idx__").fit(df)
            work = vi.transform(df)
            levels = vi.get("levels")
            work = work.drop(label).rename({"__label_idx__": label})
        feat_cols = [c for c in work.columns if c != label]
        featurizer = Featurize(
            input_cols=feat_cols,
            output_col="features",
            number_of_features=self.get("number_of_features"),
        ).fit(work)
        feats = featurizer.transform(work)
        if hasattr(inner, "param") and "label_col" in inner.params():
            inner = inner.copy({"label_col": label})
        inner_model = inner.fit(feats)
        m = TrainedClassifierModel(label_col=label)
        m.set(featurizer=featurizer, inner_model=inner_model)
        if levels is not None:
            m.set(levels=levels)
        return m


class TrainedClassifierModel(_FromJaxParts, Model, HasLabelCol):
    featurizer = ComplexParam("fitted featurizer")
    inner_model = ComplexParam("fitted classifier model")
    levels = Param("original label values", type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        work = df
        label = self.get("label_col")
        if label in work.columns and self.get("levels") is not None:
            # map labels to indices for scoring consistency
            table = {str(v): i for i, v in enumerate(self.get("levels"))}
            work = work.with_column(
                label,
                lambda p: np.array([table.get(str(v), -1) for v in p[label]], np.int32),
            )
        feats = self.get_or_fail("featurizer").transform(work)
        out = self.get_or_fail("inner_model").transform(feats)
        levels = self.get("levels")
        if levels is not None:
            out = out.with_column_metadata("prediction", {CATEGORICAL_KEY: levels})
        return out

    def get_scored_labels(self, out: DataFrame, col: str = "scored_labels") -> DataFrame:
        """Map integer predictions back to original label values."""
        levels = self.get("levels")
        if levels is None:
            return out
        lv = np.array(levels, dtype=object)
        return out.with_column(
            col, lambda p: lv[np.asarray(p["prediction"], np.int64)]
        )


class TrainRegressor(Estimator, HasLabelCol):
    model = ComplexParam("inner regressor estimator (defaults to LinearRegression)")
    number_of_features = Param("hash space for featurization", default=NUM_FEATURES_DEFAULT, type_=int)

    def fit(self, df: DataFrame) -> "TrainedRegressorModel":
        label = self.get("label_col")
        inner = self.get("model")
        if inner is None:
            from mmlspark_tpu_torch.models.linear import LinearRegression

            inner = LinearRegression()
        feat_cols = [c for c in df.columns if c != label]
        featurizer = Featurize(
            input_cols=feat_cols,
            output_col="features",
            number_of_features=self.get("number_of_features"),
        ).fit(df)
        feats = featurizer.transform(df)
        if hasattr(inner, "param") and "label_col" in inner.params():
            inner = inner.copy({"label_col": label})
        inner_model = inner.fit(feats)
        m = TrainedRegressorModel(label_col=label)
        m.set(featurizer=featurizer, inner_model=inner_model)
        return m


class TrainedRegressorModel(_FromJaxParts, Model, HasLabelCol):
    featurizer = ComplexParam("fitted featurizer")
    inner_model = ComplexParam("fitted regressor model")

    def transform(self, df: DataFrame) -> DataFrame:
        feats = self.get_or_fail("featurizer").transform(df)
        return self.get_or_fail("inner_model").transform(feats)


class OneVsRest(Estimator, HasLabelCol, HasFeaturesCol, HasPredictionCol):
    """Fit one binary copy of any classifier per class; predict argmax of
    per-class positive scores.

    The reference promotes multiclass LogisticRegression through Spark's
    OneVsRest (train/TrainClassifier.scala:106-128) because its LR is
    binary-only; here LogisticRegression is natively softmax-multiclass,
    so this stage exists as the user-facing meta-estimator, not a
    promotion workaround."""

    classifier = ComplexParam("binary base classifier (cloned per class)")

    def fit(self, df: DataFrame) -> "OneVsRestModel":
        import copy

        base = self.get_or_fail("classifier")
        label = self.get("label_col")
        y = np.asarray(df[label], np.float64)
        classes = sorted(float(c) for c in np.unique(y))
        models = []
        for c in classes:
            est = copy.deepcopy(base)
            # base estimators vary in declared params ("any classifier"):
            # set only what each one understands (train.py pattern above)
            if "label_col" in est.params():
                est.set(label_col="__ovr_label__")
            if "features_col" in est.params():
                est.set(features_col=self.get("features_col"))
            # the multiclass label must not leak into featurize-all bases
            binary = df.with_column(
                "__ovr_label__", (y == c).astype(np.float64)
            ).drop(label)
            models.append(est.fit(binary))
        m = OneVsRestModel(
            features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
        )
        m.set(models=models, classes=classes)
        return m


class OneVsRestModel(_FromJaxParts, Model, HasFeaturesCol, HasPredictionCol):
    models = ComplexParam("per-class fitted binary models")
    classes = ComplexParam("class label per model")

    def transform(self, df: DataFrame) -> DataFrame:
        models = self.get_or_fail("models")
        classes = np.asarray(self.get_or_fail("classes"))
        scores = []
        for sub in models:
            out = sub.transform(df)
            # positive-class confidence from the sub-model's CONFIGURED
            # columns (probability_col when it has one, else prediction_col);
            # wrapper models (TrainedClassifierModel) don't declare the
            # param but their inner model still emits "probability"
            pc = (
                sub.get("probability_col")
                if "probability_col" in sub.params()
                else None
            )
            if pc is None and "probability" in out.columns:
                pc = "probability"
            if pc and pc in out.columns:
                p = np.asarray(out[pc], np.float64)
                scores.append(p[:, 1] if p.ndim == 2 else p)
            else:
                spc = (
                    sub.get("prediction_col")
                    if "prediction_col" in sub.params()
                    else "prediction"
                )
                scores.append(np.asarray(out[spc], np.float64))
        stacked = np.stack(scores, axis=1)  # (n, k)
        return df.with_column(
            self.get("prediction_col"), classes[stacked.argmax(axis=1)]
        )
