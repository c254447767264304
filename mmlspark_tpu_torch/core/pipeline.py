"""Estimator / Transformer / Model / Pipeline abstractions.

The reference's public surface is SparkML pipeline stages (SURVEY.md L5);
this module provides the same contract for the PyTorch port (a copy of
``mmlspark_tpu.core.pipeline`` with its own registry):

- :class:`Transformer` — ``transform(df) -> df``
- :class:`Estimator` — ``fit(df) -> Model``
- :class:`Pipeline` / :class:`PipelineModel` — stage composition
- every concrete stage auto-registers (for fuzzing coverage + binding
  codegen, the ``Wrappable`` analogue, core/contracts/Params.scala:15)
- ``save``/``load`` with complex payloads via ``core.serialize``

Stages must be constructible with no arguments; all state is params.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import ComplexParam, Param, Params
from mmlspark_tpu_torch.core import serialize as _ser

# Stage registry — the Wrappable analogue. Keys are class names. It is the
# port's own: the JAX package keys its registry by bare class name too, so a
# shared one would let the port's LightGBMClassifier replace the JAX one in
# any process that imports both packages.
STAGE_REGISTRY: dict[str, type] = {}


class PipelineStage(Params):
    """Base class for all stages."""

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        # abstract bases in this module are not public stages
        if not cls.__name__.startswith("_") and cls.__module__ != __name__:
            STAGE_REGISTRY[cls.__name__] = cls

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, overwrite: bool = True) -> None:
        import os
        import shutil

        if os.path.exists(path):
            if not overwrite:
                raise FileExistsError(f"{path} exists; pass overwrite=True")
            shutil.rmtree(path)
        _ser.save_stage(self, path)

    @classmethod
    def load(cls, path: str) -> Any:
        stage = _ser.load_stage(path)
        if cls is not PipelineStage and not isinstance(stage, cls):
            raise TypeError(f"loaded {type(stage).__name__}, expected {cls.__name__}")
        return stage

    def transform_schema(self, schema: Any) -> Any:
        """Optional schema-level dry-run; default: identity."""
        return schema


class Transformer(PipelineStage):
    def transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


class Estimator(PipelineStage):
    def fit(self, df: DataFrame) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted transformer."""


def load_stage(path: str) -> PipelineStage:
    return _ser.load_stage(path)


# --------------------------------------------------------------------------


class Pipeline(Estimator):
    """Sequential composition of stages (SparkML Pipeline semantics:
    estimators are fitted on the running dataframe, transformers applied)."""

    stages = ComplexParam("ordered list of pipeline stages", default=[])

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, **kw: Any):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def fit(self, df: DataFrame) -> "PipelineModel":
        fitted: list[Transformer] = []
        cur = df
        stages = self.get("stages")
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if i < len(stages) - 1:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(stages) - 1:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"pipeline stage {stage!r} is neither Estimator nor Transformer")
        return PipelineModel(stages=fitted)


class PipelineModel(Model):
    stages = ComplexParam("fitted stages", default=[])

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, **kw: Any):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def transform(self, df: DataFrame) -> DataFrame:
        for stage in self.get("stages"):
            df = stage.transform(df)
        return df

    def compile(self, **options: Any) -> Any:
        """Compile this fitted pipeline into a
        :class:`~mmlspark_tpu_torch.compiler.CompiledPipeline` — a drop-in
        Transformer that runs adjacent fusable stages as one program (one
        CUDA graph per bucket on the card) and schedules independent
        branches by critical path, with output element-wise equal to
        staged execution. ``options`` forward to CompiledPipeline params
        (``exact``, ``max_bucket``, ``partition_mode``,
        ``parallel_hosts``, ``device``)."""
        from mmlspark_tpu_torch.compiler import CompiledPipeline

        return CompiledPipeline(stages=list(self.get("stages")), **options)
