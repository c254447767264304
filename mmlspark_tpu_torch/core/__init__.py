from mmlspark_tpu_torch.core.dataframe import DataFrame, Row
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    Param,
    Params,
)
from mmlspark_tpu_torch.core.pipeline import (
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    PipelineStage,
    STAGE_REGISTRY,
    Transformer,
    load_stage,
)
from mmlspark_tpu_torch.core.schema import ColumnInfo, Schema

__all__ = [
    "DataFrame",
    "Row",
    "resolve_device",
    "Param",
    "ComplexParam",
    "Params",
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Model",
    "Pipeline",
    "PipelineModel",
    "STAGE_REGISTRY",
    "load_stage",
    "ColumnInfo",
    "Schema",
]
