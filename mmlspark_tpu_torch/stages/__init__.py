"""Generic dataflow stages: the port of ``mmlspark_tpu.stages``, with every
name of its ``__all__``."""

from mmlspark_tpu_torch.stages.adapters import (
    FastVectorAssembler,
    MultiColumnAdapter,
    MultiColumnAdapterModel,
    VectorZipper,
)
from mmlspark_tpu_torch.stages.basic import (
    Cacher,
    DropColumns,
    Explode,
    Lambda,
    RenameColumn,
    Repartition,
    SelectColumns,
    Timer,
    UDFTransformer,
    get_value_at,
    to_vector,
)
from mmlspark_tpu_torch.stages.batching import (
    DynamicMiniBatchTransformer,
    FixedMiniBatchTransformer,
    FlattenBatch,
    TimeIntervalMiniBatchTransformer,
)
from mmlspark_tpu_torch.stages.balance import (
    ClassBalancer,
    ClassBalancerModel,
    EnsembleByKey,
    StratifiedRepartition,
)
from mmlspark_tpu_torch.stages.summarize import SummarizeData
from mmlspark_tpu_torch.stages.text import TextPreprocessor, UnicodeNormalize

__all__ = [
    "VectorZipper",
    "MultiColumnAdapterModel",
    "MultiColumnAdapter",
    "FastVectorAssembler",
    "DropColumns",
    "SelectColumns",
    "RenameColumn",
    "Repartition",
    "Lambda",
    "UDFTransformer",
    "Explode",
    "Cacher",
    "Timer",
    "get_value_at",
    "to_vector",
    "FixedMiniBatchTransformer",
    "DynamicMiniBatchTransformer",
    "TimeIntervalMiniBatchTransformer",
    "FlattenBatch",
    "StratifiedRepartition",
    "ClassBalancer",
    "ClassBalancerModel",
    "EnsembleByKey",
    "SummarizeData",
    "TextPreprocessor",
    "UnicodeNormalize",
]
