"""Generic dataflow stages: the port of ``mmlspark_tpu.stages``.

Only ``stages/basic.py`` is ported so far; ``adapters``, ``balance``,
``batching``, ``summarize`` and ``text`` follow (ROADMAP.md, Queue A item
6), so this package exports basic's names only.
"""

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

__all__ = [
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
]
