"""The parallel layer on ``torch.distributed``: the port of
``mmlspark_tpu.parallel`` (its A4 step 1: mesh, sharding, collectives and
distributed; the elastic gang, ``parallel/elastic.py``, comes later,
ROADMAP.md Queue A).

A mesh shard of the JAX package is a rank here: one process per device,
each holding its own rows, joined in a process group (NCCL on the card,
gloo on the CPU). The JAX package's ``parallel/compat.py`` has no
counterpart: it is a JAX version shim for ``shard_map``, which the port
does not need (:func:`collectives.shard_apply` maps over ranks).
"""

from mmlspark_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    cluster_summary,
    data_sharding,
    device_count,
    get_mesh,
    local_device_count,
    make_mesh,
    replicated,
    set_mesh,
)
from mmlspark_tpu_torch.parallel.sharding import (
    multihost_pad_target,
    pad_batch,
    replicate,
    shard_batch,
    shard_batch_multihost,
)
from mmlspark_tpu_torch.parallel import collectives, distributed

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "get_mesh",
    "set_mesh",
    "device_count",
    "local_device_count",
    "cluster_summary",
    "data_sharding",
    "replicated",
    "pad_batch",
    "shard_batch",
    "shard_batch_multihost",
    "multihost_pad_target",
    "replicate",
    "collectives",
    "distributed",
]
