"""The parallel layer on ``torch.distributed``: the port of
``mmlspark_tpu.parallel``: mesh, sharding, collectives and distributed
(A4 step 1), and the elastic training gang (``elastic``, A4 steps 2-3),
whose members sum their histograms over their own TCP reducer, vote
(PV-Tree) instead of summing whole planes, stream out-of-core data, and
replicate checkpoints as content-addressed artifacts (no shared disk).

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
    process_mesh,
    replicated,
    set_mesh,
)
from mmlspark_tpu_torch.parallel.sharding import (
    check_same_rows,
    multihost_pad_target,
    pad_batch,
    replicate,
    shard_batch,
    shard_batch_multihost,
)
from mmlspark_tpu_torch.parallel import collectives, distributed, elastic

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "get_mesh",
    "process_mesh",
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
    "check_same_rows",
    "collectives",
    "distributed",
    "elastic",
]
