"""Low-latency model serving (Spark Serving analogue), on one worker.

The PyTorch port of ``mmlspark_tpu.serving``, its single-worker core: the
reference serves models from Structured Streaming, per-executor HTTP
servers feeding epoch-keyed request queues, replies routed back by request
id on the same machine, crashed partitions replaying their queue history
(HTTPSourceV2.scala:457-675).

- :class:`WorkerServer` — asyncio HTTP ingress with epoch-keyed queues,
  request-id routing table, history replay and commit pruning. A request
  never leaves its host: ingress -> batch -> card -> reply.
- :class:`ServingQuery` — couples a server to a Transformer/function:
  *continuous* mode batches whatever is queued (up to ``max_batch_size``
  / ``max_wait_ms``) and replies immediately; *micro-batch* mode advances
  epochs on a timer. Batches are padded to fixed shapes, so a compiled
  model replays one CUDA graph per bucket.
- :class:`ModelStore` / :class:`ModelDispatcher` (``modelstore/``) — named
  and versioned models resident on the card under a byte budget,
  background load + warmup, zero-downtime hot-swap, per-model queues with
  deadline-aware admission control, and a ``/models`` control plane.
- ``make_reply`` / ``request_to_json`` — ServingUDFs analogues.

Not ported yet (ROADMAP.md, Queue A item 7): the serving registry, the
gateway (``distributed.py``), the fleet CLI, the artifact plane and the
supervisor.
"""

from mmlspark_tpu_torch.serving.server import CachedRequest, ServiceInfo, WorkerServer
from mmlspark_tpu_torch.serving.query import (
    ServingQuery,
    SplitHandler,
    serve_transformer,
)
from mmlspark_tpu_torch.serving.modelstore import (
    LoadedModel,
    ModelDispatcher,
    ModelStore,
)
from mmlspark_tpu_torch.serving.udfs import make_reply, request_to_json, request_to_text

__all__ = [
    "WorkerServer",
    "CachedRequest",
    "ServiceInfo",
    "ServingQuery",
    "SplitHandler",
    "serve_transformer",
    "LoadedModel",
    "ModelDispatcher",
    "ModelStore",
    "make_reply",
    "request_to_json",
    "request_to_text",
]
