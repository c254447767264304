"""Device-resident ModelStore: versioned multi-model serving on one worker.

The PyTorch port of ``mmlspark_tpu.serving.modelstore``: the
model-lifecycle layer between the serving ingress
(:class:`~mmlspark_tpu_torch.serving.server.WorkerServer`) and the models
it serves — named models, integer versions, tensors resident on the card
under a byte budget, background load + warmup, atomic zero-downtime
hot-swap, and per-model dispatch with deadline-aware admission control.
See docs/modelstore.md.

- :class:`ModelStore` / :class:`LoadedModel` / :class:`ModelVersion` —
  the store itself (store.py);
- :class:`ModelDispatcher` — per-model queues + control plane on a
  WorkerServer (dispatch.py);
- :func:`build_loaded_model` / :func:`model_name_from_spec` — spec
  loaders, :func:`tensor_nbytes` their byte count (loaders.py).
"""

from mmlspark_tpu_torch.serving.modelstore.store import (
    EVICTED,
    FAILED,
    HBMBudgetExceeded,
    LOADING,
    LoadedModel,
    ModelStore,
    ModelStoreError,
    ModelVersion,
    READY,
    WARMING,
)
from mmlspark_tpu_torch.serving.modelstore.dispatch import (
    DEADLINE_HEADER,
    MODEL_HEADER,
    ModelDispatcher,
    STATE_HEADER,
)
from mmlspark_tpu_torch.serving.modelstore.loaders import (
    build_loaded_model,
    model_name_from_spec,
    tensor_nbytes,
)

__all__ = [
    "DEADLINE_HEADER",
    "EVICTED",
    "FAILED",
    "HBMBudgetExceeded",
    "LOADING",
    "LoadedModel",
    "MODEL_HEADER",
    "ModelDispatcher",
    "ModelStore",
    "ModelStoreError",
    "ModelVersion",
    "READY",
    "STATE_HEADER",
    "WARMING",
    "build_loaded_model",
    "model_name_from_spec",
    "tensor_nbytes",
]
