"""mmlspark_tpu_torch: the PyTorch/CUDA port of mmlspark_tpu.

A second package beside the JAX one, for NVIDIA Hopper cards. Plain tensor
code is PyTorch; each kernel the JAX package wrote in Pallas for the TPU is
a CUDA kernel written by hand (``ops/csrc/``). The port never imports JAX
or the JAX package: it keeps its own copies of what it needs. The JAX
package stays the reference the port is tested against.

The slices ported so far are listed in ROADMAP.md; the first is GBDT
training and scoring (``mmlspark_tpu_torch.models.gbdt``).
"""

from mmlspark_tpu_torch.version import __version__

from mmlspark_tpu_torch.core.dataframe import DataFrame, Row
from mmlspark_tpu_torch.core.pipeline import (
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    Transformer,
    load_stage,
)

__all__ = [
    "__version__",
    "DataFrame",
    "Row",
    "Estimator",
    "Model",
    "Pipeline",
    "PipelineModel",
    "Transformer",
    "load_stage",
]
