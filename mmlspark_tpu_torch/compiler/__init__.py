"""Pipeline compiler: fitted pipelines -> scheduled, fused programs.

The PyTorch port of ``mmlspark_tpu.compiler``. A fitted ``PipelineModel``
executes stage by stage, each stage launching its own ops and
materializing every intermediate column on the host. This package turns
it into (close to) one program per pipeline:

- :mod:`planner`     — stage DAG from column I/O + fusability classes;
- :mod:`kernels`     — the ``StageKernel`` fusability contract and
  ``pairwise_sum`` (numpy's summation order as elementwise adds);
- :mod:`fuser`       — maximal fusable runs -> one CUDA graph per
  (segment, bucket) on the card, with a bounded bucket set;
- :mod:`partitioner` — Automap-style spec propagation with search only at
  conflict points (arXiv:2112.02958), kept as data (one card: replicated);
- :mod:`scheduler`   — critical-path ordering of independent branches
  (arXiv:1711.01912) + overlapped host segments;
- :mod:`compiled`    — :class:`CompiledPipeline`, the drop-in Transformer
  (``PipelineModel.compile()``).

Correctness contract: compiled output is element-wise equal to staged
execution at every batch size, with per-call fallback to staged execution
when a segment's guard refuses an input. A failure to capture or replay a
graph raises.
"""

from mmlspark_tpu_torch.compiler.compiled import CompiledPipeline
from mmlspark_tpu_torch.compiler.fuser import FusedSegment, HostSegment, build_segments
from mmlspark_tpu_torch.compiler.kernels import (
    StageKernel,
    guard_dense_numeric,
    pairwise_sum,
    stage_kernel,
)
from mmlspark_tpu_torch.compiler.partitioner import ShardingPlan, plan_sharding
from mmlspark_tpu_torch.compiler.planner import PipelinePlan, plan_pipeline, stage_io
from mmlspark_tpu_torch.compiler.scheduler import (
    CostModel,
    ScheduledExecutor,
    critical_path,
    schedule_order,
    segment_deps,
)

__all__ = [
    "CompiledPipeline",
    "CostModel",
    "FusedSegment",
    "HostSegment",
    "PipelinePlan",
    "ScheduledExecutor",
    "ShardingPlan",
    "StageKernel",
    "build_segments",
    "critical_path",
    "guard_dense_numeric",
    "pairwise_sum",
    "plan_pipeline",
    "plan_sharding",
    "schedule_order",
    "segment_deps",
    "stage_io",
    "stage_kernel",
]
