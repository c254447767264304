"""CompiledPipeline — a fitted pipeline as one scheduled, fused program.

The PyTorch port of ``mmlspark_tpu.compiler.compiled``.
``PipelineModel.compile()`` returns this drop-in :class:`Transformer`: the
planner derives the stage DAG, the fuser merges adjacent fusable stages
into segments that run as one CUDA graph per bucket on the card, the
partitioner assigns each column batch or replicated over the process's
ranks (one rank, or a CPU mesh in ``auto`` mode: replicated), the fuser
carries that out per bucket, and the scheduler orders independent branches
by critical path. The correctness
contract is **element-wise equality with staged execution** — every
representative pipeline, including chunked scoring, where a
CompiledPipeline is a plain Transformer applied to each chunk (the
bounded bucket cache absorbs varying chunk sizes).

Build is lazy (first ``transform``) and also exposed as
:meth:`CompiledPipeline.build` so a caller can pay planning up front.
Persistence: only the fitted stages and the compile options are saved
(``save``/``load`` via the Params machinery); plans, graphs and measured
costs are runtime state, rebuilt on load.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.compiler.fuser import FusedSegment, build_segments
from mmlspark_tpu_torch.compiler.planner import PipelinePlan, plan_pipeline
from mmlspark_tpu_torch.compiler.scheduler import CostModel, ScheduledExecutor
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import ComplexParam, Param
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.parallel.mesh import process_mesh

_M_PIPE_COMPILE = obs.histogram(
    "mmlspark_compiler_plan_seconds",
    "Wall time of plan+fuse+partition+schedule for one pipeline "
    "(excludes per-bucket graph captures, which land in "
    "mmlspark_compiler_compile_seconds)",
    buckets=(0.001, 0.01, 0.05, 0.25, 1.0, 5.0),
)
_M_STAGES_FUSED = obs.counter(
    "mmlspark_compiler_stages_fused_total",
    "Stages merged into fused segments across pipeline compiles",
)
_M_SEGMENTS = obs.counter(
    "mmlspark_compiler_segments_total",
    "Segments produced by pipeline compiles", labels=("kind",),
)
_M_SEARCHES = obs.counter(
    "mmlspark_compiler_sharding_search_total",
    "Sharding groups resolved by search (Automap conflict points) "
    "rather than propagation",
)


class CompiledPipeline(Model):
    """Drop-in Transformer executing a fitted pipeline as fused segments."""

    stages = ComplexParam("fitted stages of the source pipeline", default=[])
    exact = Param(
        "element-wise equal to staged execution: stages whose kernels "
        "cannot promise it at every batch shape (convolutions) run "
        "host-bound; False fuses them too (allclose-level equal)",
        default=True, type_=bool,
    )
    max_bucket = Param(
        "power-of-two batch-bucket cap bounding CUDA graphs per segment to "
        "log2(cap)+1 per feature shape", default=1024, type_=int,
    )
    partition_mode = Param(
        "auto (batch-shard on accelerator meshes, replicate on CPU) | "
        "batch (force batch sharding) | replicated",
        default="auto", type_=str,
    )
    device = Param(
        "device of fused segments whose stages name none: 'cuda' (default; "
        "raises without a card) or 'cpu'", type_=str,
    )
    parallel_hosts = Param(
        "overlap independent ready host-bound segments on threads",
        default=True, type_=bool,
    )

    def __init__(self, stages: Optional[Sequence[Any]] = None, **kw: Any):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))
        self._plan: Optional[PipelinePlan] = None
        self._segments: Optional[list] = None
        self._executor: Optional[ScheduledExecutor] = None
        self._cost_model = CostModel()

    # -- build ---------------------------------------------------------------

    def build(self, mesh: Any = None) -> "CompiledPipeline":
        """Plan + fuse + partition + schedule (idempotent). ``mesh``
        defaults to the process mesh on each fused segment's device
        (``parallel.process_mesh``: the default group's ranks, one without
        an initialised group), unless ``partition_mode`` is ``replicated``;
        the partitioner falls back to replicated on one rank, and on a CPU
        mesh in ``auto`` mode. Over more than one rank ``transform`` is a
        collective: every rank calls it with the same rows."""
        if self._executor is not None:
            return self
        t0 = time.perf_counter()
        with obs.span("compiler.compile"):
            plan = plan_pipeline(list(self.get("stages")))
            segments = build_segments(
                plan,
                exact=self.get("exact"),
                max_bucket=self.get("max_bucket"),
                mesh=mesh,
                partition_mode=self.get("partition_mode"),
                device=self.get("device"),
            )
            if mesh is None and self.get("partition_mode") != "replicated":
                for s in segments:
                    if isinstance(s, FusedSegment):
                        s.mesh = process_mesh(s.device_name)
            self._plan = plan
            self._segments = segments
            self._executor = ScheduledExecutor(
                segments, plan,
                cost_model=self._cost_model,
                parallel_hosts=self.get("parallel_hosts"),
            )
        if obs.REGISTRY.enabled:
            _M_PIPE_COMPILE.observe(time.perf_counter() - t0)
            fused = [s for s in segments if isinstance(s, FusedSegment)]
            _M_STAGES_FUSED.inc(sum(len(s.nodes) for s in fused))
            _M_SEGMENTS.labels(kind="fused").inc(len(fused))
            _M_SEGMENTS.labels(kind="host").inc(len(segments) - len(fused))
            _M_SEARCHES.inc(sum(len(s.sharding.searched) for s in fused))
        return self

    # -- introspection -------------------------------------------------------

    @property
    def plan(self) -> PipelinePlan:
        self.build()
        return self._plan

    @property
    def segments(self) -> list:
        self.build()
        return self._segments

    @property
    def fused_segments(self) -> list:
        return [s for s in self.segments if isinstance(s, FusedSegment)]

    @property
    def num_fused_stages(self) -> int:
        return sum(len(s.nodes) for s in self.fused_segments)

    def explain(self) -> str:
        """Plan, segments, sharding decisions and schedule, one report."""
        self.build()
        parts = ["== plan ==", self._plan.explain(), "", "== segments =="]
        for s in self._segments:
            kind = "fused" if isinstance(s, FusedSegment) else "host"
            parts.append(f"{s.name} kind={kind} stages={s.stage_names}")
            if isinstance(s, FusedSegment):
                sh = s.sharding
                if sh.decisions:
                    parts.append(f"  sharding: {sh.decisions}")
                for g in sh.searched:
                    parts.append(f"  searched: {g}")
                parts.append(f"  device: {s.device_name or 'cuda'}, graphs: {len(s._graphs)}")
        parts += ["", "== schedule =="]
        parts.append(self._executor.explain())
        return "\n".join(parts)

    # -- execution -----------------------------------------------------------

    def transform(self, df: DataFrame) -> DataFrame:
        self.build()
        with obs.span("compiler.pipeline.transform"):
            out = self._executor.run(df)
        # staged execution fixes the output column order; reordering-capable
        # schedules restore it so compiled output is indistinguishable
        final = self._plan.final_columns(df.columns)
        if final and set(final) == set(out.columns) and out.columns != final:
            out = out.select(*final)
        return out
