"""Scheduler: order segments by critical path; overlap independent hosts.

The PyTorch port's copy of ``mmlspark_tpu.compiler.scheduler``.

Per the TF partitioning/scheduling paper (arXiv:1711.01912), once a
program is partitioned the remaining lever is the *schedule*: the makespan
of a DAG of tasks is bounded below by its critical path, and
longest-remaining-path list scheduling is the classic near-optimal
heuristic. Pipeline DAGs here are small (tens of segments), so exact
critical-path priorities are cheap to recompute every run.

Cost model: the first transform measures every segment with the obs span
substrate and feeds an EWMA per segment; later transforms schedule
against measured reality instead of ``cost_hint`` guesses. The first
fused-segment sample includes its warm-up and CUDA graph capture — the
EWMA washes that out after a couple of runs, which is exactly the cadence
at which the schedule can usefully change.

Execution is host-sequential except for one genuinely concurrent case:
when two or more *host-bound* segments (HTTP transformers, io clients)
are ready at the same instant on independent branches, they run
overlapped on a thread pool — their wall time is I/O wait, so the overlap
is the whole win the critical-path argument promises. Device segments
never overlap (one device) and opaque stages are plan-level barriers, so
neither can be co-ready with anything.

Safety: any reordering (or overlap) of independent branches is only sound
when every declared-I/O stage preserves row count (see planner docstring);
a plan carrying a row-dropping stage degrades to original stage order,
fusion still applied.
"""

from __future__ import annotations

import concurrent.futures as _futures
import time
from typing import Any, Optional

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.compiler.fuser import HostSegment
from mmlspark_tpu_torch.core.dataframe import DataFrame

_M_SCHED_REORDERS = obs.counter(
    "mmlspark_compiler_schedule_overlaps_total",
    "Host segments executed concurrently by the critical-path scheduler",
)

_DEFAULT_HOST_COST = 10.0   # host stages (HTTP, io) dominate until measured
_DEFAULT_OPAQUE_COST = 1.0


class CostModel:
    """Per-segment cost estimates: kernel hints until measured, EWMA after."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self.measured: dict = {}   # segment name -> seconds

    def observe(self, name: str, seconds: float) -> None:
        prev = self.measured.get(name)
        self.measured[name] = (
            seconds if prev is None
            else self.alpha * seconds + (1 - self.alpha) * prev
        )

    def cost(self, segment: Any) -> float:
        m = self.measured.get(segment.name)
        if m is not None:
            return m
        if isinstance(segment, HostSegment):
            return _DEFAULT_OPAQUE_COST if segment.opaque else _DEFAULT_HOST_COST
        return sum(k.cost_hint for k in segment.kernels)


def segment_deps(segments: list, plan: Any) -> list:
    """Per-segment dependency sets, projected from the stage DAG."""
    seg_of: dict = {}
    for si, seg in enumerate(segments):
        for n in seg.nodes:
            seg_of[n.index] = si
    deps: list = [set() for _ in segments]
    for si, seg in enumerate(segments):
        for n in seg.nodes:
            for d in n.deps:
                ds = seg_of[d]
                if ds != si:
                    deps[si].add(ds)
    return deps


def critical_path(segments: list, deps: list, cost_model: CostModel) -> list:
    """Longest cost path from each segment to any sink (inclusive)."""
    dependents: list = [set() for _ in segments]
    for si, ds in enumerate(deps):
        for d in ds:
            dependents[d].add(si)
    prio = [0.0] * len(segments)
    # reverse index order is reverse-topological: deps only point backwards
    for si in range(len(segments) - 1, -1, -1):
        down = max((prio[d] for d in dependents[si]), default=0.0)
        prio[si] = cost_model.cost(segments[si]) + down
    return prio


def schedule_order(segments: list, deps: list, cost_model: CostModel) -> list:
    """List schedule: among ready segments, longest remaining path first
    (original index breaks ties, keeping the schedule deterministic)."""
    prio = critical_path(segments, deps, cost_model)
    remaining = set(range(len(segments)))
    done: set = set()
    order: list = []
    while remaining:
        ready = [s for s in remaining if deps[s] <= done]
        ready.sort(key=lambda s: (-prio[s], s))
        nxt = ready[0]
        order.append(nxt)
        remaining.discard(nxt)
        done.add(nxt)
    return order


class ScheduledExecutor:
    """Run the segment DAG over a DataFrame under staged-equality rules."""

    def __init__(
        self,
        segments: list,
        plan: Any,
        cost_model: Optional[CostModel] = None,
        parallel_hosts: bool = True,
    ):
        self.segments = segments
        self.plan = plan
        self.cost_model = cost_model or CostModel()
        self.deps = segment_deps(segments, plan)
        # reordering/overlap requires every declared stage row-preserving
        self.reorderable = plan.all_row_preserving
        self.parallel_hosts = parallel_hosts and self.reorderable

    # -- schedule ------------------------------------------------------------

    def order(self) -> list:
        if not self.reorderable:
            return list(range(len(self.segments)))
        return schedule_order(self.segments, self.deps, self.cost_model)

    def explain(self) -> str:
        prio = critical_path(self.segments, self.deps, self.cost_model)
        lines = []
        for pos, si in enumerate(self.order()):
            seg = self.segments[si]
            dep = ",".join(str(d) for d in sorted(self.deps[si])) or "-"
            lines.append(
                f"{pos}. [{si}] {seg.name} cost={self.cost_model.cost(seg):.4g}s "
                f"critical_path={prio[si]:.4g}s deps={dep}"
            )
        if not self.reorderable:
            lines.append("(row-dropping stage present: original order pinned)")
        return "\n".join(lines)

    # -- execution -----------------------------------------------------------

    def _apply_one(self, seg: Any, df: DataFrame) -> DataFrame:
        t0 = time.perf_counter()
        out = seg.apply(df)
        self.cost_model.observe(seg.name, time.perf_counter() - t0)
        return out

    def _overlap_hosts(self, batch: list, df: DataFrame) -> DataFrame:
        """Run independent ready host segments concurrently on the same df
        snapshot; merge each one's declared written columns back. Sound
        because co-ready segments have disjoint writes (write-write hazards
        are plan edges) and every stage here is row-preserving."""
        m = _M_SCHED_REORDERS
        if m._on:
            m.inc(len(batch))
        with obs.span("compiler.schedule.host_overlap"):
            with _futures.ThreadPoolExecutor(max_workers=len(batch)) as pool:
                outs = list(pool.map(
                    lambda seg: self._apply_one(seg, df), batch
                ))
        for seg, out in zip(batch, outs):
            for c in seg.writes:
                df = df.with_column(c, out[c])
                md = out.column_metadata(c)
                if md:
                    df = df.with_column_metadata(c, md)
        return df

    def run(self, df: DataFrame) -> DataFrame:
        order = self.order()
        done: set = set()
        i = 0
        while i < len(order):
            si = order[i]
            seg = self.segments[si]
            # gather the run of consecutively-scheduled segments that are
            # ALL ready now and all host-bound: those overlap
            batch = [si]
            if self.parallel_hosts and isinstance(seg, HostSegment) and not seg.opaque:
                j = i + 1
                while j < len(order):
                    nj = order[j]
                    sj = self.segments[nj]
                    if (
                        isinstance(sj, HostSegment)
                        and not sj.opaque
                        and self.deps[nj] <= done
                    ):
                        batch.append(nj)
                        j += 1
                    else:
                        break
            if len(batch) > 1:
                df = self._overlap_hosts([self.segments[b] for b in batch], df)
            else:
                df = self._apply_one(seg, df)
            done.update(batch)
            i += len(batch)
        return df
