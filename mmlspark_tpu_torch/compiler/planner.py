"""Planner: fitted stage list -> column-dependency DAG + fusability classes.

The PyTorch port's copy of ``mmlspark_tpu.compiler.planner`` (pure
planning logic, no device code).

The reference executes a fitted ``PipelineModel`` strictly stage-by-stage
(core/pipeline.py:124); but stages declare their column I/O (the shared
``HasInputCol``/``HasOutputCol`` traits and ``transform_schema``), so the
true execution constraints are *data* dependencies: stage B depends on
stage A only when B reads a column A writes (or a write-write / read-write
ordering hazard links them). The planner recovers that DAG and classifies
every stage:

- ``fused``  — exposes a :class:`~mmlspark_tpu_torch.compiler.kernels.StageKernel`
  (pure tensor→tensor): eligible for fusion with adjacent fusable stages.
- ``host``   — known column I/O but host-bound work (HTTP transformers,
  io clients, native link functions): scheduled, never fused.
- ``opaque`` — declares no column I/O (``Lambda``, ``Repartition``,
  ``SummarizeData``...): planned as a barrier — it depends on every prior
  stage and every later stage depends on it, which is exactly the staged
  semantics for a stage that may touch anything.

Column I/O resolution order (first match wins):

1. ``stage.pipeline_opaque`` (class attr, True) — forced opaque: the
   stage drops/renames columns or rewrites rows wholesale (``Explode``,
   ``RenameColumn``) so column-level dependencies cannot describe it;
2. ``stage.pipeline_io() -> (reads, writes) | None`` — explicit
   declaration (None = opaque for this configuration);
3. the stage's kernel ``reads``/``writes``;
4. declared column params: reads from ``input_col``/``input_cols``/
   ``features_col``, writes from ``output_col``/``output_cols``/
   ``prediction_col``/``probability_col``/``raw_prediction_col``.

Declared-I/O stages sign a **row-locality contract**: output row k
depends only on input row k plus fitted state. Stages that may *drop*
rows (``ImageFeaturizer`` with ``drop_na`` on undecodable images) set
``pipeline_row_preserving = False``; the scheduler then pins execution to
original stage order (fusion still applies) because reordering around a
row-filter is only sound when no other branch exists.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from mmlspark_tpu_torch.compiler.kernels import StageKernel, stage_kernel

_READ_PARAMS = ("input_col", "features_col")
_READ_LIST_PARAMS = ("input_cols",)
_WRITE_PARAMS = (
    "output_col", "prediction_col", "probability_col", "raw_prediction_col",
)
_WRITE_LIST_PARAMS = ("output_cols",)


_UNRESOLVED = object()


def stage_io(stage: Any, kernel: Any = _UNRESOLVED) -> tuple:
    """(reads, writes, known) for one stage; ``known=False`` means opaque.
    ``kernel`` lets the planner pass an already-constructed kernel so
    heavyweight kernel builds (tree stacking, weight capture) happen once.
    """
    if getattr(stage, "pipeline_opaque", False):
        return (), (), False
    explicit = getattr(stage, "pipeline_io", None)
    if explicit is not None:
        try:
            io = explicit()
            if io is None:  # this configuration declines to declare
                return (), (), False
            reads, writes = io
            return tuple(reads), tuple(writes), True
        except Exception:  # noqa: BLE001 — a broken declaration plans opaque
            return (), (), False
    if kernel is _UNRESOLVED:
        kernel = stage_kernel(stage)
    if kernel is not None:
        return tuple(kernel.reads), tuple(kernel.writes), True
    reads: list = []
    writes: list = []
    try:
        params = type(stage).params()
    except Exception:  # noqa: BLE001 — not a Params stage: opaque
        return (), (), False
    def val(name: str) -> Any:
        return stage.get(name) if name in params else None
    for p in _READ_PARAMS:
        v = val(p)
        if isinstance(v, str) and v:
            reads.append(v)
    for p in _READ_LIST_PARAMS:
        v = val(p)
        if isinstance(v, (list, tuple)):
            reads.extend(str(c) for c in v)
    for p in _WRITE_PARAMS:
        v = val(p)
        if isinstance(v, str) and v:
            writes.append(v)
    for p in _WRITE_LIST_PARAMS:
        v = val(p)
        if isinstance(v, (list, tuple)):
            writes.extend(str(c) for c in v)
    if not reads and not writes:
        return (), (), False
    # de-dup preserving order
    return (
        tuple(dict.fromkeys(reads)), tuple(dict.fromkeys(writes)), True
    )


@dataclass
class StageNode:
    """One stage in the plan."""

    index: int
    stage: Any
    name: str
    reads: tuple
    writes: tuple
    kernel: Optional[StageKernel]
    opaque: bool
    row_preserving: bool = True
    deps: set = field(default_factory=set)       # node indices this waits on
    dependents: set = field(default_factory=set)

    @property
    def kind(self) -> str:
        if self.opaque:
            return "opaque"
        return "fused" if self.kernel is not None else "host"


class PipelinePlan:
    """The stage DAG + classification for one fitted pipeline."""

    def __init__(self, nodes: list, external_inputs: tuple):
        self.nodes = nodes
        self.external_inputs = external_inputs

    @property
    def all_row_preserving(self) -> bool:
        """False when any non-opaque stage may drop rows — the scheduler
        then keeps original stage order (opaque stages are already
        barriers, so only declared-I/O row-filters matter)."""
        return all(n.opaque or n.row_preserving for n in self.nodes)

    def topo_order(self) -> list:
        """Original-index order is always a valid topological order (deps
        only ever point backwards)."""
        return list(self.nodes)

    def final_columns(self, input_columns: list) -> list:
        """Column order staged execution would produce for this input —
        the scheduler restores it after any reordering."""
        cols = list(input_columns)
        for n in self.nodes:
            if n.opaque:
                return []  # an opaque stage may drop/rename: order unknowable
            for w in n.writes:
                if w not in cols:
                    cols.append(w)
        return cols

    def explain(self) -> str:
        lines = []
        for n in self.nodes:
            dep = ",".join(str(d) for d in sorted(n.deps)) or "-"
            lines.append(
                f"[{n.index}] {n.name} kind={n.kind} "
                f"reads={list(n.reads)} writes={list(n.writes)} deps={dep}"
            )
        if self.external_inputs:
            lines.append(f"external inputs: {list(self.external_inputs)}")
        return "\n".join(lines)


def plan_pipeline(stages: list) -> PipelinePlan:
    """Derive the DAG. Dependencies per column, staged-semantics faithful:

    - read-after-write: a reader depends on the LAST writer of the column;
    - write-after-read: a writer depends on every reader since the last
      write (it would otherwise clobber the value they expect);
    - write-after-write: a writer depends on the previous writer.
    """
    nodes: list = []
    for i, stage in enumerate(stages):
        kernel = stage_kernel(stage)
        reads, writes, known = stage_io(stage, kernel=kernel)
        nodes.append(StageNode(
            index=i,
            stage=stage,
            name=type(stage).__name__,
            reads=reads,
            writes=writes,
            kernel=kernel if known else None,
            opaque=not known,
            row_preserving=bool(
                getattr(stage, "pipeline_row_preserving", True)
            ),
        ))

    last_writer: dict = {}
    readers_since: dict = {}
    external: list = []
    barrier: Optional[int] = None  # most recent opaque stage
    for n in nodes:
        if n.opaque:
            # barrier: after everything before it...
            n.deps.update(range(n.index))
            barrier = n.index
            # ...and it invalidates column tracking (may rewrite anything)
            last_writer.clear()
            readers_since.clear()
            continue
        if barrier is not None:
            n.deps.add(barrier)
        for c in n.reads:
            w = last_writer.get(c)
            if w is not None:
                n.deps.add(w)
            elif barrier is None and c not in external:
                external.append(c)
            readers_since.setdefault(c, set()).add(n.index)
        for c in n.writes:
            w = last_writer.get(c)
            if w is not None:
                n.deps.add(w)
            for r in readers_since.get(c, ()):
                if r != n.index:
                    n.deps.add(r)
            last_writer[c] = n.index
            readers_since[c] = set()
        n.deps.discard(n.index)
    for n in nodes:
        for d in n.deps:
            nodes[d].dependents.add(n.index)
    return PipelinePlan(nodes, tuple(external))
