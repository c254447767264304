"""Fuser: run maximal runs of adjacent fusable stages as one program.

The PyTorch port of ``mmlspark_tpu.compiler.fuser``. Stage-by-stage
execution of a fitted pipeline launches each stage's ops per partition and
materializes every intermediate column on the host between stages. The
fuser instead runs the stage kernels of a maximal run of adjacent fusable
stages back to back on the device: the JAX package traces them into one
``jax.jit`` program; here, on the card, they are captured into **one CUDA
graph per (segment, bucket)**, replayed for every later batch of that
bucket, so a segment costs one graph launch, one host-to-device copy and
one device-to-host copy per chunk, and its intermediate values never leave
the card. On the CPU the same segment runs the same ops eagerly.

Load-bearing design points:

- **Exactness.** The compiled pipeline's contract is element-wise
  equality with staged execution. Every kernel runs the same PyTorch ops
  the stage's own ``transform`` runs (a graph replays exactly the kernels
  its capture launched), and every ``exact_capable`` kernel computes each
  row independently of how many rows its batch holds (docs/compiler.md;
  ``kernels.pairwise_sum`` for sums), so padding to a bucket and chunking
  cannot change a bit. Nothing fuses across stage boundaries here, so the
  JAX package's optimization barriers have no counterpart; ``exact``
  decides only whether an ``exact_capable=False`` kernel (a convolution,
  whose algorithm is picked by batch shape) is fused or planned
  host-bound.
- **Bounded graph cache.** Batches are padded to power-of-two buckets
  (``_bucket``, the JAX package's ``serving/query.py`` idiom) capped at
  ``max_bucket``, so a segment captures at most ``log2(max_bucket)+1``
  graphs per distinct feature shape no matter what partition sizes
  arrive. Oversized partitions run in bucket-size chunks. All graphs of a
  segment share one memory pool, so their intermediates are held once.
- **Static buffers.** Each graph reads its inputs from, and writes its
  outputs to, one packed device buffer each, mirrored by a pinned host
  buffer; a chunk is copied into the input one, the graph replays, and the
  outputs are copied out of the host one before the next replay.
- **Rows over ranks.** Over a mesh of more than one rank (the process
  group; ``CompiledPipeline.build`` takes it) a bucket the plan
  batch-shards runs on every rank at its block of the bucket
  (``ShardingPlan.in_specs``: batch columns cut to the rank's contiguous
  block, replicated columns whole), its graph captured at that block's
  shape (the key says so); the outputs of batch groups are all-gathered
  in rank order, one gather a partition, before the host epilogue, so
  every rank returns the whole output, as every JAX caller gets the global
  array. A batch column that a cross-row kernel reads (or a
  ``needs_replicated`` input) is all-gathered before that kernel, where
  XLA puts its all-gather; a bucket with such a gather runs its kernels
  eagerly (a CUDA graph cannot hold a gloo collective, which goes through
  the host), and its key holds None. A bucket the world size does not
  divide runs replicated: every rank computes it whole, as
  ``in_shardings`` degrades it. Every rank must pass the same rows (one
  all-gather of the partitions' row counts a call checks it).
- **Capture beside serving.** A serving worker captures a new version's
  graphs (its warm-up) while another thread replays the old version's and
  waits on their results. Each capture runs in thread-local capture mode,
  which forbids syncs and allocations only on the capturing thread (the
  default global mode would make the other thread's illegal, or break the
  capture), and captures, like the release of a segment's graphs, are
  serialised process-wide, so one capture's device-wide synchronize never
  lands inside another.

A segment that cannot run a given DataFrame (an object-dtype input, a
kernel guard refusal) runs its stages staged for that call — recorded in
``mmlspark_compiler_fallback_total{reason=...}``. A failure to capture or
launch a graph raises: it is never hidden behind a staged or CPU rerun.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.compiler.partitioner import BATCH, ShardingPlan, plan_sharding
from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.device import CAPTURE_LOCK as _CAPTURE_LOCK, resolve_device
from mmlspark_tpu_torch.core.profiling import device_phase
from mmlspark_tpu_torch.parallel import collectives
from mmlspark_tpu_torch.parallel.sharding import check_same_rows

_M_COMPILE = obs.histogram(
    "mmlspark_compiler_compile_seconds",
    "Wall time of a fused segment's first call per bucket (on the card: "
    "warm-up and CUDA graph capture)",
    labels=("segment",),
    buckets=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0),
)
_M_BUCKET_COMPILES = obs.counter(
    "mmlspark_compiler_bucket_compiles_total",
    "Fused-program builds (one per new bucket/shape per segment; a CUDA "
    "graph capture on the card)",
    labels=("segment",),
)
_M_REPLAYS = obs.counter(
    "mmlspark_compiler_graph_replays_total",
    "CUDA graph replays of fused segments (one per chunk)",
    labels=("segment",),
)
_M_SEG_LATENCY = obs.histogram(
    "mmlspark_compiler_segment_latency_seconds",
    "Per-call latency of compiled-pipeline segments",
    labels=("segment",),
)
_M_FALLBACK = obs.counter(
    "mmlspark_compiler_fallback_total",
    "Fused segments that fell back to staged execution",
    labels=("reason",),
)

# byte alignment of each column inside a packed static buffer
_ALIGN = 256


def _bucket(n: int, cap: Optional[int] = None) -> int:
    """Next power of two >= ``n``, capped at the next power of two >=
    ``cap``. The cap bounds the set of distinct padded shapes — and with
    it the number of graphs — to ``log2(cap) + 1`` buckets regardless of
    what batch sizes arrive."""
    b = 1
    while b < n:
        b *= 2
    if cap is not None:
        c = 1
        while c < cap:
            c *= 2
        b = min(b, c)
    return b


class Segment:
    """Base: one schedulable unit of a compiled pipeline."""

    name: str = "segment"
    nodes: list = []

    @property
    def stage_names(self) -> list:
        return [n.name for n in self.nodes]

    @property
    def reads(self) -> tuple:
        out: list = []
        produced: set = set()
        for n in self.nodes:
            out.extend(c for c in n.reads if c not in produced)
            produced.update(n.writes)
        return tuple(dict.fromkeys(out))

    @property
    def writes(self) -> tuple:
        out: list = []
        for n in self.nodes:
            out.extend(n.writes)
        return tuple(dict.fromkeys(out))

    def apply(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError


class HostSegment(Segment):
    """A single host-bound (or opaque) stage, executed via its own
    ``transform`` — per-stage fallback is the *plan* for these, not an
    error path."""

    def __init__(self, node: Any, name: str):
        self.nodes = [node]
        self.name = name
        self.opaque = node.opaque

    def apply(self, df: DataFrame) -> DataFrame:
        t0 = time.perf_counter()
        out = self.nodes[0].stage.transform(df)
        m = _M_SEG_LATENCY.labels(segment=self.name)
        if m._on:
            m.observe(time.perf_counter() - t0)
        return out


class _Packed:
    """Columns laid out in one byte buffer on the device and one pinned
    host buffer, each column a view at an aligned offset: one copy moves
    them all."""

    def __init__(self, specs: list, dev: torch.device):
        # specs: [(col, shape, torch dtype)]
        offs, total = [], 0
        for _, shape, dt in specs:
            offs.append(total)
            nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dt).element_size()
            total += -(-nbytes // _ALIGN) * _ALIGN
        total = max(total, _ALIGN)
        self.dev = torch.empty(total, dtype=torch.uint8, device=dev)
        self.host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        raw = self.host.numpy()
        self.dev_views: dict = {}
        self.host_views: dict = {}
        for (col, shape, dt), off in zip(specs, offs):
            np_dt = _np_dtype(dt)
            nbytes = int(np.prod(shape, dtype=np.int64)) * np_dt.itemsize
            self.dev_views[col] = self.dev[off: off + nbytes].view(dt).view(shape)
            self.host_views[col] = raw[off: off + nbytes].view(np_dt).reshape(shape)


def _np_dtype(dt: torch.dtype) -> np.dtype:
    if dt == torch.bfloat16:
        raise TypeError("a fused kernel must not output bfloat16 (numpy has no "
                        "bfloat16): cast it to float32 inside the kernel")
    return torch.empty((), dtype=dt).numpy().dtype


class _Graph:
    """One (bucket, input shapes) entry of a segment on the card: the
    captured graph and its packed static input and output buffers."""

    def __init__(self, graph: torch.cuda.CUDAGraph, ins: _Packed, outs: _Packed):
        self.graph, self.ins, self.outs = graph, ins, outs


class _RankPlan:
    """How this rank runs one bucket that the plan batch-shards: its block
    of ``per`` rows of each ``blocks`` input column, per kernel the columns
    all-gathered and the columns cut to the block before it (``steps``),
    and the device outputs left as blocks, gathered after the chunks."""

    def __init__(self, mesh: Any, per: int, blocks: frozenset, steps: tuple,
                 out_blocks: frozenset):
        self.mesh, self.per, self.blocks = mesh, per, blocks
        self.steps, self.out_blocks = steps, out_blocks
        # a collective inside the run: no CUDA graph can hold it over gloo
        self.gathers = any(g for g, _ in steps)

    def block(self, t: Any) -> Any:
        lo = self.mesh.rank * self.per
        return t[lo: lo + self.per]


class FusedSegment(Segment):
    """A maximal run of adjacent fusable stages run as one program: one
    CUDA graph per bucket on the card, the same ops eagerly on the CPU."""

    def __init__(
        self,
        nodes: list,
        name: str,
        exact: bool = True,
        max_bucket: int = 1024,
        mesh: Any = None,
        partition_mode: str = "auto",
        device: Optional[str] = None,
    ):
        self.nodes = nodes
        self.name = name
        self.exact = exact
        self.max_bucket = max(1, int(max_bucket))
        self.mesh = mesh
        self.partition_mode = partition_mode
        self.kernels = [n.kernel for n in nodes]
        self.device_name = next((k.device for k in self.kernels if k.device), device)
        # a cross-row kernel would see padded lanes in its reductions, so
        # pad-and-slice bucketing is only sound when every kernel is row-wise;
        # otherwise the segment builds per exact batch shape instead
        self.row_wise = all(k.row_wise for k in self.kernels)
        # (bucket, input shapes) -> _Graph on the card, None on the CPU (the
        # key alone records the bucket): at most log2(max_bucket)+1 entries
        # per feature shape for a row-wise segment
        self._graphs: dict = {}
        self._pool: Any = None
        self._sharding: Optional[ShardingPlan] = None
        self._rank_plans: dict = {}

    # -- planning ------------------------------------------------------------

    @property
    def sharding(self) -> ShardingPlan:
        if self._sharding is None:
            self._sharding = plan_sharding(
                self.kernels,
                mesh=self.mesh,
                bucket=self.max_bucket,
                mode=self.partition_mode,
            )
        return self._sharding

    @property
    def device(self) -> torch.device:
        """Where the segment runs: the device its kernels name, else the
        compiled pipeline's, else the card (raises without one)."""
        return resolve_device(self.device_name)

    @property
    def device_outputs(self) -> tuple:
        """Columns the fused program returns: plain kernels' writes plus
        finalize kernels' raw device outputs (their final writes are
        produced on host by the epilogue)."""
        out: list = []
        for k in self.kernels:
            out.extend(k.fn_outputs)
        return tuple(dict.fromkeys(out))

    def _rank_plan(self, cols: dict, b: int) -> Optional[_RankPlan]:
        """This rank's plan for bucket ``b`` of the host columns ``cols``,
        or None when the bucket runs whole on every rank (no mesh, or the
        world size does not divide ``b``: ``in_specs`` replicates it).

        A row-wise kernel of a batch group gets its reads as blocks (a
        whole column, made by a cross-row kernel, is cut) but for its
        ``needs_replicated`` ones; a cross-row kernel, or a row-wise kernel
        of a replicated group, gets every read whole (a block is
        all-gathered first). A kernel's outputs are blocks when one of its
        reads is."""
        plan = self.sharding
        shapes = {c: np.broadcast_to(np.zeros((), a.dtype), (b,) + a.shape[1:])
                  for c, a in cols.items()}
        specs = plan.in_specs(shapes)
        blocks = frozenset(c for c, spec in (specs or {}).items() if spec)
        if not blocks:
            return None
        if not hasattr(plan.mesh, "rank"):
            raise ValueError("a mesh description can be planned for, not run: build the "
                             "pipeline on a parallel.Mesh (or with no mesh: the process's)")
        rp = self._rank_plans.get((b, blocks))
        if rp is None:
            state = {c: c in blocks for c in cols}
            steps = []
            for k in self.kernels:
                batch = any(plan.decisions.get(c) == BATCH
                            for c in tuple(k.reads) + tuple(k.writes))
                whole = set(k.needs_replicated) if k.row_wise and batch else set(k.reads)
                steps.append((tuple(c for c in k.reads if c in whole and state.get(c)),
                              tuple(c for c in k.reads if c not in whole and not state.get(c))))
                out_block = any(c not in whole for c in k.reads)
                state.update((c, out_block) for c in k.fn_outputs)
            rp = self._rank_plans[(b, blocks)] = _RankPlan(
                plan.mesh, b // plan.mesh.size, blocks, tuple(steps),
                frozenset(c for c in self.device_outputs if state.get(c)))
        return rp

    def _run(self, cols: dict, rp: Optional[_RankPlan] = None) -> dict:
        """The segment's ops on device tensors, kernel after kernel (with
        ``rp``: each kernel's gathers and cuts first)."""
        env = dict(cols)
        for i, k in enumerate(self.kernels):
            ins = {c: env[c] for c in k.reads}
            if rp is not None:
                gather, cut = rp.steps[i]
                for c in gather:
                    ins[c] = collectives.all_gather(ins[c], rp.mesh.group)
                for c in cut:
                    ins[c] = rp.block(ins[c])
            env.update(k.fn(ins))
        return {c: env[c] for c in self.device_outputs}

    # -- execution -----------------------------------------------------------

    def _guard(self, part: Partition) -> Optional[str]:
        for k in self.kernels:
            if k.guard is None:
                continue
            ins = {c: part[c] for c in k.reads if c in part}
            reason = k.guard(ins)
            if reason:
                return reason
        for c in self.reads:
            arr = part.get(c)
            if arr is None:
                return f"missing column {c!r}"
            if np.asarray(arr).dtype == object:
                return f"object column {c!r}"
        return None

    def _staged(self, df: DataFrame, reason: str) -> DataFrame:
        m = _M_FALLBACK.labels(reason=reason[:60])
        if m._on:
            m.inc()
        for n in self.nodes:
            df = n.stage.transform(df)
        return df

    def apply(self, df: DataFrame) -> DataFrame:
        plan = self.sharding
        if plan.mesh is not None and hasattr(plan.mesh, "rank"):
            # rows sharded over ranks: every rank must hold the same rows
            check_same_rows([_rows(p, self.reads) for p in df.partitions], plan.mesh,
                            f"compiled segment {self.name}")
        # guard on the first non-empty partition; the whole call either
        # runs fused or falls back (partitions must agree on dtypes)
        probe = next((p for p in df.partitions if p), None)
        if probe is not None:
            reason = self._guard(probe)
            if reason is not None:
                return self._staged(df, reason)
        t0 = time.perf_counter()
        dev = self.device
        with obs.span(f"compiler.segment.{self.name}"), torch.inference_mode():
            out = df.map_partitions(lambda p: self._apply_partition(p, dev), parallel=False)
        m = _M_SEG_LATENCY.labels(segment=self.name)
        if m._on:
            m.observe(time.perf_counter() - t0)
        return out

    def _apply_partition(self, part: Partition, dev: torch.device) -> Partition:
        cols: dict = {}
        n = 0
        for c in self.reads:
            arr = np.asarray(part[c])
            if arr.dtype == np.float64:  # the 32-bit device world, as in JAX
                arr = arr.astype(np.float32)
            n = max(n, arr.shape[0] if arr.ndim else 0)
            cols[c] = arr
        b = _bucket(max(n, 1), cap=self.max_bucket) if self.row_wise else max(n, 1)
        key = (b,) + tuple((c, a.shape[1:], str(a.dtype)) for c, a in cols.items())
        rp = self._rank_plan(cols, b)
        # (rows of the padded chunk each column's buffer holds, its first row)
        layout = {c: (b, 0) for c in cols}
        if rp is not None:
            key += (("block", rp.per),)
            layout.update((c, (rp.per, rp.mesh.rank * rp.per)) for c in rp.blocks)
        chunks = [(s, min(n, s + b)) for s in range(0, max(n, 1), b)]
        run = (self._run_cuda if dev.type == "cuda" and not (rp and rp.gathers)
               else self._run_eager)
        merged: dict = {}
        first = key not in self._graphs
        t0 = time.perf_counter()
        if first:
            with device_phase("compile", self.name, dev):
                run(key, cols, layout, chunks[:1], merged, dev, rp)
            mc = _M_COMPILE.labels(segment=self.name)
            if mc._on:
                mc.observe(time.perf_counter() - t0)
            mb = _M_BUCKET_COMPILES.labels(segment=self.name)
            if mb._on:
                mb.inc()
        rest = chunks[1:] if first else chunks
        if rest:
            with device_phase("execute", self.name, dev):
                run(key, cols, layout, rest, merged, dev, rp)
        if rp is not None and rp.out_blocks:
            _gather_blocks(merged, rp, chunks)
        q = dict(part)
        for c, parts in merged.items():
            merged[c] = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        for k in self.kernels:
            if k.finalize is not None:
                # host epilogue: replay the staged path's numpy tail on the
                # fetched device outputs (sliced to true rows already)
                q.update(k.finalize({c: merged[c] for c in k.fn_outputs}))
                continue
            for c in k.writes:
                v = merged[c]
                dt_ = k.out_dtypes.get(c)
                q[c] = v.astype(dt_) if dt_ is not None and v.dtype != dt_ else v
        return q

    def _run_eager(self, key: tuple, cols: dict, layout: dict, chunks: list, merged: dict,
                   dev: torch.device, rp: Optional[_RankPlan]) -> None:
        """The chunks through the kernels as they come: the CPU's path, and
        the card's where a gather sits inside the run (the key holds None)."""
        self._graphs.setdefault(key, None)
        for s, e in chunks:
            # fresh buffers per chunk: an output may alias its input
            views = {c: np.empty((layout[c][0],) + a.shape[1:], a.dtype)
                     for c, a in cols.items()}
            _fill(views, cols, s, e, layout)
            ins = {c: torch.from_numpy(v).to(dev) for c, v in views.items()}
            for c, v in self._run(ins, rp).items():
                merged.setdefault(c, []).append(_kept(v.cpu().numpy(), c, e - s, rp))

    def _run_cuda(self, key: tuple, cols: dict, layout: dict, chunks: list, merged: dict,
                  dev: torch.device, rp: Optional[_RankPlan]) -> None:
        entry = self._graphs.get(key)
        for s, e in chunks:
            if entry is None:
                entry = self._graphs[key] = self._capture(cols, layout, s, e, dev, rp)
            else:
                _fill(entry.ins.host_views, cols, s, e, layout)
                entry.ins.dev.copy_(entry.ins.host, non_blocking=True)
            entry.graph.replay()
            m = _M_REPLAYS.labels(segment=self.name)
            if m._on:
                m.inc()
            entry.outs.host.copy_(entry.outs.dev, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            for c, v in entry.outs.host_views.items():
                # the next replay overwrites the buffer: copy the rows out
                merged.setdefault(c, []).append(_kept(v, c, e - s, rp).copy())

    def _capture(self, cols: dict, layout: dict, s: int, e: int, dev: torch.device,
                 rp: Optional[_RankPlan]) -> _Graph:
        """Capture the segment at its buffers' shapes (``layout``: the
        bucket, or the rank's block of it) with the chunk [s, e) in its
        static inputs: one eager run on a side stream first (library
        handles, lazily placed weights, allocator warm-up), then the
        capture into the segment's memory pool, which runs nothing."""
        ins = _Packed([(c, (layout[c][0],) + a.shape[1:], torch.from_numpy(a[:0]).dtype)
                       for c, a in cols.items()], dev)
        _fill(ins.host_views, cols, s, e, layout)
        ins.dev.copy_(ins.host, non_blocking=True)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = self._run(ins.dev_views, rp)
        cur.wait_stream(side)
        outs = _Packed([(c, tuple(v.shape), v.dtype) for c, v in warm.items()], dev)
        del warm
        with _CAPTURE_LOCK:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                for c, v in self._run(ins.dev_views, rp).items():
                    outs.dev_views[c].copy_(v)
        return _Graph(graph, ins, outs)

    def release(self) -> None:
        """Drop the segment's graphs, their static buffers and its memory
        pool (a serving version's eviction); the next call captures anew."""
        with _CAPTURE_LOCK:
            self._graphs.clear()
            self._pool = None


def _fill(views: dict, cols: dict, s: int, e: int, layout: Optional[dict] = None) -> None:
    """Rows [s, e) of each column, padded to the bucket by repeating row s
    (a real row keeps padded lanes NaN/inf-free), into its host view;
    zeros when there are no rows. ``layout[c][1]``: the view's first row
    of the padded chunk (a rank's block), else 0."""
    for c, a in cols.items():
        v = views[c]
        m = e - s
        if m == 0:
            v[...] = 0
            continue
        lo = layout[c][1] if layout else 0
        real = max(0, min(m - lo, len(v)))
        v[:real] = a[s + lo: s + lo + real]
        v[real:] = a[s]


def _rows(part: Partition, reads: tuple) -> int:
    """A partition's row count, as ``_apply_partition`` counts it."""
    return max((np.shape(part[c])[0] for c in reads if c in part and np.ndim(part[c])),
               default=0)


def _kept(v: np.ndarray, c: str, m: int, rp: Optional[_RankPlan]) -> np.ndarray:
    """A chunk's output rows to keep: a block output's whole block (the
    gather puts the blocks together), else the chunk's ``m`` true rows."""
    return v if rp is not None and c in rp.out_blocks else v[:m]


def _gather_blocks(merged: dict, rp: _RankPlan, chunks: list) -> None:
    """Every rank's blocks of the block outputs of every chunk, in one
    all-gather of their bytes; each chunk's blocks are put together in rank
    order (its padded rows) and cut to its true rows, in place."""
    keys = [(c, j) for c in merged if c in rp.out_blocks for j in range(len(chunks))]
    parts = [np.ascontiguousarray(merged[c][j]) for c, j in keys]
    flat = np.concatenate([p.reshape(-1).view(np.uint8) for p in parts])
    got = collectives.all_gather(torch.from_numpy(flat), rp.mesh.group, tiled=False).numpy()
    ends = np.cumsum([0] + [p.nbytes for p in parts])
    for (c, j), p, lo, hi in zip(keys, parts, ends[:-1], ends[1:]):
        whole = np.concatenate([got[r, lo:hi].view(p.dtype).reshape(p.shape)
                                for r in range(len(got))])
        s, e = chunks[j]
        merged[c][j] = whole[: e - s]


def _same_device(a: Optional[str], b: Optional[str]) -> bool:
    if a is None or b is None:
        return True
    da, db = torch.device(a), torch.device(b)
    return da.type == db.type and (da.index or 0) == (db.index or 0)


def build_segments(
    plan: Any,
    exact: bool = True,
    max_bucket: int = 1024,
    mesh: Any = None,
    partition_mode: str = "auto",
    device: Optional[str] = None,
) -> list:
    """Partition the plan's nodes into segments: maximal runs of adjacent
    fusable stages on one device become one :class:`FusedSegment`;
    everything else is a :class:`HostSegment` of its own. ``device`` is
    where a run whose kernels name no device runs (None: the card)."""
    segments: list = []
    run: list = []
    run_dev: list = [None]

    def flush() -> None:
        if not run:
            return
        idx = len(segments)
        name = f"s{idx}:" + "+".join(n.name for n in run)
        segments.append(FusedSegment(
            list(run), name, exact=exact, max_bucket=max_bucket,
            mesh=mesh, partition_mode=partition_mode, device=device,
        ))
        run.clear()
        run_dev[0] = None

    for n in plan.nodes:
        if n.kind == "fused" and exact and not n.kernel.exact_capable:
            # the kernel cannot promise bit-equality (conv algorithms vary
            # with batch shape): exact mode runs the stage host-bound
            flush()
            segments.append(HostSegment(n, f"s{len(segments)}:{n.name}"))
        elif n.kind == "fused":
            if not _same_device(run_dev[0], n.kernel.device):
                flush()
            run.append(n)
            run_dev[0] = run_dev[0] or n.kernel.device
            if n.kernel.finalize is not None:
                # a finalize kernel's outputs live on host after its
                # epilogue — nothing later can read them on device, so it
                # always ends its fusion run
                flush()
        else:
            flush()
            segments.append(HostSegment(n, f"s{len(segments)}:{n.name}"))
    flush()
    return segments
