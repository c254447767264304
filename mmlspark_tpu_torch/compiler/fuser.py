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

import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.compiler.partitioner import ShardingPlan, plan_sharding
from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.profiling import device_phase

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

    def _run(self, cols: dict) -> dict:
        """The segment's ops on device tensors, kernel after kernel."""
        env = dict(cols)
        for k in self.kernels:
            env.update(k.fn({c: env[c] for c in k.reads}))
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
        chunks = [(s, min(n, s + b)) for s in range(0, max(n, 1), b)]
        run = self._run_cuda if dev.type == "cuda" else self._run_cpu
        merged: dict = {}
        first = key not in self._graphs
        t0 = time.perf_counter()
        if first:
            with device_phase("compile", self.name, dev):
                run(key, cols, b, chunks[:1], merged, dev)
            mc = _M_COMPILE.labels(segment=self.name)
            if mc._on:
                mc.observe(time.perf_counter() - t0)
            mb = _M_BUCKET_COMPILES.labels(segment=self.name)
            if mb._on:
                mb.inc()
        rest = chunks[1:] if first else chunks
        if rest:
            with device_phase("execute", self.name, dev):
                run(key, cols, b, rest, merged, dev)
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

    def _run_cpu(self, key: tuple, cols: dict, b: int, chunks: list, merged: dict,
                 dev: torch.device) -> None:
        self._graphs.setdefault(key, None)
        for s, e in chunks:
            # fresh buffers per chunk: an output may alias its input
            views = {c: np.empty((b,) + a.shape[1:], a.dtype) for c, a in cols.items()}
            _fill(views, cols, s, e)
            ins = {c: torch.from_numpy(v).to(dev) for c, v in views.items()}
            for c, v in self._run(ins).items():
                merged.setdefault(c, []).append(v.cpu().numpy()[: e - s])

    def _run_cuda(self, key: tuple, cols: dict, b: int, chunks: list, merged: dict,
                  dev: torch.device) -> None:
        entry = self._graphs.get(key)
        for s, e in chunks:
            if entry is None:
                entry = self._graphs[key] = self._capture(cols, b, s, e, dev)
            else:
                _fill(entry.ins.host_views, cols, s, e)
                entry.ins.dev.copy_(entry.ins.host, non_blocking=True)
            entry.graph.replay()
            m = _M_REPLAYS.labels(segment=self.name)
            if m._on:
                m.inc()
            entry.outs.host.copy_(entry.outs.dev, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            for c, v in entry.outs.host_views.items():
                # the next replay overwrites the buffer: copy the rows out
                merged.setdefault(c, []).append(v[: e - s].copy())

    def _capture(self, cols: dict, b: int, s: int, e: int, dev: torch.device) -> _Graph:
        """Capture the segment at bucket ``b`` with the chunk [s, e) in its
        static inputs: one eager run on a side stream first (library
        handles, lazily placed weights, allocator warm-up), then the
        capture into the segment's memory pool, which runs nothing."""
        ins = _Packed([(c, (b,) + a.shape[1:], torch.from_numpy(a[:0]).dtype)
                       for c, a in cols.items()], dev)
        _fill(ins.host_views, cols, s, e)
        ins.dev.copy_(ins.host, non_blocking=True)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = self._run(ins.dev_views)
        cur.wait_stream(side)
        outs = _Packed([(c, tuple(v.shape), v.dtype) for c, v in warm.items()], dev)
        del warm
        with _CAPTURE_LOCK:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                for c, v in self._run(ins.dev_views).items():
                    outs.dev_views[c].copy_(v)
        return _Graph(graph, ins, outs)

    def release(self) -> None:
        """Drop the segment's graphs, their static buffers and its memory
        pool (a serving version's eviction); the next call captures anew."""
        with _CAPTURE_LOCK:
            self._graphs.clear()
            self._pool = None


# one capture (or graph release) at a time in the process: see the module
# docstring, "Capture beside serving"
_CAPTURE_LOCK = threading.Lock()


def _fill(views: dict, cols: dict, s: int, e: int) -> None:
    """Rows [s, e) of each column into its bucket-sized host view, the pad
    rows repeating row s (a real row keeps padded lanes NaN/inf-free);
    zeros when there are no rows."""
    for c, a in cols.items():
        v = views[c]
        m = e - s
        if m == 0:
            v[...] = 0
            continue
        v[:m] = a[s:e]
        v[m:] = a[s]


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
