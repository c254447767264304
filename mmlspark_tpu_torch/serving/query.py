"""ServingQuery: the dispatch loop between a WorkerServer and a model.

The PyTorch port's copy of ``mmlspark_tpu.serving.query``, over the port's
``DataFrame`` and transformers.

Continuous mode mirrors the reference's ContinuousReader path
(HTTPSourceV2.scala:52-69, 693-706): a dispatcher thread drains whatever is
queued (bounded by ``max_batch_size``; ``max_wait_ms`` optionally holds the
batch open for stragglers — 0 dispatches immediately), runs the handler,
and replies — latency is ingress + one model call. Micro-batch mode advances an epoch on a timer and
processes whole epochs (getBatch/addBatch semantics), committing each after
its replies are sent.

Continuous **batching** (the throughput rewrite): with
``pipeline_depth >= 2`` (the default) continuous mode runs as a
two-stage pipeline — a *batcher* thread admits queued requests into the
next dispatch slot (pop + deadline shed + the handler's host-side
``prepare``: JSON decode, column stacking, bucket padding) while an
*executor* thread runs the previous batch's ``execute`` (the model call)
and replies. Batch N+1's arrays are built while batch N computes, so
the dispatch loop stops paying host parse time on the device's critical
path. Handlers that expose the :class:`SplitHandler` protocol
(``prepare(reqs) -> staged`` + ``execute(staged) -> replies``) overlap
fully; plain ``handler(reqs)`` callables still pipeline the queue pop
and deadline shed. ``pipeline_depth=1`` keeps the classic
barrier-per-batch loop; results are bit-identical either way — only
the overlap changes (pinned by tests/test_throughput.py).

Device detail that matters: handlers built by :func:`serve_transformer`
pad every batch to a power-of-two bucket, so a compiled model captures one
CUDA graph per bucket instead of one per request count.
"""

from __future__ import annotations

import contextlib
import json
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.obs.flightrec import FLIGHT
from mmlspark_tpu_torch.serving.admission import SHED_HEADER, deadline_ms_from
from mmlspark_tpu_torch.serving.server import CachedRequest, WorkerServer
from mmlspark_tpu_torch.serving.udfs import make_reply, request_to_json

# handler: list[CachedRequest] -> dict[id, (code, body_bytes, headers)]
Handler = Callable[[list], dict]

# what decoding and validating a request raises for input it cannot take
# (bad JSON, a missing field, a shape, index or value the request got
# wrong), before the model is called: those requests are answered 400.
# Whatever the model call itself raises — a stage's ValueError, a CUDA
# error, a failed kernel launch, memory — propagates to the batch's 500
# path and is counted, so a broken model or device never hides behind
# client errors.
INPUT_ERRORS = (ValueError, TypeError, KeyError, IndexError)

_M_LATENCY = obs.histogram(
    "mmlspark_serving_request_latency_seconds",
    "End-to-end request latency (ingress arrival to reply)",
    labels=("server",),
)
_M_HANDLER_ERRS = obs.counter(
    "mmlspark_serving_handler_errors_total",
    "Handler exceptions turned into 500 batches", labels=("server",),
)
_M_DEADLINE_EXPIRED = obs.counter(
    "mmlspark_serving_deadline_expired_total",
    "Requests shed because their deadline expired while queued",
    labels=("server",),
)
_M_OVERLAP = obs.counter(
    "mmlspark_serving_overlap_batches_total",
    "Batches whose host-side build overlapped a still-executing batch "
    "(continuous batching at work)", labels=("server",),
)


class SplitHandler:
    """A batch handler split into a host-side ``prepare`` (JSON decode,
    array stacking, bucket padding) and a device-side ``execute`` (the
    model call producing the reply dict). The continuous batcher runs
    ``prepare`` for batch N+1 while batch N's ``execute`` is still on
    the device; calling the object directly runs both back to back, so
    a :class:`SplitHandler` is a drop-in plain handler everywhere else.

    Any object with callable ``prepare``/``execute`` attributes
    participates — the loaders' handler classes don't need to inherit.
    """

    __slots__ = ("prepare", "execute")

    def __init__(self, prepare: Callable, execute: Callable):
        self.prepare = prepare
        self.execute = execute

    def __call__(self, reqs: list) -> dict:
        return self.execute(self.prepare(reqs))


def handler_stages(handler: Any) -> Optional[tuple]:
    """The (prepare, execute) split of ``handler``, or None for a plain
    callable (which then runs whole inside the executor stage)."""
    prepare = getattr(handler, "prepare", None)
    execute = getattr(handler, "execute", None)
    if callable(prepare) and callable(execute):
        return prepare, execute
    return None


class LatencyRing:
    """Fixed-capacity ring of end-to-end latencies (ns) with quantile
    readout — shared by :class:`ServingQuery` and the modelstore's
    :class:`~mmlspark_tpu_torch.serving.modelstore.ModelDispatcher` (whose
    per-model batcher threads record concurrently, hence the lock)."""

    def __init__(self, cap: int = 4096):
        self._buf: list = []
        self._cap = cap
        self._count = 0
        self._lock = threading.Lock()

    def record(self, latency_ns: int) -> None:
        with self._lock:
            if len(self._buf) < self._cap:
                self._buf.append(latency_ns)
            else:
                self._buf[self._count % self._cap] = latency_ns
            self._count += 1

    def quantiles_ms(self) -> dict:
        with self._lock:
            buf = list(self._buf)
        if not buf:
            return {}
        arr = np.asarray(buf, dtype=np.float64) / 1e6
        return {
            "p50": float(np.percentile(arr, 50)),
            "p90": float(np.percentile(arr, 90)),
            "p99": float(np.percentile(arr, 99)),
            "n": int(arr.size),
        }


class ServingQuery:
    def __init__(
        self,
        server: WorkerServer,
        handler: Handler,
        mode: str = "continuous",
        max_batch_size: int = 64,
        max_wait_ms: float = 0.0,
        epoch_interval_ms: float = 100.0,
        admission: Optional[Any] = None,
        default_deadline_ms: Optional[float] = None,
        pipeline_depth: int = 2,
    ):
        """``admission``: an
        :class:`~mmlspark_tpu_torch.serving.admission.AdmissionController` —
        attached to the server's ingress (429 shed beyond the adaptive
        in-flight limit) and fed queue-wait/service samples per batch.
        ``default_deadline_ms``: deadline applied to requests carrying no
        ``x-mmlspark-deadline-ms`` header; work whose deadline expired
        while queued is shed 504 without running the handler.
        ``pipeline_depth``: continuous-batching depth (module docstring);
        ``>= 2`` double-buffers build/execute, ``1`` is the classic
        barrier-per-batch loop."""
        if mode not in ("continuous", "microbatch"):
            raise ValueError(f"unknown serving mode {mode!r}")
        self.server = server
        self.handler = handler
        self.mode = mode
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        self.epoch_interval_ms = epoch_interval_ms
        self.admission = admission
        self.default_deadline_ms = default_deadline_ms
        self.pipeline_depth = max(1, int(pipeline_depth))
        if admission is not None:
            server.admission = admission
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exec_thread: Optional[threading.Thread] = None
        # batcher -> executor handoff: bounded so admission stays coupled
        # to actual progress (depth-1 staged batches at most)
        self._handoff: queue_mod.Queue = queue_mod.Queue(
            maxsize=self.pipeline_depth - 1 or 1
        )
        self._exec_busy = False
        self._lat = LatencyRing()
        self.batches = 0
        self.errors = 0
        self.deadline_expired = 0
        self.overlapped = 0
        self._m_latency = _M_LATENCY.labels(server=server.name)
        self._m_handler_errs = _M_HANDLER_ERRS.labels(server=server.name)
        self._m_deadline = _M_DEADLINE_EXPIRED.labels(server=server.name)
        self._m_overlap = _M_OVERLAP.labels(server=server.name)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingQuery":
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.server.name}-dispatch", daemon=True
        )
        if (
            self.mode == "continuous"
            and self.pipeline_depth > 1
            and handler_stages(self.handler) is not None
        ):
            # double-buffering exists to overlap a handler's host-side
            # prepare with the previous batch's device execute; a plain
            # handler has no prepare stage to overlap, so the handoff
            # hop would be pure cross-thread scheduling cost on its
            # latency — those keep the classic single-thread loop
            self._exec_thread = threading.Thread(
                target=self._exec_loop, name=f"{self.server.name}-execute",
                daemon=True,
            )
            self._exec_thread.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
        if self._exec_thread is not None:
            self._exec_thread.join(5.0)

    def await_termination(self, timeout_s: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout_s)

    # -- dispatch ------------------------------------------------------------

    def _loop(self) -> None:
        next_epoch_t = time.monotonic() + self.epoch_interval_ms / 1000.0
        while not self._stop.is_set():
            if self.mode == "microbatch":
                # wait out the epoch interval, then process the whole epoch
                now = time.monotonic()
                if now < next_epoch_t:
                    time.sleep(min(next_epoch_t - now, 0.05))
                    continue
                next_epoch_t = time.monotonic() + self.epoch_interval_ms / 1000.0
                epoch = self.server.epoch
                self.server.new_epoch()
                while True:
                    chunk = self.server.get_next_batch(
                        self.max_batch_size, timeout_s=0.0
                    )
                    if not chunk:
                        break
                    self._process(chunk)  # honor max_batch_size per model call
                self.server.commit(epoch)
            else:
                # idle wait is long (bounds stop() responsiveness only —
                # enqueue notifies the condition, so arrival latency doesn't
                # depend on it); max_wait_ms governs batch accumulation once
                # the first request is in. Continuous-batching refinement:
                # accumulation exists to amortize a BUSY executor — while
                # it is idle, holding the batch open is pure added latency,
                # so dispatch immediately and let the next batch form
                # behind the running one
                accumulate_s = self.max_wait_ms / 1000.0
                if self._exec_thread is not None and not self._exec_busy:
                    accumulate_s = 0.0
                reqs = self.server.get_next_batch(
                    self.max_batch_size, timeout_s=0.25,
                    accumulate_s=accumulate_s,
                )
                if not reqs:
                    continue
                if self._exec_thread is not None:
                    self._build(reqs)
                else:
                    self._process(reqs)
                self.server.auto_commit()

    # -- continuous batching (batcher + executor threads) ---------------------

    def _build(self, reqs: list) -> None:
        """Batcher half of the continuous-batch pipeline: shed expired
        work at the admission point, run the handler's host-side
        ``prepare`` (when it has one), and hand the staged batch to the
        executor — all while the previous batch may still be executing."""
        reqs = self._shed_expired(reqs)
        if not reqs:
            return
        split = handler_stages(self.handler)
        staged = err = None
        if split is not None:
            try:
                staged = split[0](reqs)
            except Exception as e:  # noqa: BLE001 — surfaces as a 500 batch
                err = e
        if self._exec_busy:
            # evidence the double-buffer is overlapping: this batch's
            # arrays were built while the previous batch computed
            self.overlapped += 1
            if self._m_overlap._on:
                self._m_overlap.inc()
        self._handoff.put((reqs, staged, err))

    def _exec_loop(self) -> None:
        while True:
            try:
                item = self._handoff.get(timeout=0.25)
            except queue_mod.Empty:
                # exit only once the BATCHER is gone too: a batcher
                # mid-put while we observe an empty queue must not
                # strand its staged batch unanswered
                if self._stop.is_set() and not (
                    self._thread is not None and self._thread.is_alive()
                ):
                    return
                continue
            self._exec_busy = True
            try:
                self._execute(*item)
            finally:
                self._exec_busy = False

    def _shed_expired(self, reqs: list) -> list:
        """Drop requests whose deadline already expired while they sat in
        the queue: the client gave up — running the handler for them
        burns a batch slot on a reply nobody reads, exactly when the
        queue is longest. Replies 504 so a gateway relays the expiry
        rather than retrying it."""
        now_ns = time.perf_counter_ns()
        live = []
        for r in reqs:
            dl_ms = deadline_ms_from(r.headers, self.default_deadline_ms)
            if dl_ms is not None and (now_ns - r.arrival_ns) / 1e6 > dl_ms:
                self.deadline_expired += 1
                self._m_deadline.inc()
                self.server.reply_to(
                    r.id, b'{"error": "deadline expired in queue"}', 504,
                    {"Content-Type": "application/json",
                     SHED_HEADER: "deadline"},
                )
            else:
                live.append(r)
        return live

    def _process(self, reqs: list) -> None:
        """Barrier path (microbatch mode / ``pipeline_depth=1``): build
        and execute inline — same stages as the pipelined path, zero
        overlap."""
        reqs = self._shed_expired(reqs)
        if not reqs:
            return
        split = handler_stages(self.handler)
        staged = err = None
        if split is not None:
            try:
                staged = split[0](reqs)
            except Exception as e:  # noqa: BLE001 — surfaces as a 500 batch
                err = e
        self._execute(reqs, staged, err)

    def _execute(self, reqs: list, staged: Any, prep_err: Any) -> None:
        obs_on = self._m_latency._on
        dispatch_ns = time.perf_counter_ns()  # ~= execute-slot time
        # per-request span AND trace ids are minted BEFORE dispatch so
        # the batch span can parent under the first request's span in the
        # first request's trace (headerless direct traffic mints here) —
        # the collector then renders queue wait and model time as
        # children of the request, under the gateway's forward span
        # (PARENT_HEADER) when there is one
        req_sids = req_tids = None
        if obs_on:
            req_sids = {r.id: obs.new_span_id() for r in reqs}
            req_tids = {
                r.id: r.headers.get(obs.TRACE_HEADER) or obs.new_trace_id()
                for r in reqs
            }
        split = handler_stages(self.handler)
        try:
            if prep_err is not None:
                raise prep_err
            # the dispatch span wraps the model call, so inside a
            # torch.profiler capture the device launches nest under it; the
            # trace id continues from the gateway's stamped header
            ctx = (
                obs.span(
                    "serving.dispatch",
                    trace_id=req_tids[reqs[0].id],
                    parent_id=req_sids[reqs[0].id],
                    attrs={"batch": len(reqs)},
                )
                if obs_on
                else contextlib.nullcontext()
            )
            with ctx:
                replies = (
                    split[1](staged) if split is not None
                    else self.handler(reqs)
                )
        except Exception as e:  # handler crash -> 500s, keep serving
            self.errors += 1
            self._m_handler_errs.inc()
            msg = f"handler error: {type(e).__name__}: {e}".encode()
            replies = {r.id: (500, msg, {}) for r in reqs}
        done_ns = time.perf_counter_ns()
        # two passes: every reply goes out BEFORE any telemetry is
        # recorded. The dispatcher thread is the pipeline bottleneck
        # under concurrency — recording first would add its cost to every
        # queued request's latency, recording after overlaps it with the
        # clients' own processing. On the pipelined (split-handler) path
        # reply_many batches the whole batch's replies into one loop
        # wakeup per reactor; the plain-handler barrier path keeps
        # per-reply scheduling — its batch replies landing in lockstep
        # would phase-align keep-alive clients' next requests against
        # the accumulation window and tax light-load p50 for no
        # throughput gain (that path has no build/execute overlap to
        # feed anyway)
        codes = {}
        batch_out = []
        for r in reqs:
            code, body, headers = replies.get(
                r.id, (500, b"no reply produced", {})
            )
            batch_out.append((r.id, body, code, headers))
            codes[r.id] = code
        if self._exec_thread is not None:
            self.server.reply_many(batch_out)
        else:
            for rid, body, code, headers in batch_out:
                self.server.reply_to(rid, body, code, headers)
        for r in reqs:
            if obs_on:
                code = codes[r.id]
                sid = req_sids[r.id]
                tid = req_tids[r.id]
                obs.record_span(
                    "serving.request", r.arrival_ns, done_ns,
                    trace_id=tid,
                    span_id=sid,
                    parent_id=r.headers.get(obs.PARENT_HEADER),
                    attrs={"status": code},
                )
                obs.record_span(
                    "serving.queue", r.arrival_ns, dispatch_ns,
                    trace_id=tid, parent_id=sid,
                )
                lat_s = (done_ns - r.arrival_ns) / 1e9
                # exemplar: the p99 bucket remembers a real trace id
                self._m_latency.observe(lat_s, trace_id=tid)
                FLIGHT.record(
                    "ok" if code < 500 else "error",
                    status=code,
                    trace_id=tid,
                    path=r.path,
                    latency_ms=lat_s * 1e3,
                    queue_wait_ms=(dispatch_ns - r.arrival_ns) / 1e6,
                )
            self._lat.record(done_ns - r.arrival_ns)
        if self.admission is not None:
            # AIMD signal: the batch's worst queue wait (reqs are FIFO,
            # so the first request waited longest) + per-request service
            self.admission.observe(
                (dispatch_ns - reqs[0].arrival_ns) / 1e9,
                (done_ns - dispatch_ns) / 1e9 / len(reqs),
            )
        self.batches += 1

    # -- stats ---------------------------------------------------------------

    def latency_quantiles_ms(self) -> dict:
        return self._lat.quantiles_ms()


# --------------------------------------------------------------------------


def _host(out: Any) -> np.ndarray:
    """A model function's output as a host array (a tensor is copied back
    from its device; numpy has no bfloat16, so that widens to float32)."""
    if isinstance(out, torch.Tensor):
        out = out.detach()
        return (out.float() if out.dtype == torch.bfloat16 else out).cpu().numpy()
    return np.asarray(out)


def _bucket(n: int, cap: Optional[int] = None) -> int:
    """Next power of two >= ``n``, capped at the next power of two >=
    ``cap``. The cap bounds the set of distinct padded shapes a handler
    can produce — and with it the number of graph captures — to
    ``log2(cap) + 1`` buckets regardless of what batch sizes arrive."""
    b = 1
    while b < n:
        b *= 2
    if cap is not None:
        c = 1
        while c < cap:
            c *= 2
        b = min(b, c)
    return b


def serve_transformer(
    transformer: Any,
    input_col: str,
    output_col: str,
    server: Optional[WorkerServer] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    api_path: str = "/",
    mode: str = "continuous",
    max_batch_size: int = 64,
    max_wait_ms: float = 0.0,
    epoch_interval_ms: float = 100.0,
    name: str = "serving",
    input_shape: Optional[tuple] = None,
) -> ServingQuery:
    """Serve a fitted Transformer (or plain ``fn(np.ndarray)->np.ndarray``):
    JSON request bodies become ``input_col`` rows, the transformer runs on a
    bucket-padded batch, ``output_col`` values return as JSON replies.

    A body that is not numeric JSON is that request's 400. ``input_shape``
    (one request's feature shape, e.g. ``(3,)``) makes a body of another
    shape a 400 too, checked before the model runs. Whatever the model
    raises is the batch's 500.

    A torch ``fn`` gets the batch as a numpy array, as in the JAX package:
    it moves it to its own device and may return a tensor (copied back).

    Returns a started :class:`ServingQuery`; ``q.server.port`` is the bound
    port. This is the ``spark.readStream.continuousServer()`` +
    ``makeReply`` one-liner of the reference (IOImplicits).
    """
    srv = server or WorkerServer(host=host, port=port, api_path=api_path, name=name)
    if srv.port == 0:
        srv.start()

    is_transformer = hasattr(transformer, "transform")
    from mmlspark_tpu_torch.serving.server import _M_BATCH

    m_bucket = _M_BATCH.labels(server=f"{srv.name}/buckets")
    want = None if input_shape is None else tuple(input_shape)

    def prepare(reqs: list) -> tuple:
        """Host-side build (runs on the batcher thread while the previous
        batch executes): JSON decode, per-request validation, shape
        grouping, stacking and bucket padding — everything but the model
        call."""
        vals = [request_to_json(r) for r in reqs]
        bad = {
            r.id: (400, b"invalid or empty JSON body", {})
            for r, v in zip(reqs, vals) if v is None
        }
        live = [(r, v) for r, v in zip(reqs, vals) if v is not None]
        # per-request validation: one malformed request must not poison the
        # batch for well-formed concurrent clients. Non-numeric bodies, and
        # bodies not of ``input_shape`` when it is given, 400; remaining
        # requests are grouped by feature shape and each group runs as its
        # own fixed-shape batch.
        groups: dict = {}
        for r, v in live:
            try:
                arr = np.asarray(v, dtype=np.float32)
            except (TypeError, ValueError):
                bad[r.id] = (400, b"non-numeric request body", {})
                continue
            if want is not None and arr.shape != want:
                bad[r.id] = (
                    400, f"body has shape {arr.shape}, the model takes {want}".encode(), {}
                )
                continue
            groups.setdefault(arr.shape, []).append((r, arr))
        staged = []
        cap_b = _bucket(max_batch_size)
        for group in groups.values():
            # bucket capped at the next power of two >= max_batch_size:
            # oversized groups (a caller handing the handler more than the
            # query's pop limit) are split into cap-sized chunks, so the
            # padded-shape set — and with it the compile count — is
            # bounded at log2(cap)+1 buckets no matter what arrives.
            # Chosen buckets land in the batch-size histogram under
            # "<name>/buckets", next to the raw ingress batch sizes
            for start in range(0, len(group), cap_b):
                items = group[start:start + cap_b]
                n = len(items)
                x = np.stack([a for _, a in items])
                b = _bucket(n, cap=max_batch_size)
                if m_bucket._on:
                    m_bucket.observe(b)
                if b > n:  # fixed-shape batch: pad, run, slice
                    pad = np.repeat(x[:1], b - n, axis=0)
                    x = np.concatenate([x, pad], axis=0)
                staged.append((items, x, n))
        return bad, staged

    def execute(staged: tuple) -> dict:
        """Device-side half: one model call per fixed-shape group. Nothing
        is caught: whatever the model raises fails the batch with 500."""
        bad, groups = staged
        replies = dict(bad)
        for items, x, n in groups:
            if is_transformer:
                df = DataFrame([{input_col: x}])
                out = transformer.transform(df)[output_col][:n]
            else:
                out = _host(transformer(x))[:n]
            for (r, _), o in zip(items, out):
                code, body, headers = make_reply(o)
                replies[r.id] = (code, body, headers)
        return replies

    handler = SplitHandler(prepare, execute)

    return ServingQuery(
        srv, handler, mode=mode, max_batch_size=max_batch_size,
        max_wait_ms=max_wait_ms, epoch_interval_ms=epoch_interval_ms,
    ).start()
