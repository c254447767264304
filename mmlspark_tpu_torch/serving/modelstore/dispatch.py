"""ModelDispatcher: per-model request routing on one WorkerServer.

The PyTorch port's copy of ``mmlspark_tpu.serving.modelstore.dispatch``
(host code). A handler's error is answered 500 for its batch and counted
(``mmlspark_modelstore_handler_errors_total``); the port's loaders raise
every error of the device there, and answer 400 only for input they
cannot read.

Replaces the single-handler :class:`~mmlspark_tpu_torch.serving.query.ServingQuery`
loop on multi-model workers. One fast **router thread** pops ingress
requests and does no model work — it answers the control plane and
``/health`` inline (spawning a side thread for verbs that may block on a
load), applies admission control, and pushes data requests into
**per-model queues**. Each model owns a dispatcher thread with its own
batcher, so a slow model's batch never holds another model's traffic,
and each batch resolves its model version through
``ModelStore.acquire()`` — the refcount that lets hot-swap drain the old
version without dropping a request.

Routing: ``POST /models/<name>`` or the ``x-mmlspark-model`` header pick
the model; bare ``POST /`` goes to ``default_model``.

Admission control (deadline-aware shedding): a request carrying
``x-mmlspark-deadline-ms`` (or, with ``default_deadline_ms`` set, every
request) is rejected **429** at routing time when estimated queue wait
plus one service time already blows the deadline — shedding at ingress
costs microseconds, serving a reply the client will discard costs a full
batch slot. The estimate is ``ceil(queue_len / max_batch) * svc + svc``
with ``svc`` an EWMA of recent batch service times.

Control plane (all answered by the worker itself, never queued):

- ``GET  /models``                 — full store listing
- ``GET  /models/<name>``          — one model's versions + serving alias
- ``POST /models/<name>/load``     — body ``{"spec": ..., "version"?,
  "pin"?, "activate"?, "wait"?}``; ``wait=false`` returns 202 and loads
  in the background
- ``POST /models/<name>/swap``     — body ``{"version"?}``
- ``POST /models/<name>/unload``   — body ``{"version"?}``
- ``POST /models/<name>/pin`` / ``/unpin`` — body ``{"version"?}``
- ``GET  /health``                 — 200 once the default model (or, with
  no default, any model) is ready; 503 with per-model states otherwise
"""

from __future__ import annotations

import contextlib
import json
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Optional

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.obs import watchdog
from mmlspark_tpu_torch.obs.flightrec import FLIGHT
from mmlspark_tpu_torch.serving.admission import (
    DEADLINE_HEADER,
    SHED_HEADER,
    deadline_ms_from,
)
from mmlspark_tpu_torch.serving.modelstore.store import (
    HBMBudgetExceeded,
    ModelStore,
    ModelStoreError,
    READY,
)
# the worker-level families ServingQuery emits: the dispatcher reports
# into them too (labels server=<name>), so `fleet top`, dashboards and
# alerts keyed on mmlspark_serving_* keep working on ModelStore workers
from mmlspark_tpu_torch.serving.query import (
    _M_DEADLINE_EXPIRED as _M_SRV_DEADLINE,
    _M_HANDLER_ERRS as _M_SRV_ERRS,
    _M_LATENCY as _M_SRV_LATENCY,
    _M_OVERLAP as _M_SRV_OVERLAP,
    LatencyRing,
    handler_stages,
)
from mmlspark_tpu_torch.serving.server import WorkerServer

MODEL_HEADER = "x-mmlspark-model"
# DEADLINE_HEADER is canonical in serving/admission.py (re-exported here,
# where the JAX package's callers import it from)
# stamped on 503s a routing layer may retry elsewhere (model still
# loading/warming on THIS worker — another replica may already serve it)
STATE_HEADER = "x-mmlspark-model-state"

_CONTROL_VERBS = ("load", "swap", "unload", "pin", "unpin")
_JSON = {"Content-Type": "application/json"}

_M_DISPATCH_LAT = obs.histogram(
    "mmlspark_modelstore_dispatch_latency_seconds",
    "Per-model ingress arrival to reply", labels=("model",),
)
_M_SHED = obs.counter(
    "mmlspark_modelstore_shed_total",
    "Requests shed 429 by deadline-aware admission control",
    labels=("model",),
)
_M_ERRS = obs.counter(
    "mmlspark_modelstore_handler_errors_total",
    "Handler exceptions turned into 500 batches", labels=("model",),
)
_M_EPOCH_FENCED = obs.counter(
    "mmlspark_elastic_fenced_publications_total",
    "Model load/swap publications rejected because their epoch stamp "
    "was older than the highest seen (zombie-coordinator rollback "
    "refused at the worker's swap path)", labels=("model",),
)
_M_QDEPTH = obs.gauge(
    "mmlspark_modelstore_queue_depth_requests",
    "Requests queued per model awaiting dispatch", labels=("model",),
)


class _ModelQueue:
    """One model's queue + batcher/executor thread pair + service EWMA.

    Continuous batching (``disp.pipeline_depth >= 2``, the default): the
    *batcher* thread admits queued requests into the next dispatch slot
    — deadline shed, ``ModelStore.acquire()`` (the refcount that lets
    hot-swap drain), and the handler's host-side ``prepare`` — while the
    *executor* thread still runs the previous batch's model call. The
    version refcount is held from acquire (batcher) to release
    (executor), so a swap drains both the executing AND the staged batch
    before the old version evicts. ``pipeline_depth=1`` runs everything
    inline on the batcher thread (the pre-rewrite barrier loop)."""

    def __init__(self, disp: "ModelDispatcher", name: str):
        self.disp = disp
        self.name = name
        self.q: deque = deque()
        self.cond = threading.Condition()
        self.dead = False  # set by the reaper; push() then refuses
        self.svc_s = 0.0  # EWMA of one batch's service time (0 = unknown)
        self._m_lat = _M_DISPATCH_LAT.labels(model=name)
        self._m_errs = _M_ERRS.labels(model=name)
        self._m_qdepth = _M_QDEPTH.labels(model=name)
        self._m_srv_lat = _M_SRV_LATENCY.labels(server=disp.server.name)
        self._m_srv_errs = _M_SRV_ERRS.labels(server=disp.server.name)
        self._m_srv_deadline = _M_SRV_DEADLINE.labels(server=disp.server.name)
        self._m_srv_overlap = _M_SRV_OVERLAP.labels(server=disp.server.name)
        self._exec_busy = False
        # double-buffering pays only when the handler has a host-side
        # prepare stage to overlap; plain handlers execute inline on this
        # thread (no cross-thread hop on their latency). Sticky: once a
        # split-handler batch has ridden the handoff, every later batch
        # does too — an inline execute racing a still-staged batch would
        # reorder replies and overlap two versions mid-swap
        self._use_handoff = False
        self.exec_thread: Optional[threading.Thread] = None
        self._handoff: Optional[queue_mod.Queue] = None
        if disp.pipeline_depth > 1:
            self._handoff = queue_mod.Queue(maxsize=disp.pipeline_depth - 1)
            self.exec_thread = threading.Thread(
                target=self._exec_loop,
                name=f"modelstore-execute-{name}", daemon=True,
            )
            self.exec_thread.start()
        self.thread = threading.Thread(
            target=self._loop, name=f"modelstore-dispatch-{name}", daemon=True
        )
        self.thread.start()

    def push(self, req) -> bool:
        """False when this queue was reaped between routing's lookup and
        the push — the request must be answered not-ready, not stranded
        on a queue nothing will ever pop."""
        with self.cond:
            if self.dead:
                return False
            self.q.append(req)
            self._m_qdepth.set(len(self.q))
            self.cond.notify()
            return True

    def depth(self) -> int:
        with self.cond:
            return len(self.q)

    def estimate_s(self) -> float:
        """Queue wait + one service time if a request joined now — the
        admission-control estimate. 0 while no batch has been measured
        (admit everything until the EWMA exists)."""
        if self.svc_s <= 0.0:
            return 0.0
        with self.cond:
            depth = len(self.q)
        batches_ahead = -(-depth // max(self.disp.max_batch_size, 1))
        return (batches_ahead + 1) * self.svc_s

    def _pop_batch(self) -> list:
        max_n = self.disp.max_batch_size
        acc_s = self.disp.max_wait_ms / 1000.0
        if self._use_handoff and not self._exec_busy:
            # accumulation amortizes a BUSY executor; while it is idle,
            # holding the batch open is pure added latency (query.py)
            acc_s = 0.0
        with self.cond:
            if not self.q:
                self.cond.wait(0.25)
            if self.q and acc_s > 0:
                deadline = time.monotonic() + acc_s
                while len(self.q) < max_n:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self.cond.wait(remaining)
            out = []
            while self.q and len(out) < max_n:
                out.append(self.q.popleft())
            if out:
                self._m_qdepth.set(len(self.q))
            return out

    def _reap_if_orphaned(self) -> bool:
        """Exit this batcher when its model was unloaded: otherwise every
        model name ever served leaves an idle 4 Hz-polling thread and a
        live metric series behind (multi-tenant churn). A reload simply
        recreates the queue lazily."""
        disp = self.disp
        if disp.store.serving_state(self.name) is not None:
            return False
        with disp._queues_lock:
            if disp._queues.get(self.name) is not self:
                return True  # a reload already replaced us: just exit
            with self.cond:
                if self.q:
                    return False  # stragglers first; reap on a later pass
                self.dead = True  # a racing push() now refuses
            del disp._queues[self.name]
        for fam in (_M_DISPATCH_LAT, _M_SHED, _M_ERRS, _M_QDEPTH):
            fam.remove(model=self.name)
        return True

    def _shed_expired(self, batch: list) -> list:
        """Deadline propagation's worker half: a request whose (possibly
        gateway-decremented) deadline expired while queued here is dead
        work — shed it 504 before it costs a batch slot. The admission
        estimate sheds *predictably* late requests at routing; this
        catches the ones that became late after admission (a slow batch
        ahead, a hot-swap stall)."""
        disp = self.disp
        now_ns = time.perf_counter_ns()
        live = []
        for r in batch:
            dl_ms = deadline_ms_from(r.headers, disp.default_deadline_ms)
            if dl_ms is not None and (now_ns - r.arrival_ns) / 1e6 > dl_ms:
                disp.deadline_expired += 1
                self._m_srv_deadline.inc()
                disp.server.reply_to(
                    r.id, b'{"error": "deadline expired in queue"}', 504,
                    {SHED_HEADER: "deadline", **_JSON},
                )
            else:
                live.append(r)
        return live

    def _loop(self) -> None:
        disp = self.disp
        while not disp._stop.is_set():
            batch = self._pop_batch()
            if not batch:
                if self._reap_if_orphaned():
                    if self._handoff is not None:
                        self._handoff.put(None)  # executor: exit too
                    return
                continue
            batch = self._shed_expired(batch)
            if not batch:
                continue
            mv = disp.store.acquire(self.name)
            if mv is None:
                # swap/unload raced routing: the version vanished between
                # admission and dispatch — tell the router's 503 story
                disp._reply_not_ready(batch, self.name)
                continue
            # continuous batching: run the handler's host-side prepare on
            # THIS thread while the executor still runs the previous
            # batch's model call — the acquire above already holds the
            # version against a concurrent swap's drain
            split = handler_stages(mv.loaded.handler)
            staged = err = None
            if split is not None:
                try:
                    staged = split[0](batch)
                except Exception as e:  # noqa: BLE001 — a 500 batch
                    err = e
            if self._handoff is not None and (
                self._use_handoff or split is not None
            ):
                self._use_handoff = True
                if self._exec_busy:
                    self._m_srv_overlap.inc()
                self._handoff.put((batch, mv, staged, err))
            else:
                self._execute(batch, mv, staged, err)
        # stopped: nothing queued here gets a handler anymore
        if self._handoff is not None:
            self._handoff.put(None)
        with self.cond:
            leftovers, self.q = list(self.q), deque()
        for r in leftovers:
            disp.server.reply_to(r.id, b"worker stopping", 503)

    def _exec_loop(self) -> None:
        """Executor half: model call + replies + telemetry. Exits on the
        batcher's sentinel so staged batches are never stranded — and,
        as a backstop, when the batcher thread itself is gone (a crashed
        batcher never reaches its sentinel put; blocking forever would
        strand staged work and wedge stop()'s join)."""
        while True:
            try:
                item = self._handoff.get(timeout=0.25)
            except queue_mod.Empty:
                batcher = getattr(self, "thread", None)
                if batcher is not None and not batcher.is_alive():
                    return  # batcher dead, queue drained
                continue
            if item is None:
                return
            self._exec_busy = True
            try:
                self._execute(*item)
            finally:
                self._exec_busy = False

    def _execute(self, batch: list, mv, staged, prep_err) -> None:
        disp = self.disp
        split = handler_stages(mv.loaded.handler)
        obs_on = self._m_lat._on
        dispatch_ns = time.perf_counter_ns()
        # pre-minted per-request span AND trace ids: same tree shape
        # as ServingQuery (request span parenting queue + batch
        # spans, itself parented under the gateway's forward span;
        # headerless direct traffic mints its trace ids here)
        req_sids = req_tids = None
        if obs_on:
            req_sids = {r.id: obs.new_span_id() for r in batch}
            req_tids = {
                r.id: r.headers.get(obs.TRACE_HEADER)
                or obs.new_trace_id()
                for r in batch
            }
        t0 = time.perf_counter()
        # stall forensics: a handler that wedges mid-batch (lock, device
        # hang) auto-dumps all-thread stacks; disarmed per batch so an
        # IDLE dispatcher is never a stall (obs/watchdog.py)
        watchdog.tick(f"modelstore.batch.{self.name}")
        try:
            if prep_err is not None:
                raise prep_err
            ctx = (
                obs.span(
                    "modelstore.dispatch",
                    trace_id=req_tids[batch[0].id],
                    parent_id=req_sids[batch[0].id],
                    attrs={"model": self.name, "batch": len(batch)},
                )
                if obs_on
                else contextlib.nullcontext()
            )
            with ctx:
                replies = (
                    split[1](staged) if split is not None
                    else mv.loaded.handler(batch)
                )
        except Exception as e:  # handler crash -> 500s, keep serving
            disp.errors += 1
            self._m_errs.inc()
            self._m_srv_errs.inc()
            msg = f"handler error: {type(e).__name__}: {e}".encode()
            replies = {r.id: (500, msg, {}) for r in batch}
        finally:
            disp.store.release(mv)
            watchdog.disarm(f"modelstore.batch.{self.name}")
        svc = time.perf_counter() - t0
        self.svc_s = svc if self.svc_s <= 0 else (
            0.8 * self.svc_s + 0.2 * svc
        )
        done_ns = time.perf_counter_ns()
        # replies first, telemetry second: this executor thread is the
        # model's pipeline bottleneck — recording before replying
        # would tax every queued request's latency (see query.py).
        # reply_many: one loop wakeup per reactor for the whole batch
        codes = {}
        batch_out = []
        for r in batch:
            code, body, headers = replies.get(
                r.id, (500, b"no reply produced", {})
            )
            batch_out.append((r.id, body, code, headers))
            codes[r.id] = code
        disp.server.reply_many(batch_out)
        for r in batch:
            if obs_on:
                code = codes[r.id]
                sid = req_sids[r.id]
                tid = req_tids[r.id]
                obs.record_span(
                    "serving.request", r.arrival_ns, done_ns,
                    trace_id=tid,
                    span_id=sid,
                    parent_id=r.headers.get(obs.PARENT_HEADER),
                    attrs={"status": code, "model": self.name},
                )
                obs.record_span(
                    "serving.queue", r.arrival_ns, dispatch_ns,
                    trace_id=tid, parent_id=sid,
                )
                lat_s = (done_ns - r.arrival_ns) / 1e9
                self._m_lat.observe(lat_s, trace_id=tid)
                self._m_srv_lat.observe(lat_s, trace_id=tid)
                FLIGHT.record(
                    "ok" if code < 500 else "error",
                    status=code,
                    trace_id=tid,
                    model=self.name,
                    path=r.path,
                    latency_ms=lat_s * 1e3,
                    queue_wait_ms=(dispatch_ns - r.arrival_ns) / 1e6,
                )
            disp._lat.record(done_ns - r.arrival_ns)
        if disp.admission is not None:
            # AIMD signal: worst queue wait in the batch (FIFO: the
            # first request waited longest) + per-request service
            disp.admission.observe(
                (dispatch_ns - batch[0].arrival_ns) / 1e9,
                svc / len(batch),
            )
        disp.batches += 1


class ModelDispatcher:
    """Multi-model dispatch loop between one WorkerServer and a ModelStore.

    Same lifecycle surface as :class:`ServingQuery` (``start`` / ``stop``
    / ``batches`` / ``errors`` / ``latency_quantiles_ms``) so fleet code
    and tests treat them interchangeably."""

    def __init__(
        self,
        server: WorkerServer,
        store: ModelStore,
        default_model: Optional[str] = None,
        max_batch_size: int = 64,
        max_wait_ms: float = 0.0,
        default_deadline_ms: Optional[float] = None,
        admission: Optional[object] = None,
        pipeline_depth: int = 2,
    ):
        self.server = server
        self.store = store
        self.default_model = default_model
        self.max_batch_size = max_batch_size
        self.max_wait_ms = max_wait_ms
        self.default_deadline_ms = default_deadline_ms
        # continuous-batching depth per model queue (>= 2 double-buffers
        # build/execute; 1 = the pre-rewrite barrier loop)
        self.pipeline_depth = max(1, int(pipeline_depth))
        # adaptive-concurrency limit (serving/admission.py): attached to
        # the ingress so sheds happen before routing; fed per-batch by
        # every model queue's wait/service samples
        self.admission = admission
        if admission is not None:
            server.admission = admission
        self._stop = threading.Event()
        self._router: Optional[threading.Thread] = None
        self._queues: dict[str, _ModelQueue] = {}
        self._queues_lock = threading.Lock()
        self.batches = 0
        self.errors = 0
        self.shed = 0
        self.deadline_expired = 0
        self._lat = LatencyRing()
        # epoch fencing on the publication plane: per-model highest
        # coordination epoch seen on a load/swap body. A publication
        # stamped with an OLDER epoch is a zombie coordinator (one that
        # woke after the fleet resharded) trying to roll the serving
        # fleet back — rejected with 409, never applied
        self._model_epochs: dict[str, int] = {}
        self._epoch_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ModelDispatcher":
        self._router = threading.Thread(
            target=self._route_loop, name=f"{self.server.name}-router",
            daemon=True,
        )
        self._router.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._router is not None:
            self._router.join(5.0)
        with self._queues_lock:
            queues = list(self._queues.values())
        for mq in queues:
            with mq.cond:
                mq.cond.notify_all()
            mq.thread.join(5.0)
            if mq.exec_thread is not None:
                mq.exec_thread.join(5.0)

    def latency_quantiles_ms(self) -> dict:
        return self._lat.quantiles_ms()

    # -- routing (router thread: no model work, O(µs) per request) -----------

    def _route_loop(self) -> None:
        while not self._stop.is_set():
            reqs = self.server.get_next_batch(64, timeout_s=0.25)
            for r in reqs:
                if self._stop.is_set():
                    self.server.reply_to(r.id, b"worker stopping", 503)
                    continue
                try:
                    self._route(r)
                except Exception as e:  # noqa: BLE001 — router must survive
                    self.server.reply_to(
                        r.id,
                        json.dumps({"error": f"{type(e).__name__}: {e}"})
                        .encode(),
                        500, _JSON,
                    )
            if reqs:
                self.server.auto_commit()
        # drain whatever the ingress still holds so clients aren't hung
        for r in self.server.get_next_batch(1_000_000, timeout_s=0.0):
            self.server.reply_to(r.id, b"worker stopping", 503)

    def _route(self, r) -> None:
        path = r.path.split("?", 1)[0]
        # a worker registered under a base path receives gateway-forwarded
        # targets like /api/models/m/swap — strip the prefix so the
        # control-plane and health routes match regardless of api_path
        prefix = self.server.api_path.rstrip("/")
        if prefix and path.startswith(prefix):
            path = path[len(prefix):] or "/"
        if path in ("/health", "/healthz") and r.method == "GET":
            self._reply_health(r)
            return
        model = None
        if path == "/models" or path == "/models/":
            self._reply_json(r, self.store.models())
            return
        if path.startswith("/models/"):
            parts = [p for p in path[len("/models/"):].split("/") if p]
            if not parts:
                self._reply_json(r, self.store.models())
                return
            name = parts[0]
            if len(parts) == 2 and parts[1] in _CONTROL_VERBS:
                if r.method != "POST":
                    self._reply_json(
                        r, {"error": "control verbs are POST"}, 400
                    )
                    return
                self._control(r, name, parts[1])
                return
            if len(parts) == 1 and r.method == "GET":
                listing = self.store.models().get(name)
                if listing is None:
                    self._reply_json(
                        r, {"error": f"unknown model {name!r}"}, 404
                    )
                else:
                    self._reply_json(r, {name: listing})
                return
            model = name  # data path: POST /models/<name>[/...]
        if model is None:
            model = r.headers.get(MODEL_HEADER) or self.default_model
        if model is None:
            self._reply_json(
                r,
                {"error": "no model named: set x-mmlspark-model or POST "
                          "/models/<name>"},
                404,
            )
            return
        self._admit(r, model)

    def _admit(self, r, model: str) -> None:
        state = self.store.serving_state(model)
        if state is None:
            # worker-local unknown: another replica may serve this model
            # without advertising it yet (runtime load, heartbeat lag) —
            # the state header lets the gateway retry elsewhere
            self._reply_json(
                r, {"error": f"unknown model {model!r}"}, 404,
                {STATE_HEADER: "unknown", **_JSON},
            )
            return
        if state != READY:
            self._reply_not_ready([r], model, state)
            return
        mq = self._queues.get(model)
        if mq is None:
            with self._queues_lock:
                mq = self._queues.get(model)
                if mq is None:
                    mq = self._queues[model] = _ModelQueue(self, model)
        # deadline-aware shedding: reject NOW when the queue already
        # guarantees a blown deadline — a 429 at ingress beats a reply
        # the client gave up on
        deadline_ms = r.headers.get(DEADLINE_HEADER)
        try:
            deadline_ms = (
                float(deadline_ms) if deadline_ms is not None
                else self.default_deadline_ms
            )
        except ValueError:
            deadline_ms = self.default_deadline_ms
        if deadline_ms is not None:
            waited_s = (time.perf_counter_ns() - r.arrival_ns) / 1e9
            est_s = mq.estimate_s() + waited_s
            if est_s * 1000.0 > deadline_ms:
                self.shed += 1
                _M_SHED.labels(model=model).inc()
                self._reply_json(
                    r,
                    {
                        "error": "deadline unmeetable",
                        "estimate_ms": round(est_s * 1e3, 3),
                        "deadline_ms": deadline_ms,
                    },
                    429, {"Retry-After": "1", **_JSON},
                )
                if _M_SHED._on:
                    # a shed is exactly what a flight-recorder dump should
                    # explain: deadline, estimate and queue wait survive.
                    # Recorded AFTER the reply: a shed auto-dumps the
                    # ring, and that disk write must not stall the router
                    # thread's 429 (nor every other model's routing)
                    # longer than it already has to
                    FLIGHT.record(
                        "shed",
                        status=429,
                        trace_id=r.headers.get(obs.TRACE_HEADER),
                        model=model,
                        path=r.path,
                        queue_wait_ms=waited_s * 1e3,
                        deadline_ms=deadline_ms,
                        detail=f"estimate_ms={round(est_s * 1e3, 3)}",
                    )
                return
        if not mq.push(r):
            # the queue was reaped (model unloaded) between lookup and
            # push: answer rather than strand the request
            self._reply_not_ready([r], model)

    # -- replies -------------------------------------------------------------

    def _reply_json(self, r, obj, code: int = 200,
                    headers: Optional[dict] = None) -> None:
        self.server.reply_to(
            r.id, json.dumps(obj).encode(), code, headers or _JSON
        )

    def _reply_not_ready(self, reqs: list, model: str,
                         state: Optional[str] = None) -> None:
        state = state or self.store.serving_state(model) or "unloaded"
        body = json.dumps(
            {"error": f"model {model!r} not ready", "state": state}
        ).encode()
        for r in reqs:
            # STATE_HEADER marks this 503 as worker-local (the model is
            # loading HERE) — the gateway retries another replica on it
            self.server.reply_to(
                r.id, body, 503, {STATE_HEADER: state, **_JSON}
            )

    def _reply_health(self, r) -> None:
        """Readiness: the default model (or, with no default, any model)
        has a ready serving version. The shape a registry-fronting LB or
        k8s probe consumes — and what fleet.run_worker's warm-before-
        register contract makes true by the time the worker is routable."""
        states = {
            name: {
                "serving": self.store.serving_version(name),
                "state": self.store.serving_state(name),
            }
            for name in self.store.model_names()
        }
        if self.default_model is not None:
            ok = states.get(self.default_model, {}).get("state") == READY
        else:
            ok = any(s["state"] == READY for s in states.values())
        self._reply_json(
            r,
            {"status": "ok" if ok else "loading", "models": states},
            200 if ok else 503,
        )

    # -- control plane (side threads: a load must not stall routing) ---------

    def _control(self, r, name: str, verb: str) -> None:
        def run() -> None:
            try:
                body = json.loads(r.body) if r.body else {}
                if not isinstance(body, dict):
                    raise ValueError("control body must be a JSON object")
                if verb in ("load", "swap") and body.get("epoch") is not None:
                    # epoch fence: the committed training generation
                    # rides the publication as a fencing token — an
                    # epoch older than the highest this worker has seen
                    # is a zombie's rollback and is refused, counted
                    epoch = int(body["epoch"])
                    with self._epoch_lock:
                        high = self._model_epochs.get(name, 0)
                        if epoch < high:
                            fenced = True
                        else:
                            fenced = False
                            self._model_epochs[name] = epoch
                    if fenced:
                        faults.inject("publish.fence", context={
                            "model": name, "epoch": epoch, "highest": high,
                        })
                        _M_EPOCH_FENCED.labels(model=name).inc()
                        self._reply_json(r, {
                            "error": (
                                f"fenced: publication epoch {epoch} is "
                                f"older than highest seen {high}"
                            ),
                            "fenced": True, "highest_epoch": high,
                        }, 409, headers={
                            "Content-Type": "application/json",
                            # survives the gateway hop (distributed.py
                            # preserves it), so a publisher behind the
                            # gateway still sees WHY the 409 happened
                            "x-mmlspark-fenced": str(high),
                        })
                        return
                if verb == "load":
                    spec = body.get("spec")
                    if spec is None:
                        raise ValueError('load needs {"spec": ...}')
                    wait = bool(body.get("wait", True))
                    v = self.store.load(
                        name, spec, version=body.get("version"),
                        wait=wait, pin=bool(body.get("pin", False)),
                        activate=body.get("activate", "auto"),
                    )
                    out, code = {
                        "model": name, "version": v,
                        "state": READY if wait else "loading",
                    }, (200 if wait else 202)
                elif verb == "swap":
                    v = self.store.swap(name, body.get("version"))
                    out, code = {"model": name, "serving": v}, 200
                elif verb == "unload":
                    n = self.store.unload(name, body.get("version"))
                    out, code = {"model": name, "unloaded": n}, 200
                else:  # pin / unpin
                    v = self.store.pin(
                        name, body.get("version"), pinned=(verb == "pin")
                    )
                    out, code = {
                        "model": name, "version": v,
                        "pinned": verb == "pin",
                    }, 200
                self._reply_json(r, out, code)
            except KeyError as e:
                self._reply_json(r, {"error": str(e).strip("'\"")}, 404)
            except HBMBudgetExceeded as e:
                self._reply_json(r, {"error": str(e)}, 507)
            except (ModelStoreError, ValueError, TypeError) as e:
                self._reply_json(r, {"error": str(e)}, 400)
            except Exception as e:  # noqa: BLE001 — loader crashes land here
                self._reply_json(
                    r, {"error": f"{type(e).__name__}: {e}"}, 500
                )

        threading.Thread(
            target=run, name=f"modelstore-ctl-{verb}-{name}", daemon=True
        ).start()
