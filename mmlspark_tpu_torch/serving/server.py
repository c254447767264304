"""WorkerServer: machine-local HTTP ingress for model serving.

The PyTorch port's copy of ``mmlspark_tpu.serving.server`` (host code:
asyncio and the stdlib, with the port's ``obs`` and ``core.faults``).

Rebuilds the continuous-serving server of the reference
(HTTPSourceV2.scala:457-675) without the JVM: an asyncio event loop on one
thread parses HTTP/1.1 (keep-alive) and enqueues :class:`CachedRequest`s
into epoch-keyed queues; a routing table maps request id -> connection so
replies from the dispatcher thread land on the originating socket
(replyTo, :516-533); uncommitted epochs are kept in ``history`` and can be
replayed after a crash (:470-487); ``commit`` prunes them (:535-547).

The ingress threads do no model work — batching and device dispatch live
in :class:`~mmlspark_tpu_torch.serving.query.ServingQuery` — so request
queuing stays O(µs) and the end-to-end budget is spent on the model call.

Multi-reactor ingress (the throughput rewrite): ``num_reactors > 1``
runs N acceptor/reader event loops over ONE shared listening socket
(each reactor polls its own dup of the listen fd and races ``accept``;
the kernel hands every connection to exactly one loop). A connection
lives its whole life on the reactor that accepted it, so one slow
client — or a multi-MB ``/artifacts`` window draining inline — stalls
only its own reactor while the others keep taking requests. The inline
``/metrics``, ``/traces`` and ``/artifacts`` contracts (answered on the
reactor, never queued or counted) hold per reactor, and all reactors
feed the one shared request queue the dispatcher pops.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import socket as socket_mod
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.obs.registry import SIZE_BUCKETS

_REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found",
             408: "Request Timeout", 413: "Payload Too Large",
             429: "Too Many Requests", 431: "Request Header Fields Too Large",
             500: "Internal Server Error", 502: "Bad Gateway",
             503: "Service Unavailable", 504: "Gateway Timeout",
             507: "Insufficient Storage"}

# ingress telemetry (docs/observability.md). Families are module-level;
# each server pre-binds its label children in __init__ so the per-request
# hot path is one enabled-check + one locked add per instrument.
_M_ACCEPTED = obs.counter(
    "mmlspark_serving_requests_total",
    "Requests accepted into the ingress queue", labels=("server",),
)
_M_REJECTED = obs.counter(
    "mmlspark_serving_rejected_total",
    "Requests rejected at ingress (never queued)",
    labels=("server", "reason"),
)
_M_QDEPTH = obs.gauge(
    "mmlspark_serving_queue_depth_requests",
    "Requests currently queued awaiting dispatch", labels=("server",),
)
_M_QWAIT = obs.histogram(
    "mmlspark_serving_queue_wait_seconds",
    "Ingress-to-dispatch wait (arrival_ns to queue pop)", labels=("server",),
)
_M_BATCH = obs.histogram(
    "mmlspark_serving_batch_size_requests",
    "Requests per dispatched batch", labels=("server",),
    buckets=SIZE_BUCKETS,
)
_M_REPLAYED = obs.counter(
    "mmlspark_serving_replayed_total",
    "Requests re-enqueued by epoch replay recovery", labels=("server",),
)
_M_REACTOR_CONNS = obs.counter(
    "mmlspark_serving_reactor_connections_total",
    "Client connections accepted, per ingress reactor",
    labels=("server", "reactor"),
)
_M_INFLIGHT = obs.gauge(
    "mmlspark_serving_inflight_requests",
    "Accepted (non-probe) requests not yet replied to — the ingress "
    "routing table. MUST drain to zero after traffic stops; the "
    "invariant checker's nothing-lost gauge (chaos/invariants.py)",
    labels=("server",),
)
_METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


@dataclass
class CachedRequest:
    id: str
    epoch: int
    method: str
    path: str
    headers: dict
    body: bytes
    arrival_ns: int = 0
    attempt: int = 0


@dataclass
class ServiceInfo:
    """What a worker reports to the serving registry
    (HTTPSourceV2.scala ServiceInfo :649-655)."""

    name: str
    host: str
    port: int
    path: str = "/"
    # public endpoint when an SSH reverse forward fronts the worker
    # (HTTPSourceV2.scala :657-665 forwarding options)
    forwarded_host: Optional[str] = None
    forwarded_port: Optional[int] = None
    # model names this worker serves (ModelStore-backed workers advertise
    # them so the gateway can route model-aware); None = unadvertised
    models: Optional[tuple] = None
    # content-addressed artifacts this process can serve over GET
    # /artifacts/<digest> ("name@sha256" strings, serving/artifacts.py);
    # consumers resolve fetch peers by scanning rosters for a digest
    artifacts: Optional[tuple] = None
    # process-generation stamp: set once when the server starts, constant
    # across heartbeat re-registrations, new on every restart. Roster
    # consumers use it to tell "new process" from "same process, fresh
    # heartbeat" — the registry's own ``ts`` is bumped by every beat, so
    # it cannot carry that distinction (the gateway resets a backend's
    # circuit breaker only on a new boot)
    boot: Optional[float] = None


class WorkerServer:
    """Epoch-queued HTTP ingress with reply routing and history replay."""

    # health probes may queue past max_queue (they are never bounced with
    # an inline answer — see _handle_conn), but only this many: beyond it
    # the connection closes unanswered, preserving the wedge signal
    # without letting a probing supervisor grow the queue forever
    _PROBE_OVERFLOW = 64

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        api_path: str = "/",
        name: str = "serving",
        max_queue: int = 100_000,
        forwarding: Optional[dict] = None,
        num_reactors: int = 1,
        header_deadline_s: Optional[float] = 30.0,
        max_header_bytes: int = 65536,
        max_body_bytes: int = 256 << 20,
        max_conns_per_reactor: int = 4096,
    ):
        """``forwarding``: kwargs for io.port_forwarding.PortForwarding
        (remote_host, remote_port, user, key_file, ...) — when given,
        ``start()`` opens an ssh -R tunnel exposing this worker publicly
        and reports the forwarded endpoint in ServiceInfo, like the
        reference's worker port forwarding (HTTPSourceV2.scala:657-665).

        ``num_reactors``: ingress event loops sharing the listening
        socket (module docstring). 1 keeps the classic single-loop
        ingress; fleet workers and gateways default higher.

        Hostile-client hardening (docs/chaos.md; the slowloris defenses
        the wire chaos harness forces):

        - ``header_deadline_s``: once a request's FIRST byte arrives,
          the full head must land within this budget or the connection
          is answered 408 and closed (an idle keep-alive connection
          between requests is never timed — idleness is not dripping).
          The body rides the same clock with a floor of 256 KiB/s so a
          legitimately large upload at normal speed always fits. None
          disables.
        - ``max_header_bytes`` / ``max_body_bytes``: 431 / 413 bounds —
          a hostile client cannot buffer-balloon a reactor.
        - ``max_conns_per_reactor``: connections beyond the cap are
          answered 503 and closed immediately, so one client opening
          sockets in a loop cannot pin a reactor's fd table. All four
          sheds are counted in ``mmlspark_serving_rejected_total`` and
          never touch the request queue."""
        self.name = name
        self.host = host
        self._forwarding_cfg = forwarding
        self._forwarding: Any = None
        self.api_path = api_path.rstrip("/") or "/"
        self._requested_port = port
        self.port: int = 0
        self.num_reactors = max(1, int(num_reactors or 1))
        # reactor index -> (loop, server); _loop stays reactor 0's loop
        self._reactors: list = []
        self._lsock: Optional[socket_mod.socket] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._threads: list = []
        self._started = threading.Event()
        self._boot_errors: list = []
        self._max_queue = max_queue
        # request ids: uuid4 can cost ~14 µs a call in some containers —
        # at data-plane rates that is real budget, so ids are one
        # process-unique prefix + a shared atomic counter
        self._id_prefix = uuid.uuid4().hex[:12]
        self._id_counter = itertools.count()
        self._header_deadline_s = header_deadline_s
        self._max_header_bytes = int(max_header_bytes)
        self._max_body_bytes = int(max_body_bytes)
        self._max_conns_per_reactor = max(1, int(max_conns_per_reactor))
        # per-reactor live-connection counts (each loop touches only its
        # own key from its own thread)
        self._conn_counts: dict = {}

        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._epoch = 0
        self._queue: deque[CachedRequest] = deque()
        # epoch -> [CachedRequest] for replay-on-failure (historyQueues)
        self._history: dict[int, list[CachedRequest]] = {}
        # request id -> (writer, keep_alive) — pending replies (routingTable)
        self._routing: dict[str, tuple] = {}
        # open client connections -> owning reactor loop, so stop() can
        # close them on the right loop: a stopped worker whose sockets
        # linger half-open looks "slow" (send succeeds, reply never
        # comes) to keep-alive peers like the gateway, instead of
        # cleanly dead
        self._writers: dict = {}
        self.requests_seen = 0
        # optional AdmissionController (serving/admission.py): consulted
        # before a request is queued — the adaptive-concurrency shed path.
        # Attribute, not constructor arg: the query/dispatcher layer that
        # owns the controller attaches it (ServingQuery/ModelDispatcher)
        self.admission: Any = None
        # optional ArtifactStore (the JAX package's serving/artifacts.py,
        # not ported yet; any object with its handle_http): when attached,
        # GET /artifacts[/<digest>] is answered inline off this ingress
        # (ranged, never queued or counted — the /metrics contract), so
        # any worker doubles as a content-addressed artifact peer
        self.artifact_store: Any = None
        self._m_accepted = _M_ACCEPTED.labels(server=name)
        self._m_rej_full = _M_REJECTED.labels(server=name, reason="queue_full")
        self._m_rej_admission = _M_REJECTED.labels(
            server=name, reason="admission"
        )
        self._m_rej_404 = _M_REJECTED.labels(server=name, reason="not_found")
        self._m_rej_400 = _M_REJECTED.labels(server=name, reason="bad_request")
        self._m_rej_slow = _M_REJECTED.labels(
            server=name, reason="slow_client"
        )
        self._m_rej_hdr_big = _M_REJECTED.labels(
            server=name, reason="header_too_large"
        )
        self._m_rej_body_big = _M_REJECTED.labels(
            server=name, reason="body_too_large"
        )
        self._m_rej_conn_cap = _M_REJECTED.labels(
            server=name, reason="conn_cap"
        )
        self._m_inflight = _M_INFLIGHT.labels(server=name)
        self._inflight_accepted = 0
        self._m_qdepth = _M_QDEPTH.labels(server=name)
        self._m_qwait = _M_QWAIT.labels(server=name)
        self._m_batch = _M_BATCH.labels(server=name)
        self._m_replayed = _M_REPLAYED.labels(server=name)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> ServiceInfo:
        # bind + listen ONCE on the calling thread; every reactor then
        # polls its own dup of this fd and races accept() — the kernel
        # delivers each connection to exactly one reactor. Family
        # resolved per host (an IPv6 literal/host must keep working the
        # way asyncio.start_server(host=...) did). ONE family only —
        # unlike asyncio's bind-every-result — so on a dual-stack name
        # like "localhost" prefer the IPv4 entry: every roster address,
        # Backend and tool in this repo speaks IPv4 literals
        infos = socket_mod.getaddrinfo(
            self.host or None, self._requested_port,
            type=socket_mod.SOCK_STREAM, flags=socket_mod.AI_PASSIVE,
        )
        family, _, _, _, sockaddr = next(
            (i for i in infos if i[0] == socket_mod.AF_INET), infos[0]
        )
        lsock = socket_mod.socket(family, socket_mod.SOCK_STREAM)
        lsock.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_REUSEADDR, 1)
        lsock.bind(sockaddr[:2] if family == socket_mod.AF_INET else sockaddr)
        lsock.listen(512)
        lsock.setblocking(False)
        self._lsock = lsock
        self.port = lsock.getsockname()[1]
        started = threading.Barrier(self.num_reactors + 1)
        for i in range(self.num_reactors):
            t = threading.Thread(
                target=self._run_reactor, args=(i, started),
                name=f"{self.name}-ingress-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        try:
            started.wait(10.0)
        except threading.BrokenBarrierError:
            # release what did come up: the bound listen socket and any
            # reactor that booted — a caller retrying start() on a fixed
            # port must not hit EADDRINUSE against our own leaked fd
            self.stop()
            raise RuntimeError("WorkerServer failed to start") from None
        if self._boot_errors:
            self.stop()
            raise RuntimeError(
                f"WorkerServer reactor failed to start: {self._boot_errors[0]}"
            )
        self._started.set()
        info = ServiceInfo(
            self.name, self.host, self.port, self.api_path,
            boot=time.time(),
        )
        if self._forwarding_cfg:
            from mmlspark_tpu_torch.io.port_forwarding import PortForwarding

            try:
                cfg = dict(self._forwarding_cfg)
                cfg.setdefault("local_port", self.port)
                self._forwarding = PortForwarding(**cfg).start()
            except Exception:
                # a failed start() must not leave a live listener behind
                self.stop()
                raise
            info.forwarded_host = cfg.get("remote_host")
            info.forwarded_port = cfg.get("remote_port")
        return info

    def _run_reactor(self, idx: int, started: threading.Barrier) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        if idx == 0:
            self._loop = loop
        m_conns = _M_REACTOR_CONNS.labels(server=self.name, reactor=str(idx))

        async def handle(reader, writer) -> None:
            if m_conns._on:
                m_conns.inc()
            await self._handle_conn(reader, writer)

        async def boot() -> bool:
            try:
                # each reactor owns a dup of the shared listen fd: the
                # loops race accept(); asyncio absorbs the loser's
                # BlockingIOError, so the herd costs a wakeup, not a bug
                # the stream buffer must hold one full-size header line:
                # asyncio's default 64 KiB limit would make readline()
                # raise ValueError BEFORE the head_bytes/431 check sees
                # a configured max_header_bytes >= 64 KiB
                aserver = await asyncio.start_server(
                    handle, sock=self._lsock.dup(),
                    limit=self._max_header_bytes + 4096,
                )
                self._reactors.append((loop, aserver))
                ok = True
            except Exception as e:  # noqa: BLE001 — surfaced by start()
                self._boot_errors.append(e)
                ok = False
            started.wait(10.0)
            return ok

        booted = loop.run_until_complete(boot())
        try:
            # a reactor that failed to boot never registered in
            # _reactors, so stop() could not reach its loop — it must
            # not enter run_forever or the thread leaks alive
            if booted:
                loop.run_forever()
        finally:
            loop.close()

    def pause_accepting(self) -> None:
        """Stop taking NEW connections; established connections (and
        their in-flight requests) live on. The graceful-drain lifecycle's
        middle step: deregister -> pause_accepting -> wait
        :meth:`inflight` to zero -> :meth:`stop` (docs/chaos.md)."""
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        for loop, aserver in list(self._reactors):
            try:
                loop.call_soon_threadsafe(aserver.close)
            except RuntimeError:
                pass

    def stop(self) -> None:
        if self._forwarding is not None:
            self._forwarding.stop()
            self._forwarding = None
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        for loop, aserver in list(self._reactors):

            def _shutdown(loop=loop, aserver=aserver) -> None:
                aserver.close()
                # close this reactor's client connections BEFORE stopping
                # its loop: cancelled handler tasks never get to run their
                # cleanup once the loop stops, and a lingering ESTABLISHED
                # socket makes this worker look slow (send-then-silence)
                # rather than dead to keep-alive clients. transport.abort()
                # alone isn't enough — its close callbacks need loop
                # iterations that never come — so shut the raw socket down
                # synchronously (FIN goes out now; the fd stays valid for
                # the transport's own teardown)
                for w, owner in list(self._writers.items()):
                    if owner is not loop:
                        continue
                    try:
                        sock = w.transport.get_extra_info("socket")
                        w.transport.abort()
                        if sock is not None:
                            sock.shutdown(socket_mod.SHUT_RDWR)
                    except Exception:
                        pass
                    self._writers.pop(w, None)
                for task in asyncio.all_tasks(loop):
                    task.cancel()
                loop.stop()

            try:
                loop.call_soon_threadsafe(_shutdown)
            except RuntimeError:
                pass
        for t in self._threads:
            t.join(5.0)
        with self._not_empty:
            self._not_empty.notify_all()

    # -- ingress (loop thread) -----------------------------------------------

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        loop = asyncio.get_running_loop()
        key = id(loop)
        n_conns = self._conn_counts.get(key, 0)
        if n_conns >= self._max_conns_per_reactor:
            # per-reactor connection cap: a client opening sockets in a
            # loop must not pin this reactor's fd table — shed NOW,
            # before the connection costs anything
            self._m_rej_conn_cap.inc()
            try:
                self._write_response(
                    writer, 503, b"connection limit", False,
                    {"Retry-After": "1"},
                )
                await writer.drain()
            except Exception:
                pass
            try:
                writer.close()
            except Exception:
                pass
            return
        self._conn_counts[key] = n_conns + 1
        self._writers[writer] = loop
        watchdog = None  # the current request's slow-client timer
        try:
            while True:
                # line-framed head read (readline resolves from the
                # stream buffer without suspending once bytes are in),
                # decoded and split in one pass at the end. NOT
                # readuntil(b"\r\n\r\n"): a bare-LF client — which this
                # parser has always tolerated — would never match the
                # CRLF terminator and hang the connection open forever.
                #
                # Slowloris defense: the idle wait for a request's FIRST
                # byte is unbounded (keep-alive idleness is legitimate),
                # but once that byte lands the WHOLE request must land
                # within its deadline — a client dripping one header
                # byte per second is answered 408 and dropped, pinning
                # nothing. Enforced by ONE call_later watchdog per
                # request, not a wait_for per line: wait_for mints a
                # Task + timer per call, and at data-plane rates that
                # tax measured ~2x on echo throughput
                first = await reader.read(1)
                if not first:
                    return
                reading = [True]  # the watchdog's am-I-still-relevant flag
                if self._header_deadline_s:
                    def _expire(reading=reading, writer=writer):
                        if not reading[0]:
                            return
                        reading[0] = False  # mark expired for the reader
                        self._m_rej_slow.inc()
                        try:
                            self._write_response(
                                writer, 408, b"request read timed out",
                                False,
                            )
                            # flush the 408, FIN, and wake the pending
                            # readline/readexactly with EOF
                            writer.transport.close()
                        except Exception:
                            pass

                    watchdog = loop.call_later(
                        self._header_deadline_s, _expire
                    )
                raw_lines = []
                head_bytes = 0
                lead = first
                while True:
                    try:
                        h = await reader.readline()
                    except ValueError:
                        # a single line overran the stream buffer (sized
                        # max_header_bytes + margin above): same attack,
                        # same counted 431 as the head_bytes check below
                        if watchdog is not None:
                            watchdog.cancel()
                        self._m_rej_hdr_big.inc()
                        self._write_response(
                            writer, 431, b"header too large", False
                        )
                        return
                    if not reading[0]:
                        return  # the watchdog fired (already 408'd)
                    if lead is not None:
                        h = lead + h
                        lead = None
                    head_bytes += len(h)
                    if head_bytes > self._max_header_bytes:
                        if watchdog is not None:
                            watchdog.cancel()
                        self._m_rej_hdr_big.inc()
                        self._write_response(
                            writer, 431, b"header too large", False
                        )
                        return
                    if h in (b"\r\n", b"\n", b""):
                        break
                    raw_lines.append(h)
                if not raw_lines:
                    if watchdog is not None:
                        watchdog.cancel()
                    return
                try:
                    # split on the actual line framing only — NOT
                    # str.splitlines(), which also breaks on latin1
                    # control bytes (NEL \x85, \x0b, \x0c, ...) that a
                    # header value may legally carry
                    lines = [
                        ln.rstrip("\r")
                        for ln in b"".join(raw_lines).decode("latin1")
                        .split("\n")
                    ]
                    if lines and lines[-1] == "":
                        lines.pop()  # the head's trailing newline
                    try:
                        method, path, version = lines[0].split()
                    except ValueError:
                        return
                    headers: dict = {}
                    for h in lines[1:]:
                        k, _, v = h.partition(":")
                        headers[k.strip().lower()] = v.strip()
                    try:
                        n = int(headers.get("content-length") or 0)
                    except ValueError:
                        self._m_rej_400.inc()
                        self._write_response(
                            writer, 400, b"bad Content-Length", False
                        )
                        return
                    if n < 0:
                        self._m_rej_400.inc()
                        self._write_response(
                            writer, 400, b"bad Content-Length", False
                        )
                        return
                    if n > self._max_body_bytes:
                        self._m_rej_body_big.inc()
                        self._write_response(
                            writer, 413, b"body too large", False
                        )
                        return
                    if n and watchdog is not None:
                        # the body gets a fresh budget with a floor of
                        # 256 KiB/s, so a large-but-honest upload at
                        # normal speed always fits; a dripped body does
                        # not (the watchdog 408s and closes)
                        watchdog.cancel()
                        watchdog = loop.call_later(
                            max(
                                self._header_deadline_s,
                                n / (256 * 1024.0),
                            ),
                            _expire,
                        )
                    body = await reader.readexactly(n) if n else b""
                    if not reading[0]:
                        return  # the watchdog fired mid-body
                finally:
                    # the request is fully read (or abandoned): the
                    # slow-client clock stops here, before any model
                    # work or queue wait
                    if watchdog is not None:
                        watchdog.cancel()
                keep = headers.get("connection", "keep-alive").lower() != "close"
                prefix = self.api_path.rstrip("/")
                path_only = path.split("?", 1)[0]
                if path_only == "/metrics" and method == "GET":
                    # scrape endpoint: answered inline on the ingress
                    # thread (no model work), never queued or counted as
                    # an accepted request — scraping must not perturb the
                    # request metrics it reports
                    self._write_response(
                        writer, 200, obs.render().encode(), keep,
                        {"Content-Type": _METRICS_CONTENT_TYPE},
                    )
                    if not keep:
                        return
                    continue
                if method == "GET" and (
                    path_only == "/traces"
                    or path_only.startswith("/traces/")
                ):
                    # span-buffer scrape (trace assembly): same inline,
                    # never-counted contract as /metrics
                    tid = path_only[len("/traces/"):] or None
                    self._write_response(
                        writer, 200, obs.render_traces(tid).encode(), keep,
                        {"Content-Type": "application/json"},
                    )
                    if not keep:
                        return
                    continue
                if (
                    method in ("GET", "PUT")
                    and self.artifact_store is not None
                    and (
                        path_only == "/artifacts"
                        or path_only.startswith("/artifacts/")
                    )
                ):
                    # content-addressed artifact plane (serving/
                    # artifacts.py): advertisement + ranged blob reads +
                    # pushed replica windows (PUT), answered inline like
                    # /metrics. Blobs can be many MB — drain so
                    # backpressure lands here, not in an unbounded
                    # transport buffer
                    code, body_out, hdrs = self.artifact_store.handle_http(
                        path_only, headers, method=method, body=body
                    )
                    self._write_response(writer, code, body_out, keep, hdrs)
                    try:
                        await writer.drain()
                    except ConnectionError:
                        return
                    if not keep:
                        return
                    continue
                if path_only == "/profile" and method == "GET":
                    # sampling-profiler scrape: collapsed flame stacks,
                    # same inline never-counted contract as /metrics.
                    # First scrape starts the sampler, so even a process
                    # booted without it accumulates from the moment
                    # someone looks (obs/prof.py)
                    from mmlspark_tpu_torch.obs import prof

                    body_out = prof.ensure_started().profile_payload()
                    self._write_response(
                        writer, 200, body_out.encode(), keep,
                        {"Content-Type": "text/plain; version=0.0.4"},
                    )
                    if not keep:
                        return
                    continue
                if path_only == "/debug/threads" and method == "GET":
                    # instant all-thread stack dump — what is this
                    # process standing in RIGHT NOW (no sampler needed)
                    from mmlspark_tpu_torch.obs import prof

                    self._write_response(
                        writer, 200,
                        json.dumps(prof.threads_payload()).encode(), keep,
                        {"Content-Type": "application/json"},
                    )
                    if not keep:
                        return
                    continue
                if path_only == "/debug/dump" and method == "POST":
                    # on-demand flight-recorder dump (docs/observability.md)
                    from mmlspark_tpu_torch.obs.flightrec import FLIGHT

                    dump_path = FLIGHT.dump("manual")
                    body_out = json.dumps({
                        "dumped": dump_path is not None,
                        "path": dump_path,
                        "records": len(FLIGHT),
                    }).encode()
                    self._write_response(
                        writer, 200, body_out, keep,
                        {"Content-Type": "application/json"},
                    )
                    if not keep:
                        return
                    continue
                on_path = (
                    not prefix
                    or path_only == prefix
                    or path_only.startswith(prefix + "/")
                )
                if not on_path:
                    self._m_rej_404.inc()
                    self._write_response(writer, 404, b"not found", keep)
                    if not keep:
                        return
                    continue
                # Health probes (supervisor, orchestrators, humans) are
                # monitoring, not traffic: never counted as accepted,
                # never admission-shed, never bounced by a full queue —
                # a saturated worker answering 429 to its supervisor
                # would be wedge-killed, shrinking the fleet under
                # overload. The probe still rides the QUEUE though: a
                # wedged dispatcher answers nothing, which is exactly
                # the signal wedge detection needs.
                bare = (
                    path_only[len(prefix):]
                    if prefix and path_only.startswith(prefix)
                    else path_only
                )
                is_probe = (
                    method == "GET" and bare in ("/health", "/healthz")
                )
                admission = self.admission if not is_probe else None
                if admission is not None:
                    # adaptive-concurrency shed (serving/admission.py):
                    # beyond the AIMD in-flight limit the request is
                    # answered 429 + Retry-After HERE, in microseconds,
                    # instead of joining a queue that already guarantees
                    # a blown deadline. Fault point admission.shed: a
                    # truthy payload forces the shed, delay_s stalls the
                    # admission path (chaos latency fault)
                    forced = None
                    try:
                        forced = faults.inject("admission.shed")
                    except Exception:  # noqa: BLE001 — injected error = shed
                        forced = True
                    if forced or not admission.try_acquire():
                        if forced:
                            admission.force_shed()
                        self._m_rej_admission.inc()
                        self._write_response(
                            writer, 429,
                            b'{"error": "over concurrency limit"}', keep,
                            admission.shed_headers(),
                        )
                        if not keep:
                            return
                        continue
                req = CachedRequest(
                    id=f"{self._id_prefix}-{next(self._id_counter)}",
                    epoch=self._epoch,
                    method=method,
                    path=path,
                    headers=headers,
                    body=body,
                    arrival_ns=time.perf_counter_ns(),
                )
                replied = asyncio.Event()
                with self._not_empty:
                    qlen = len(self._queue)
                    if not is_probe and qlen >= self._max_queue:
                        if admission is not None:
                            admission.release()  # the slot never queued
                        self._m_rej_full.inc()
                        self._write_response(writer, 503, b"queue full", keep)
                        if not keep:
                            return
                        continue
                    if is_probe and qlen >= self._max_queue + \
                            self._PROBE_OVERFLOW:
                        # probes ride the queue so a wedged dispatcher
                        # answers nothing (the wedge signal) — but they
                        # must not grow it unboundedly either. Past a
                        # small overflow allowance, close unanswered:
                        # any inline answer (even a 503) would read as
                        # "alive" to the supervisor and defeat wedge
                        # detection; a dropped connection reads as a
                        # failed probe, exactly the signal intended
                        return
                    self._routing[req.id] = (
                        writer, keep, replied, admission is not None, loop,
                        not is_probe,
                    )
                    self._queue.append(req)
                    self._history.setdefault(req.epoch, []).append(req)
                    self.requests_seen += 1
                    if not is_probe:
                        # the nothing-lost gauge: accepted, not yet
                        # replied — the invariant checker demands this
                        # drains to zero after traffic stops
                        self._inflight_accepted += 1
                        if self._m_accepted._on:
                            self._m_accepted.inc()
                            self._m_qdepth.set(len(self._queue))
                            self._m_inflight.set(self._inflight_accepted)
                    self._not_empty.notify()
                # wait for the reply before reading the next request on this
                # connection (no HTTP/1.1 pipelining needed)
                await replied.wait()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        finally:
            if watchdog is not None:
                # a head/body read that RAISED (client reset mid-request)
                # skips the per-request cancel — without this, the timer
                # later fires on the dead connection and falsely counts
                # a slow_client shed for every abrupt disconnect
                watchdog.cancel()
            self._conn_counts[key] = max(0, self._conn_counts.get(key, 1) - 1)
            self._writers.pop(writer, None)
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _write_response(
        writer: asyncio.StreamWriter, code: int, body: bytes, keep: bool,
        headers: Optional[dict] = None,
    ) -> None:
        reason = _REASONS.get(code, "")
        head = [f"HTTP/1.1 {code} {reason}"]
        hdrs = {"Content-Length": str(len(body)),
                "Connection": "keep-alive" if keep else "close"}
        hdrs.update(headers or {})
        head += [f"{k}: {v}" for k, v in hdrs.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin1") + body)

    # -- consumption (dispatcher thread) --------------------------------------

    def get_next_batch(
        self, max_n: int, timeout_s: float = 0.1, min_n: int = 1,
        accumulate_s: float = 0.0,
    ) -> list:
        """Pop up to ``max_n`` queued requests; blocks up to ``timeout_s``
        for the first ``min_n`` (getNextRequest analogue, :588-623).
        ``accumulate_s > 0`` then waits that long for more arrivals (batch
        accumulation window) unless ``max_n`` is already reached."""
        deadline = time.monotonic() + timeout_s
        with self._not_empty:
            while len(self._queue) < min_n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            if self._queue and accumulate_s > 0:
                acc_deadline = time.monotonic() + accumulate_s
                while len(self._queue) < max_n:
                    remaining = acc_deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._not_empty.wait(remaining)
            out = []
            while self._queue and len(out) < max_n:
                out.append(self._queue.popleft())
            if out and self._m_qwait._on:
                # ingress->dispatch latency: arrival_ns was previously
                # recorded but never reported anywhere — the queue-wait
                # histogram is where it lands (docs/observability.md)
                now_ns = time.perf_counter_ns()
                for r in out:
                    self._m_qwait.observe((now_ns - r.arrival_ns) / 1e9)
                self._m_batch.observe(len(out))
                self._m_qdepth.set(len(self._queue))
            return out

    # -- replies (any thread) --------------------------------------------------

    def reply_to(
        self, request_id: str, body: bytes, code: int = 200,
        headers: Optional[dict] = None,
    ) -> bool:
        """Write the response on the originating connection. Idempotent:
        second reply for the same id is a no-op (routing-table removal,
        HTTPSourceV2.scala:516-527)."""
        with self._lock:
            entry = self._routing.pop(request_id, None)
            if entry is not None and entry[5]:
                self._inflight_accepted -= 1
                if self._m_inflight._on:
                    self._m_inflight.set(self._inflight_accepted)
        if entry is None:
            return False
        writer, keep, replied, admitted, loop, _counted = entry
        if admitted and self.admission is not None:
            # the admitted request is answered (any status): free its
            # concurrency slot exactly once (the routing-table pop above
            # is the idempotency guard). Probes were never admitted —
            # releasing for one would mint a phantom slot.
            self.admission.release()
        if loop is None:
            return False

        def _send() -> None:
            try:
                self._write_response(writer, code, body, keep, headers)
            except Exception:
                pass
            finally:
                replied.set()

        try:
            # the reply must be written by the reactor that owns the
            # connection — asyncio transports are not thread-safe
            loop.call_soon_threadsafe(_send)
        except RuntimeError:  # loop already closed (server stopped first)
            return False
        return True

    def reply_many(self, replies: list) -> int:
        """Batched :meth:`reply_to`: ``[(request_id, body, code,
        headers), ...]`` with ONE loop wakeup per owning reactor instead
        of one per request — on a 64-request dispatch batch that is 63
        fewer cross-thread signal syscalls on the reply path. Same
        idempotency (routing-table pop) and admission-release semantics
        per entry; returns how many replies were actually deliverable."""
        with self._lock:
            entries = [
                (entry, body, code, headers)
                for rid, body, code, headers in replies
                if (entry := self._routing.pop(rid, None)) is not None
            ]
            dec = sum(1 for entry, _b, _c, _h in entries if entry[5])
            if dec:
                self._inflight_accepted -= dec
                if self._m_inflight._on:
                    self._m_inflight.set(self._inflight_accepted)
        by_loop: dict = {}
        for (writer, keep, replied, admitted, loop, _counted), body, code, \
                hdrs in entries:
            if admitted and self.admission is not None:
                self.admission.release()
            if loop is not None:
                by_loop.setdefault(id(loop), (loop, []))[1].append(
                    (writer, keep, replied, body, code, hdrs)
                )
        for loop, items in by_loop.values():

            def _send_all(items=items) -> None:
                for writer, keep, replied, body, code, hdrs in items:
                    try:
                        self._write_response(writer, code, body, keep, hdrs)
                    except Exception:
                        pass
                    finally:
                        replied.set()

            try:
                loop.call_soon_threadsafe(_send_all)
            except RuntimeError:
                pass  # loop already closed (server stopped first)
        return len(entries)

    # -- epochs / recovery -----------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    def new_epoch(self) -> int:
        """Advance the epoch (micro-batch mode boundary)."""
        with self._lock:
            self._epoch += 1
            return self._epoch

    def commit(self, epoch: int) -> None:
        """Acknowledge an epoch fully replied: prune its replay history
        (:535-547)."""
        with self._lock:
            for e in [e for e in self._history if e <= epoch]:
                del self._history[e]

    def auto_commit(self) -> None:
        """Compact history down to the still-unanswered requests — the
        continuous-mode commit policy. (The old floor-epoch prune never
        fired in continuous mode: the epoch stays 0, one in-flight
        request kept it live, and epoch 0's list grew — and was
        re-scanned — per batch, forever. Compacting per epoch keeps
        replay semantics byte-identical: replay() only ever re-enqueues
        requests still awaiting a reply.)"""
        with self._lock:
            for e in list(self._history):
                reqs = [
                    r for r in self._history[e] if r.id in self._routing
                ]
                if reqs:
                    self._history[e] = reqs
                else:
                    del self._history[e]

    def replay(self, epoch: int) -> int:
        """Re-enqueue uncommitted requests of ``epoch`` whose replies never
        happened — the re-registration recovery path (:470-487). Returns the
        number of requests rehydrated."""
        with self._not_empty:
            reqs = [
                r for r in self._history.get(epoch, ())
                if r.id in self._routing  # unanswered only
            ]
            for r in reqs:
                r.attempt += 1
            # remove any still-queued instances to avoid double delivery
            queued = {r.id for r in reqs}
            self._queue = deque(r for r in self._queue if r.id not in queued)
            self._queue.extendleft(reversed(reqs))
            if reqs:
                self._m_replayed.inc(len(reqs))
                self._m_qdepth.set(len(self._queue))
            self._not_empty.notify()
            return len(reqs)

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def inflight(self) -> int:
        """Accepted requests not yet replied to (queued OR handed to a
        dispatcher) — the set a graceful drain must see through to zero."""
        with self._lock:
            return len(self._routing)

    def drain_inflight(self, timeout_s: float = 10.0) -> bool:
        """Wait until every accepted (non-probe) request has been
        replied to — queued, dispatched AND staged continuous batches
        all hold routing entries until their reply lands, so a True
        return means zero requests will be dropped by a subsequent
        :meth:`stop`. Supervisor health probes are excluded (a probing
        supervisor must not hold the drain open)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and self._inflight_accepted <= 0:
                    return True
            time.sleep(0.02)
        with self._lock:
            return not self._queue and self._inflight_accepted <= 0
