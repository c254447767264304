"""Always-on flight recorder: a bounded ring of recent request records
that persists itself to disk the moment something goes wrong.

The PyTorch port's copy of ``mmlspark_tpu.obs.flightrec`` (stdlib only).

Metrics say *that* the p99 blew up; traces say *where* one request spent
its time — the flight recorder answers "what were the last N requests
through this process when it broke", with zero steady-state cost beyond
one dict + ring append per request. Every serving reply path records a
:func:`record` (trace id, model, status, latency, queue wait, outcome),
and every fired fault-injection point records one too, so a chaos run's
injected failures are in the ring next to the requests they broke.

Auto-dump: a record whose outcome is ``error``/``shed``, whose status is
5xx, or whose latency exceeds ``latency_dump_ms`` triggers a JSON dump of
the whole ring — debounced (``min_dump_interval_s``) and retention-capped
(``max_dumps`` files / ``max_bytes`` total, oldest deleted first), so a
crash-looping fleet can never fill a disk. On-demand dumps ride
``POST /debug/dump`` (served inline by every WorkerServer and the serving
registry) and ``SIGUSR1`` (installed by the fleet CLI roles).

Dump file shape::

    {"process": "...", "reason": "status_5xx", "ts": 1690000000.0,
     "records": [{"ts": ..., "trace_id": ..., "model": ..., "path": ...,
                  "status": 503, "latency_ms": ..., "queue_wait_ms": ...,
                  "deadline_ms": ..., "outcome": "5xx", "detail": ...}]}

Environment knobs: ``MMLSPARK_FLIGHTREC_DIR`` (dump directory, default
``<tmp>/mmlspark_flightrec``), ``MMLSPARK_FLIGHTREC_CAP`` (ring size,
default 1024), ``MMLSPARK_FLIGHTREC_LAT_MS`` (latency dump threshold,
default off).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Optional

from mmlspark_tpu_torch.obs import tracing
from mmlspark_tpu_torch.obs.registry import REGISTRY, counter, gauge

_M_RECORDS = gauge(
    "mmlspark_trace_flight_records_count",
    "Request records currently held in the flight-recorder ring",
)
_M_DUMPS = counter(
    "mmlspark_trace_flight_dumps_total",
    "Flight-recorder dumps written, by trigger reason", labels=("reason",),
)

# outcomes that always trigger an auto-dump (latency is threshold-gated)
_DUMP_OUTCOMES = frozenset(("error", "shed"))


class FlightRecorder:
    """Bounded, thread-safe ring of request records with auto-persist."""

    def __init__(
        self,
        cap: int = 1024,
        dump_dir: Optional[str] = None,
        max_dumps: int = 20,
        max_bytes: int = 16 << 20,
        min_dump_interval_s: float = 30.0,
        latency_dump_ms: Optional[float] = None,
    ):
        self.cap = int(cap)
        self.dump_dir = dump_dir or os.path.join(
            tempfile.gettempdir(), "mmlspark_flightrec"
        )
        self.max_dumps = int(max_dumps)
        self.max_bytes = int(max_bytes)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.latency_dump_ms = latency_dump_ms
        self.enabled = True
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=self.cap)
        self._last_dump = 0.0  # monotonic; 0 = never
        self.dumps_written = 0
        self.dumps_suppressed = 0

    # -- recording (reply-path hot code) --------------------------------------

    def record(
        self,
        outcome: str,
        status: int = 0,
        trace_id: Optional[str] = None,
        model: Optional[str] = None,
        path: Optional[str] = None,
        latency_ms: Optional[float] = None,
        queue_wait_ms: Optional[float] = None,
        deadline_ms: Optional[float] = None,
        detail: Optional[str] = None,
    ) -> None:
        """Append one request record; auto-dump when it smells like an
        incident. Call sites gate on their metrics child's ``_on`` flag,
        so a disabled registry skips the whole call."""
        if not self.enabled:
            return
        rec = {
            "ts": round(time.time(), 3),
            "trace_id": trace_id,
            "model": model,
            "path": path,
            "status": int(status),
            "latency_ms": (
                round(latency_ms, 3) if latency_ms is not None else None
            ),
            "queue_wait_ms": (
                round(queue_wait_ms, 3) if queue_wait_ms is not None else None
            ),
            "deadline_ms": deadline_ms,
            "outcome": outcome,
            "detail": detail,
        }
        with self._lock:
            self._buf.append(rec)
            n = len(self._buf)
        if _M_RECORDS._on:
            _M_RECORDS.set(n)
        reason = self._dump_reason(rec)
        if reason is not None:
            # auto-dumps write on a side thread: the recorder is called
            # from reply/routing threads, and a disk write (retention
            # scan + JSON of the whole ring) must not stall serving —
            # incidents are exactly when those threads are busiest. The
            # debounce inside dump() serializes concurrent triggers.
            threading.Thread(
                target=self.dump, args=(reason,),
                name="flightrec-dump", daemon=True,
            ).start()

    def _dump_reason(self, rec: dict) -> Optional[str]:
        if rec["outcome"] in _DUMP_OUTCOMES:
            return f"outcome_{rec['outcome']}"
        if rec["status"] >= 500:
            return "status_5xx"
        lat = rec.get("latency_ms")
        if (
            self.latency_dump_ms is not None
            and lat is not None
            and lat > self.latency_dump_ms
        ):
            return "latency_threshold"
        return None

    # -- inspection ------------------------------------------------------------

    def snapshot(self, outcome: Optional[str] = None) -> list:
        with self._lock:
            recs = list(self._buf)
        if outcome is not None:
            recs = [r for r in recs if r["outcome"] == outcome]
        return recs

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
        if _M_RECORDS._on:
            _M_RECORDS.set(0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    # -- persistence -----------------------------------------------------------

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Write the ring to ``dump_dir`` as one JSON file; returns the
        path, or None when debounced/empty/failed. Manual dumps
        (``reason="manual"``: the /debug/dump and SIGUSR1 paths) skip the
        debounce — an operator asking twice gets two files."""
        now = time.monotonic()
        with self._lock:
            if reason != "manual" and (
                self._last_dump
                and now - self._last_dump < self.min_dump_interval_s
            ):
                self.dumps_suppressed += 1
                return None
            recs = list(self._buf)
            if not recs:
                return None
            self._last_dump = now
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            self._enforce_retention()
            fname = (
                f"flightrec-{time.strftime('%Y%m%d-%H%M%S')}"
                f"-{os.getpid()}-{self.dumps_written}-{reason}.json"
            )
            final = os.path.join(self.dump_dir, fname)
            tmp = final + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "process": tracing.process_label(),
                        "reason": reason,
                        "ts": round(time.time(), 3),
                        "records": recs,
                    },
                    f,
                )
            os.replace(tmp, final)  # a reader never sees a half dump
        except OSError:
            return None  # a broken disk must not take the reply path down
        self.dumps_written += 1
        if REGISTRY._enabled:
            _M_DUMPS.labels(reason=reason).inc()
        return final

    def _enforce_retention(self) -> None:
        """Delete oldest dumps until under the file-count and byte caps
        (with room for the dump about to be written)."""
        try:
            entries = []
            for f in os.listdir(self.dump_dir):
                if f.startswith("flightrec-") and f.endswith(".json"):
                    p = os.path.join(self.dump_dir, f)
                    st = os.stat(p)
                    entries.append((st.st_mtime, st.st_size, p))
            entries.sort()
            total = sum(e[1] for e in entries)
            while entries and (
                len(entries) >= self.max_dumps or total > self.max_bytes
            ):
                mtime, size, p = entries.pop(0)
                os.remove(p)
                total -= size
        except OSError:
            pass


def _env_float(name: str) -> Optional[float]:
    v = os.environ.get(name)
    try:
        return float(v) if v else None
    except ValueError:
        return None


# the process-wide recorder every serving reply path reports into
FLIGHT = FlightRecorder(
    cap=int(os.environ.get("MMLSPARK_FLIGHTREC_CAP", "1024")),
    dump_dir=os.environ.get("MMLSPARK_FLIGHTREC_DIR"),
    latency_dump_ms=_env_float("MMLSPARK_FLIGHTREC_LAT_MS"),
)


def record(outcome: str, **kw: Any) -> None:
    """Module-level convenience: ``FLIGHT.record(...)``."""
    FLIGHT.record(outcome, **kw)


def install_sigusr1() -> bool:
    """SIGUSR1 -> dump the flight recorder (fleet CLI roles call this;
    signal handlers only install from the main thread). Returns whether
    the handler was installed."""
    import signal

    def on_sig(signum: int, frame: Any) -> None:
        path = FLIGHT.dump("sigusr1")
        print(f"flightrec: dumped to {path}", flush=True)

    try:
        signal.signal(signal.SIGUSR1, on_sig)
        return True
    except (ValueError, OSError):  # non-main thread / unsupported platform
        return False
