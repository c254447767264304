"""Adaptive concurrency control: AIMD limit on in-flight serving work.

The PyTorch port's copy of ``mmlspark_tpu.serving.admission`` (host code).

The overload failure mode this exists for: a worker whose queue grows
past its deadline serves *every* request late — goodput collapses to
zero while the server stays "busy". The fix (the Overload-control /
adaptive-concurrency lineage: TCP congestion control applied to RPC
admission) is to bound in-flight work and shed the excess **at ingress**
with a fast 429 + ``Retry-After``, so the requests that are admitted
still meet their deadlines.

:class:`AdmissionController` is shared by
:class:`~mmlspark_tpu_torch.serving.query.ServingQuery` and the modelstore's
:class:`~mmlspark_tpu_torch.serving.modelstore.ModelDispatcher`: the
:class:`~mmlspark_tpu_torch.serving.server.WorkerServer` ingress consults
``try_acquire()`` before enqueuing a request (the shed path costs
microseconds on the asyncio thread) and releases on reply; the dispatch
loops feed ``observe()`` with the queue-wait + service-time samples the
limit adapts on.

The control law is AIMD fed by the queue-wait signal (the same samples
the ``mmlspark_serving_queue_wait_seconds`` histogram records):

- queue wait in the last window above ``wait_factor x`` the service-time
  EWMA (queueing is building faster than the handler drains it) —
  multiplicative decrease, ``limit *= decrease``;
- window healthy — additive increase, ``limit += 1``;
- the limit is clamped to ``[min_limit, max_limit]`` and in-flight work
  above it is shed 429 before it ever queues.

Fault point ``admission.shed`` fires on every admission decision: a
truthy payload forces a shed (chaos-testing the client's 429 handling),
``delay_s`` stalls ingress (a latency fault on the admission path).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from mmlspark_tpu_torch import obs

# canonical request-budget headers (the modelstore dispatcher re-exports
# DEADLINE_HEADER for back-compat; the gateway decrements it per hop)
DEADLINE_HEADER = "x-mmlspark-deadline-ms"
RETRY_BUDGET_HEADER = "x-mmlspark-retry-budget"
SHED_HEADER = "x-mmlspark-shed"

_M_LIMIT = obs.gauge(
    "mmlspark_admission_limit_requests",
    "Current adaptive in-flight limit (AIMD)", labels=("server",),
)
_M_INFLIGHT = obs.gauge(
    "mmlspark_admission_inflight_requests",
    "Requests currently admitted and not yet replied", labels=("server",),
)
_M_SHED = obs.counter(
    "mmlspark_admission_shed_total",
    "Requests shed 429 at ingress by the concurrency limit",
    labels=("server",),
)
_M_DECREASES = obs.counter(
    "mmlspark_admission_limit_decreases_total",
    "Multiplicative-decrease events (overload signals)", labels=("server",),
)


def deadline_ms_from(headers: dict, default: Optional[float] = None,
                     ) -> Optional[float]:
    """Parse ``x-mmlspark-deadline-ms`` out of a header dict; a missing
    or malformed value falls back to ``default`` (None = no deadline)."""
    raw = headers.get(DEADLINE_HEADER)
    if raw is None:
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


class AdmissionController:
    """AIMD limit on in-flight requests for ONE serving worker.

    ``wait_factor``: the overload threshold — a window whose worst queue
    wait exceeds ``wait_factor * svc_ewma`` (but at least
    ``min_target_s``) triggers a multiplicative decrease. The service
    EWMA comes from the same ``observe()`` calls, so the target scales
    with the model actually being served instead of hard-coding a
    millisecond budget that is absurd for one model and lax for another.
    """

    def __init__(
        self,
        server: str = "serving",
        initial_limit: int = 32,
        min_limit: int = 2,
        max_limit: int = 4096,
        decrease: float = 0.7,
        wait_factor: float = 1.5,
        min_target_s: float = 0.002,
        window_samples: int = 16,
        window_s: float = 0.25,
        retry_after_s: float = 1.0,
    ):
        self.server = server
        self.min_limit = max(1, int(min_limit))
        self.max_limit = int(max_limit)
        self.decrease = decrease
        self.wait_factor = wait_factor
        self.min_target_s = min_target_s
        self.window_samples = max(1, int(window_samples))
        self.window_s = window_s
        self.retry_after_s = retry_after_s
        self._lock = threading.Lock()
        self._limit = float(min(max(initial_limit, self.min_limit),
                                self.max_limit))
        self._inflight = 0
        self.shed = 0
        # adjustment window state (guarded by the lock)
        self._svc_ewma_s = 0.0
        self._win_worst_wait_s = 0.0
        self._win_n = 0
        self._win_started = time.monotonic()
        self._m_limit = _M_LIMIT.labels(server=server)
        self._m_inflight = _M_INFLIGHT.labels(server=server)
        self._m_shed = _M_SHED.labels(server=server)
        self._m_decreases = _M_DECREASES.labels(server=server)
        self._m_limit.set(int(self._limit))
        self._m_inflight.set(0)

    # -- admission (ingress thread) ------------------------------------------

    @property
    def limit(self) -> int:
        return int(self._limit)

    @property
    def inflight(self) -> int:
        return self._inflight

    def try_acquire(self) -> bool:
        """One admission slot, or False (the caller sheds 429). The
        ingress calls this once per would-be-queued request."""
        with self._lock:
            if self._inflight >= int(self._limit):
                self.shed += 1
                self._m_shed.inc()
                return False
            self._inflight += 1
            self._m_inflight.set(self._inflight)
            return True

    def release(self) -> None:
        """The admitted request was replied (any status) — free its slot."""
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1
                self._m_inflight.set(self._inflight)

    def force_shed(self) -> None:
        """Count a shed forced from outside the limit check (the
        ``admission.shed`` fault point) with the same locked accounting
        as a real limit shed — counter and metric stay in step."""
        with self._lock:
            self.shed += 1
            self._m_shed.inc()

    # -- the control law (dispatcher threads) --------------------------------

    def observe(self, queue_wait_s: float, service_s: float) -> None:
        """Feed one dispatched request's queue wait + per-request service
        time into the AIMD window; adjusts the limit when the window
        closes (``window_samples`` samples or ``window_s`` elapsed)."""
        now = time.monotonic()
        with self._lock:
            a = 0.2
            self._svc_ewma_s = (
                service_s if self._svc_ewma_s <= 0.0
                else (1 - a) * self._svc_ewma_s + a * service_s
            )
            if queue_wait_s > self._win_worst_wait_s:
                self._win_worst_wait_s = queue_wait_s
            self._win_n += 1
            if (
                self._win_n < self.window_samples
                and now - self._win_started < self.window_s
            ):
                return
            target_s = max(
                self.min_target_s, self.wait_factor * self._svc_ewma_s
            )
            if self._win_worst_wait_s > target_s:
                self._limit = max(
                    float(self.min_limit), self._limit * self.decrease
                )
                self._m_decreases.inc()
            else:
                self._limit = min(float(self.max_limit), self._limit + 1.0)
            self._m_limit.set(int(self._limit))
            self._win_worst_wait_s = 0.0
            self._win_n = 0
            self._win_started = now

    # -- the shed reply ------------------------------------------------------

    def shed_headers(self) -> dict:
        return {
            "Retry-After": str(max(1, int(round(self.retry_after_s)))),
            SHED_HEADER: "admission",
            "Content-Type": "application/json",
        }
