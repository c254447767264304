"""Deterministic fault injection: named points, seeded schedules.

The PyTorch port's copy of ``mmlspark_tpu.core.faults`` (it imports only
``obs``): every fire is counted on ``mmlspark_faults_injected_total`` and
recorded in the flight recorder (``obs/flightrec.py``). Of the injection
points below the port wires ``parallel.barrier``, ``modelstore.load``,
``modelstore.swap``, ``admission.shed``, ``publish.fence`` and
``obs.watchdog_dump`` so far; the others come with their modules.

The reference leans on Spark for fault tolerance (barrier execution,
uncommitted-epoch replay, ``FaultToleranceUtils.retryWithTimeout``); the
TPU rebuild proves its recovery machinery works by *injecting* the
failures those mechanisms exist for. A :class:`FaultPlan` maps named
injection points to error/latency/payload schedules; production code
calls :func:`inject` at each point unconditionally (a no-op costing one
attribute read when no plan is armed).

Injection points wired into the framework (see docs/robustness.md):

========================  ====================================================
point                     fires inside
========================  ====================================================
``io.send_request``       io/clients.send_request — network errors become
                          status-0 rows, int payloads become that HTTP status
``gateway.forward``       serving/distributed.ServingGateway pre-send — an
                          OSError here looks like a worker that died before
                          the request was delivered (re-dispatch path)
``gateway.response``      ServingGateway post-send — a TimeoutError here
                          looks like a worker hanging mid-execution
                          (at-most-once 504 path)
``parallel.barrier``      parallel/distributed.barrier — latency simulates a
                          slow/dead host for the timeout diagnostics
``gbdt.round``            models/gbdt/train.py round boundary — a
                          :class:`Preempted` here simulates host preemption
                          between boosting rounds (checkpoint/resume path)
``modelstore.load``       serving/modelstore/store.py before the loader runs
                          — latency is a slow deserialize (background loads
                          must keep serving through it), an error a corrupt
                          model artifact
``modelstore.swap``       serving/modelstore/store.py before the alias flip —
                          latency stalls only the control op while traffic
                          keeps serving the old version (the zero-downtime
                          hot-swap property the chaos suite asserts)
``admission.shed``        serving/server.py ingress admission check — a
                          truthy payload forces a 429 shed (chaos for the
                          client's Retry-After handling), delay stalls
                          admission itself
``gateway.hedge``         serving/distributed.py as a tail hedge launches —
                          an error suppresses the duplicate (the primary
                          must still win eventually)
``supervisor.restart``    serving/supervisor.py before a worker respawn —
                          an error is "the scheduler refused", retried next
                          tick; delay simulates slow node allocation
``online.ingest``         online/feedback.py per accepted micro-batch — an
                          error refuses the chunk (HTTP ingest answers 503,
                          nothing buffered), delay stalls intake
``online.publish``        online/publisher.py before the snapshot is written
                          — an error aborts the whole publication (alias
                          untouched: the rollback path), delay stalls only
                          the control path while serving continues
``autoscaler.scale``      serving/supervisor.py as an autoscale decision is
                          about to be applied — an error suppresses that
                          scale event ("the scheduler refused", retried
                          next tick), delay stalls it
``elastic.detect``        parallel/elastic.py GangContext.on_round detection
                          check — a string payload names a member to declare
                          lost WITHOUT killing anything (drives the whole
                          reshard path as chaos), an error is the detector
                          itself failing
``elastic.reshard``       parallel/elastic.py as the new-generation commit is
                          attempted — an error is "the commit refused",
                          retried each heartbeat until the plan relents
``train.round_abort``     parallel/elastic.py as an in-flight round is
                          abandoned after a gang change — delay stalls the
                          abort -> reshard turnaround (visible in recovery
                          timings), an error kills the trainer (the
                          supervisor-restart recovery path)
``artifact.put``          serving/artifacts.py before an artifact is stored
                          — an error is a refused push (producers degrade
                          to shared-dir semantics or retry)
``artifact.fetch``        serving/artifacts.py per transfer attempt — an
                          error fails that peer (failover), delay is a slow
                          network; a mid-stream death leaves a partial the
                          next attempt resumes by Range
``artifact.verify``       serving/artifacts.py as a local blob is hash-
                          checked — a truthy payload forces the failure
                          verdict (quarantine + re-fetch-elsewhere path)
                          without corrupting anything
``registry.commit_cas``   serving/registry.py as a generation CAS commit is
                          evaluated — an error refuses the commit (503, a
                          missing ack toward the caller's quorum), delay
                          stalls the commit endpoint
``elastic.park``          parallel/elastic.py as a member parks (lost the
                          registry quorum or the generation CAS) — delay
                          stalls the stop-training transition, an error
                          kills the trainer mid-park
``publish.fence``         serving/modelstore/dispatch.py as a stale-epoch
                          publication is refused — delay stalls the 409,
                          an error kills the control op instead of
                          answering (the publisher retry path)
``obs.watchdog_dump``     obs/watchdog.py as a stall dump is about to be
                          spooled — an error is a failed dump write (the
                          stall is still counted: losing the forensics
                          must never lose the signal), delay stalls only
                          the dump, not the monitor
========================  ====================================================

Schedules are **seeded and step-indexed**: a rule fires by absolute step
index (``at=(5,)``), by stride (``after=/every=``), or by a Bernoulli
draw whose rng is keyed on ``(seed, point, step)`` — the same plan
replays the same failures, so chaos tests are reproducible bit-for-bit.
"""

from __future__ import annotations

import contextlib
import json
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from mmlspark_tpu_torch import obs

# chaos observability: every fire is counted, so a live fleet under an
# armed plan shows its injected faults on /metrics and chaos tests can
# assert schedule counts == observed counts (tests/test_obs.py)
_M_INJECTED = obs.counter(
    "mmlspark_faults_injected_total",
    "Faults fired by the armed FaultPlan, by injection point",
    labels=("point",),
)


class FaultError(Exception):
    """Base class for errors whose only cause is an armed FaultPlan."""


class Preempted(FaultError):
    """Injected host preemption (the SIGTERM/spot-reclaim analogue)."""


# error specs resolvable from JSON plans (tools/deploy smoke --fault-plan)
_ERROR_NAMES = {
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "TimeoutError": TimeoutError,
    "OSError": OSError,
    "Preempted": Preempted,
    "FaultError": FaultError,
}


@dataclass
class FaultRule:
    """One scheduled fault at one injection point.

    ``error`` — exception instance or class raised when the rule fires;
    ``delay_s`` — sleep before erroring/returning (hang/slow-host sim);
    ``payload`` — returned to the injection site when no error is set
    (sites interpret it, e.g. an int HTTP status for ``io.send_request``);
    ``at`` — fire exactly at these step indices; otherwise ``after``/
    ``every`` stride. ``probability`` thins eligible steps with a draw
    seeded on (plan seed, point, step). ``max_fires`` caps total fires.
    """

    error: Any = None
    delay_s: float = 0.0
    payload: Any = None
    at: Optional[frozenset] = None
    after: int = 0
    every: int = 1
    probability: float = 1.0
    max_fires: int = -1
    fired: int = 0

    def matches(self, step: int, seed: int, point: str) -> bool:
        if self.max_fires >= 0 and self.fired >= self.max_fires:
            return False
        if self.at is not None:
            if step not in self.at:
                return False
        else:
            if step < self.after or (step - self.after) % max(self.every, 1):
                return False
        if self.probability >= 1.0:
            return True
        # deterministic per (seed, point, step): replaying the plan
        # replays the exact same failure schedule
        return (
            random.Random(f"{seed}:{point}:{step}").random() < self.probability
        )

    def raise_or_payload(self) -> Any:
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        if self.error is not None:
            e = self.error
            if isinstance(e, type):
                e = e(f"injected fault (fire #{self.fired})")
            raise e
        return self.payload if self.payload is not None else True


class FaultPlan:
    """A process-global registry of named injection points -> schedules.

    >>> plan = FaultPlan(seed=7).on("gbdt.round", at=(5,), error=Preempted)
    >>> with plan.armed():
    ...     train(...)  # raises Preempted entering round 5
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rules: dict[str, list[FaultRule]] = {}
        self._hits: dict[str, int] = {}
        self._lock = threading.Lock()
        self.log: list[tuple[str, int]] = []  # (point, step) of every fire

    def on(
        self,
        point: str,
        *,
        error: Any = None,
        delay_s: float = 0.0,
        payload: Any = None,
        at: Optional[tuple] = None,
        after: int = 0,
        every: int = 1,
        probability: float = 1.0,
        max_fires: int = -1,
    ) -> "FaultPlan":
        if isinstance(error, str):
            # resolve JSON-plan error names EAGERLY: a typo'd name must
            # fail the plan load, not surface as a mystery FaultError from
            # inside the injected call site
            if error not in _ERROR_NAMES:
                raise ValueError(
                    f"unknown fault error name {error!r}; known: "
                    f"{sorted(_ERROR_NAMES)}"
                )
            error = _ERROR_NAMES[error]
        self._rules.setdefault(point, []).append(
            FaultRule(
                error=error, delay_s=delay_s, payload=payload,
                at=frozenset(at) if at is not None else None,
                after=after, every=every, probability=probability,
                max_fires=max_fires,
            )
        )
        return self

    def points(self) -> list:
        return sorted(self._rules)

    def rules(self, point: str) -> list:
        """The :class:`FaultRule` list installed at ``point`` (a copy —
        callers inspect schedules, e.g. the smoke containment gate
        deciding whether a plan guarantees a breaker-tripping burst)."""
        return list(self._rules.get(point, ()))

    def fires(self, point: Optional[str] = None) -> list:
        with self._lock:
            return [f for f in self.log if point is None or f[0] == point]

    # -- the hot path ---------------------------------------------------------

    def check(self, point: str, step: Optional[int] = None) -> Any:
        """Called by :func:`inject` for the armed plan. Returns the firing
        rule's payload (or raises its error); None when nothing fires.

        The rule's delay/raise runs OUTSIDE the plan lock — an injected
        hang must stall only the injected call site, not every other
        thread consulting the plan."""
        rules = self._rules.get(point)
        if not rules:
            return None
        with self._lock:
            idx = self._hits.get(point, 0)
            self._hits[point] = idx + 1
            s = idx if step is None else step
            fire = None
            for rule in rules:
                if rule.matches(s, self.seed, point):
                    rule.fired += 1
                    self.log.append((point, s))
                    fire = rule
                    break
        if fire is None:
            return None
        _M_INJECTED.labels(point=point).inc()
        # every fire also lands in the flight recorder, so a post-incident
        # dump shows the injected faults interleaved with the requests
        # they broke — and the chaos smoke can gate recorded == injected
        from mmlspark_tpu_torch.obs import flightrec

        flightrec.record("fault", path=point, detail=f"step={s}")
        return fire.raise_or_payload()

    # -- arming ---------------------------------------------------------------

    def install(self) -> "FaultPlan":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    @contextlib.contextmanager
    def armed(self) -> Iterator["FaultPlan"]:
        self.install()
        try:
            yield self
        finally:
            self.uninstall()

    # -- JSON round-trip (docker-compose / CLI chaos smoke) -------------------

    @staticmethod
    def from_spec(spec: Any) -> "FaultPlan":
        """Build a plan from a dict / JSON string / path to a JSON file::

            {"seed": 0, "rules": [
              {"point": "io.send_request", "error": "ConnectionError",
               "at": [2, 5]},
              {"point": "io.send_request", "payload": 503,
               "probability": 0.2}]}
        """
        if isinstance(spec, str):
            s = spec.strip()
            if not s.startswith("{"):
                with open(spec) as f:
                    s = f.read()
            spec = json.loads(s)
        plan = FaultPlan(seed=int(spec.get("seed", 0)))
        for r in spec.get("rules", ()):
            r = dict(r)
            point = r.pop("point")
            if "at" in r and r["at"] is not None:
                r["at"] = tuple(r["at"])
            plan.on(point, **r)
        return plan


_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def install(plan: FaultPlan) -> FaultPlan:
    return plan.install()


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def inject(point: str, step: Optional[int] = None, context: Any = None) -> Any:
    """The hook production code calls at a named injection point.

    No plan armed: returns None at the cost of one global read — safe to
    leave in hot paths. Plan armed: consults the point's schedule; may
    sleep (latency fault), raise (error fault), or return the rule's
    payload for the site to interpret. ``step`` pins schedule indexing to
    a domain counter (e.g. boosting round); otherwise each call at the
    point advances a per-point hit counter. ``context`` is unused by the
    scheduler but keeps call sites self-describing."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.check(point, step=step)
