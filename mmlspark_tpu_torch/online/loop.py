"""OnlineLearningLoop: the control loop of the continuous-learning
subsystem.

One background thread: poll the :class:`FeedbackStream` for micro-
batches, fold each into the :class:`OnlineTrainer` (device-resident
state), and every ``publish_every_s`` (when new examples arrived) drive
the :class:`Publisher` through the zero-drop load -> warm -> swap path.

Freshness accounting: the loop tracks the OLDEST ingest timestamp among
examples trained since the last successful publication (the watermark).
A publication's freshness is ``servable_time - watermark`` — the worst
example's wait. A FAILED publication keeps the watermark (those
examples are still unserved), so freshness honestly degrades while
publication is broken and the SLO burn pages — the loop retries at the
next due time rather than crashing.

The loop optionally runs its own
:class:`~mmlspark_tpu_torch.obs.slo.SLOEngine` over the process registry with
the :func:`~mmlspark_tpu_torch.obs.slo.freshness_target`, so any process
hosting a loop exports ``mmlspark_slo_*`` burn gauges for the freshness
objective (``fleet online`` wires this up; the deploy smoke's freshness
gate reads them).

The PyTorch port's copy of ``mmlspark_tpu.online.loop``: host code. The
trainer and the publisher run on the loop's one thread, so a snapshot
never races a step; on the card the trainer's state stays resident.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Callable, Optional

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.online.publisher import PublishError

_M_LOOP_TICKS = obs.counter(
    "mmlspark_online_loop_ticks_total", "Control-loop iterations",
)
_M_PENDING = obs.gauge(
    "mmlspark_online_pending_examples_count",
    "Examples trained but not yet covered by a successful publication",
)
_M_POISONED = obs.counter(
    "mmlspark_online_poisoned_examples_total",
    "Examples in poison chunks discarded after repeated train-step "
    "failures — accounted, never silently lost (chaos/invariants.py)",
)


class OnlineLearningLoop:
    def __init__(
        self,
        stream: Any,
        trainer: Any,
        publisher: Any,
        publish_every_s: float = 2.0,
        min_publish_examples: int = 1,
        poll_s: float = 0.25,
        freshness_budget_ms: Optional[float] = None,
        slo_interval_s: float = 15.0,
        time_fn: Callable[[], float] = time.monotonic,
    ):
        """``freshness_budget_ms``: when set, the loop starts an SLO
        engine evaluating the freshness target against this budget (None
        = the caller owns SLO evaluation)."""
        self.stream = stream
        self.trainer = trainer
        self.publisher = publisher
        self.publish_every_s = float(publish_every_s)
        self.min_publish_examples = max(1, int(min_publish_examples))
        self.poll_s = poll_s
        self.freshness_budget_ms = freshness_budget_ms
        self.slo_interval_s = slo_interval_s
        self._now = time_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.slo_engine: Any = None
        # freshness watermark state
        self._pending_oldest_ts: Optional[float] = None
        self._pending_examples = 0
        self._last_publish_t = 0.0
        self.publish_results: list = []  # successful publish() returns
        # poison-chunk escape: a chunk whose step fails this many times
        # CONSECUTIVELY is discarded (acked away) instead of retried
        # forever — one bad chunk must not head-of-line-block the loop
        self.max_step_retries = 3
        self._step_failures = 0
        self.poisoned_chunks = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "OnlineLearningLoop":
        if self.freshness_budget_ms is not None:
            from mmlspark_tpu_torch.obs import slo

            self.slo_engine = slo.SLOEngine(
                [slo.freshness_target(budget_ms=self.freshness_budget_ms)],
                interval_s=self.slo_interval_s,
            ).start()
        self._last_publish_t = self._now()
        self._thread = threading.Thread(
            target=self._run, name="online-loop", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_publish: bool = False) -> None:
        """Stop the loop; ``final_publish=True`` flushes any pending
        examples into one last publication before returning."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10.0)
        if final_publish and self._pending_examples >= 1:
            try:
                self._publish()
            except PublishError:
                pass
        if self.slo_engine is not None:
            self.slo_engine.stop()

    # -- the loop ------------------------------------------------------------

    def _publish(self) -> None:
        res = self.publisher.publish(
            self.trainer, oldest_ts=self._pending_oldest_ts
        )
        self.publish_results.append(res)
        self._pending_oldest_ts = None
        self._pending_examples = 0
        _M_PENDING.set(0)

    def _tick(self) -> None:
        item = self.stream.poll(self.poll_s)
        if item is not None:
            ts, chunk = item
            try:
                trained = self.trainer.step(chunk)
                self._step_failures = 0
            except BaseException:
                self._step_failures += 1
                if self._step_failures >= self.max_step_retries:
                    # poison chunk: discard (ack so the spill truncates)
                    # rather than hot-retry it forever while everything
                    # behind it goes stale
                    self._step_failures = 0
                    self.poisoned_chunks += 1
                    _M_POISONED.inc(len(chunk))
                    ack = getattr(self.stream, "ack_trained", None)
                    if ack is not None:
                        ack()
                    print(
                        f"online: dropping poison chunk after "
                        f"{self.max_step_retries} failed train steps",
                        file=sys.stderr, flush=True,
                    )
                else:
                    # a transiently-failed step did NOT consume the
                    # chunk: requeue it (retried next tick) so a later
                    # success's ack cannot silently truncate it
                    nack = getattr(self.stream, "nack_failed", None)
                    if nack is not None:
                        nack()
                raise
            # the step succeeded: confirm the spill (disk-backed streams
            # truncate their chunk log; a crash BEFORE this point replays
            # the chunk on restart — no feedback loss)
            ack = getattr(self.stream, "ack_trained", None)
            if ack is not None:
                ack()
            if trained:
                if self._pending_oldest_ts is None or ts < self._pending_oldest_ts:
                    self._pending_oldest_ts = ts
                self._pending_examples += trained
                _M_PENDING.set(self._pending_examples)
        now = self._now()
        if (
            self._pending_examples >= self.min_publish_examples
            and now - self._last_publish_t >= self.publish_every_s
        ):
            self._last_publish_t = now  # back off a full interval on failure
            try:
                self._publish()
            except PublishError as e:
                # the watermark survives: those examples are still not
                # servable, so the NEXT successful publish's freshness
                # includes the outage — the burn rate tells the truth
                print(f"online: publish failed: {e}", file=sys.stderr,
                      flush=True)
        _M_LOOP_TICKS.inc()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the loop must outlive a tick
                print(f"online: tick failed: {e}", file=sys.stderr, flush=True)
                self._stop.wait(self.poll_s)

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        return {
            "examples": self.trainer.examples,
            "batches": self.trainer.batches,
            "publishes": self.publisher.publishes,
            "publish_failures": self.publisher.failures,
            "pending_examples": self._pending_examples,
            "last_freshness_s": self.publisher.last_freshness_s,
            "freshness_history_s": list(self.publisher.freshness_history),
            "buffered_chunks": self.stream.depth(),
            "dropped_chunks": self.stream.dropped,
        }


__all__ = ["OnlineLearningLoop"]
