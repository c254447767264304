"""Always-on wall-clock sampling profiler — "what is every thread doing".

The PyTorch port's copy of ``mmlspark_tpu.obs.prof`` (stdlib only).

Metrics say *that* something is slow and spans say *where one request*
spent its time; neither answers "what was this process standing in when
it wedged". A stdlib-only daemon thread samples ``sys._current_frames()``
at a configurable rate (default 19 Hz — deliberately co-prime with 1 Hz
and 10 Hz periodic work so the sampler never phase-locks onto a timer
loop) and aggregates per-thread **collapsed flame stacks** in a bounded
dict: ``thread;frame;frame;... count`` lines, directly feedable to any
flamegraph renderer.

Exposure:

- ``GET /profile`` on every instrumented ingress (WorkerServer — which
  is also the gateway's and the trainer's artifact ingress — and the
  serving registry) returns the collapsed-stack text and **starts the
  sampler on first scrape** if the process didn't already;
  ``fleet profile <role|url> [--seconds N]`` diffs two scrapes N seconds
  apart and merges the window across processes into one fleet view.
- ``GET /debug/threads`` returns an instant all-thread dump (JSON) —
  no sampler needed, one ``sys._current_frames()`` walk.
- :func:`collapsed_now` / :func:`threads_payload` are the in-process
  halves the hang watchdog (obs/watchdog.py) embeds into stall dumps.

Exported metrics (``tools/lint_metric_names.py`` family ``prof``):
``mmlspark_prof_samples_total`` (sampling passes taken),
``mmlspark_prof_drops_total{reason}`` (``overflow``: distinct stacks
beyond the per-thread bound collapse into an overflow bucket;
``behind``: sampler overslept more than one period and skipped ticks),
``mmlspark_prof_overhead_ratio`` (EWMA fraction of wall time spent
inside the sampling pass — the smoke test's sampler-overhead gate reads
this gauge).

Env knobs: ``MMLSPARK_PROF_HZ`` (default 19; ``0`` disables
:func:`ensure_started`), ``MMLSPARK_PROF_MAX_STACKS`` (distinct
collapsed stacks kept per thread, default 512).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from mmlspark_tpu_torch.obs import tracing
from mmlspark_tpu_torch.obs.registry import counter, gauge

_M_SAMPLES = counter(
    "mmlspark_prof_samples_total",
    "Sampling-profiler passes over sys._current_frames()",
)
_M_DROPS = counter(
    "mmlspark_prof_drops_total",
    "Profiler data dropped (overflow: stack dict at bound; behind: "
    "sampler overslept and skipped ticks)", labels=("reason",),
)
_M_OVERHEAD = gauge(
    "mmlspark_prof_overhead_ratio",
    "EWMA fraction of wall time the sampling pass consumes "
    "(the smoke probe's sampler-overhead bound reads this)",
)

DEFAULT_HZ = 19.0
_OVERFLOW_KEY = "<overflow>"


def _frame_key(frame: Any) -> str:
    """One collapsed-stack element: ``file:function``. No line numbers —
    a hot loop would otherwise mint one stack per line it was caught on
    and blow the bound with near-duplicates (the instant dump keeps
    lines; aggregation wants the function)."""
    co = frame.f_code
    return f"{os.path.basename(co.co_filename)}:{co.co_name}"


def _collapse(frame: Any, limit: int = 64) -> str:
    """Root-first semicolon-joined frames of one thread's stack."""
    parts: list = []
    depth = 0
    while frame is not None and depth < limit:
        parts.append(_frame_key(frame))
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts)


def _thread_names() -> Dict[int, str]:
    return {t.ident: t.name for t in threading.enumerate() if t.ident}


def threads_payload() -> dict:
    """Instant all-thread dump: every live thread's full stack with line
    numbers (``GET /debug/threads``; also embedded in watchdog stall
    dumps). Pure ``sys._current_frames()`` — works with the sampler off.
    """
    names = _thread_names()
    threads = []
    for ident, frame in sys._current_frames().items():
        stack: list = []
        f = frame
        depth = 0
        while f is not None and depth < 128:
            co = f.f_code
            stack.append(f"{co.co_filename}:{f.f_lineno} {co.co_name}")
            f = f.f_back
            depth += 1
        stack.reverse()
        threads.append({
            "ident": ident,
            "name": names.get(ident, f"thread-{ident}"),
            "stack": stack,
            "collapsed": _collapse(frame),
        })
    threads.sort(key=lambda t: t["name"])
    return {
        "process": tracing.process_label(),
        "ts": round(time.time(), 3),
        "threads": threads,
    }


def collapsed_now() -> str:
    """One instantaneous collapsed-stack line per live thread (count 1)
    — the zero-state fallback the watchdog embeds when a process wedges
    before its sampler accumulated anything."""
    payload = threads_payload()
    return "".join(
        f"{t['name']};{t['collapsed']} 1\n" for t in payload["threads"]
    )


class SamplingProfiler:
    """Daemon-thread wall-clock sampler with bounded per-thread stacks."""

    def __init__(
        self, hz: Optional[float] = None, max_stacks: Optional[int] = None
    ):
        env_hz = os.environ.get("MMLSPARK_PROF_HZ")
        self.hz = float(hz if hz is not None else (env_hz or DEFAULT_HZ))
        self.max_stacks = int(
            max_stacks
            if max_stacks is not None
            else os.environ.get("MMLSPARK_PROF_MAX_STACKS", "512")
        )
        self._lock = threading.Lock()
        # {thread_name: {collapsed_stack: count}} — thread NAME, not
        # ident: a respawned worker thread keeps aggregating into the
        # same flame rather than minting a dead twin per incarnation
        self._stacks: Dict[str, Dict[str, int]] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.samples = 0
        self.started_at = 0.0
        self._overhead_ewma = 0.0

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "SamplingProfiler":
        with self._lock:
            if self.running or self.hz <= 0:
                return self
            self._stop.clear()
            self.started_at = time.monotonic()
            self._thread = threading.Thread(
                target=self._loop, name="mmlspark-prof-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(2.0)
        self._thread = None

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self.samples = 0

    # -- sampling ------------------------------------------------------------

    def _loop(self) -> None:
        period = 1.0 / self.hz
        me = threading.get_ident()
        next_at = time.monotonic()
        while not self._stop.is_set():
            next_at += period
            now = time.monotonic()
            if now < next_at:
                if self._stop.wait(next_at - now):
                    return
            elif now - next_at > period:
                # overslept a whole period (GIL starvation, suspend):
                # skip the missed ticks rather than burst-sample —
                # bursts would over-weight whatever starved us
                missed = int((now - next_at) / period)
                next_at += missed * period
                if _M_DROPS._on:
                    _M_DROPS.labels(reason="behind").inc(missed)
            t0 = time.perf_counter()
            self._sample_once(me)
            cost = time.perf_counter() - t0
            # EWMA of (time sampling) / (period): the steady-state
            # fraction of one core this profiler burns
            self._overhead_ewma = (
                0.95 * self._overhead_ewma + 0.05 * (cost / period)
            )
            if _M_OVERHEAD._on:
                _M_OVERHEAD.set(round(self._overhead_ewma, 6))

    def _sample_once(self, skip_ident: int) -> None:
        names = _thread_names()
        frames = sys._current_frames()
        with self._lock:
            self.samples += 1
            for ident, frame in frames.items():
                if ident == skip_ident:
                    continue  # the sampler never profiles itself
                tname = names.get(ident, f"thread-{ident}")
                per = self._stacks.get(tname)
                if per is None:
                    per = self._stacks[tname] = {}
                key = _collapse(frame)
                if key in per or len(per) < self.max_stacks:
                    per[key] = per.get(key, 0) + 1
                else:
                    # bound hit: new distinct stacks fold into one
                    # overflow bucket instead of growing without limit
                    per[_OVERFLOW_KEY] = per.get(_OVERFLOW_KEY, 0) + 1
                    if _M_DROPS._on:
                        _M_DROPS.labels(reason="overflow").inc()
        if _M_SAMPLES._on:
            _M_SAMPLES.inc()

    # -- exposition ----------------------------------------------------------

    def collapsed(self) -> str:
        """Flamegraph-ready collapsed-stack text: one
        ``thread;frame;...;frame count`` line per (thread, stack)."""
        with self._lock:
            snap = {t: dict(per) for t, per in self._stacks.items()}
        lines = []
        for tname in sorted(snap):
            for stack, n in sorted(snap[tname].items()):
                lines.append(f"{tname};{stack} {n}\n")
        return "".join(lines)

    def profile_payload(self) -> str:
        """The ``GET /profile`` body: a comment header (process, rate,
        sample count, overhead — ``#``-prefixed, ignored by flamegraph
        tooling) followed by the collapsed stacks."""
        head = (
            f"# process: {tracing.process_label()}\n"
            f"# hz: {self.hz:g}\n"
            f"# samples: {self.samples}\n"
            f"# running: {str(self.running).lower()}\n"
            f"# overhead_ratio: {self._overhead_ewma:.6f}\n"
        )
        return head + self.collapsed()


# the process-wide sampler every /profile ingress serves from
PROFILER = SamplingProfiler()


def ensure_started() -> SamplingProfiler:
    """Start the process sampler if it isn't running (fleet roles call
    this at boot; ``GET /profile`` calls it on first scrape so even a
    process booted without it starts accumulating the moment someone
    looks). ``MMLSPARK_PROF_HZ=0`` disables."""
    if not PROFILER.running:
        PROFILER.start()
    return PROFILER


def parse_collapsed(text: str) -> Dict[str, int]:
    """Parse collapsed-stack text back to ``{stack_line: count}`` —
    ``fleet profile``'s scrape-side half (comment lines skipped)."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        stack, _, n = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(n)
        except ValueError:
            continue
    return out


def merge_collapsed(per_process: Dict[str, Dict[str, int]]) -> str:
    """Merge per-process ``{stack: count}`` maps into one fleet-wide
    collapsed view, each stack prefixed with its process name so one
    flamegraph shows which process owns which flame."""
    lines = []
    for proc in sorted(per_process):
        for stack, n in sorted(per_process[proc].items()):
            lines.append(f"{proc};{stack} {n}\n")
    return "".join(lines)


__all__ = [
    "DEFAULT_HZ",
    "PROFILER",
    "SamplingProfiler",
    "collapsed_now",
    "ensure_started",
    "merge_collapsed",
    "parse_collapsed",
    "threads_payload",
]
