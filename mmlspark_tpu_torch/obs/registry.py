"""MetricsRegistry: counters, gauges, fixed-bucket histograms; Prometheus
text exposition v0.0.4 and its scrape-side parser.

The PyTorch port's copy of ``mmlspark_tpu.obs.registry`` (stdlib only).

Design constraints, in priority order:

1. Hot-path cost. Serving instruments fire per request; call sites
   pre-resolve label children once (``family.labels(server=name)``) so the
   per-event op is one enabled-check + one locked float add. A disabled
   registry short-circuits before the lock.
2. No dependencies. stdlib only; scraping/aggregation (serving/fleet.py
   ``top``) reuses :func:`parse_text` rather than a client library.
3. Prometheus-compatible output. ``GET /metrics`` on the worker, gateway
   and fleet registry all emit :func:`render`'s text so any standard
   scraper ingests the fleet unchanged.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Iterable, Optional, Sequence

# latency-oriented default: 100 µs .. 10 s (fixed buckets per metric family
# keep scrape output bounded and make cross-worker aggregation exact)
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# size-oriented alternative (batch sizes, queue depths)
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz0123456789_")


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    return "{" + ",".join(
        f'{k}="{_escape(v)}"' for k, v in zip(names, values)
    ) + "}"


class _Family:
    """Shared family machinery: label-child management + one lock.

    An unlabeled family is its own single child; a labeled one lazily
    creates a child per label-value tuple. One lock per family serves both
    child creation and child value ops — serving-level contention on a
    CPython float add is negligible, and it keeps snapshot() consistent.
    """

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labels: Sequence[str]):
        self._reg = registry
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._children: dict[tuple, Any] = {}

    def labels(self, **kv: Any) -> Any:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}"
            )
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def _make_child(self) -> Any:
        raise NotImplementedError

    def remove(self, **kv: Any) -> None:
        """Drop one label child (series lifecycle: e.g. a gateway pruning
        the series of a permanently departed backend). No-op when absent;
        a later ``labels()`` recreates the child at zero (standard
        Prometheus counter-reset semantics, handled by ``rate()``)."""
        key = tuple(str(kv[k]) for k in self.label_names)
        with self._lock:
            self._children.pop(key, None)

    def _read(self) -> list:
        """[(label_values_tuple, payload)] materialized UNDER the family
        lock, so a scrape never sees a torn histogram (counts incremented
        but count not yet — cumulative buckets would exceed +Inf).
        Payload: float for counter/gauge, (counts, sum, count) copies for
        histograms."""
        with self._lock:
            items = (
                sorted(self._children.items()) if self.label_names
                else [((), self)]
            )
            out = []
            for values, child in items:
                if self.kind == "histogram":
                    out.append(
                        (values, (list(child.counts), child.sum, child.count))
                    )
                else:
                    out.append((values, child._value))
            return out

    def reset(self) -> None:
        with self._lock:
            targets = (
                list(self._children.values()) if self.label_names else [self]
            )
        for t in targets:
            t._zero()


class _CounterChild:
    __slots__ = ("_on", "_lock", "_value")

    def __init__(self, registry: "MetricsRegistry", lock: threading.Lock):
        # the enabled flag is CACHED on every child and family
        # (set_enabled walks the registry propagating it). Hot call sites
        # may branch on the pre-bound child's/family's ``_on`` directly to
        # skip a whole instrument bundle with ONE attribute load — that,
        # not per-op checks, is what keeps the serving path's disabled
        # per-request overhead under 1 µs (tests/test_obs.py)
        self._on = registry._enabled
        self._lock = lock
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not self._on:
            return
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value

    def _zero(self) -> None:
        self._value = 0.0


class Counter(_Family, _CounterChild):
    """Monotone counter. ``.inc()`` on the family (unlabeled) or on
    ``.labels(...)`` children."""

    kind = "counter"

    def __init__(self, registry, name, help, labels):
        _Family.__init__(self, registry, name, help, labels)
        _CounterChild.__init__(self, registry, self._lock)

    def _make_child(self) -> _CounterChild:
        return _CounterChild(self._reg, self._lock)

    def inc(self, v: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(f"metric {self.name!r} needs .labels(...)")
        _CounterChild.inc(self, v)


class _GaugeChild:
    __slots__ = ("_on", "_lock", "_value")

    def __init__(self, registry: "MetricsRegistry", lock: threading.Lock):
        self._on = registry._enabled
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._on:
            return
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        if not self._on:
            return
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        return self._value

    def _zero(self) -> None:
        self._value = 0.0


class Gauge(_Family, _GaugeChild):
    kind = "gauge"

    def __init__(self, registry, name, help, labels):
        _Family.__init__(self, registry, name, help, labels)
        _GaugeChild.__init__(self, registry, self._lock)

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild(self._reg, self._lock)


class _HistogramChild:
    __slots__ = ("_on", "_lock", "_bounds", "counts", "sum", "count",
                 "exemplars")

    def __init__(self, registry: "MetricsRegistry", lock: threading.Lock,
                 bounds: Sequence[float]):
        self._on = registry._enabled
        self._lock = lock
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        # per-bucket exemplar: (trace_id, value) of the LAST observation
        # that carried a trace id — the bucket -> real-trace jump table
        # (`fleet traces --slowest`). Lazily allocated: histograms whose
        # call sites never pass a trace id pay nothing.
        self.exemplars: Optional[list] = None

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        if not self._on:
            return
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if trace_id is not None:
                if self.exemplars is None:
                    self.exemplars = [None] * (len(self._bounds) + 1)
                self.exemplars[i] = (trace_id, v)

    def _zero(self) -> None:
        self.counts = [0] * (len(self._bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.exemplars = None


class Histogram(_Family, _HistogramChild):
    """Fixed-bucket histogram (cumulative ``le`` buckets on render)."""

    kind = "histogram"

    def __init__(self, registry, name, help, labels,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        _Family.__init__(self, registry, name, help, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        _HistogramChild.__init__(self, registry, self._lock, self.buckets)

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self._reg, self._lock, self.buckets)

    def exemplar_samples(self) -> list:
        """[{labels, le, trace_id, value}] for every bucket exemplar this
        family holds (materialized under the family lock)."""
        out = []
        with self._lock:
            items = (
                sorted(self._children.items()) if self.label_names
                else [((), self)]
            )
            for values, child in items:
                ex = child.exemplars
                if not ex:
                    continue
                ld = dict(zip(self.label_names, values))
                bounds = list(self.buckets) + [math.inf]
                for b, slot in zip(bounds, ex):
                    if slot is None:
                        continue
                    out.append({
                        "labels": ld,
                        "le": "+Inf" if b == math.inf else _fmt(b),
                        "trace_id": slot[0],
                        "value": slot[1],
                    })
        return out


class MetricsRegistry:
    """Process-wide metric store. Families are get-or-create by name — a
    second registration with the same (type, labels, buckets) returns the
    SAME family, so modules can declare their metrics at import time
    without coordinating; a conflicting re-registration raises."""

    def __init__(self) -> None:
        self._enabled = True
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, on: bool) -> None:
        # propagate to every child's cached flag: the per-event check is
        # then a single attribute load (see _CounterChild)
        on = bool(on)
        self._enabled = on
        for fam in self.families():
            with fam._lock:
                fam._on = on
                for child in fam._children.values():
                    child._on = on

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Sequence[str], **kw: Any) -> Any:
        _validate_name(name)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}"
                    )
                if kw.get("buckets") is not None and tuple(
                    sorted(float(b) for b in kw["buckets"])
                ) != fam.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different buckets"
                    )
                return fam
            fam = (
                cls(self, name, help, labels, buckets=kw["buckets"])
                if kw.get("buckets") is not None
                else cls(self, name, help, labels)
            )
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def families(self) -> list:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def exemplars(self) -> dict:
        """{histogram name: [{labels, le, trace_id, value}]} across the
        registry — only histograms that recorded at least one trace-id
        exemplar appear."""
        out: dict = {}
        for fam in self.families():
            if fam.kind != "histogram":
                continue
            samples = fam.exemplar_samples()
            if samples:
                out[fam.name] = samples
        return out

    def reset(self) -> None:
        for fam in self.families():
            fam.reset()

    # -- snapshot / exposition ------------------------------------------------

    def snapshot(self) -> dict:
        """name -> {kind, help, samples: [(labels_dict, value_or_hist)]}.
        Histogram values are {buckets: [(le, cumulative)], sum, count}."""
        out: dict = {}
        for fam in self.families():
            samples = []
            for values, payload in fam._read():
                ld = dict(zip(fam.label_names, values))
                if fam.kind == "histogram":
                    counts, total, count = payload
                    cum, acc = [], 0
                    for b, c in zip(fam.buckets, counts):
                        acc += c
                        cum.append((b, acc))
                    samples.append((ld, {
                        "buckets": cum, "sum": total, "count": count,
                    }))
                else:
                    samples.append((ld, payload))
            out[fam.name] = {
                "kind": fam.kind, "help": fam.help, "samples": samples,
            }
        return out

    def render(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines: list = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, payload in fam._read():
                ls = _label_str(fam.label_names, values)
                if fam.kind == "histogram":
                    counts, total, count = payload
                    acc = 0
                    for b, c in zip(fam.buckets, counts):
                        acc += c
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_le_labels(fam.label_names, values, _fmt(b))}"
                            f" {acc}"
                        )
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_le_labels(fam.label_names, values, '+Inf')}"
                        f" {count}"
                    )
                    lines.append(f"{fam.name}_sum{ls} {_fmt(total)}")
                    lines.append(f"{fam.name}_count{ls} {count}")
                else:
                    lines.append(f"{fam.name}{ls} {_fmt(payload)}")
        return "\n".join(lines) + "\n"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _le_labels(names: Sequence[str], values: Sequence[str], le: str) -> str:
    return _label_str(tuple(names) + ("le",), tuple(values) + (le,))


def _validate_name(name: str) -> None:
    if not name or not set(name) <= _NAME_OK or name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")


# -- process-wide default registry -------------------------------------------

REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets=buckets)


def render() -> str:
    return REGISTRY.render()


# -- scrape side --------------------------------------------------------------

def parse_text(text: str) -> dict:
    """Parse exposition text -> {(name, ((label, value), ...)): float}.

    The inverse of :func:`render` for the metrics the fleet aggregator
    needs (counters, gauges, histogram _sum/_count/_bucket samples all
    appear under their literal sample names). Label pairs are sorted for
    stable keys."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                labels_part, value_part = rest.rsplit("}", 1)
                labels = []
                for pair in _split_labels(labels_part):
                    k, _, v = pair.partition("=")
                    labels.append((k.strip(), _unescape(v.strip().strip('"'))))
                value = float(value_part.strip())
                out[(name, tuple(sorted(labels)))] = value
            else:
                name, value_part = line.rsplit(None, 1)
                out[(name, ())] = float(value_part)
        except ValueError:
            continue  # scrape must survive a malformed line, not die on it
    return out


def _split_labels(s: str) -> Iterable[str]:
    """Split 'a="x",b="y,z"' on commas OUTSIDE quotes."""
    depth_quote = False
    cur = []
    prev = ""
    for ch in s:
        if ch == '"' and prev != "\\":
            depth_quote = not depth_quote
        if ch == "," and not depth_quote:
            yield "".join(cur)
            cur = []
        else:
            cur.append(ch)
        prev = ch
    if cur:
        yield "".join(cur)


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def sum_samples(parsed: dict, name: str,
                match: Optional[dict] = None) -> float:
    """Sum every sample of ``name`` whose labels include ``match``."""
    want = set((match or {}).items())
    total = 0.0
    for (n, labels), v in parsed.items():
        if n == name and want <= set(labels):
            total += v
    return total
