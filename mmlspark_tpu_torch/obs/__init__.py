"""Runtime telemetry: metrics registry, span tracing, Prometheus exposition.

The PyTorch port's copy of ``mmlspark_tpu.obs``, with its two core modules
only: :mod:`registry` (counters, gauges, fixed-bucket histograms; snapshot
and Prometheus text exposition v0.0.4) and :mod:`tracing` (host spans with
trace-id propagation; each span also enters
``torch.profiler.record_function``, so host spans nest into a trace of the
card), and the three modules serving imports: :mod:`flightrec` (the ring
of recent request records), :mod:`prof` (the sampling profiler behind
``GET /profile``) and :mod:`watchdog` (stall dumps). SLOs and the trace
collector are still to come (ROADMAP.md, Queue A item 7, step 2).

Metric names follow ``mmlspark_<subsystem>_<name>_<unit>``, as in the JAX
package. Hot-path contract: every instrument op on a disabled registry
(:func:`set_enabled`\\ (False)) returns after one attribute read.
"""

from mmlspark_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    counter,
    gauge,
    histogram,
    parse_text,
    render,
    sum_samples,
)
from mmlspark_tpu_torch.obs.tracing import (
    BUFFER,
    PARENT_HEADER,
    Span,
    SpanBuffer,
    TRACE_HEADER,
    clear_recent_spans,
    current_trace_id,
    new_span_id,
    new_trace_id,
    process_label,
    recent_spans,
    record_span,
    render_traces,
    set_process_label,
    span,
    traces_payload,
)


def set_enabled(on: bool) -> None:
    """Enable/disable the process-wide default registry (and with it span
    recording)."""
    REGISTRY.enabled = bool(on)


def enabled() -> bool:
    return REGISTRY.enabled


def reset() -> None:
    """Zero every metric in the default registry IN PLACE (children stay
    bound — call sites pre-resolve label children for hot-path speed) and
    drop recorded spans, flight records, profiler aggregates and watchdog
    counters. Test isolation helper."""
    import sys as _sys

    from mmlspark_tpu_torch.obs import flightrec

    REGISTRY.reset()
    clear_recent_spans()
    flightrec.FLIGHT.clear()
    # prof/watchdog state only if those modules were actually imported —
    # reset() must not drag them (and core.faults) into every test
    prof_mod = _sys.modules.get("mmlspark_tpu_torch.obs.prof")
    if prof_mod is not None:
        prof_mod.PROFILER.reset()
    wd_mod = _sys.modules.get("mmlspark_tpu_torch.obs.watchdog")
    if wd_mod is not None:
        wd_mod.WATCHDOG.reset()


__all__ = [
    "BUFFER",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PARENT_HEADER",
    "REGISTRY",
    "Span",
    "SpanBuffer",
    "TRACE_HEADER",
    "clear_recent_spans",
    "counter",
    "current_trace_id",
    "enabled",
    "gauge",
    "histogram",
    "new_span_id",
    "new_trace_id",
    "parse_text",
    "process_label",
    "recent_spans",
    "record_span",
    "render",
    "render_traces",
    "reset",
    "set_enabled",
    "set_process_label",
    "span",
    "sum_samples",
    "traces_payload",
]
