"""Profiling and tracing: the port of ``mmlspark_tpu.core.profiling``.

- :func:`trace` captures a ``torch.profiler`` trace of the host and the
  card (CPU and CUDA activities) and writes it as a Chrome trace under
  ``log_dir`` (viewable in Perfetto or ``chrome://tracing``), where the
  JAX package wraps ``jax.profiler.trace``.
- :func:`annotate` marks a host span that nests into that trace
  (``torch.profiler.record_function``).
- :class:`ProfiledRun` times each stage of a pipeline transform through
  ``obs.span`` and :func:`device_phase`, so each stage lands in the
  metrics registry as ``mmlspark_trace_span_seconds{span="pipeline.<Stage>"}``
  and in any active trace.

:func:`device_phase`'s one counter splits where time goes across the compiled-pipeline path:
``phase=compile`` (a fused segment's first call per bucket: on the card,
the warm-up and the CUDA graph capture), ``phase=execute`` (graph replays
or eager runs), by pipeline stage / fused segment. On the card a phase is
bracketed with CUDA events on the current stream and its device time is
counted; on the CPU its wall time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core.dataframe import DataFrame

_M_DEVICE_SECONDS = obs.counter(
    "mmlspark_device_seconds_total",
    "Seconds at the compile/execute boundaries, by phase and pipeline "
    "stage / fused segment (CUDA-event time on the card, wall time on "
    "the CPU)",
    labels=("phase", "stage"),
)


@contextlib.contextmanager
def device_phase(phase: str, stage: str,
                 device: Optional[torch.device] = None) -> Iterator[None]:
    """Attribute the time of a compile/execute boundary to
    ``mmlspark_device_seconds_total{phase,stage}``. Near-free when the
    registry is disabled (one attribute read). With a CUDA ``device`` the
    phase is bracketed by two CUDA events and the reading waits for the
    second."""
    if not _M_DEVICE_SECONDS._on:
        yield
        return
    if device is not None and device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            end.synchronize()
            _M_DEVICE_SECONDS.labels(phase=phase, stage=stage).inc(
                start.elapsed_time(end) / 1e3)
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _M_DEVICE_SECONDS.labels(phase=phase, stage=stage).inc(time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[Any]:
    """Capture a host + card profiler trace into ``log_dir`` (a Chrome trace
    file, ``trace-<pid>-<n>.json``). Yields the ``torch.profiler.profile``,
    whose ``key_averages()`` and ``events()`` the caller may read after the
    block. CUDA activities are recorded when a card is present.
    ``create_perfetto_link`` is accepted for the JAX signature; the file is
    what Perfetto opens."""
    del create_perfetto_link
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield prof
    n = sum(1 for f in os.listdir(log_dir) if f.startswith(f"trace-{os.getpid()}-"))
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{n}.json"))


def annotate(name: str) -> Any:
    """Named host span that nests into the profiler timeline."""
    return torch.profiler.record_function(name)


def _pipeline_stages(pipeline_model: Any) -> list:
    """The stage list of a PipelineModel, or [model] for a single
    transformer. Must not raise on plain transformers: anything without a
    ``params()`` classmethod / ``get`` accessor (a bare function wrapper,
    a duck-typed stage) profiles as one stage."""
    try:
        params = type(pipeline_model).params()
    except Exception:  # noqa: BLE001 — params() is a Params-API contract
        return [pipeline_model]
    if "stages" not in params:
        return [pipeline_model]
    try:
        return list(pipeline_model.get("stages"))
    except Exception:  # noqa: BLE001 — declared but unreadable
        return [pipeline_model]


class ProfiledRun:
    """Time each stage of a pipeline transform; emit a stats DataFrame.

    >>> prof = ProfiledRun()
    >>> out = prof.transform(pipeline_model, df)
    >>> prof.stats().head()   # stage, seconds

    A stage's seconds are its host wall time (``obs.span``); a stage whose
    ``device`` param names a card also has its CUDA-event time counted by
    :func:`device_phase`."""

    def __init__(self) -> None:
        self.records: list = []

    def transform(self, pipeline_model: Any, df: DataFrame,
                  trace_id: Optional[str] = None) -> DataFrame:
        cur = df
        with obs.span("pipeline.transform", trace_id=trace_id):
            for stage in _pipeline_stages(pipeline_model):
                name = type(stage).__name__
                with obs.span(f"pipeline.{name}") as sp:
                    with device_phase("execute", name, _stage_device(stage)):
                        cur = stage.transform(cur)
                self.records.append((name, sp.duration_ns))
        return cur

    def stats(self) -> DataFrame:
        return DataFrame.from_dict({
            "stage": np.array([r[0] for r in self.records], dtype=object),
            "seconds": np.array([r[1] / 1e9 for r in self.records]),
        })


def _stage_device(stage: Any) -> Optional[torch.device]:
    """The card a stage runs on (its ``device`` param; None = the card),
    or None for a CPU stage or one without the param."""
    try:
        dev = stage.get("device")
    except Exception:  # noqa: BLE001 — no device param: a host stage
        return None
    dev = torch.device("cuda" if dev is None else dev)
    return dev if dev.type == "cuda" and torch.cuda.is_available() else None
