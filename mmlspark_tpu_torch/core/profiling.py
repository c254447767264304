"""Device-time attribution: the port of ``mmlspark_tpu.core.profiling``'s
``device_phase`` (the rest of that module, ``trace``/``annotate``/
``ProfiledRun``, comes with ROADMAP.md Queue A item 7).

One counter splits where time goes across the compiled-pipeline path:
``phase=compile`` (a fused segment's first call per bucket: on the card,
the warm-up and the CUDA graph capture), ``phase=execute`` (graph replays
or eager runs), by pipeline stage / fused segment. On the card a phase is
bracketed with CUDA events on the current stream and its device time is
counted; on the CPU its wall time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch

from mmlspark_tpu_torch import obs

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
