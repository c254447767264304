"""Core utilities: timing, bounded-concurrency async, managed resources.

Analogue of core/utils/{StopWatch,AsyncUtils}.scala and core/env/
{StreamUtilities,FileUtilities}.scala in the reference. This is the
PyTorch port's copy of ``mmlspark_tpu.core.utils`` without its ``obs``
counters (retry attempts, deadline hits, backoff seconds), which come back
with the port's ``obs/``.
"""

from __future__ import annotations

import concurrent.futures as _futures
import contextlib
import time
import zipfile
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, TypeVar

T = TypeVar("T")


class StopWatch:
    """ns-resolution stopwatch (core/utils/StopWatch.scala:6)."""

    def __init__(self) -> None:
        self.elapsed_ns = 0
        self._start: Optional[int] = None

    def start(self) -> None:
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        if self._start is not None:
            self.elapsed_ns += time.perf_counter_ns() - self._start
            self._start = None

    def restart(self) -> None:
        self.elapsed_ns = 0
        self.start()

    def measure(self, fn: Callable[[], T]) -> T:
        self.start()
        try:
            return fn()
        finally:
            self.stop()

    @property
    def elapsed_s(self) -> float:
        return self.elapsed_ns / 1e9


def buffered_await(
    tasks: Iterable[Callable[[], T]],
    max_concurrency: int,
    executor: Optional[_futures.Executor] = None,
) -> Iterator[T]:
    """Run thunks with bounded concurrency, yielding results in input order.

    ``AsyncUtils.bufferedAwait`` analogue (core/utils/AsyncUtils.scala):
    keeps at most ``max_concurrency`` in flight; yields as the *head* task
    completes, so memory stays bounded and order is preserved.
    """
    own = executor is None
    pool = executor or _futures.ThreadPoolExecutor(max_workers=max_concurrency)
    try:
        pending: list[_futures.Future] = []
        it = iter(tasks)
        exhausted = False
        while True:
            while not exhausted and len(pending) < max_concurrency:
                try:
                    thunk = next(it)
                except StopIteration:
                    exhausted = True
                    break
                pending.append(pool.submit(thunk))
            if not pending:
                break
            yield pending.pop(0).result()
    finally:
        if own:
            pool.shutdown(wait=True)


@contextlib.contextmanager
def using(*resources: Any) -> Iterator[Sequence[Any]]:
    """StreamUtilities.using/usingMany analogue."""
    try:
        yield resources
    finally:
        for r in reversed(resources):
            close = getattr(r, "close", None)
            if close is not None:
                with contextlib.suppress(Exception):
                    close()


def zip_iterator(path: str, sample_ratio: float = 1.0, seed: int = 0) -> Iterator[tuple]:
    """Iterate (filename, bytes) over a zip archive with optional subsampling
    (StreamUtilities.ZipIterator analogue, used by BinaryFileFormat)."""
    import random

    rng = random.Random(seed)
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            if info.is_dir():
                continue
            if sample_ratio >= 1.0 or rng.random() < sample_ratio:
                yield f"{path}::{info.filename}", z.read(info)


def retry_with_backoff(
    fn: Callable[[], T],
    backoffs_ms: Sequence[int] = (100, 500, 1000),
    retryable: Callable[[Exception], bool] = lambda e: True,
    jitter: bool = True,
    deadline_s: Optional[float] = None,
    rng: Optional[Any] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> T:
    """FaultToleranceUtils.retryWithTimeout / RESTHelpers.retry analogue
    (ModelDownloader.scala:37-47, RESTHelpers.scala:35-47).

    ``jitter`` (default on): each wait is uniform in [0, backoff] — full
    jitter, so a fleet of workers retrying the same dead dependency
    desynchronizes instead of hammering it in lockstep every 100/500/
    1000 ms. ``deadline_s``: overall budget — no sleep extends past it and
    no attempt starts after it, so a retried call cannot overshoot its
    caller's own timeout; on expiry the last error is raised. ``rng``/
    ``sleep``/``clock`` are injectable for deterministic tests."""
    import random as _random

    draw = (rng or _random).uniform
    start = clock()
    last: Optional[Exception] = None
    for wait_ms in [0, *backoffs_ms]:
        if wait_ms:
            delay = draw(0.0, wait_ms / 1000.0) if jitter else wait_ms / 1000.0
            if deadline_s is not None and (
                delay >= deadline_s - (clock() - start)
            ):
                # the next attempt would start at/after the deadline
                break
            sleep(delay)
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - retry boundary
            if not retryable(e):
                raise
            last = e
            if deadline_s is not None and clock() - start >= deadline_s:
                break
    assert last is not None
    raise last
