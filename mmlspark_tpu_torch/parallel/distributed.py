"""Multi-process rendezvous and gang sync points.

The PyTorch port of ``mmlspark_tpu.parallel.distributed``. The JAX package
replaces the reference's driver TCP rendezvous (LightGBMUtils.scala:116-185)
and handshake (LightGBMConstants.scala:34-40, TrainUtils.scala:453-494)
with ``jax.distributed``; the port joins the gang with
``torch.distributed.init_process_group``: one coordinator address, one
process per device, each given its rank and the world size by the launcher.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.parallel.mesh import group_rank_size

_initialized = False

_M_BARRIER_WAIT = obs.histogram(
    "mmlspark_parallel_barrier_wait_seconds",
    "Time spent inside gang barriers, by barrier name", labels=("name",),
)
_M_BARRIER_TIMEOUTS = obs.counter(
    "mmlspark_parallel_barrier_timeouts_total",
    "Barriers abandoned by timeout", labels=("name",),
)


class BarrierTimeoutError(TimeoutError):
    """A gang sync point that did not complete in time — carries enough
    diagnostics to name the culprit instead of hanging forever."""

    def __init__(
        self,
        name: str,
        timeout_s: float,
        missing: Sequence[str] = (),
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.name = name
        self.timeout_s = timeout_s
        self.missing = list(missing)
        msg = (
            f"barrier {name!r} timed out after {timeout_s:g}s on process "
            f"{process_index}/{process_count}"
        )
        if self.missing:
            msg += f"; missing hosts: {', '.join(self.missing)}"
        else:
            msg += (
                "; no roster provided — pass expected=/alive= to barrier() "
                "to identify the missing host"
            )
        super().__init__(msg)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: "str | torch.device | None" = None,
    backend: Optional[str] = None,
) -> None:
    """Join the gang. No-ops for single-process runs and when already
    initialized (so library code can call it unconditionally).

    Environment fallbacks (set by the launcher): ``MMLSPARK_TPU_COORDINATOR``
    (``host:port`` of rank 0, or a full ``tcp://``/``file://`` URL),
    ``MMLSPARK_TPU_NUM_PROCESSES``, ``MMLSPARK_TPU_PROCESS_ID``. The
    ``backend`` is by default ``nccl`` when the rank's ``device`` (default:
    its card) is a CUDA device and ``gloo`` when it is the CPU; ``gloo``
    with a CUDA device runs the collectives through host buffers (several
    ranks on one card, where NCCL refuses a second rank)."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    coordinator_address = coordinator_address or os.environ.get("MMLSPARK_TPU_COORDINATOR")
    if coordinator_address is None:
        _initialized = True  # single-process mode
        return
    num_processes = num_processes or int(os.environ.get("MMLSPARK_TPU_NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("MMLSPARK_TPU_PROCESS_ID", "0"))
    )
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to join over gloo"
            )
        if dev.index is not None:
            torch.cuda.set_device(dev)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=url,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=600),
    )
    _initialized = True


def is_coordinator() -> bool:
    return group_rank_size()[0] == 0


def _barrier_collective() -> None:
    rank, size = group_rank_size()
    if size == 1:
        return
    # a collective is the barrier: every rank must contribute
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    dist.all_reduce(torch.ones(1, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def barrier(
    name: str = "mmlspark_tpu_barrier",
    timeout_s: Optional[float] = None,
    expected: Optional[Sequence[str]] = None,
    alive: Optional[Callable[[], Sequence[str]]] = None,
) -> None:
    """Gang sync point: a one-element all-reduce over the default group;
    a no-op with one rank.

    ``timeout_s``: instead of blocking forever on a slow or dead rank,
    raise :class:`BarrierTimeoutError` after this many seconds. The
    abandoned collective keeps waiting on a daemon thread, but the caller
    gets control back with a diagnosis.

    ``expected``/``alive``: optional roster for the diagnosis — the full
    gang's host names and a callable returning the currently live ones;
    the error then names exactly which hosts never arrived.

    Fault point ``parallel.barrier``: an injected delay simulates the slow
    host; an injected error simulates local rendezvous failure."""

    def _wait() -> None:
        faults.inject("parallel.barrier", context={"name": name})
        _barrier_collective()

    t0 = time.perf_counter()

    def _observe() -> None:
        _M_BARRIER_WAIT.labels(name=name).observe(time.perf_counter() - t0)

    if timeout_s is None:
        with obs.span("parallel.barrier"):
            _wait()
        _observe()
        return
    done = threading.Event()
    errs: list = []

    def _run() -> None:
        try:
            _wait()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            errs.append(e)
        finally:
            done.set()

    threading.Thread(
        target=_run, name=f"barrier-{name}", daemon=True
    ).start()
    if not done.wait(timeout_s):
        _M_BARRIER_TIMEOUTS.labels(name=name).inc()
        _observe()  # the timeout IS the observed wait — the tail must show
        missing: list = []
        if expected is not None and alive is not None:
            try:
                missing = sorted(set(expected) - set(alive()))
            except Exception:  # noqa: BLE001 — roster is best-effort
                missing = []
        rank, size = group_rank_size()
        raise BarrierTimeoutError(
            name, timeout_s, missing, process_index=rank, process_count=size,
        )
    _observe()
    if errs:
        raise errs[0]
