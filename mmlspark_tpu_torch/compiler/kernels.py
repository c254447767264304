"""The fusability contract between pipeline stages and the compiler.

The PyTorch port of ``mmlspark_tpu.compiler.kernels``. A stage opts into
fusion by implementing ``fusable_kernel()`` and returning a
:class:`StageKernel` — a *pure tensor→tensor* description of its
transform: which columns it reads, which it writes, and a function mapping
input column tensors to output column tensors. The fuser
(:mod:`mmlspark_tpu_torch.compiler.fuser`) runs a run of adjacent kernels
as one program: on the card one CUDA graph per (segment, bucket), on the
CPU the same ops eagerly.

The correctness contract a kernel author signs (docs/compiler.md):

- ``fn`` on the declared reads must produce, for every row, exactly the
  values the stage's own ``transform`` would — including dtype-cast
  behaviour. Inputs arrive as 32-bit tensors (the host canonicalises
  float64 to float32, as the JAX package's x64-disabled device does), so
  mirror the staged path's casts inside the kernel and declare host-side
  output dtypes via ``out_dtypes`` for values the staged path
  materializes beyond float32 (e.g. ``float64`` prediction columns).
- ``fn`` must be row-independent along axis 0 (``row_wise=True``), and
  compute each row's bits independently of how many rows the batch holds:
  the fuser pads batches to power-of-two buckets and chunks oversized
  partitions, so a product whose library kernel is picked by shape (a
  matmul) breaks equality; sum in a fixed order instead
  (:func:`pairwise_sum`). Declare ``row_wise=False`` for cross-row
  kernels — the partitioner then treats the kernel's columns as a
  replication demand and the fuser never pads through it.
- ``fn`` must be capturable into a CUDA graph: no host read, no host to
  device copy of new data (place weights on the device lazily, on the
  first call, which is the eager warm-up before the capture).
- ``guard`` (optional) inspects the *host* input columns and returns a
  reason string when the kernel cannot handle them (object dtype, int64,
  ...); the fused segment then runs the stages staged for that DataFrame,
  recorded in ``mmlspark_compiler_fallback_total{reason=...}``.
- ``finalize`` (optional) is a **host epilogue**: a kernel whose staged
  transform ends in host numpy ops (libm ``exp`` in a sigmoid/softmax,
  float64 arithmetic) declares ``device_writes`` (the raw device outputs,
  e.g. summed tree scores) and a ``finalize(host_cols) -> {col: array}``
  that replays the staged path's *exact numpy epilogue* on the fetched
  device arrays. The fuser closes a fusion run after a finalize kernel
  (its outputs live on host).
- ``device`` (optional) names the device the stage runs on; None follows
  the rest of its segment. A kernel naming another device than the run
  it would join starts a new segment.

Floating-point summation is the other exactness trap: ``np.sum`` uses
pairwise summation, a device reduction adds in another order, and float32
adds do not associate. :func:`pairwise_sum` reproduces numpy's exact
association order with elementwise tensor adds (IEEE adds in a fixed
order are deterministic on the CPU and the card), so a kernel can sum on
the device and still bit-match a staged ``np.sum``, at any batch size.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np


@dataclass
class StageKernel:
    """Fusable description of one stage's transform."""

    reads: tuple
    writes: tuple
    # dict[col -> tensor] (reads) -> dict[col -> tensor] (writes)
    fn: Callable[[dict], dict]
    # host-side np dtype per output column, applied AFTER the device fetch
    out_dtypes: dict = field(default_factory=dict)
    # host-side pre-check: dict[col -> np array] -> None (ok) | reason str
    guard: Optional[Callable[[dict], Optional[str]]] = None
    # relative cost estimate used by the scheduler before real timings exist
    cost_hint: float = 1.0
    # row-independent along axis 0 (padding-safe); False is a sharding
    # conflict point (replication demand) for the partitioner
    row_wise: bool = True
    # input columns that must be fully replicated across ranks regardless
    # of batch sharding (e.g. a lookup table column) — a partitioner demand
    needs_replicated: tuple = ()
    # False: this kernel's ops are not bit-stable across batch shapes
    # (convolution algorithms picked by shape), so exact-mode compilation
    # plans the stage host-bound and only ``exact=False`` fuses it
    exact_capable: bool = True
    # host epilogue: fn's device outputs are the ``device_writes`` keys;
    # finalize(fetched host arrays, sliced to the true row count) returns
    # the final ``writes`` columns by replaying the staged path's numpy
    # tail ops bit-for-bit
    finalize: Optional[Callable[[dict], dict]] = None
    device_writes: tuple = ()  # defaults to ``writes`` when finalize is None
    # the stage's device ("cuda", "cpu", ...); None follows its segment
    device: Optional[str] = None

    @property
    def fn_outputs(self) -> tuple:
        """The columns ``fn`` actually returns from the device program."""
        if self.finalize is not None and self.device_writes:
            return self.device_writes
        return self.writes


def stage_kernel(stage: Any) -> Optional[StageKernel]:
    """The stage's kernel, or None for host-bound stages. Never raises:
    a kernel constructor that fails (missing weights, unsupported plan)
    classifies the stage host-bound rather than failing compilation."""
    getter = getattr(stage, "fusable_kernel", None)
    if getter is None:
        return None
    try:
        k = getter()
    except Exception:  # noqa: BLE001 — unfusable, not an error
        return None
    if k is None:
        return None
    if not isinstance(k, StageKernel):
        raise TypeError(
            f"{type(stage).__name__}.fusable_kernel() returned "
            f"{type(k).__name__}, expected StageKernel or None"
        )
    return k


def guard_dense_numeric(cols: dict) -> Optional[str]:
    """Common guard: every input column must be a dense numeric array."""
    for name, arr in cols.items():
        a = np.asarray(arr)
        if a.dtype == object:
            return f"object column {name!r}"
        if a.dtype.kind not in ("f", "i", "u", "b"):
            return f"non-numeric column {name!r} ({a.dtype})"
    return None


def guard_f32_safe(cols: dict) -> Optional[str]:
    """Guard for kernels whose staged path computes float32 (possibly via a
    float64 upcast): dtypes where the host's 32-bit canonicalization yields
    the same single rounding the staged ``astype`` chain does — floats,
    bool, and ints that fit 32 bits (int64 would have to wrap to int32
    instead of rounding like the host cast)."""
    for name, arr in cols.items():
        a = np.asarray(arr)
        if a.dtype == object:
            return f"object column {name!r}"
        if a.dtype.kind == "f" or a.dtype.kind == "b":
            continue
        if a.dtype.kind in ("i", "u") and a.dtype.itemsize <= 4:
            continue
        return f"dtype {a.dtype} column {name!r}"
    return None


# width at which numpy's pairwise summation switches from the 8-accumulator
# block loop to recursive halving (numpy's PW_BLOCKSIZE)
_PW_BLOCKSIZE = 128


def pairwise_sum(a: Any) -> Any:
    """Sum over axis 1 in **numpy's exact association order**.

    ``np.sum`` on float32 uses pairwise summation (sequential under 8
    elements; 8 interleaved accumulators tree-combined up to 128; recursive
    halving above) on top of a zero start, while a device reduction
    associates differently — so a device sum is *not* bit-equal to the
    staged path's host sum. This helper makes the same adds in the same
    order as elementwise ops: ``a`` is a numpy array or a tensor of two or
    more dims (summed over axis 1; the other axes are carried along), or a
    non-empty list of equally shaped columns. Every add is an IEEE float32
    add on each side, so the result matches ``np.sum(a, axis=1)`` bitwise,
    and each row is computed independently of the rest of the batch. Cost
    is T-1 elementwise adds for T columns (one launch each on the card).
    """
    if isinstance(a, (list, tuple)):
        cols = list(a)
    else:
        if a.shape[1] == 0:
            shape = tuple(a.shape[:1]) + tuple(a.shape[2:])
            if isinstance(a, np.ndarray):
                return np.zeros(shape, a.dtype)
            import torch

            return torch.zeros(shape, dtype=a.dtype, device=a.device)
        cols = [a[:, j] for j in range(a.shape[1])]
    res = _pairwise(cols)
    # numpy adds the pairwise total to a zero start; only the sign of an
    # all -0.0 sum shows it (a short sum already starts from zero)
    return res if len(cols) < 8 else res + 0.0


def _pairwise(cols: list) -> Any:
    n = len(cols)
    if n < 8:
        res = cols[0] + 0.0
        for c in cols[1:]:
            res = res + c
        return res
    if n <= _PW_BLOCKSIZE:
        r = list(cols[:8])
        i = 8
        while i < n - (n % 8):
            r = [r[j] + cols[i + j] for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for c in cols[i:]:
            res = res + c
        return res
    n2 = (n // 2) - ((n // 2) % 8)
    return _pairwise(cols[:n2]) + _pairwise(cols[n2:])
