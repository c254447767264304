"""Gradient-histogram builders — the GBDT hot op, on the GPU.

The port of ``mmlspark_tpu.ops.histogram``. ``plane_histogram(bins, stats,
mask)`` scatters the (g, h, count) stats of the masked rows into a
``(d * B, 3)`` plane; ``multi_plane_histogram`` does the same for many leaves
(slots) in one pass; ``leaf_stat_sums`` totals the stats per final leaf.

Each builder is a wrapper with two bodies:

- on a CUDA tensor it launches a kernel written by hand for Hopper
  (``ops/csrc/histogram.cu``: ``plane_hist`` for the single plane — the
  port of the TPU kernels ``_hist_kernel`` and ``_hist_split_kernel`` —
  and ``multi_plane_hist`` for the slot cube, the port of ``_multi_kernel``),
  or raises;
- on a CPU tensor it runs the plain PyTorch version beside it
  (``*_plain``: ``index_add_`` over flattened indices, in row order, f32).

There is no fallback between the two: the tensor's device decides.

The kernels sum in fixed point: each column j gets a power-of-two scale
2^k_j from the largest |stat| of the call (n * max * 2^k_j < 2^62), every
row adds its stats rounded to int64 at that scale, and the int64 sums are
scaled back and rounded to f32. A row's rounding is at most
max * 2^-(62 - ceil(log2 n)) of its column: at n = 200,000 a value 2^20
below the column's largest is rounded no more coarsely than f32 rounds it
(2^-24 of itself). Integer
addition does not depend on order, so the kernels are
deterministic (the same inputs give a bitwise-equal output on every run)
and equal, bit for bit, the ``*_emulated`` versions here, which repeat that
arithmetic in PyTorch. Those serve the tests and ``chip_smoke.py`` only.
The plain versions sum in f32, so kernel and plain agree to f32 rounding,
and counts exactly.

Every launch adds one to ``launches[<kernel>]``; ``chip_smoke.py`` resets
the counts before it drives the main path and reads them after. A call
made while the stream is being captured into a CUDA graph launches
nothing and is not counted; the graph's replays launch the captured
kernels without calling a wrapper, so they show only in a device trace.

The distributed form (B4, the JAX package's per-shard kernel + ``psum``:
``_plane_histogram_shard_map`` and ``multi_plane_histogram(mesh=...)``):
given a process ``group``, the builders sum over its ranks, each holding
its own rows. The scale is fixed for all ranks first: an all-reduce MAX of
the ranks' column maxima and an all-reduce SUM of their row counts give
the k_j one call on all the rows would compute. Each rank then sums its
rows in int64 at that scale (``plane_hist_fixed`` / ``multi_plane_hist_fixed``
on the card, the same arithmetic in PyTorch on the CPU), the int64 cells
are all-reduced, and only then rounded to f32. So the plane equals a
single call on all the ranks' rows bit for bit, at every world size: on
the card that single call is ``plane_hist``; on the CPU it is
``plane_histogram_emulated``, not the f32 ``plane_histogram_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Any

import torch

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.parallel import collectives

NUM_BINS = 256

launches = {"plane_hist": 0, "multi_plane_hist": 0, "plane_hist_fixed": 0,
            "multi_plane_hist_fixed": 0}

_SUM_BITS = 62  # n * max|v| * 2^k < 2^62: no int64 sum overflows (csrc kSumBits)
_TOO_MANY_BINS = -1  # csrc kTooManyBins

_BIN_KIND = {torch.uint8: 0, torch.int32: 1}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def hist_lowering(device: "str | torch.device") -> str:
    """Which body the builders run for tensors on ``device``: ``cuda``
    (the hand-written kernels) or ``torch`` (the plain versions)."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


# -- plain PyTorch versions (CPU tensors; the kernels' yardstick) -----------


def _flat_index(bins: torch.Tensor, num_bins: int, base: "torch.Tensor | None",
                trash: int) -> torch.Tensor:
    """(n, d) bins -> (n * d * 3,) indices into a flat (..., d*B, 3) output;
    out-of-range bins (and rows with base < 0) point at ``trash``."""
    n, d = bins.shape
    b = bins.long()
    ok = (b >= 0) & (b < num_bins)
    cell = torch.arange(d, device=bins.device) * num_bins + b
    if base is not None:
        ok = ok & (base >= 0)[:, None]
        cell = cell + base[:, None]
    cell = torch.where(ok, cell, trash)
    return (cell[:, :, None] * 3 + torch.arange(3, device=bins.device)).reshape(-1)


def plane_histogram_plain(
    bins: torch.Tensor, stats: torch.Tensor, mask: "torch.Tensor | None" = None,
    num_bins: int = NUM_BINS,
) -> torch.Tensor:
    """(n, d) int bins + (n, 3) f32 stats [+ (n,) f32 mask] -> (d*B, 3)."""
    n, d = bins.shape
    if mask is not None:
        stats = stats * mask[:, None]
    size = d * num_bins
    out = torch.zeros((size + 1) * 3, dtype=torch.float32, device=bins.device)
    src = stats[:, None, :].expand(n, d, 3).reshape(-1)
    out.index_add_(0, _flat_index(bins, num_bins, None, size), src)
    return out[: size * 3].view(size, 3)


def multi_plane_histogram_plain(
    bins: torch.Tensor, stats: torch.Tensor, slot: torch.Tensor, num_slots: int,
    num_bins: int = NUM_BINS,
) -> torch.Tensor:
    """(n, d) bins + (n, 3) stats + (n,) slot -> (S, d*B, 3); rows whose
    slot lies outside [0, S) drop."""
    n, d = bins.shape
    size = num_slots * d * num_bins
    sl = slot.long()
    base = torch.where((sl >= 0) & (sl < num_slots), sl * (d * num_bins), -1)
    out = torch.zeros((size + 1) * 3, dtype=torch.float32, device=bins.device)
    src = stats[:, None, :].expand(n, d, 3).reshape(-1)
    out.index_add_(0, _flat_index(bins, num_bins, base, size), src)
    return out[: size * 3].view(num_slots, d * num_bins, 3)


# -- the kernels' fixed-point arithmetic in PyTorch (tests, chip_smoke.py) ---


def _fixed_scale(v: torch.Tensor, n: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """Per column j of the (rows, 3) contributions ``v``: the largest
    exponent k_j with n * max|v_j| * 2^k_j < 2^62, and whether that max is
    finite."""
    amax = v.abs().amax(0) if v.shape[0] else v.new_zeros(3)
    _, e = torch.frexp(amax)
    finite = torch.isfinite(amax)
    nb = (n - 1).bit_length() if n > 1 else 0   # least nb with 2^nb >= n
    k = torch.where(finite, _SUM_BITS - nb - e.long(), 0)
    return k, finite


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k in f64, built from its bits (|k| stays far inside f64's range)."""
    return ((k + 1023) << 52).view(torch.float64)


def _to_fixed(v: torch.Tensor, k: torch.Tensor, finite: torch.Tensor) -> torch.Tensor:
    """round_half_even(v * 2^k) as int64; the product is exact in f64."""
    v = torch.where(finite, v, 0.0).double()
    return torch.round(v * _pow2(k)).long()


def _from_fixed(acc: torch.Tensor, k: torch.Tensor, finite: torch.Tensor) -> torch.Tensor:
    """int64 sums (|sum| < 2^62) rounded to f64, times 2^-k (exact), rounded
    to f32; NaN in a column whose max was not finite."""
    out = (acc.double() * _pow2(-k)).float()
    return torch.where(finite, out, float("nan"))


def _fixed_sums(bins: torch.Tensor, v: torch.Tensor, k: torch.Tensor, finite: torch.Tensor,
                num_bins: int, base: "torch.Tensor | None", size: int) -> torch.Tensor:
    """The int64 cells (size, 3) of the rows' contributions ``v`` at scale
    2^k_j: the kernels' accumulator."""
    n, d = bins.shape
    q = _to_fixed(v, k, finite)
    acc = torch.zeros((size + 1) * 3, dtype=torch.int64, device=bins.device)
    acc.index_add_(0, _flat_index(bins, num_bins, base, size),
                   q[:, None, :].expand(n, d, 3).reshape(-1))
    return acc[: size * 3].view(size, 3)


def _slot_base(bins: torch.Tensor, slot: torch.Tensor, num_slots: int,
               num_bins: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """(rows whose slot lies in [0, S), each row's plane offset or -1)."""
    sl = slot.long()
    ok = (sl >= 0) & (sl < num_slots)
    return ok, torch.where(ok, sl * (bins.shape[1] * num_bins), -1)


def plane_histogram_emulated(
    bins: torch.Tensor, stats: torch.Tensor, mask: "torch.Tensor | None" = None,
    num_bins: int = NUM_BINS,
) -> torch.Tensor:
    """``plane_hist``'s own arithmetic (fixed-point sums) in PyTorch:
    (n, d) bins + (n, 3) stats [+ (n,) mask] -> (d*B, 3), equal to the
    kernel bit for bit."""
    n, d = bins.shape
    v = stats if mask is None else stats * mask[:, None]
    k, finite = _fixed_scale(v, n)
    return _from_fixed(_fixed_sums(bins, v, k, finite, num_bins, None, d * num_bins), k, finite)


def multi_plane_histogram_emulated(
    bins: torch.Tensor, stats: torch.Tensor, slot: torch.Tensor, num_slots: int,
    num_bins: int = NUM_BINS,
) -> torch.Tensor:
    """``multi_plane_hist``'s own arithmetic in PyTorch -> (S, d*B, 3); the
    scale comes from the rows whose slot lies in [0, S)."""
    n, d = bins.shape
    ok, base = _slot_base(bins, slot, num_slots, num_bins)
    k, finite = _fixed_scale(stats[ok], n)
    acc = _fixed_sums(bins, stats, k, finite, num_bins, base, num_slots * d * num_bins)
    return _from_fixed(acc.view(num_slots, d * num_bins, 3), k, finite)


# -- the CUDA kernels -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of the device: the kernels size their grid by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scratch(n: int, out_cells: int, dev: torch.device) -> torch.Tensor:
    """int64 words: accumulator, 2 header words, the kept-row list (int32)."""
    return torch.empty(out_cells + 2 + (n + 1) // 2, dtype=torch.int64, device=dev)


def _lib() -> ctypes.CDLL:
    from mmlspark_tpu_torch.ops.cuda_build import library

    lib = library("histogram.cu")
    if not getattr(lib, "_mmlspark_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mmlspark_plane_hist.argtypes = [p, i, p, p, p, p, i, i, i, i, p]
        lib.mmlspark_plane_hist.restype = i
        lib.mmlspark_multi_plane_hist.argtypes = [p, i, p, p, p, p, i, i, i, i, i, p]
        lib.mmlspark_multi_plane_hist.restype = i
        lib.mmlspark_plane_hist_fixed.argtypes = [p, i, p, p, p, p, i, i, i, i, p]
        lib.mmlspark_plane_hist_fixed.restype = i
        lib.mmlspark_multi_plane_hist_fixed.argtypes = [p, i, p, p, p, p, i, i, i, i, i, p]
        lib.mmlspark_multi_plane_hist_fixed.restype = i
        lib._mmlspark_typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtypes: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(code: int, kernel: str, num_bins: int) -> None:
    if code == _TOO_MANY_BINS:
        raise ValueError(
            f"{kernel}: num_bins {num_bins} is more than one block's shared memory "
            "holds for a feature"
        )
    if code != 0:
        raise RuntimeError(
            f"{kernel} launch failed: cudaError {code} "
            f"({torch.cuda.get_device_name()})"
        )


def _check_rows(kernel: str, bins: torch.Tensor, stats: torch.Tensor,
                extra: tuple, scale: "torch.Tensor | None") -> "tuple[int, int]":
    """Device, type, shape and contiguity of a kernel's row inputs; extra
    = (name, tensor, dtype) of the mask or the slot."""
    dev = bins.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {dev}")
    if bins.dim() != 2:
        raise ValueError(f"bins must be (n, d), got shape {tuple(bins.shape)}")
    n, d = bins.shape
    _check("bins", bins, (n, d), tuple(_BIN_KIND), dev)
    _check("stats", stats, (n, 3), (torch.float32,), dev)
    if extra[1] is not None:
        _check(extra[0], extra[1], (n,), (extra[2],), dev)
    if scale is not None:
        _check("scale", scale, (6,), (torch.int64,), dev)
    return n, d


def plane_hist(
    bins: torch.Tensor, stats: torch.Tensor, mask: "torch.Tensor | None",
    num_bins: int,
) -> torch.Tensor:
    """The ``plane_hist`` kernel on CUDA tensors: uint8/int32 (n, d) bins,
    f32 (n, 3) stats, optional f32 (n,) mask -> f32 (d*B, 3)."""
    dev = bins.device
    n, d = _check_rows("plane_hist", bins, stats, ("mask", mask, torch.float32), None)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    out = torch.empty((d * num_bins, 3), dtype=torch.float32, device=dev)
    if d == 0:
        return out
    scratch = _scratch(n, d * num_bins * 3, dev)
    code = _lib().mmlspark_plane_hist(
        bins.data_ptr(), _BIN_KIND[bins.dtype], stats.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        scratch.data_ptr(), out.data_ptr(), n, d, num_bins, _sm_count(dev.index or 0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(code, "plane_hist", num_bins)
    if not torch.cuda.is_current_stream_capturing():
        launches["plane_hist"] += 1
    return out


def multi_plane_hist(
    bins: torch.Tensor, stats: torch.Tensor, slot: torch.Tensor, num_slots: int,
    num_bins: int,
) -> torch.Tensor:
    """The ``multi_plane_hist`` kernel on CUDA tensors: uint8/int32 (n, d)
    bins, f32 (n, 3) stats, int32 (n,) slot -> f32 (S, d*B, 3)."""
    dev = bins.device
    n, d = _check_rows("multi_plane_hist", bins, stats, ("slot", slot, torch.int32), None)
    if num_bins < 1 or num_slots < 1:
        raise ValueError("num_bins and num_slots must be >= 1")
    out = torch.empty((num_slots, d * num_bins, 3), dtype=torch.float32, device=dev)
    if d == 0:
        return out
    scratch = _scratch(n, num_slots * d * num_bins * 3, dev)
    code = _lib().mmlspark_multi_plane_hist(
        bins.data_ptr(), _BIN_KIND[bins.dtype], stats.data_ptr(), slot.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), n, d, num_bins, num_slots,
        _sm_count(dev.index or 0), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(code, "multi_plane_hist", num_bins)
    if not torch.cuda.is_current_stream_capturing():
        launches["multi_plane_hist"] += 1
    return out


def plane_hist_fixed(
    bins: torch.Tensor, stats: torch.Tensor, mask: "torch.Tensor | None",
    num_bins: int, scale: torch.Tensor,
) -> torch.Tensor:
    """The distributed entry of the ``plane_hist`` kernel: the caller's
    scale, (6,) int64 [k_0..k_2, finite_0..finite_2] on the card ->
    this rank's int64 sums (d*B, 3), not yet rounded to f32."""
    dev = bins.device
    n, d = _check_rows("plane_hist_fixed", bins, stats, ("mask", mask, torch.float32), scale)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    size = d * num_bins
    scratch = _scratch(n, size * 3, dev)
    if d == 0:
        return scratch[:0].view(0, 3)
    code = _lib().mmlspark_plane_hist_fixed(
        bins.data_ptr(), _BIN_KIND[bins.dtype], stats.data_ptr(),
        mask.data_ptr() if mask is not None else None, scale.data_ptr(),
        scratch.data_ptr(), n, d, num_bins, _sm_count(dev.index or 0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(code, "plane_hist_fixed", num_bins)
    if not torch.cuda.is_current_stream_capturing():
        launches["plane_hist_fixed"] += 1
    return scratch[: size * 3].view(size, 3)


def multi_plane_hist_fixed(
    bins: torch.Tensor, stats: torch.Tensor, slot: torch.Tensor, num_slots: int,
    num_bins: int, scale: torch.Tensor,
) -> torch.Tensor:
    """The distributed entry of the ``multi_plane_hist`` kernel: the
    caller's scale -> this rank's int64 sums (S, d*B, 3)."""
    dev = bins.device
    n, d = _check_rows("multi_plane_hist_fixed", bins, stats, ("slot", slot, torch.int32), scale)
    if num_bins < 1 or num_slots < 1:
        raise ValueError("num_bins and num_slots must be >= 1")
    size = num_slots * d * num_bins
    scratch = _scratch(n, size * 3, dev)
    if d == 0:
        return scratch[:0].view(num_slots, 0, 3)
    code = _lib().mmlspark_multi_plane_hist_fixed(
        bins.data_ptr(), _BIN_KIND[bins.dtype], stats.data_ptr(), slot.data_ptr(),
        scale.data_ptr(), scratch.data_ptr(), n, d, num_bins, num_slots,
        _sm_count(dev.index or 0), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(code, "multi_plane_hist_fixed", num_bins)
    if not torch.cuda.is_current_stream_capturing():
        launches["multi_plane_hist_fixed"] += 1
    return scratch[: size * 3].view(num_slots, d * num_bins, 3)


# -- the distributed form (B4) ------------------------------------------------


def global_rows(n_local: int, group: Any, device: torch.device) -> torch.Tensor:
    """The real rows of every rank of ``group``: (1,) int64 on ``device``
    (one all-reduce SUM). A caller that builds many planes of the same rows
    computes it once and passes it as ``rows``."""
    return collectives.allreduce_sum(
        torch.tensor([int(n_local)], dtype=torch.int64, device=device), group)


def global_scale(v: torch.Tensor, rows: torch.Tensor, group: Any) -> torch.Tensor:
    """The scale one call on all ranks' rows would take: (6,) int64
    [k_0..k_2, finite_0..finite_2] from the all-reduce MAX of the ranks'
    max |v_j| (as the bits of the f32 absolute value, so NaN orders above
    inf as in the kernel's scan) and ``rows``, all on the device."""
    a = v.abs().amax(0) if v.shape[0] else v.new_zeros(3)
    bits = collectives.allreduce_max(a.view(torch.int32) & 0x7FFFFFFF, group)
    amax = bits.view(torch.float32)
    _, e = torch.frexp(amax)
    finite = torch.isfinite(amax)
    m = rows.reshape(()) - 1
    nb = torch.where(m > 0, torch.frexp(m.clamp_min(1).double())[1].long(), 0)  # bit_length
    k = torch.where(finite, _SUM_BITS - nb - e.long(), 0)
    return torch.cat([k, finite.long()])


def _split(scale: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    return scale[:3], scale[3:].bool()


def plane_histogram_fixed(
    bins: torch.Tensor, stats: torch.Tensor, mask: "torch.Tensor | None",
    num_bins: int, scale: torch.Tensor,
) -> torch.Tensor:
    """This rank's int64 plane (d*B, 3) at the given scale: the
    ``plane_hist_fixed`` kernel on CUDA tensors, its arithmetic in PyTorch
    on CPU tensors."""
    if _on_cpu(bins, "plane_histogram_fixed"):
        v = stats if mask is None else stats * mask[:, None]
        return _fixed_sums(bins, v, *_split(scale), num_bins, None, bins.shape[1] * num_bins)
    return plane_hist_fixed(bins, stats, mask, num_bins, scale)


def multi_plane_histogram_fixed(
    bins: torch.Tensor, stats: torch.Tensor, slot: torch.Tensor, num_slots: int,
    num_bins: int, scale: torch.Tensor,
) -> torch.Tensor:
    """This rank's int64 cube (S, d*B, 3) at the given scale."""
    if _on_cpu(bins, "multi_plane_histogram_fixed"):
        _, base = _slot_base(bins, slot, num_slots, num_bins)
        d = bins.shape[1]
        acc = _fixed_sums(bins, stats, *_split(scale), num_bins, base, num_slots * d * num_bins)
        return acc.view(num_slots, d * num_bins, 3)
    return multi_plane_hist_fixed(bins, stats, slot, num_slots, num_bins, scale)


def from_fixed(acc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int64 sums at ``scale`` -> f32, as the kernels' last pass rounds."""
    return _from_fixed(acc, *_split(scale))


def _no_capture(op: str) -> None:
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{op}: a collective cannot run inside a CUDA graph capture")


def _reduced(acc: torch.Tensor, scale: torch.Tensor, group: Any) -> torch.Tensor:
    return from_fixed(collectives.allreduce_sum(acc, group), scale)


# -- the builders the growers call -------------------------------------------


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def plane_histogram(
    bins: torch.Tensor, stats: torch.Tensor, mask: "torch.Tensor | None" = None,
    num_bins: int = NUM_BINS, group: Any = None, rows: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """(d * B, 3) gradient-histogram plane of the masked rows.

    ``bins``: (n, d) int bin codes (uint8 or int32 on CUDA); ``stats``:
    (n, 3) f32 per-row (g, h, count); ``mask``: optional (n,) f32 row weight
    (0 rows contribute nothing).

    ``group``: a ``torch.distributed`` process group whose ranks each pass
    their own rows: the plane of all of them (the distributed form, equal
    to one call on all their rows bit for bit); None builds this process's
    rows alone. ``rows``: the ranks' real row count (:func:`global_rows`),
    all-reduced here when not given."""
    if group is not None:
        _no_capture("plane_histogram")
        if rows is None:
            rows = global_rows(bins.shape[0], group, bins.device)
        v = stats if mask is None else stats * mask[:, None]
        scale = global_scale(v, rows, group)
        return _reduced(plane_histogram_fixed(bins, stats, mask, num_bins, scale), scale, group)
    if _on_cpu(bins, "plane_histogram"):
        return plane_histogram_plain(bins, stats, mask, num_bins)
    return plane_hist(bins, stats, mask, num_bins)


def multi_plane_histogram(
    bins: torch.Tensor, stats: torch.Tensor, slot: torch.Tensor, num_slots: int,
    num_bins: int = NUM_BINS, group: Any = None, rows: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Histogram planes for many leaves in one pass over the rows:
    ``slot`` (n,) picks each row's plane (outside [0, S) = none). Returns
    (num_slots, d * B, 3). The depthwise grower's workhorse. ``group`` and
    ``rows`` as in :func:`plane_histogram`; the scale comes from the rows
    whose slot lies in [0, S)."""
    if group is not None:
        _no_capture("multi_plane_histogram")
        if rows is None:
            rows = global_rows(bins.shape[0], group, bins.device)
        ok, _ = _slot_base(bins, slot, num_slots, num_bins)
        scale = global_scale(torch.where(ok[:, None], stats, 0.0), rows, group)
        acc = multi_plane_histogram_fixed(bins, stats, slot, num_slots, num_bins, scale)
        return _reduced(acc, scale, group)
    if _on_cpu(bins, "multi_plane_histogram"):
        return multi_plane_histogram_plain(bins, stats, slot, num_slots, num_bins)
    return multi_plane_hist(bins, stats, slot, num_slots, num_bins)


def leaf_stat_sums(
    leaf: torch.Tensor, stats: torch.Tensor, num_leaves: int, group: Any = None,
    rows: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Per-leaf (g, h, count) totals: (n,) int32 leaf ids in [0, L) + (n, 3)
    stats -> (L, 3). On CUDA this is ``plane_hist`` with d = 1 and B = L,
    as the JAX package's host path reuses its plane kernel, so it is
    deterministic too. ``group``/``rows``: the totals over the ranks, as
    :func:`plane_histogram`'s."""
    if group is not None:
        return plane_histogram(leaf[:, None], stats, None, num_leaves, group, rows)
    if _on_cpu(leaf, "leaf_stat_sums"):
        return plane_histogram_plain(leaf[:, None], stats, None, num_leaves)
    return plane_hist(leaf[:, None], stats, None, num_leaves)


_M_ALLREDUCE_SECONDS = obs.histogram(
    "mmlspark_gbdt_hist_allreduce_seconds",
    "Wall time of one sharded histogram build including the explicit "
    "all-reduce (observed by eager/bench builds)",
)


def sharded_build_timed(
    bins: torch.Tensor, stats: torch.Tensor, group: Any, num_bins: int = NUM_BINS,
) -> torch.Tensor:
    """One distributed plane build (this rank's kernel plus the
    all-reduces), timed on the host clock up to a synchronise of the
    card, into ``mmlspark_gbdt_hist_allreduce_seconds``."""
    t0 = time.perf_counter()
    out = plane_histogram(bins, stats, None, num_bins, group)
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    _M_ALLREDUCE_SECONDS.observe(time.perf_counter() - t0)
    return out
