"""VowpalWabbit's minibatch SGD step — the online learner's hot op, on the GPU.

The JAX package has no Pallas kernel here: XLA compiles the minibatch body
of ``mmlspark_tpu.vw.learner._shard_train`` (a ``lax.scan`` of sparse
gathers and scatter-adds) into one program. The port runs a whole pass as
one launch of a kernel written by hand for Hopper (``ops/csrc/sgd.cu``):
``vw_pass``, one block (or, from 256 rows a minibatch, a cluster of up to
8 blocks) that walks the minibatches in order, each a grad phase and an
apply phase between barriers:

- grad: the weights of the minibatch's slots gathered in flat order, then
  one thread per row: the margin as a serial FMA chain over the row's K
  slots, the loss's derivative times the row's weight, and each slot's
  gradient ``fma(dl, v, (l2 * w) * (v != 0))``. In a cluster each block
  forms its share of the rows and copies it into block 0;
- apply, on one block, over the runs of equal indices in the minibatch
  (``sgd_plan``): the AdaGrad accumulator and the weight updated serially
  over the run in (row, slot) order, or ``w += -step * g`` with the
  power_t schedule. A run of fewer than ``LONG_RUN`` entries is one
  thread's; a longer one (the Constant slot's) is one warp's, which forms
  the products and quotients 128 at a time and keeps both serial chains in
  order;
- ``vw_margin``, for scoring: the same chain a row, in a persistent kernel
  whose blocks walk panels of rows (a chunk of K at a time where rows are
  long), every thread loading and gathering slots one panel ahead, one
  chain a thread from shared memory; a block of a few rows takes no panels
  (a thread a row); ``margin_layout`` picks the path, the panels and the
  grid from the shape.

``pass_layout`` decides from the shapes where a minibatch lives (g and the
plan's slices in shared memory where they fit) and the cluster.
``vw_grad_step`` and ``vw_apply_step`` run one phase of the same kernel on
one minibatch with the pass's layout at their shape, so what they time is
what a pass runs.

Each wrapper has two bodies: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs the plain PyTorch version beside it
(``*_plain``). There is no fallback between the two. The plain versions
round where XLA:CPU rounds: the margin is a chain of ``torch.addcmul``
(a fused multiply-add on the CPU), ``g`` is one ``addcmul``, the
scatter-adds are CPU ``index_add_`` (serial, in order) and the square root
is taken in f64 and rounded to f32 (PyTorch's f32 ``sqrt`` on the CPU is not
correctly rounded). The non-adaptive step ``lr * (1 / (1 + t)) ** power_t``
comes from ``step_table``, which calls the C library's ``powf`` as XLA:CPU
does. So the plain version's weights equal the JAX package's bit for bit
for the squared, quantile and hinge losses, and the kernels equal the plain
version on the CPU bit for bit: the runs come from one stable sort per fit
(``sgd_plan``), so no two threads touch one weight and there are no atomics.
Logistic and poisson call ``exp``, which rounds differently in XLA, in
PyTorch and on the card; tests/test_torch_port_vw.py states their
tolerance. The plain version on a CUDA tensor scatters with atomics (its
order changes from run to run); ``chip_smoke.py`` holds it to a tolerance.

Every launch adds one to ``launches[<entry>]``: ``vw_pass`` once a pass,
``vw_grad`` and ``vw_apply`` once a stand-alone call, ``vw_margin`` once a
scoring call; a call made while the stream is being captured into a CUDA
graph is not counted.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

LOSS_CODES = {"logistic": 0, "squared": 1, "quantile": 2, "hinge": 3, "poisson": 4}

launches = {"vw_pass": 0, "vw_grad": 0, "vw_apply": 0, "vw_margin": 0}

_T_MAX = float(2 ** 24)  # an f32 counter stops at 2^24: t + 1 rounds back to it


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=1)
def _powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = libm.powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def step_table(lr: float, power_t: float, t0: float, m: int) -> np.ndarray:
    """The non-adaptive step sizes ``lr * (1 / (1 + t)) ** power_t`` in f32
    for the minibatch counters ``t = t0, t0 + 1, ...`` (m of them), rounded
    as XLA:CPU rounds them: f32 divide, the C library's ``powf``, f32 multiply.
    Built on the host because the card's ``powf`` is not the C library's."""
    t = np.minimum(np.float64(t0) + np.arange(m), _T_MAX).astype(np.float32)
    x = np.float32(1.0) / (np.float32(1.0) + t)
    powf, pt = _powf(), float(np.float32(power_t))
    p = np.fromiter((powf(float(v), pt) for v in x), np.float32, count=m)
    return np.float32(lr) * p


def counter_after(t0: float, m: int) -> float:
    """The f32 minibatch counter after ``m`` more minibatches."""
    return float(np.float32(min(float(t0) + m, _T_MAX)))


# -- plain PyTorch versions (CPU tensors; the kernels' yardstick) -----------


def _f32(v: float, dev: torch.device) -> torch.Tensor:
    """v rounded to an f32 scalar on ``dev`` by a fill, not a host copy, so
    the plain versions can be captured in a CUDA graph (for timing)."""
    return torch.full((), v, dtype=torch.float32, device=dev)


def margin_plain(idx: torch.Tensor, val: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, K) indices and values -> (n,) margins: m = fma(w[i_k], v_k, m)
    over k = 0..K-1, from 0."""
    gathered = w[idx.long()]
    m = torch.zeros(idx.shape[0], dtype=torch.float32, device=w.device)
    for k in range(idx.shape[1]):
        m = torch.addcmul(m, gathered[:, k], val[:, k])
    return m


def dloss_plain(loss: str, m: torch.Tensor, y: torch.Tensor, tau: float) -> torch.Tensor:
    """d(loss)/d(margin) (``mmlspark_tpu.vw.learner._dloss``)."""
    if loss == "logistic":
        return -y * torch.sigmoid(-y * m)
    if loss == "squared":
        return m - y
    if loss == "quantile":
        t = _f32(tau, m.device)
        return torch.where(m >= y, 1.0 - t, -t)
    if loss == "hinge":
        return torch.where(y * m < 1.0, -y, torch.zeros_like(y))
    if loss == "poisson":
        return torch.exp(torch.clamp(m, -30.0, 30.0)) - y
    raise ValueError(f"unknown loss {loss!r}")


def grad_plain(
    idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor, wt: torch.Tensor,
    w: torch.Tensor, *, loss: str, tau: float, l2: float,
) -> torch.Tensor:
    """``vw_grad``'s function: one minibatch's (B, K) rows -> (B, K) slot
    gradients ``fma(dl, v, (l2 * w[i]) * (v != 0))``."""
    dl = dloss_plain(loss, margin_plain(idx, val, w), y, tau) * wt
    gathered = w[idx.long()]
    decay = (_f32(l2, w.device) * gathered) * (val != 0).float()
    return torch.addcmul(decay, dl[:, None], val)


def apply_plain(
    idx: torch.Tensor, g: torch.Tensor, w: torch.Tensor, g2: torch.Tensor,
    step: "torch.Tensor | None", *, lr: float, eps: float, adaptive: bool,
) -> None:
    """``vw_apply``'s function: one minibatch's slot gradients scattered into
    ``w`` (and ``g2`` when adaptive) in place, serially in (row, slot) order
    on the CPU (``index_add_``)."""
    flat = idx.long().reshape(-1)
    if adaptive:
        g2.index_add_(0, flat, (g * g).reshape(-1))
        denom = torch.sqrt(g2[idx.long()].double()).float() + _f32(eps, w.device)
        w.index_add_(0, flat, ((_f32(-lr, w.device) * g) / denom).reshape(-1))
    else:
        w.index_add_(0, flat, (-step * g).reshape(-1))


def sgd_pass_plain(
    idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor, wt: torch.Tensor,
    w: torch.Tensor, g2: torch.Tensor, steps: "torch.Tensor | None", *,
    loss: str, batch: int, tau: float, lr: float, l2: float, eps: float,
    adaptive: bool,
) -> None:
    """One pass over the rows in minibatches of ``batch``, updating ``w`` and
    ``g2`` in place (``_shard_train``'s minibatch body). ``steps``: one f32
    step size per minibatch when not adaptive."""
    for b in range(idx.shape[0] // batch):
        rows = slice(b * batch, (b + 1) * batch)
        g = grad_plain(idx[rows], val[rows], y[rows], wt[rows], w, loss=loss, tau=tau, l2=l2)
        apply_plain(idx[rows], g, w, g2, None if adaptive else steps[b], lr=lr, eps=eps,
                    adaptive=adaptive)


# -- the CUDA kernels -------------------------------------------------------

LONG_RUN = 32  # a run of at least this many entries is applied by a warp, not a thread

SMEM_BYTES = 232_448  # the shared memory an H100 block may opt in to (227 KB)
MAX_THREADS = 1024
MAX_CTAS = 8        # the most blocks of a portable cluster
CLUSTER_ROWS = 128  # the fewest rows a block of a cluster forms
# the kernel's fixed shared memory: two 8-byte mbarriers, then two windows of
# 128 floats for each of the 8 warps that take long runs
SMEM_FIXED = 16 + 8 * 2 * 128 * 4
SLACK = 16  # a staged array's room past its bytes: copies move 16-byte aligned windows
GRAD, APPLY = 1, 2  # the kernel's phases


class SGDPlan(NamedTuple):
    """The runs of equal indices of every minibatch, from one stable sort of
    the nonzero slots by (minibatch, index): ``order`` holds each slot's
    position (row * K + k) in its minibatch, runs in (row, k) order inside;
    run r spans ``order[run_start[r]:run_start[r + 1]]`` and updates weight
    ``run_index[r]``; minibatch b owns runs ``mb_runs[b]:mb_runs[b + 1]``.
    ``long_runs``: the ids of the runs of at least ``LONG_RUN`` entries, in
    order; minibatch b's are ``long_runs[mb_long[b]:mb_long[b + 1]]``.
    ``packed``: minibatch b's slices of ``order``, ``run_start`` (one more
    than its runs) and ``run_index`` back to back, so the kernel copies
    them in as one. ``meta``: (nb + 1, 4) int32 rows (first run, first entry
    of ``order``, first long run, start in ``packed``) of each minibatch, as
    the kernel reads them. ``max_runs``, ``max_entries``: the most runs and
    entries of any minibatch (the kernel's block and plan buffer)."""

    order: torch.Tensor
    run_start: torch.Tensor
    run_index: torch.Tensor
    mb_runs: torch.Tensor
    long_runs: torch.Tensor
    mb_long: torch.Tensor
    packed: torch.Tensor
    meta: torch.Tensor
    max_runs: int
    max_entries: int


def sgd_plan(idx: torch.Tensor, val: torch.Tensor, batch: int, dim: int) -> SGDPlan:
    """Runs of the (n, K) rows in minibatches of ``batch`` over a weight
    table of ``dim`` entries; slots whose value is 0 (padding) are left
    out. One sort per fit; the passes reuse it."""
    n, k = idx.shape
    nb = n // batch
    per = batch * k
    if nb * per >= 2 ** 31:
        raise ValueError(f"{n} rows x {k} slots overflow the kernels' int32 offsets")
    dev = idx.device
    pos = torch.nonzero(val[: nb * batch].reshape(-1) != 0).squeeze(1)
    key = (pos // per) * dim + idx[: nb * batch].reshape(-1)[pos].long()
    key, perm = torch.sort(key, stable=True)
    order = (pos[perm] % per).int()
    new = torch.ones(key.numel(), dtype=torch.bool, device=dev)
    new[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(new).squeeze(1)
    run_start = torch.cat([starts, torch.tensor([key.numel()], device=dev)])
    mb_runs = torch.searchsorted(key[starts] // dim, torch.arange(nb + 1, device=dev))
    long_runs = torch.nonzero(run_start[1:] - run_start[:-1] >= LONG_RUN).squeeze(1)
    mb_long = torch.searchsorted(long_runs, mb_runs)
    mb_entries = run_start[mb_runs]
    run_index = (key[starts] % dim).int()
    # packed: minibatch b's order slice from e0 + 2 r0 + b, then its run
    # starts, then its run indices (e0, r0: its first entry and run)
    runs = torch.arange(starts.numel(), device=dev)
    b_run = torch.searchsorted(mb_runs, runs, right=True) - 1
    b_entry = b_run[torch.cumsum(new, 0) - 1]
    bs = torch.arange(nb, device=dev)
    packed = torch.empty(key.numel() + 2 * starts.numel() + nb, dtype=torch.int32, device=dev)
    packed[torch.arange(key.numel(), device=dev) + 2 * mb_runs[b_entry] + b_entry] = order
    after_order = mb_entries[b_run + 1] + mb_runs[b_run] + b_run  # + r: its run start
    packed[after_order + runs] = run_start[:-1].int()
    packed[mb_entries[bs + 1] + mb_runs[bs] + bs + mb_runs[bs + 1]] = mb_entries[bs + 1].int()
    packed[after_order + mb_runs[b_run + 1] - mb_runs[b_run] + 1 + runs] = run_index
    mb_packed = mb_entries + 2 * mb_runs + torch.arange(nb + 1, device=dev)
    meta = torch.stack([mb_runs, mb_entries, mb_long, mb_packed], 1)
    max_runs = int((mb_runs[1:] - mb_runs[:-1]).max()) if nb else 0
    max_entries = int((mb_entries[1:] - mb_entries[:-1]).max()) if nb else 0
    return SGDPlan(order, run_start.int(), run_index, mb_runs.int(), long_runs.int(),
                   mb_long.int(), packed, meta.int().contiguous(), max_runs, max_entries)


class Layout(NamedTuple):
    """The pass kernel's launch: ``ctas`` blocks in one cluster (1: one
    block), ``threads`` a block; byte offsets of g and of the staged plan
    slices (-1 where they live in device memory instead); ``smem_bytes`` in
    all."""

    ctas: int
    threads: int
    g_off: int
    plan_off: int
    smem_bytes: int


def _a16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _staged(nbytes: int) -> int:
    return _a16(nbytes) + SLACK


STAGING = ("g", "plan")  # what pass_layout places in shared memory, in order


def pass_layout(batch: int, k: int, max_runs: int, max_entries: int) -> Layout:
    """Where ``vw_pass`` keeps a minibatch, from the shapes alone: g in
    shared memory where its ``batch * k * 4`` bytes fit beside the fixed
    ``SMEM_FIXED`` bytes (the mbarriers and the chains' windows), then the
    minibatch's packed plan slices (order, run_start, run_index;
    ``max_entries`` and ``max_runs`` of them at most) where they fit:
    ``STAGING``'s order. (The rows are read where they lie, each value
    once: staging them cost more than it saved, PERF.md.)
    One thread a row or a run, a multiple of 32, at most 1,024. Where g is in
    shared memory and the minibatch has 256 rows or more, a cluster of
    blocks on as many SMs (a power of two, at most 8, at least 128 rows
    each) forms the gradients and block 0 applies them: one SM's gathers
    would set the pace. The stand-alone entries take the layout of the pass
    at their shape."""
    threads = min(MAX_THREADS, max(32, -(-max(batch, max_runs) // 32) * 32))
    sizes = {"g": _a16(batch * k * 4), "plan": _staged((max_entries + 2 * max_runs + 1) * 4)}
    used = SMEM_FIXED
    offs = dict.fromkeys(sizes, -1)
    for name in STAGING:
        if used + sizes[name] <= SMEM_BYTES:
            offs[name] = used
            used += sizes[name]
    ctas = 1
    while offs["g"] >= 0 and ctas < MAX_CTAS and batch // (2 * ctas) >= CLUSTER_ROWS:
        ctas *= 2
    return Layout(ctas, threads, offs["g"], offs["plan"], used)


class MarginLayout(NamedTuple):
    """``vw_margin``'s launch: ``blocks`` blocks of ``threads``, block b taking
    rows [b rows, (b + 1) rows) in panels of ``panel_rows`` rows x ``chunk``
    slots (a chunk of K; all of K where it fits), its weights and values in
    shared memory ``stride`` floats a slot, ``smem_bytes`` in all; or, where
    ``direct``, a thread a row and no panels (the block's rows as one panel
    of whole rows, no shared memory)."""

    threads: int
    blocks: int
    rows: int
    panel_rows: int
    chunk: int
    stride: int
    direct: bool
    smem_bytes: int


MARGIN_THREADS = 256
MARGIN_PER = 16            # slots each thread brings in a panel (the kernel's kMarginPer)
MARGIN_BLOCKS_PER_SM = 2
MARGIN_MIN_SLOTS = 512     # the fewest slots a block takes, where the rows allow it
MARGIN_PANEL_ROWS = 64     # K is cut into chunks where fewer whole rows than this fit
                           # in a panel, so that many chains run side by side
MARGIN_DIRECT_SLOTS = 4096 # a block of at most this many slots takes no panels: a
                           # thread a row walks its slots
H100_SMS = 132


def margin_layout(n: int, k: int, sms: int = H100_SMS) -> MarginLayout:
    """``vw_margin``'s launch from the shape alone. Up to
    ``MARGIN_BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, each at least
    ``MARGIN_MIN_SLOTS`` slots where there are enough (so 20,000 x 17 rows
    still spread over every SM), whole rows each; ``MARGIN_THREADS``
    threads a block, fewer where a block has fewer than ``MARGIN_PER`` slots
    for each. A panel holds at most ``MARGIN_PER`` slots a thread: whole rows
    where ``MARGIN_PANEL_ROWS`` of them fit, else as many rows as the block
    has threads (one chain a thread, its margin carried) x a chunk of K; a
    block's groups of rows then made equal, and the chunks of K too. Shared
    memory grows with the panel, not with K. A block of at most
    ``MARGIN_DIRECT_SLOTS`` slots and ``MARGIN_THREADS`` rows takes no panels
    (``direct``): a thread a row walks its slots, with no shared memory."""
    blocks = max(1, min(MARGIN_BLOCKS_PER_SM * sms, -(-max(1, n * k) // MARGIN_MIN_SLOTS), n))
    rows = -(-n // blocks)
    blocks = -(-n // rows)
    if rows * k >= 2 ** 31:
        raise ValueError(f"{rows} rows x {k} slots a block overflow the kernel's int32 offsets")
    if rows * k <= MARGIN_DIRECT_SLOTS and rows <= MARGIN_THREADS:
        return MarginLayout(-(-rows // 32) * 32, blocks, rows, rows, k, rows | 1, True, 0)
    threads = min(MARGIN_THREADS, -(-rows * k // (32 * MARGIN_PER)) * 32)
    tile = MARGIN_PER * threads
    if k * min(rows, MARGIN_PANEL_ROWS) <= tile:   # whole rows
        r = min(rows, tile // k)
    else:                                          # K in chunks: one row a thread
        r = min(rows, threads)
    r = -(-rows // -(-rows // r))                  # equal groups of rows
    c = max(1, min(k, tile // r))
    c = -(-k // -(-k // c))                        # equal chunks of K
    stride = r | 1
    return MarginLayout(threads, blocks, rows, r, c, stride, False, 2 * c * stride * 4)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    from mmlspark_tpu_torch.ops.cuda_build import library

    lib = library("sgd.cu")
    if not getattr(lib, "_mmlspark_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mmlspark_vw_pass.argtypes = [p] * 11 + [i] * 4 + [f] * 5 + [i] * 8 + [p]
        ll = ctypes.c_longlong
        lib.mmlspark_vw_margin.argtypes = [p, p, p, p, ll, i, ll] + [i] * 7 + [p]
        for fn in ("pass", "margin"):
            getattr(lib, f"mmlspark_vw_{fn}").restype = i
        lib._mmlspark_typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_plan(plan: SGDPlan, nb: int, device: torch.device) -> None:
    if plan.mb_runs.numel() != nb + 1:
        raise ValueError(f"the plan holds {plan.mb_runs.numel() - 1} minibatches, not {nb}")
    runs, entries = plan.run_index.numel(), plan.order.numel()
    for name, shape in (("order", (entries,)), ("run_start", (runs + 1,)),
                        ("run_index", (runs,)), ("long_runs", (plan.long_runs.numel(),)),
                        ("packed", (entries + 2 * runs + nb,)), ("meta", (nb + 1, 4))):
        _check(f"plan.{name}", getattr(plan, name), shape, torch.int32, device)
    if plan.meta.data_ptr() % 16:
        raise ValueError("plan.meta must be 16-byte aligned (the kernel reads int4 rows)")


def _raise_on(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{kernel} launch failed: cudaError {code} ({torch.cuda.get_device_name()})")


def _tau_pair(tau: float) -> "tuple[float, float]":
    """(1 - tau, -tau) rounded as the JAX package rounds them (f32)."""
    t = np.float32(tau)
    return float(np.float32(1.0) - t), float(-t)


def _count(kernel: str, n: int) -> None:
    if not torch.cuda.is_current_stream_capturing():
        launches[kernel] += n


def _launch(kernel: str, phases: int, idx: torch.Tensor, val: "torch.Tensor | None",
            y: "torch.Tensor | None", wt: "torch.Tensor | None", w: torch.Tensor,
            g2: torch.Tensor, g: torch.Tensor, plan: "SGDPlan | None",
            steps: "torch.Tensor | None", nb: int, batch: int, *, loss: str = "squared",
            tau: float = 0.5, lr: float = 0.0, l2: float = 0.0, eps: float = 0.0,
            adaptive: bool = True) -> None:
    """One launch of the pass kernel over ``nb`` minibatches of ``batch``
    rows, running ``phases`` of each; ``g``: the (batch * K) scratch, or the
    stand-alone grad's output, or the stand-alone apply's input."""
    k = idx.shape[1]
    runs, entries = (plan.max_runs, plan.max_entries) if plan is not None else (0, 0)
    lay = pass_layout(batch, k, runs, entries)
    none = None
    code = _lib().mmlspark_vw_pass(
        idx.data_ptr(), none if val is None else val.data_ptr(),
        none if y is None else y.data_ptr(), none if wt is None else wt.data_ptr(),
        w.data_ptr(), g2.data_ptr(), g.data_ptr(),
        *((none,) * 3 if plan is None else
          (plan.packed.data_ptr(), plan.meta.data_ptr(), plan.long_runs.data_ptr())),
        None if adaptive else steps.data_ptr(), nb, batch, k, LOSS_CODES[loss],
        *_tau_pair(tau), float(np.float32(-lr)), float(np.float32(l2)),
        float(np.float32(eps)), int(adaptive), phases, LONG_RUN, lay.threads, lay.g_off,
        lay.plan_off, lay.ctas, lay.smem_bytes,
        torch.cuda.current_stream(idx.device).cuda_stream)
    _raise_on(code, kernel)
    _count(kernel, 1)


def vw_grad_step(
    idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor, wt: torch.Tensor,
    w: torch.Tensor, *, loss: str, tau: float, l2: float,
) -> torch.Tensor:
    """The grad phase of ``vw_pass`` alone, on one minibatch of CUDA tensors:
    int32 (B, K) idx, f32 (B, K) val, f32 (B,) y and wt, f32 (D,) w -> f32
    (B, K) g."""
    dev = idx.device
    if dev.type != "cuda" or idx.dim() != 2:
        raise ValueError(f"vw_grad runs on (B, K) CUDA tensors, got {dev} {tuple(idx.shape)}")
    b, k = idx.shape
    _check("idx", idx, (b, k), torch.int32, dev)
    _check("val", val, (b, k), torch.float32, dev)
    _check("y", y, (b,), torch.float32, dev)
    _check("wt", wt, (b,), torch.float32, dev)
    _check("w", w, (w.numel(),), torch.float32, dev)
    if loss not in LOSS_CODES:
        raise ValueError(f"unknown loss {loss!r}")
    g = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b:
        _launch("vw_grad", GRAD, idx, val, y, wt, w, w, g, None, None, 1, b,
                loss=loss, tau=tau, l2=l2)
    return g


def vw_apply_step(
    idx: torch.Tensor, g: torch.Tensor, w: torch.Tensor, g2: torch.Tensor,
    step: "torch.Tensor | None", plan: SGDPlan, *, lr: float, eps: float, adaptive: bool,
) -> None:
    """The apply phase of ``vw_pass`` alone, on one minibatch: int32 (B, K)
    idx and f32 (B, K) g of the minibatch whose runs are the whole of
    ``plan`` (a plan of this one minibatch); w and g2 updated in place;
    ``step``: f32 (1,) when not adaptive."""
    dev = idx.device
    if dev.type != "cuda" or idx.dim() != 2:
        raise ValueError(f"vw_apply runs on (B, K) CUDA tensors, got {dev} {tuple(idx.shape)}")
    _check("idx", idx, tuple(idx.shape), torch.int32, dev)
    _check("g", g, tuple(idx.shape), torch.float32, dev)
    _check("w", w, (w.numel(),), torch.float32, dev)
    _check("g2", g2, (w.numel(),), torch.float32, dev)
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned (the kernel copies it in whole)")
    if plan.mb_runs.numel() != 2:
        raise ValueError("vw_apply_step takes the plan of one minibatch")
    _check_plan(plan, 1, dev)
    if not adaptive:
        if step is None:
            raise ValueError("the non-adaptive update needs its step size")
        _check("step", step, (1,), torch.float32, dev)
    if plan.max_runs:
        _launch("vw_apply", APPLY, idx, None, None, None, w, g2, g, plan, step, 1,
                idx.shape[0], lr=lr, eps=eps, adaptive=adaptive)


def vw_pass(
    idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor, wt: torch.Tensor,
    w: torch.Tensor, g2: torch.Tensor, steps: "torch.Tensor | None", plan: SGDPlan, *,
    loss: str, batch: int, tau: float, lr: float, l2: float, eps: float, adaptive: bool,
) -> None:
    """One pass in one launch of the pass kernel on CUDA tensors: int32 (n,
    K) idx, f32 (n, K) val, f32 (n,) y and wt, f32 (D,) w and g2 updated in
    place; ``steps``: f32 (nb,) step sizes when not adaptive. ``plan`` from
    ``sgd_plan`` over the same rows."""
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"vw_pass runs on CUDA tensors, got {dev}")
    if idx.dim() != 2 or batch < 1 or idx.shape[0] % batch:
        raise ValueError(f"idx {tuple(idx.shape)} is not whole minibatches of {batch}")
    n, k = idx.shape
    nb = n // batch
    _check("idx", idx, (n, k), torch.int32, dev)
    _check("val", val, (n, k), torch.float32, dev)
    _check("y", y, (n,), torch.float32, dev)
    _check("wt", wt, (n,), torch.float32, dev)
    _check("g2", g2, tuple(w.shape), torch.float32, dev)
    _check("w", w, tuple(w.shape), torch.float32, dev)
    if not adaptive:
        if steps is None:
            raise ValueError("the non-adaptive update needs its step sizes")
        _check("steps", steps, (nb,), torch.float32, dev)
    if loss not in LOSS_CODES:
        raise ValueError(f"unknown loss {loss!r}")
    _check_plan(plan, nb, dev)
    if nb == 0:
        return
    gbuf = torch.empty(batch * k, dtype=torch.float32, device=dev)
    _launch("vw_pass", GRAD | APPLY, idx, val, y, wt, w, g2, gbuf, plan, steps, nb, batch,
            loss=loss, tau=tau, lr=lr, l2=l2, eps=eps, adaptive=adaptive)


def vw_margin(idx: torch.Tensor, val: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The ``vw_margin`` kernel on CUDA tensors: int32 (n, K) idx, f32 (n, K)
    val, f32 (D,) w -> f32 (n,) margins."""
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"vw_margin runs on CUDA tensors, got {dev}")
    if idx.dim() != 2:
        raise ValueError(f"idx must be (n, K), got shape {tuple(idx.shape)}")
    n, k = idx.shape
    _check("idx", idx, (n, k), torch.int32, dev)
    _check("val", val, (n, k), torch.float32, dev)
    _check("w", w, (w.numel(),), torch.float32, dev)
    if n == 0 or k == 0:
        return torch.zeros(n, dtype=torch.float32, device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lay = margin_layout(n, k, _sm_count(dev.index if dev.index is not None
                                        else torch.cuda.current_device()))
    code = _lib().mmlspark_vw_margin(
        idx.data_ptr(), val.data_ptr(), w.data_ptr(), out.data_ptr(), n, k, lay.rows,
        lay.panel_rows, lay.chunk, lay.stride, int(lay.direct), lay.threads, lay.blocks,
        lay.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "vw_margin")
    _count("vw_margin", 1)
    return out


# -- the entry points the learner calls --------------------------------------


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def sgd_pass(
    idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor, wt: torch.Tensor,
    w: torch.Tensor, g2: torch.Tensor, steps: "torch.Tensor | None",
    plan: Optional[SGDPlan], *, loss: str, batch: int, tau: float, lr: float,
    l2: float, eps: float, adaptive: bool,
) -> None:
    """One pass over whole minibatches, ``w`` and ``g2`` updated in place: the
    kernels on CUDA tensors (``plan`` from ``sgd_plan``), the plain version
    on CPU tensors (``plan`` unused)."""
    kw = dict(loss=loss, batch=batch, tau=tau, lr=lr, l2=l2, eps=eps, adaptive=adaptive)
    if _on_cpu(idx, "sgd_pass"):
        sgd_pass_plain(idx, val, y, wt, w, g2, steps, **kw)
    else:
        vw_pass(idx, val, y, wt, w, g2, steps, plan, **kw)


def margins(idx: torch.Tensor, val: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n,) margins of the (n, K) rows against the weights ``w``."""
    if _on_cpu(idx, "margins"):
        return margin_plain(idx, val, w)
    return vw_margin(idx, val, w)
