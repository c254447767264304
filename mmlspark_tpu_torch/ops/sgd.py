"""VowpalWabbit's minibatch SGD step — the online learner's hot op, on the GPU.

The JAX package has no Pallas kernel here: XLA compiles the minibatch body
of ``mmlspark_tpu.vw.learner._shard_train`` (a ``lax.scan`` of sparse
gathers and scatter-adds) into one program. The port runs it as kernels
written by hand for Hopper (``ops/csrc/sgd.cu``):

- ``vw_grad``, one thread per row: the margin as a serial FMA chain over the
  row's K slots, the loss's derivative times the row's weight, and each
  slot's gradient ``fma(dl, v, (l2 * w) * (v != 0))``;
- ``vw_apply``, one thread per run of equal indices in the minibatch: the
  AdaGrad accumulator and the weight updated serially over the run in
  (row, slot) order, or ``w += -step * g`` with the power_t schedule;
- ``vw_margin``, one thread per row: the same chain, for scoring.

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

Every launch adds one to ``launches[<kernel>]`` (a pass launches ``vw_grad``
and ``vw_apply`` once per minibatch); a call made while the stream is being
captured into a CUDA graph is not counted.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

LOSS_CODES = {"logistic": 0, "squared": 1, "quantile": 2, "hinge": 3, "poisson": 4}

launches = {"vw_grad": 0, "vw_apply": 0, "vw_margin": 0}

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


class SGDPlan(NamedTuple):
    """The runs of equal indices of every minibatch, from one stable sort of
    the nonzero slots by (minibatch, index): ``order`` holds each slot's
    position (row * K + k) in its minibatch, runs in (row, k) order inside;
    run r spans ``order[run_start[r]:run_start[r + 1]]``; minibatch b owns
    runs ``mb_runs[b]:mb_runs[b + 1]``. ``max_runs``: the most runs of any
    minibatch (the ``vw_apply`` grid)."""

    order: torch.Tensor
    run_start: torch.Tensor
    mb_runs: torch.Tensor
    max_runs: int


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
    run_start = torch.cat([starts, torch.tensor([key.numel()], device=dev)]).int()
    mb_runs = torch.searchsorted(
        key[starts] // dim, torch.arange(nb + 1, device=dev)).int()
    max_runs = int((mb_runs[1:] - mb_runs[:-1]).max()) if nb else 0
    return SGDPlan(order, run_start, mb_runs, max_runs)


def _lib() -> ctypes.CDLL:
    from mmlspark_tpu_torch.ops.cuda_build import library

    lib = library("sgd.cu")
    if not getattr(lib, "_mmlspark_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mmlspark_vw_grad.argtypes = [p] * 6 + [i] * 3 + [f] * 3 + [p]
        lib.mmlspark_vw_apply.argtypes = [p] * 8 + [f, f, i, i, p]
        lib.mmlspark_vw_pass.argtypes = [p] * 11 + [i] * 4 + [f] * 5 + [i, i, p]
        lib.mmlspark_vw_margin.argtypes = [p, p, p, p, i, i, p]
        for fn in ("grad", "apply", "pass", "margin"):
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


def vw_grad_step(
    idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor, wt: torch.Tensor,
    w: torch.Tensor, *, loss: str, tau: float, l2: float,
) -> torch.Tensor:
    """The ``vw_grad`` kernel on one minibatch of CUDA tensors: int32 (B, K)
    idx, f32 (B, K) val, f32 (B,) y and wt, f32 (D,) w -> f32 (B, K) g."""
    dev = idx.device
    if dev.type != "cuda" or idx.dim() != 2:
        raise ValueError(f"vw_grad runs on (B, K) CUDA tensors, got {dev} {tuple(idx.shape)}")
    b, k = idx.shape
    _check("idx", idx, (b, k), torch.int32, dev)
    _check("val", val, (b, k), torch.float32, dev)
    _check("y", y, (b,), torch.float32, dev)
    _check("wt", wt, (b,), torch.float32, dev)
    _check("w", w, (w.numel(),), torch.float32, dev)
    g = torch.empty((b, k), dtype=torch.float32, device=dev)
    if b == 0:
        return g
    code = _lib().mmlspark_vw_grad(
        idx.data_ptr(), val.data_ptr(), y.data_ptr(), wt.data_ptr(), w.data_ptr(),
        g.data_ptr(), b, k, LOSS_CODES[loss], *_tau_pair(tau), float(np.float32(l2)),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "vw_grad")
    _count("vw_grad", 1)
    return g


def vw_apply_step(
    idx: torch.Tensor, g: torch.Tensor, w: torch.Tensor, g2: torch.Tensor,
    step: "torch.Tensor | None", plan: SGDPlan, *, lr: float, eps: float, adaptive: bool,
) -> None:
    """The ``vw_apply`` kernel on one minibatch: int32 (B, K) idx and f32
    (B, K) g of the minibatch whose runs are the whole of ``plan`` (a plan
    of this one minibatch); w and g2 updated in place; ``step``: f32 (1,)
    when not adaptive."""
    dev = idx.device
    if dev.type != "cuda" or idx.dim() != 2:
        raise ValueError(f"vw_apply runs on (B, K) CUDA tensors, got {dev} {tuple(idx.shape)}")
    _check("idx", idx, tuple(idx.shape), torch.int32, dev)
    _check("g", g, tuple(idx.shape), torch.float32, dev)
    _check("w", w, (w.numel(),), torch.float32, dev)
    _check("g2", g2, (w.numel(),), torch.float32, dev)
    if plan.mb_runs.numel() != 2:
        raise ValueError("vw_apply_step takes the plan of one minibatch")
    if not adaptive:
        if step is None:
            raise ValueError("the non-adaptive update needs its step size")
        _check("step", step, (1,), torch.float32, dev)
    code = _lib().mmlspark_vw_apply(
        idx.data_ptr(), g.data_ptr(), plan.order.data_ptr(), plan.run_start.data_ptr(),
        plan.mb_runs.data_ptr(), w.data_ptr(), g2.data_ptr(),
        None if adaptive else step.data_ptr(), float(np.float32(-lr)),
        float(np.float32(eps)), int(adaptive), plan.max_runs,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "vw_apply")
    _count("vw_apply", 1 if plan.max_runs else 0)


def vw_pass(
    idx: torch.Tensor, val: torch.Tensor, y: torch.Tensor, wt: torch.Tensor,
    w: torch.Tensor, g2: torch.Tensor, steps: "torch.Tensor | None", plan: SGDPlan, *,
    loss: str, batch: int, tau: float, lr: float, l2: float, eps: float, adaptive: bool,
) -> None:
    """One pass of ``vw_grad`` + ``vw_apply`` per minibatch on CUDA tensors:
    int32 (n, K) idx, f32 (n, K) val, f32 (n,) y and wt, f32 (D,) w and g2
    updated in place; ``steps``: f32 (nb,) step sizes when not adaptive.
    ``plan`` from ``sgd_plan`` over the same rows."""
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
    if plan.mb_runs.numel() != nb + 1:
        raise ValueError(f"the plan holds {plan.mb_runs.numel() - 1} minibatches, not {nb}")
    if nb == 0:
        return
    gbuf = torch.empty(batch * k, dtype=torch.float32, device=dev)
    code = _lib().mmlspark_vw_pass(
        idx.data_ptr(), val.data_ptr(), y.data_ptr(), wt.data_ptr(), w.data_ptr(),
        g2.data_ptr(), gbuf.data_ptr(), plan.order.data_ptr(), plan.run_start.data_ptr(),
        plan.mb_runs.data_ptr(),
        None if adaptive else steps.data_ptr(), nb, batch, k, LOSS_CODES[loss],
        *_tau_pair(tau), float(np.float32(-lr)),
        float(np.float32(l2)), float(np.float32(eps)), int(adaptive), plan.max_runs,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(code, "vw_pass")
    _count("vw_grad", nb)
    _count("vw_apply", nb if plan.max_runs else 0)


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
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    code = _lib().mmlspark_vw_margin(
        idx.data_ptr(), val.data_ptr(), w.data_ptr(), out.data_ptr(), n, k,
        torch.cuda.current_stream(dev).cuda_stream)
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
