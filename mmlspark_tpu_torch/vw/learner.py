"""Device SGD for VW-style online learning, on the card.

The PyTorch port of ``mmlspark_tpu.vw.learner``. The JAX package runs each
mesh shard's online pass as one XLA program (``lax.scan`` over fixed-shape
minibatches of gathered/scattered sparse features) and averages weights
with ``pmean`` at every pass boundary, VW's "allreduce weights once per
pass" (vw/VowpalWabbitBase.scala:235-266,401-429). Here a pass is one
launch of a hand-written kernel that walks every minibatch in order
(``ops/sgd.py``, ``ops/csrc/sgd.cu``) on the card, or the plain PyTorch
version on the CPU.
Both round where XLA:CPU rounds, so weights equal the JAX package's
single-device program bit for bit for the squared, quantile and hinge
losses (tests/test_torch_port_vw.py).

Adaptive (AdaGrad) per-coordinate learning rates stand in for VW's
``--adaptive`` default; ``power_t`` scales the global schedule for the
non-adaptive path.

Over ranks (``distributed=True`` and a default ``torch.distributed`` group
of two or more): each rank passes its own rows, runs one ``vw_pass`` a
pass over them, and after every pass ``w`` and ``g2`` become their mean
over the ranks (``parallel.collectives.allreduce_mean``, the JAX package's
per-pass ``pmean``). Every rank pads its rows to the same whole number of
minibatches (the largest rank's row count, all-gathered), as the JAX
package's multi-process branch does. With one rank, or
``distributed=False``, the single-device program runs.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.ops import sgd
from mmlspark_tpu_torch.parallel import collectives, make_mesh, multihost_pad_target
from mmlspark_tpu_torch.parallel.mesh import group_rank_size

LOSS_LOGISTIC = "logistic"
LOSS_SQUARED = "squared"
LOSS_QUANTILE = "quantile"
LOSS_HINGE = "hinge"
LOSS_POISSON = "poisson"
LOSSES = (LOSS_LOGISTIC, LOSS_SQUARED, LOSS_QUANTILE, LOSS_HINGE, LOSS_POISSON)

_EPS = 1e-6  # AdaGrad's denominator floor: sqrt(g2) + eps


class SGDState(NamedTuple):
    """Full optimizer state of the VW online learner.

    Carrying ``g2`` (the AdaGrad accumulator) and ``t`` (the minibatch
    counter for the non-adaptive schedule) across calls is what makes
    incremental training *bit-identical* to one batch run over the
    concatenated rows: warm-starting on weights alone would reset the
    per-coordinate step sizes every micro-batch. The fields are tensors on
    the fit's device: ``w`` and ``g2`` f32 of shape (2^num_bits,), ``t`` an
    f32 scalar."""

    w: Any    # (2^num_bits,) f32 weights
    g2: Any   # (2^num_bits,) f32 AdaGrad sum of squared gradients
    t: Any    # scalar f32: minibatches seen (power_t schedule input)


def sgd_init(num_bits: int, initial_weights: Optional[np.ndarray] = None,
             device: "str | torch.device | None" = None) -> SGDState:
    """Fresh optimizer state for :func:`train_sparse_sgd_state`, on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    d = 1 << num_bits
    w = (
        np.zeros(d, np.float32) if initial_weights is None
        else np.asarray(initial_weights, np.float32)
    )
    if w.shape != (d,):
        raise ValueError(f"initial weights shape {w.shape} != ({d},)")
    return SGDState(
        w=torch.from_numpy(w.copy()).to(dev),
        g2=torch.zeros(d, dtype=torch.float32, device=dev),
        t=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _as_tensor(x: Any, dev: torch.device) -> torch.Tensor:
    """A state field as an f32 tensor on ``dev`` that this call may update
    in place (a copy: the caller's state stays as it was)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=dev, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def train_sparse_sgd_state(
    idx: np.ndarray,
    val: np.ndarray,
    y: np.ndarray,
    wt: Optional[np.ndarray],
    num_bits: int,
    state: Optional[SGDState] = None,
    *,
    loss: str = LOSS_LOGISTIC,
    num_passes: int = 1,
    batch: int = 0,
    lr: float = 0.5,
    power_t: float = 0.5,
    l2: float = 0.0,
    adaptive: bool = True,
    distributed: bool = True,
    quantile_tau: float = 0.5,
    device: "str | torch.device | None" = None,
) -> SGDState:
    """One incremental training step: continue from ``state`` (or fresh
    zeros) over this (padded) sparse micro-batch, returning the FULL
    updated optimizer state as tensors on ``device`` (default: the card).

    State stays on the device between calls, and because the AdaGrad
    accumulator and schedule counter ride along, feeding rows chunk by chunk
    is bit-identical to one :func:`train_sparse_sgd` call over the
    concatenation whenever chunk sizes are multiples of the minibatch size.
    The given state is not changed: the call updates a copy in place.

    ``batch <= 0`` = auto: 1024 on the card (each minibatch costs the pass
    kernel two block barriers and its memory round trips; fewer, bigger
    minibatches keep it busy), 64 on the CPU (closer to VW's
    per-example updates), the JAX package's rule with the card in the TPU's
    place. ``distributed``: over two or more ranks, average ``w`` and
    ``g2`` over them after every pass (module docstring)."""
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    dev = resolve_device(device)
    d = 1 << num_bits
    n = len(y)
    if batch <= 0:
        batch = 1024 if dev.type == "cuda" else 64
    wt = np.ones(n, np.float32) if wt is None else np.asarray(wt, np.float32)
    ranks = group_rank_size()[1] if distributed else 1
    if ranks > 1:
        # every rank runs the same number of minibatches: sized from the
        # largest rank's rows (at least one inert minibatch)
        target = max(1, multihost_pad_target(n, make_mesh(device=dev)))
        batch = max(1, min(batch, target))
        n_pad = int(np.ceil(target / batch)) * batch
    else:
        batch = max(1, min(batch, max(1, n)))
        n_pad = int(np.ceil(max(n, 1) / batch)) * batch
    idx = np.asarray(idx)
    val = np.asarray(val, np.float32)
    y = np.asarray(y, np.float32)
    if n_pad != n:
        pad = n_pad - n
        idx = np.concatenate([idx, np.zeros((pad, idx.shape[1]), idx.dtype)])
        val = np.concatenate([val, np.zeros((pad, val.shape[1]), val.dtype)])
        y = np.concatenate([y, np.zeros(pad, np.float32)])
        wt = np.concatenate([wt, np.zeros(pad, np.float32)])  # padding = no-op
    if state is None:
        state = sgd_init(num_bits, device=dev)
    w0, g20, t0 = state
    if tuple(getattr(w0, "shape", ())) != (d,):
        raise ValueError(
            f"state weights shape {getattr(w0, 'shape', None)} != ({d},)"
        )
    w, g2 = _as_tensor(w0, dev), _as_tensor(g20, dev)
    t0 = float(t0)
    idx_t = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev)
    val_t = torch.from_numpy(np.ascontiguousarray(val)).to(dev)
    y_t = torch.from_numpy(y).to(dev)
    wt_t = torch.from_numpy(wt).to(dev)
    nb = n_pad // batch
    steps = None
    if not adaptive:
        steps = torch.from_numpy(sgd.step_table(lr, power_t, t0, num_passes * nb)).to(dev)
    plan = sgd.sgd_plan(idx_t, val_t, batch, d) if dev.type == "cuda" else None
    for p in range(num_passes):
        sgd.sgd_pass(
            idx_t, val_t, y_t, wt_t, w, g2,
            None if steps is None else steps[p * nb:(p + 1) * nb], plan,
            loss=loss, batch=batch, tau=quantile_tau, lr=lr, l2=l2, eps=_EPS,
            adaptive=adaptive,
        )
        if ranks > 1:  # the per-pass allreduce (VowpalWabbitBase.scala:401-429)
            w.copy_(collectives.allreduce_mean(w))
            g2.copy_(collectives.allreduce_mean(g2))
    t = torch.tensor(sgd.counter_after(t0, num_passes * nb), dtype=torch.float32, device=dev)
    return SGDState(w=w, g2=g2, t=t)


def train_sparse_sgd(
    idx: np.ndarray,
    val: np.ndarray,
    y: np.ndarray,
    wt: Optional[np.ndarray],
    num_bits: int,
    *,
    loss: str = LOSS_LOGISTIC,
    num_passes: int = 1,
    batch: int = 0,
    lr: float = 0.5,
    power_t: float = 0.5,
    l2: float = 0.0,
    adaptive: bool = True,
    initial_weights: Optional[np.ndarray] = None,
    distributed: bool = True,
    quantile_tau: float = 0.5,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Train on the (padded) sparse batch; returns the (2^num_bits,) weights
    as numpy. ``batch <= 0`` = auto (1024 on the card, 64 on the CPU)."""
    state = train_sparse_sgd_state(
        idx, val, y, wt, num_bits,
        sgd_init(num_bits, initial_weights, device=device),
        loss=loss, num_passes=num_passes, batch=batch, lr=lr,
        power_t=power_t, l2=l2, adaptive=adaptive, distributed=distributed,
        quantile_tau=quantile_tau, device=device,
    )
    return state.w.cpu().numpy()


def predict_margin(idx: np.ndarray, val: np.ndarray, w: Any,
                   device: "str | torch.device | None" = None) -> np.ndarray:
    """Batched sparse dot with the weight vector (scoring hot path): a
    serial FMA chain over each row's slots. ``w`` may be numpy or a tensor
    (already on ``device``: it is not copied again)."""
    dev = resolve_device(device)
    w_t = w.to(dev) if isinstance(w, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(w, np.float32)).to(dev)
    idx_t = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev)
    val_t = torch.from_numpy(np.ascontiguousarray(val, np.float32)).to(dev)
    return sgd.margins(idx_t, val_t, w_t).cpu().numpy()
