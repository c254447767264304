"""Lasso solver for LIME's local surrogates: the port of
``mmlspark_tpu.lime.lasso``.

Reference: ``LassoUtils.lasso`` (lime/BreezeUtils.scala:112) solves one
small dense lasso per explained row. Here ISTA with a Lipschitz step from
the Gram matrix's largest eigenvalue (16 power-iteration steps) runs a fixed
number of iterations on the inputs' device, and :func:`batched_lasso`
solves a batch of per-row problems as one set of batched products.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(a: "torch.Tensor | np.ndarray") -> torch.Tensor:
    return a.float() if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.float32))


def batched_lasso(x: "torch.Tensor | np.ndarray", y: "torch.Tensor | np.ndarray", lam: float,
                  iters: int = 300) -> torch.Tensor:
    """(R, n, d) states and (R, n) targets -> (R, d) coefficients of
    ``min_b 0.5/n ||x b - y||^2 + lam ||b||_1`` per problem, on ``x``'s
    device. Columns and targets are centred first (an unpenalised
    intercept), so a constant model output attributes zero weight."""
    x = _as_tensor(x)
    y = _as_tensor(y).to(x.device)
    n, d = x.shape[1], x.shape[2]
    x = x - x.mean(dim=1, keepdim=True)
    y = y - y.mean(dim=1, keepdim=True)
    gram = x.transpose(1, 2) @ x / n                        # (R, d, d)
    xty = (x.transpose(1, 2) @ y[..., None])[..., 0] / n    # (R, d)
    v = torch.full((x.shape[0], d), 1.0 / np.sqrt(d), dtype=x.dtype, device=x.device)
    for _ in range(16):
        v = (gram @ v[..., None])[..., 0]
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
    lip = torch.clamp((v * (gram @ v[..., None])[..., 0]).sum(-1), min=1e-6)
    step = (1.0 / lip)[:, None]
    b = torch.zeros((x.shape[0], d), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        g = (gram @ b[..., None])[..., 0] - xty
        b = b - step * g
        b = torch.sign(b) * torch.clamp(b.abs() - step * lam, min=0.0)
    return b


def lasso(x: "torch.Tensor | np.ndarray", y: "torch.Tensor | np.ndarray", lam: float,
          iters: int = 300) -> torch.Tensor:
    """min_b 0.5/n ||x b - y||^2 + lam ||b||_1 for (n, d) ``x`` and (n,)
    ``y``; returns b, shape (d,), on ``x``'s device."""
    return batched_lasso(_as_tensor(x)[None], _as_tensor(y)[None], lam, iters)[0]
