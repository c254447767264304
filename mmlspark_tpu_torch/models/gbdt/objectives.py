"""GBDT objectives: gradients/hessians (on the device) and the host-side
prediction transforms.

The port of ``mmlspark_tpu.models.gbdt.objectives`` for the objectives of
the first slice: binary, multiclass and regression (L2). The other
regression kinds and lambdarank are not ported yet (ROADMAP.md, Queue A
item 3); ``train`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import numpy as np
import torch


def binary_grad_hess(scores: torch.Tensor, y: torch.Tensor) -> tuple:
    p = torch.sigmoid(scores)
    return p - y, p * (1.0 - p)


def l2_grad_hess(scores: torch.Tensor, y: torch.Tensor) -> tuple:
    return scores - y, torch.ones_like(scores)


def multiclass_grad_hess(scores: torch.Tensor, y_onehot: torch.Tensor) -> tuple:
    """scores (n, k) -> grads/hess (n, k)."""
    p = torch.softmax(scores, dim=-1)
    k = scores.shape[-1]
    factor = k / max(k - 1.0, 1.0)  # LightGBM's multiclass hessian factor
    return p - y_onehot, factor * p * (1.0 - p)


# canonical regression objective kinds of the JAX package (LightGBM
# TrainParams.scala:8-40); only "regression" trains in the port so far
REGRESSION_KINDS = (
    "regression", "regression_l1", "quantile", "huber", "fair",
    "poisson", "tweedie", "gamma", "mape",
)

# objectives whose raw score lives in log space: prediction applies exp
# (LightGBM's convert_output for poisson/gamma/tweedie)
LOG_LINK_KINDS = ("poisson", "tweedie", "gamma")

_OBJECTIVE_ALIASES = {
    "regression_l2": "regression", "l2": "regression", "mse": "regression",
    "mean_squared_error": "regression", "root_mean_squared_error": "regression",
    "rmse": "regression", "l2_root": "regression",
    "l1": "regression_l1", "mae": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mean_absolute_percentage_error": "mape",
}


def canonical_objective(name: str) -> str:
    """LightGBM objective aliases -> the canonical kind string."""
    return _OBJECTIVE_ALIASES.get(name, name)


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
