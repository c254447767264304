"""Alternating least squares on the card: the port of ``mmlspark_tpu.cyber.als``.

Replaces the reference's Spark ALS dependency (cyber
collaborative_filtering.py uses pyspark.ml.recommendation.ALS). Each
alternating half-step solves U (or I) independent ridge systems
``(Y^T W_u Y + lam I) x_u = Y^T W_u r_u``; they are built as stacked
(F, F) grams and solved as one batch with ``torch.linalg.solve``. Explicit
mode uses the observation mask as weights; implicit mode
(Hu-Koren-Volinsky) uses confidence ``1 + alpha*r`` on all cells with
binary preference targets.

Two entry points, each on ``device`` (the card unless ``device="cpu"``):
- ``als_train`` — dense (U, I) matrix; fine for per-tenant demo scale.
- ``als_train_coo`` — SPARSE (user, item, rating) triples, the production
  path: gram matrices and right-hand sides accumulate per edge over
  fixed-size edge blocks, so memory is O(U*F^2 + block*F^2), never O(U*I).

The initial factors are the JAX package's draws, ``0.1 *
jax.random.normal`` under the two keys of ``split(PRNGKey(seed))``,
within 4 ulp (``models.resnet.normal``), drawn on the host for every
device. Edges add into the carried grams one by one in edge order, as
XLA's scatter-add does: ``lime.superpixel.segment_sum``, which on the card
sorts stably instead of adding with atomics, so a fit is bitwise the same
from run to run. The solves' LU rounds differently from XLA's, and ALS
carries a last-bit difference far (an ulp in the draws becomes ~1e-4 of
the factors in 10 iterations), so factors agree with the JAX package's by
tolerance, not bits. TF32 is left off (PyTorch's default), as the
reference's products are f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.lime.lime import prng_key, split
from mmlspark_tpu_torch.lime.superpixel import segment_sum
from mmlspark_tpu_torch.models.resnet import normal

_EDGE_BLOCK = 8192


def initial_factors(seed: int, n_users: int, n_items: int, rank: int,
                    device: torch.device) -> tuple:
    """``0.1 * jax.random.normal(k, (n, rank))`` for ``ku, ki =
    split(PRNGKey(seed))``: (x, y) in f32 on ``device``. Drawn on the host
    and copied: the card's ``erf_inv`` rounds a few values an ulp apart
    from the CPU's, and ALS carries such a difference to ~1e-4 of the
    factors in 10 iterations; drawn once, a fit's bits do not depend on the
    device that runs it."""
    scale = torch.tensor(np.float32(0.1))
    return tuple((scale * normal(k, (n, rank), device="cpu")).to(device)
                 for k, n in zip(split(prng_key(seed)), (n_users, n_items)))


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stacked (F, F) systems ``a x = b`` -> (n, F)."""
    return torch.linalg.solve(a, b[..., None])[..., 0]


def _als_run(r: torch.Tensor, w: torch.Tensor, seed: int, rank: int, iters: int,
             reg: float, implicit: bool) -> tuple:
    u_n, i_n = r.shape
    x, y = initial_factors(seed, u_n, i_n, rank, r.device)
    eye = torch.eye(rank, dtype=torch.float32, device=r.device) * np.float32(reg)

    if implicit:
        conf = 1.0 + w * r  # w carries alpha; preference is binarized r
        pref = (r > 0).to(torch.float32)
        targets, weights = pref, conf
    else:
        targets, weights = r, w

    def solve_side(fixed: torch.Tensor, t: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        # one system per row of t: (F, F) grams stacked then batch-solved
        a = torch.einsum("if,ui,ig->ufg", fixed, wt, fixed) + eye[None]
        b = torch.einsum("if,ui,ui->uf", fixed, wt, t)
        return _solve(a, b)

    for _ in range(iters):
        x = solve_side(y, targets, weights)
        y = solve_side(x, targets.T, weights.T)
    return x, y


def als_train(
    ratings: np.ndarray,
    mask: Optional[np.ndarray] = None,
    rank: int = 10,
    iters: int = 10,
    reg: float = 0.1,
    implicit: bool = False,
    alpha: float = 40.0,
    seed: int = 0,
    device: "str | torch.device | None" = None,
) -> tuple:
    """Train on a dense (U, I) ratings matrix; returns (user_factors, item_factors).

    ``mask``: 1 where observed (defaults to ratings != 0). In implicit mode
    the mask is ignored and confidence = 1 + alpha * ratings everywhere.
    """
    dev = resolve_device(device)
    r = torch.as_tensor(np.asarray(ratings, np.float32), device=dev)
    if implicit:
        w = torch.full(r.shape, np.float32(alpha), dtype=torch.float32, device=dev)
    else:
        w = torch.as_tensor(
            np.asarray(mask if mask is not None else (ratings != 0), np.float32), device=dev
        )
    x, y = _als_run(r, w, seed, rank, iters, reg, implicit)
    return x.cpu().numpy(), y.cpu().numpy()


def _accumulate(fixed: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                er: torch.Tensor, ew: torch.Tensor, n_out: int, implicit: bool) -> tuple:
    """Per-row grams/rhs from observed edges, one edge block at a time.

    Explicit: A_u = sum_e w y y^T, b_u = sum_e w r y.
    Implicit (Hu-Koren): confidence c = 1 + alpha*r on observed cells
    (alpha arrives premultiplied in ``ew``), identity confidence
    elsewhere -> A_u = Y^T Y + sum_e (c-1) y y^T, b_u = sum_e c y.
    Each edge's gram and rhs go into one (n_out, F*F + F) accumulator, each
    value summed in edge order.
    """
    rank = fixed.shape[1]
    acc = torch.zeros((n_out, rank * rank + rank), dtype=torch.float32, device=fixed.device)
    for lo in range(0, src.shape[0], _EDGE_BLOCK):
        s, d = src[lo:lo + _EDGE_BLOCK], dst[lo:lo + _EDGE_BLOCK]
        r, w = er[lo:lo + _EDGE_BLOCK], ew[lo:lo + _EDGE_BLOCK]
        yf = fixed[d]                                   # (B, F)
        if implicit:
            aw = w * r                                  # c - 1 = alpha*r
            # c * pref(=1); padding edges (w == 0) must contribute 0
            bw = torch.where(w > 0, 1.0 + w * r, torch.zeros_like(w))
        else:
            aw = w
            bw = w * r
        outer = (aw[:, None, None] * yf[:, :, None]) * yf[:, None, :]
        vals = torch.cat([outer.reshape(-1, rank * rank), bw[:, None] * yf], dim=1)
        segment_sum(vals, s, n_out, out=acc)
    return acc[:, :rank * rank].reshape(n_out, rank, rank), acc[:, rank * rank:]


def _als_run_coo(eu: torch.Tensor, ei: torch.Tensor, er: torch.Tensor, ew: torch.Tensor,
                 seed: int, u_n: int, i_n: int, rank: int, iters: int, reg: float,
                 implicit: bool) -> tuple:
    dev = eu.device
    x, y = initial_factors(seed, u_n, i_n, rank, dev)
    eye = torch.eye(rank, dtype=torch.float32, device=dev) * np.float32(reg)
    for _ in range(iters):
        a, b = _accumulate(y, eu, ei, er, ew, u_n, implicit)
        if implicit:
            a = a + (y.T @ y)[None]
        x = _solve(a + eye[None], b)
        a, b = _accumulate(x, ei, eu, er, ew, i_n, implicit)
        if implicit:
            a = a + (x.T @ x)[None]
        y = _solve(a + eye[None], b)
    return x, y


def als_train_coo(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    num_users: int,
    num_items: int,
    rank: int = 10,
    iters: int = 10,
    reg: float = 0.1,
    implicit: bool = False,
    alpha: float = 40.0,
    seed: int = 0,
    device: "str | torch.device | None" = None,
) -> tuple:
    """Sparse ALS on (user, item, rating) triples — never builds (U, I)."""
    dev = resolve_device(device)
    e = len(users)
    pad = (-e) % _EDGE_BLOCK
    eu = np.pad(np.asarray(users, np.int64), (0, pad))
    ei = np.pad(np.asarray(items, np.int64), (0, pad))
    er = np.pad(np.asarray(ratings, np.float32), (0, pad))
    ew = np.pad(
        np.full(e, alpha if implicit else 1.0, np.float32), (0, pad)
    )  # padded edges carry weight 0 -> contribute nothing
    x, y = _als_run_coo(
        *(torch.as_tensor(v, device=dev) for v in (eu, ei, er, ew)),
        int(seed), int(num_users), int(num_items),
        int(rank), int(iters), float(reg), bool(implicit),
    )
    return x.cpu().numpy(), y.cpu().numpy()


def als_predict(user_factors: np.ndarray, item_factors: np.ndarray,
                users: np.ndarray, items: np.ndarray) -> np.ndarray:
    """Pairwise predicted affinity x_u · y_i for aligned index arrays."""
    return np.einsum(
        "nf,nf->n", user_factors[np.asarray(users)], item_factors[np.asarray(items)]
    )
