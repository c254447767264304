"""GBDT objectives: gradients/hessians (on the device) and the host-side
prediction transforms.

The port of ``mmlspark_tpu.models.gbdt.objectives``: binary, multiclass,
the regression zoo (LightGBM's regression_objective.hpp formulas) with
its pointwise losses and the quantile-family leaf renewal, and LambdaRank
(padded ``(G, M, M)`` pairs on the device, or the f64 host version for
groups the padded layout cannot hold).

Every device function takes its knobs as f32 0-d tensors where the JAX
package computes with them in f32 (``1.0 - alpha`` rounds differently in
f64), so the formulas match the reference's arithmetic.
"""

from __future__ import annotations

from typing import Any, Optional

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
# TrainParams.scala:8-40). ``p1`` is each one's knob: quantile/huber ->
# alpha, tweedie -> tweedie_variance_power, poisson ->
# poisson_max_delta_step, fair -> fair_c.
REGRESSION_KINDS = (
    "regression", "regression_l1", "quantile", "huber", "fair",
    "poisson", "tweedie", "gamma", "mape",
)

# objectives whose raw score lives in log space: prediction applies exp
# (LightGBM's convert_output for poisson/gamma/tweedie)
LOG_LINK_KINDS = ("poisson", "tweedie", "gamma")

# objectives whose leaf values LightGBM "renews" after growth: the leaf's
# weighted alpha-percentile of residuals replaces the unit-hessian Newton
# step (RegressionL1loss/QuantileLoss RenewTreeOutput)
RENEWED_KINDS = ("regression_l1", "quantile", "mape")

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


def regression_grad_hess(kind: str, scores: torch.Tensor, y: torch.Tensor,
                         p1: torch.Tensor) -> tuple:
    """Gradient/hessian pairs of the regression zoo; ``p1`` is the
    objective's knob as an f32 0-d tensor on the scores' device."""
    r = scores - y
    one = torch.ones_like(scores)
    if kind == "regression_l1":
        return torch.sign(r), one
    if kind == "quantile":
        # pinball: score >= label contributes (1 - alpha), else -alpha
        return torch.where(r >= 0, 1.0 - p1, -p1), one
    if kind == "huber":
        return torch.clamp(r, -p1, p1), one
    if kind == "fair":
        a = r.abs() + p1
        return p1 * r / a, p1 * p1 / (a * a)
    if kind == "poisson":
        # scores in log space; p1 = poisson_max_delta_step stabilizes the
        # hessian as LightGBM's exp(score + max_delta_step)
        return torch.exp(scores) - y, torch.exp(scores + p1)
    if kind == "tweedie":
        e1 = torch.exp((1.0 - p1) * scores)
        e2 = torch.exp((2.0 - p1) * scores)
        return -y * e1 + e2, -y * (1.0 - p1) * e1 + (2.0 - p1) * e2
    if kind == "gamma":
        ei = torch.exp(-scores)
        return 1.0 - y * ei, y * ei
    if kind == "mape":
        w = 1.0 / torch.clamp_min(y.abs(), 1.0)
        return torch.sign(r) * w, w
    return r, one  # regression (l2)


def regression_loss(kind: str, s: torch.Tensor, y: torch.Tensor,
                    p1: Any) -> torch.Tensor:
    """Pointwise loss of each regression objective: the eval metric the
    trainer early-stops on."""
    r = s - y
    if kind == "regression_l1":
        return r.abs()
    if kind == "quantile":
        return torch.maximum(p1 * (y - s), (p1 - 1.0) * (y - s))
    if kind == "huber":
        a = r.abs()
        return torch.where(a <= p1, 0.5 * r * r, p1 * (a - 0.5 * p1))
    if kind == "fair":
        a = r.abs()
        return p1 * p1 * (a / p1 - torch.log1p(a / p1))
    if kind == "poisson":
        return torch.exp(s) - y * s
    if kind == "tweedie":
        return (-y * torch.exp((1.0 - p1) * s) / (1.0 - p1)
                + torch.exp((2.0 - p1) * s) / (2.0 - p1))
    if kind == "gamma":
        return y * torch.exp(-s) + s
    if kind == "mape":
        return r.abs() / torch.clamp_min(y.abs(), 1.0)
    return r * r  # l2


def regression_metric_name(kind: str) -> str:
    return {
        "regression": "l2", "regression_l1": "l1", "quantile": "quantile",
        "huber": "huber", "fair": "fair", "poisson": "poisson",
        "tweedie": "tweedie", "gamma": "gamma", "mape": "mape",
    }.get(kind, "l2")


def leaf_quantile_renewal(
    row_leaf: torch.Tensor,   # (n,) int32 leaf of every row
    resid: torch.Tensor,      # (n,) f32 y - score (pre-update residuals)
    w: torch.Tensor,          # (n,) f32 row weights (0 = excluded)
    num_leaves: int,
    alpha: torch.Tensor,      # f32 0-d
) -> torch.Tensor:
    """Weighted alpha-percentile of the residuals per leaf -> (L,) f32 (0
    for empty leaves); the reference's two-key stable sort and crossing.

    Two stable sorts (residual, then leaf) put each leaf's rows in residual
    order; the row where the leaf's running weight first reaches
    alpha * leaf weight gives the leaf's value. The running weights are
    summed in f64 from the sorted rows, so they are exact for any weights
    of a sane range, independent of summation order (and so equal on the
    card and the CPU, and to the reference's f32 sums wherever those are
    exact, as for integer weights); the target alpha * leaf weight is
    rounded to f32 as the reference computes it."""
    L = num_leaves
    leaf = row_leaf.long()
    ord1 = torch.sort(resid, stable=True).indices
    ord2 = torch.sort(leaf[ord1], stable=True).indices
    order = ord1[ord2]
    leaf_s, r_s, w_s = leaf[order], resid[order], w[order]
    run = torch.cumsum(w_s.double(), 0)
    # each leaf's rows are one run of the sorted order: its weight is the
    # running total at its last row minus the total before its first
    ids = torch.arange(L, device=leaf.device)
    end = torch.searchsorted(leaf_s, ids, right=True)
    start = torch.searchsorted(leaf_s, ids, right=False)
    total = torch.cat([run.new_zeros(1), run])
    Wl = total[end] - total[start]                    # (L,) f64, exact
    within = run - total[start][leaf_s]               # weight up to and incl. the row
    target = (torch.clamp_min(alpha, 1e-12) * Wl.float()).double()[leaf_s]
    crossing = (w_s > 0) & (within >= target) & (within - w_s.double() < target)
    vals = torch.zeros(L, dtype=torch.float32, device=leaf.device).index_add_(
        0, leaf_s, torch.where(crossing, r_s, 0.0)
    )
    return torch.where(Wl > 0, vals, 0.0)


# -- LambdaRank ---------------------------------------------------------------


def lambdarank_grad_hess(
    scores: np.ndarray,
    relevance: np.ndarray,
    group_ids: np.ndarray,
    sigma: float = 1.0,
    truncation: int = 30,
) -> tuple:
    """LambdaRank (NDCG) gradients, in f64 on the host, per query group.

    For each group, pairs (i, j) with rel_i > rel_j contribute lambda_ij
    scaled by |delta NDCG|. The path for groups the padded device layout
    cannot hold (non-contiguous ids, or G * M * M above the device budget)."""
    n = len(scores)
    grad = np.zeros(n, np.float64)
    hess = np.zeros(n, np.float64)
    for gid in np.unique(group_ids):
        idx = np.flatnonzero(group_ids == gid)
        if len(idx) < 2:
            continue
        s = scores[idx]
        r = relevance[idx]
        order = np.argsort(-s, kind="stable")
        ranks = np.empty(len(idx), np.int64)
        ranks[order] = np.arange(len(idx))
        gains = (2.0 ** r - 1.0)
        discounts = 1.0 / np.log2(ranks + 2.0)
        ideal = np.sort(gains)[::-1]
        idcg = (ideal / np.log2(np.arange(len(idx)) + 2.0))[:truncation].sum()
        if idcg <= 0:
            continue
        diff_r = r[:, None] - r[None, :]
        better = diff_r > 0
        sd = s[:, None] - s[None, :]
        rho = 1.0 / (1.0 + np.exp(sigma * sd))  # sigmoid(-sigma * sd)
        delta_ndcg = np.abs(
            (gains[:, None] - gains[None, :])
            * (discounts[:, None] - discounts[None, :])
        ) / idcg
        lam = sigma * rho * delta_ndcg
        lam_h = sigma * sigma * rho * (1.0 - rho) * delta_ndcg
        # pair (i better than j): grad_i -= lam_ij ; grad_j += lam_ij
        g = np.where(better, -lam, 0.0).sum(axis=1) + np.where(better.T, lam.T, 0.0).sum(axis=1)
        h = np.where(better, lam_h, 0.0).sum(axis=1) + np.where(better.T, lam_h.T, 0.0).sum(axis=1)
        grad[idx] = g
        hess[idx] = np.maximum(h, 1e-9)
    return grad.astype(np.float32), hess.astype(np.float32)


def lambdarank_pad_groups(
    group_ids: np.ndarray, keep: Optional[np.ndarray] = None
) -> tuple:
    """Contiguous query groups -> padded (G, M) row-index layout, made once
    on the host so the device functions see static shapes. ``keep``: an
    optional row filter (the validation rows) applied before grouping.

    Returns (pad_idx (G, M) int32 with -1 padding, valid (G, M) bool)."""
    gid = np.asarray(group_ids)
    pos = np.arange(len(gid), dtype=np.int64)
    if keep is not None:
        pos = pos[keep]
        gid = gid[keep]
    if len(gid) == 0:
        return np.full((1, 1), -1, np.int32), np.zeros((1, 1), bool)
    starts = np.flatnonzero(np.r_[True, gid[1:] != gid[:-1]])
    ends = np.r_[starts[1:], len(gid)]
    sizes = ends - starts
    G, M = len(starts), int(sizes.max())
    pad_idx = np.full((G, M), -1, np.int64)
    for i, (s0, e0) in enumerate(zip(starts, ends)):
        pad_idx[i, : e0 - s0] = pos[s0:e0]
    return pad_idx.astype(np.int32), pad_idx >= 0


def _padded_groups(scores: torch.Tensor, rel: torch.Tensor, pad_idx: torch.Tensor,
                   valid: torch.Tensor) -> tuple:
    """Gather rows into the (G, M) layout: scores (-inf padding), relevance,
    2^rel - 1 gains and each slot's 0-based rank by descending score
    (stable; padding sinks to the tail)."""
    n = scores.shape[0]
    idx = pad_idx.long().clamp(0, n - 1)
    s = torch.where(valid, scores[idx], -torch.inf)
    r = torch.where(valid, rel[idx], 0.0)
    order = torch.sort(-s, dim=1, stable=True).indices
    ranks = torch.argsort(order, dim=1)
    gains = torch.where(valid, torch.pow(2.0, r) - 1.0, 0.0)
    return s, r, gains, ranks


def lambdarank_grad_hess_device(
    scores: torch.Tensor,
    rel: torch.Tensor,
    pad_idx: torch.Tensor,     # (G, M) int32, -1 padding
    valid: torch.Tensor,       # (G, M) bool
    sigma: float = 1.0,
    truncation: int = 30,
) -> tuple:
    """LambdaRank gradients on the device over padded groups: the formula
    of :func:`lambdarank_grad_hess` on (G, M, M) pair tensors, in f32, with
    no host round trip."""
    n = scores.shape[0]
    G, M = pad_idx.shape
    s, r, gains, ranks = _padded_groups(scores, rel, pad_idx, valid)
    disc = 1.0 / torch.log2(ranks.float() + 2.0)
    ideal = -torch.sort(-gains, dim=1).values
    pos = torch.arange(M, device=scores.device)
    pos_disc = 1.0 / torch.log2(pos.float() + 2.0)
    idcg = (ideal * pos_disc * (pos < truncation)).sum(dim=1)
    better = (
        (r[:, :, None] - r[:, None, :] > 0)
        & valid[:, :, None] & valid[:, None, :]
    )
    pair = better | better.transpose(1, 2)
    sd = torch.where(pair, s[:, :, None] - s[:, None, :], 0.0)
    rho = torch.sigmoid(-sigma * sd)
    dndcg = ((gains[:, :, None] - gains[:, None, :])
             * (disc[:, :, None] - disc[:, None, :])).abs() / torch.clamp_min(
        idcg, 1e-12)[:, None, None]
    lam = sigma * rho * dndcg
    lam_h = sigma * sigma * rho * (1.0 - rho) * dndcg
    bf = better.float()
    g = -(lam * bf).sum(dim=2) + (lam * bf).sum(dim=1)
    h = (lam_h * bf).sum(dim=2) + (lam_h * bf).sum(dim=1)
    keep = ((idcg > 0) & (valid.sum(dim=1) >= 2))[:, None] & valid
    g = torch.where(keep, g, 0.0)
    h = torch.where(keep, torch.clamp_min(h, 1e-9), 0.0)
    # every row sits in one slot: a plain scatter; padding lands in slot n
    sink = torch.where(valid, pad_idx.long(), n).reshape(-1)
    grad = torch.zeros(n + 1, dtype=torch.float32, device=scores.device)
    hess = torch.zeros(n + 1, dtype=torch.float32, device=scores.device)
    return (grad.index_put_((sink,), g.reshape(-1))[:n],
            hess.index_put_((sink,), h.reshape(-1))[:n])


def grouped_ndcg(
    scores: np.ndarray, labels: np.ndarray, group_ids: np.ndarray, k: int = 5
) -> float:
    """Mean NDCG@k over query groups with LightGBM's 2^rel - 1 gain, on the
    host; all-zero-relevance groups score 1.0 (LightGBM's convention)."""
    total, n_groups = 0.0, 0
    for gid in np.unique(group_ids):
        m = group_ids == gid
        s, rel = scores[m], labels[m]
        if len(s) == 0:
            continue
        kk = min(k, len(s))
        order = np.argsort(-s, kind="stable")[:kk]
        gains = 2.0 ** rel - 1.0
        disc = 1.0 / np.log2(np.arange(2, kk + 2))
        dcg = float((gains[order] * disc).sum())
        ideal = np.sort(gains)[::-1][:kk]
        idcg = float((ideal * disc).sum())
        total += dcg / idcg if idcg > 0 else 1.0
        n_groups += 1
    return total / max(n_groups, 1)


def grouped_ndcg_device(
    scores: torch.Tensor,
    rel: torch.Tensor,
    pad_idx: torch.Tensor,
    valid: torch.Tensor,
    k: int = 5,
) -> torch.Tensor:
    """Mean NDCG@k over padded groups on the device (0-d f32): the twin of
    :func:`grouped_ndcg`, so ranking early stopping needs no host sync."""
    G, M = pad_idx.shape
    _, _, gains, ranks = _padded_groups(scores, rel, pad_idx, valid)
    sizes = valid.sum(dim=1)
    kk = torch.clamp_max(sizes, k)[:, None]
    disc = 1.0 / torch.log2(ranks.float() + 2.0)
    dcg = (gains * disc * (ranks < kk)).sum(dim=1)
    ideal = -torch.sort(-gains, dim=1).values
    pos = torch.arange(M, device=scores.device)[None, :]
    pos_disc = 1.0 / torch.log2(pos.float() + 2.0)
    idcg = (ideal * pos_disc * (pos < kk)).sum(dim=1)
    ndcg = torch.where(idcg > 0, dcg / torch.clamp_min(idcg, 1e-12), 1.0)
    nonempty = sizes > 0
    return (ndcg * nonempty).sum() / torch.clamp_min(nonempty.sum(), 1)


def binary_auc_device(s: torch.Tensor, y: torch.Tensor, vw: torch.Tensor) -> torch.Tensor:
    """ROC AUC over the rows with ``vw > 0``, on the device (0-d f32): the
    rank statistic with ties averaged (searchsorted ranks). Raw scores
    serve, since sigmoid is increasing. A validation set of one class
    gives 0.5, as the reference's device metric does."""
    valid = vw > 0
    # invalid rows sort to +inf: they change no count below a finite score
    srt = torch.sort(torch.where(valid, s, torch.inf)).values
    lo = torch.searchsorted(srt, s, right=False)
    hi = torch.searchsorted(srt, s, right=True)
    avg_rank = (lo + hi + 1).float() / 2.0
    pos = torch.where(valid, y, 0.0)
    n_pos = pos.sum()
    n_neg = valid.sum().float() - n_pos
    rank_sum = (avg_rank * pos).sum()
    auc = (rank_sum - n_pos * (n_pos + 1) / 2.0) / torch.clamp_min(n_pos * n_neg, 1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, 0.5)


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
