"""GBDT training loop on the device.

The port of ``mmlspark_tpu.models.gbdt.train`` for the first slice: per
boosting round compute gradients/hessians from the current scores, grow
one tree per class (``treegrow``: histograms, split search and row
assignment all on the device), and update the scores from the grower's own
row -> leaf output. Scores, labels, gradients and the bin matrix (uint8)
stay on the device for the whole run; the split records come to the host
once, after the last round, in one transfer.

Ported: ``boosting_type="gbdt"``; binary, multiclass and regression (L2)
objectives; ``lossguide`` and ``depthwise`` growth; ``feature_fraction``
(drawn from ``numpy.random.default_rng(seed)`` in the JAX package's order,
so the same seed masks the same features); sample weights; ``init_score``;
``base_score``. One device, one Python loop over rounds.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item, Queue A item 3): bagging, goss/dart/rf, validation rows and early
stopping, categorical features, continued training, lambdarank and the
other regression objectives, voting-parallel, checkpoint/resume, elastic
and multi-host training, pre-binned and sparse input, delegates.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.models.gbdt import objectives
from mmlspark_tpu_torch.models.gbdt.binning import BinMapper, _require_dense
from mmlspark_tpu_torch.models.gbdt.booster import Booster, Tree
from mmlspark_tpu_torch.models.gbdt.treegrow import (
    SplitParams,
    grow_tree,
    grow_tree_depthwise,
)

BOOSTING_TYPES = ("gbdt", "goss", "dart", "rf")
OBJECTIVES = ("binary", "multiclass", "regression")


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` field for field, so one config
    drives both packages; fields of unported features must keep their
    defaults (``train`` checks)."""

    objective: str = "binary"          # binary|multiclass|regression
    num_class: int = 1
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1
    lambda_l2: float = 0.0
    lambda_l1: float = 0.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    min_data_in_leaf: int = 20
    max_bin: int = 255
    feature_fraction: float = 1.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    early_stopping_round: int = 0
    metric: str = ""
    seed: int = 0
    parallelism: str = "data_parallel"
    growth_policy: str = "lossguide"   # lossguide | depthwise
    top_k: int = 20
    verbosity: int = -1
    categorical_features: tuple = ()
    boosting_type: str = "gbdt"
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    top_rate: float = 0.2
    other_rate: float = 0.1
    eval_at: int = 5
    alpha: float = 0.9
    tweedie_variance_power: float = 1.5
    poisson_max_delta_step: float = 0.7
    fair_c: float = 1.0
    delegate: Optional[Any] = None


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mmlspark_tpu_torch yet "
        f"(ROADMAP.md Queue A item 3: {item})"
    )


def _check_config(cfg: TrainConfig) -> None:
    if cfg.boosting_type not in BOOSTING_TYPES:
        raise ValueError(f"boosting_type must be one of {BOOSTING_TYPES}")
    if cfg.boosting_type != "gbdt":
        raise _unported(f"boosting_type={cfg.boosting_type!r}", "goss/dart/rf")
    if cfg.objective not in OBJECTIVES:
        if cfg.objective in objectives.REGRESSION_KINDS or cfg.objective == "lambdarank":
            raise _unported(f"objective={cfg.objective!r}", "other objectives")
        raise ValueError(f"unknown objective {cfg.objective!r}")
    if cfg.growth_policy not in ("lossguide", "depthwise"):
        raise ValueError(
            f"growth_policy must be 'lossguide' or 'depthwise', got {cfg.growth_policy!r}"
        )
    if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0:
        raise _unported("bagging", "bagging with torch.Generator")
    if cfg.early_stopping_round > 0:
        raise _unported("early stopping", "validation and early stopping")
    if cfg.categorical_features:
        raise _unported("categorical_features", "categorical splits")
    if cfg.parallelism != "data_parallel":
        raise _unported(f"parallelism={cfg.parallelism!r}", "voting-parallel")
    if cfg.delegate is not None:
        raise _unported("training delegates", "delegates")


def _tree_from_host(rec: np.ndarray, L: int, mapper: BinMapper) -> Tree:
    """One tree's packed f64 record vector -> a host Tree."""
    s = L - 1
    leaf, feature, bin_, active, gain = (rec[i * s:(i + 1) * s] for i in range(5))
    values, counts = rec[5 * s: 5 * s + L], rec[5 * s + L:]
    thr = np.array(
        [
            mapper.threshold_value(int(f), int(b)) if f >= 0 else np.inf
            for f, b in zip(feature, bin_)
        ],
        dtype=np.float64,
    )
    return Tree(
        leaf=leaf.astype(np.int32),
        feature=feature.astype(np.int32),
        threshold=thr,
        active=active > 0.5,
        gain=gain.astype(np.float32),
        values=values.astype(np.float32),
        counts=counts.astype(np.int32),
    )


def _pack(grown: Any) -> torch.Tensor:
    """A grown tree's records as one f64 vector (exact for every field),
    so all trees reach the host in one transfer."""
    return torch.cat([
        grown.rec_leaf.double(), grown.rec_feature.double(),
        grown.rec_bin.double(), grown.rec_active.double(),
        grown.rec_gain.double(), grown.leaf_values.double(),
        grown.leaf_counts.double(),
    ])


def train(
    x: np.ndarray,
    y: np.ndarray,
    cfg: TrainConfig,
    sample_weight: Optional[np.ndarray] = None,
    init_score: Optional[np.ndarray] = None,
    valid_mask: Optional[np.ndarray] = None,
    group_ids: Optional[np.ndarray] = None,
    init_booster: Optional[Booster] = None,
    base_score: Any = 0.0,
    device: "str | torch.device | None" = None,
) -> Booster:
    """Fit a booster on a dense (n, d) float matrix.

    ``device``: where training runs; ``None`` means ``"cuda"``, which
    raises when no card is present. Pass ``"cpu"`` to train on the CPU
    through the plain PyTorch histogram versions.

    ``base_score``: boost_from_average baseline (scalar, or (k,) for
    multiclass), added to the initial scores and stored on the booster."""
    canon = objectives.canonical_objective(cfg.objective)
    if canon != cfg.objective:
        cfg = _dc_replace(cfg, objective=canon)
    _check_config(cfg)
    if valid_mask is not None and np.any(valid_mask):
        raise _unported("validation rows", "validation and early stopping")
    if group_ids is not None:
        raise _unported("query groups", "other objectives")
    if init_booster is not None and init_booster.trees:
        raise _unported("continued training (init_booster)", "continued training")
    _require_dense(x)
    dev = resolve_device(device)

    n, d = x.shape
    y = np.asarray(y).reshape(n)
    k = cfg.num_class if cfg.objective == "multiclass" else 1
    L, B = int(cfg.num_leaves), max(16, ((cfg.max_bin + 15) // 16) * 16)
    if L < 2:
        raise ValueError(f"num_leaves must be >= 2, got {L}")

    mapper = BinMapper.fit(x, max_bin=cfg.max_bin, seed=cfg.seed)
    bins = torch.from_numpy(mapper.transform(x)).to(dev)     # (n, d) uint8
    w = sample_weight if sample_weight is not None else np.ones(n, np.float32)
    w_dev = torch.from_numpy(np.asarray(w, np.float32)).to(dev)

    scores0 = np.zeros(n if k == 1 else (n, k), np.float32)
    scores0 = scores0 + np.asarray(base_score, np.float32)
    if init_score is not None:
        scores0 = scores0 + np.asarray(init_score).astype(scores0.dtype)
    scores = torch.from_numpy(np.ascontiguousarray(scores0, np.float32)).to(dev)
    if k > 1:
        y_enc = torch.from_numpy(np.eye(k, dtype=np.float32)[y.astype(np.int64)]).to(dev)
    else:
        y_enc = torch.from_numpy(y.astype(np.float32)).to(dev)

    sp = SplitParams.make(
        dev, lambda_l2=cfg.lambda_l2, lambda_l1=cfg.lambda_l1,
        min_sum_hessian=cfg.min_sum_hessian_in_leaf,
        min_gain=cfg.min_gain_to_split, learning_rate=cfg.learning_rate,
    )
    grow = grow_tree_depthwise if cfg.growth_policy == "depthwise" else grow_tree
    # every round's feature mask, drawn up front in the JAX package's order
    # and moved in one copy, so no round waits on a host-to-device transfer
    rng = np.random.default_rng(cfg.seed)
    fms = np.ones((cfg.num_iterations, d), np.float32)
    if cfg.feature_fraction < 1.0:
        for fm in fms:
            fm[:] = rng.random(d) < cfg.feature_fraction
            if fm.sum() == 0:
                fm[rng.integers(d)] = 1.0
    fms_dev = torch.from_numpy(fms).to(dev)
    pending = []
    for it in range(cfg.num_iterations):
        if cfg.objective == "binary":
            g, h = objectives.binary_grad_hess(scores, y_enc)
        elif cfg.objective == "multiclass":
            g, h = objectives.multiclass_grad_hess(scores, y_enc)
        else:
            g, h = objectives.l2_grad_hess(scores, y_enc)
        fm_dev = fms_dev[it]
        deltas = []
        for c in range(k):
            grown = grow(
                bins, g[:, c] if k > 1 else g, h[:, c] if k > 1 else h, w_dev,
                num_leaves=L, sp=sp, feature_mask=fm_dev,
                max_depth=int(cfg.max_depth),
                min_data_in_leaf=int(cfg.min_data_in_leaf), num_bins=B,
            )
            pending.append(_pack(grown))
            deltas.append(grown.leaf_values[grown.row_leaf])
        scores = scores + (torch.stack(deltas, 1) if k > 1 else deltas[0])

    booster = Booster(
        trees=[], objective=cfg.objective, num_class=k, num_features=d,
        base_score=base_score, boosting_type=cfg.boosting_type,
    )
    if pending:
        records = torch.stack(pending).cpu().numpy()  # the one host transfer
        booster.trees = [_tree_from_host(r, L, mapper) for r in records]
    return booster
