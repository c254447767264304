"""GBDT training loop on the device.

The port of ``mmlspark_tpu.models.gbdt.train``: per boosting round compute
gradients/hessians from the current scores, sample rows, grow one tree per
class (``treegrow``: histograms, split search and row assignment all on the
device), and update the scores from the grower's own row -> leaf output.
Scores, labels, gradients, row weights and the bin matrix (uint8) stay on
the device for the whole run. The host reads the device only where the
reference's algorithm needs a value there: the validation metrics, once per
chunk of rounds (every round's metric is computed on the device and the
stopping decision is replayed round by round), LambdaRank's f64 host
gradients for groups the padded device layout cannot hold, and the split
records, once, after the last kept round.

Ported: boosting types ``gbdt``, ``goss``, ``dart`` and ``rf``; bagging;
validation rows with device eval metrics and early stopping; the
objectives binary, multiclass, the regression zoo (with the quantile-family
leaf renewal) and lambdarank; ``lossguide`` and ``depthwise`` growth;
``feature_fraction``; sample weights; ``init_score``; ``base_score``. One
device, one Python loop over rounds. Random draws: ``sampling``.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item, Queue A item 3): categorical features, continued training,
voting-parallel, checkpoint/resume, elastic and multi-host training,
pre-binned and sparse input, delegates.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.models.gbdt import evaluation, objectives, sampling
from mmlspark_tpu_torch.models.gbdt.binning import BinMapper, _require_dense
from mmlspark_tpu_torch.models.gbdt.booster import Booster, Tree
from mmlspark_tpu_torch.models.gbdt.treegrow import (
    SplitParams,
    grow_tree,
    grow_tree_depthwise,
    predict_scores,
)

log = logging.getLogger("mmlspark_tpu_torch.gbdt")

BOOSTING_TYPES = ("gbdt", "goss", "dart", "rf")
OBJECTIVES = ("binary", "multiclass", "lambdarank") + objectives.REGRESSION_KINDS

# padded LambdaRank pair tensors are (G, M, M): above this many elements
# the f64 host gradients take over (the JAX package's bound)
MAX_RANK_PAIRS = 1 << 26

# device -> host reads made by the last ``train`` call (metric chunks,
# host LambdaRank gradients, the record transfer); chip_smoke.py prints it
host_reads = {"count": 0}


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` field for field, so one config
    drives both packages; fields of unported features must keep their
    defaults (``train`` checks)."""

    objective: str = "binary"          # binary|multiclass|lambdarank|regression kinds
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


def _objective_p1(cfg: TrainConfig) -> float:
    """The (single) knob each regression objective consumes."""
    return {
        "quantile": cfg.alpha,
        "huber": cfg.alpha,
        "fair": cfg.fair_c,
        "poisson": cfg.poisson_max_delta_step,
        "tweedie": cfg.tweedie_variance_power,
    }.get(cfg.objective, 0.0)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mmlspark_tpu_torch yet "
        f"(ROADMAP.md Queue A item 3: {item})"
    )


def _check_config(cfg: TrainConfig) -> None:
    if cfg.boosting_type not in BOOSTING_TYPES:
        raise ValueError(f"boosting_type must be one of {BOOSTING_TYPES}")
    if cfg.objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {cfg.objective!r}")
    if cfg.growth_policy not in ("lossguide", "depthwise"):
        raise ValueError(
            f"growth_policy must be 'lossguide' or 'depthwise', got {cfg.growth_policy!r}"
        )
    if cfg.boosting_type == "goss" and cfg.top_rate + cfg.other_rate > 1.0:
        # LightGBM refuses too: the sampler is unbiased only if b/(1-a) <= 1
        raise ValueError("goss requires top_rate + other_rate <= 1")
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


def _to_host(t: torch.Tensor) -> np.ndarray:
    host_reads["count"] += 1
    return t.cpu().numpy()


def _pairwise_sum(cols: list) -> torch.Tensor:
    """Sum of f32 columns in numpy's pairwise order (``np.sum`` over a
    contiguous axis), so dart's dropped-tree contributions round as the
    reference's host sum does."""
    n = len(cols)
    if n < 8:
        res = torch.zeros_like(cols[0])
        for c in cols:
            res = res + c
        return res
    if n <= 128:
        r = list(cols[:8])
        i = 8
        while i < n - n % 8:
            r = [r[j] + cols[i + j] for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for c in cols[i:]:
            res = res + c
        return res
    half = n // 2
    half -= half % 8
    return _pairwise_sum(cols[:half]) + _pairwise_sum(cols[half:])


class _DartTrees:
    """Dart's trees on the device: records, f32 thresholds and leaf values
    of every tree grown so far, so the dropped trees' contribution is a
    device replay (``predict_scores`` over the f32 features, as the
    reference's ``per_tree_raw``) and their rescaling a device multiply.
    The trees reach the host once, with everything else, at the end."""

    def __init__(self, x: np.ndarray, n_trees: int, L: int, B: int,
                 mapper: BinMapper, dev: torch.device):
        d = x.shape[1]
        self.x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        table = np.array(
            [[mapper.threshold_value(f, b) for b in range(B)] for f in range(d)]
        ).astype(np.float32)
        self.thr_table = torch.from_numpy(table).to(dev)   # (d, B): threshold of a bin
        i64 = torch.int64
        self.leaf = torch.full((n_trees, L - 1), -1, dtype=i64, device=dev)
        self.feature = torch.zeros((n_trees, L - 1), dtype=i64, device=dev)
        self.threshold = torch.full((n_trees, L - 1), torch.inf, device=dev)
        self.active = torch.zeros((n_trees, L - 1), dtype=torch.bool, device=dev)
        self.values = torch.zeros((n_trees, L), device=dev)

    def store(self, t: int, grown: Any, scale: float) -> None:
        feat = grown.rec_feature.clamp_min(0)
        self.leaf[t] = grown.rec_leaf
        self.feature[t] = feat
        self.threshold[t] = torch.where(
            grown.rec_active, self.thr_table[feat, grown.rec_bin.clamp_min(0)], torch.inf
        )
        self.active[t] = grown.rec_active
        self.values[t] = grown.leaf_values * scale

    def contrib(self, idx: torch.Tensor, k: int) -> torch.Tensor:
        """Summed raw output of the trees ``idx`` (rounds in drop order,
        classes inside): (n,), or (n, k) summed per class in that order."""
        per = predict_scores(
            self.x, self.leaf[idx], self.feature[idx], self.threshold[idx],
            self.active[idx], self.values[idx],
        )
        cols = list(per.unbind(1))
        if k == 1:
            return _pairwise_sum(cols)
        out = []
        for c in range(k):
            acc = torch.zeros_like(cols[0])
            for col in cols[c::k]:
                acc = acc + col
            out.append(acc)
        return torch.stack(out, 1)

    def scale(self, idx: torch.Tensor, factor: float) -> None:
        self.values[idx] = self.values[idx] * factor


def _rank_pads(group_ids: np.ndarray, keep: Optional[np.ndarray],
               dev: torch.device) -> Optional[tuple]:
    """The padded (G, M) group layout on the device, or None where the
    device path cannot take the groups: ids not contiguous (grouping would
    change), or (G, M, M) pair tensors above ``MAX_RANK_PAIRS``."""
    gids = np.asarray(group_ids)
    runs = 1 + int((gids[1:] != gids[:-1]).sum()) if len(gids) else 0
    if runs != len(np.unique(gids)):
        return None
    pi, va = objectives.lambdarank_pad_groups(gids, keep=keep)
    if pi.shape[0] * pi.shape[1] * pi.shape[1] > MAX_RANK_PAIRS:
        return None
    return torch.from_numpy(pi).to(dev), torch.from_numpy(va).to(dev)


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

    ``valid_mask``: (n,) bool, rows held out of training (weight 0, still
    binned) on which the metric of every round is computed; with
    ``early_stopping_round`` the fit stops after that many rounds without
    improvement and records ``best_iteration``. ``group_ids``: the query
    of every row (lambdarank).

    ``base_score``: boost_from_average baseline (scalar, or (k,) for
    multiclass), added to the initial scores and stored on the booster."""
    canon = objectives.canonical_objective(cfg.objective)
    if canon != cfg.objective:
        cfg = _dc_replace(cfg, objective=canon)
    _check_config(cfg)
    if canon in objectives.LOG_LINK_KINDS and np.any(np.asarray(y) < 0):
        # log-link objectives model a nonnegative mean; LightGBM errors too
        raise ValueError(f"objective {canon!r} requires non-negative labels")
    if canon == "lambdarank" and group_ids is None:
        raise ValueError("lambdarank needs group_ids (the query of every row)")
    if init_booster is not None and init_booster.trees:
        raise _unported("continued training (init_booster)", "continued training")
    _require_dense(x)
    dev = resolve_device(device)
    host_reads["count"] = 0

    n, d = x.shape
    y = np.asarray(y).reshape(n)
    k = cfg.num_class if cfg.objective == "multiclass" else 1
    L, B = int(cfg.num_leaves), max(16, ((cfg.max_bin + 15) // 16) * 16)
    T = int(cfg.num_iterations)
    if L < 2:
        raise ValueError(f"num_leaves must be >= 2, got {L}")
    is_rf = cfg.boosting_type == "rf"
    is_dart = cfg.boosting_type == "dart"
    is_goss = cfg.boosting_type == "goss"

    mapper = BinMapper.fit(x, max_bin=cfg.max_bin, seed=cfg.seed)
    bins = torch.from_numpy(mapper.transform(x)).to(dev)     # (n, d) uint8
    valid = None if valid_mask is None else np.asarray(valid_mask, bool).reshape(n)
    w = sample_weight if sample_weight is not None else np.ones(n, np.float32)
    if valid is not None:
        w = np.where(valid, 0.0, w)  # validation rows never train
    w_dev = torch.from_numpy(np.asarray(w, np.float32)).to(dev)

    bagging_fraction, bagging_freq = cfg.bagging_fraction, cfg.bagging_freq
    if is_rf and not (bagging_freq > 0 and bagging_fraction < 1.0):
        # rf without bagging would grow the same tree every round
        log.info("rf boosting without bagging params: defaulting to "
                 "bagging_fraction=0.632, bagging_freq=1")
        bagging_fraction, bagging_freq = 0.632, 1
    if is_goss and bagging_freq > 0:
        log.info("goss boosting: bagging disabled (GOSS is the row sampler)")
        bagging_freq = 0
    use_bag = bagging_freq > 0 and bagging_fraction < 1.0
    patience = cfg.early_stopping_round
    if is_dart and patience > 0:
        # dropout rescales trees inside any best-iteration prefix, so no
        # prefix reproduces the scores that won
        log.info("early stopping is not available in dart mode; disabled")
        patience = 0

    scores0 = np.zeros(n if k == 1 else (n, k), np.float32)
    scores0 = scores0 + np.asarray(base_score, np.float32)
    if init_score is not None:
        scores0 = scores0 + np.asarray(init_score).astype(scores0.dtype)
    scores = torch.from_numpy(np.ascontiguousarray(scores0, np.float32)).to(dev)
    if k > 1:
        y_enc = torch.from_numpy(np.eye(k, dtype=np.float32)[y.astype(np.int64)]).to(dev)
    else:
        y_enc = torch.from_numpy(y.astype(np.float32)).to(dev)
    p1_host = _objective_p1(cfg)
    p1 = torch.tensor(p1_host, dtype=torch.float32).to(dev)

    rank = None    # device layout of the query groups (lambdarank)
    if cfg.objective == "lambdarank":
        rank = _rank_pads(group_ids, None, dev)
    # dart refits from host scores each round, as the reference's
    # per-round loop does; so do groups the device layout cannot hold
    host_rank = cfg.objective == "lambdarank" and (rank is None or is_dart)

    def gradients(s: torch.Tensor) -> tuple:
        if cfg.objective == "binary":
            return objectives.binary_grad_hess(s, y_enc)
        if cfg.objective == "multiclass":
            return objectives.multiclass_grad_hess(s, y_enc)
        if cfg.objective == "lambdarank":
            if host_rank:
                g_np, h_np = objectives.lambdarank_grad_hess(
                    _to_host(s).astype(np.float64), y.astype(np.float64), group_ids)
                return torch.from_numpy(g_np).to(dev), torch.from_numpy(h_np).to(dev)
            return objectives.lambdarank_grad_hess_device(s, y_enc, *rank)
        return objectives.regression_grad_hess(cfg.objective, s, y_enc, p1)

    rf_base = None
    if is_rf:
        # constant gradients at the initial score; ``scores`` becomes the
        # running SUM of tree outputs (averaged for eval and prediction)
        rf_base = scores
        if cfg.objective == "lambdarank":
            g_np, h_np = objectives.lambdarank_grad_hess(
                scores0.astype(np.float64), y.astype(np.float64), group_ids)
            g_rf, h_rf = torch.from_numpy(g_np).to(dev), torch.from_numpy(h_np).to(dev)
        else:
            g_rf, h_rf = gradients(rf_base)
        scores = torch.zeros_like(scores)

    sp = SplitParams.make(
        dev, lambda_l2=cfg.lambda_l2, lambda_l1=cfg.lambda_l1,
        min_sum_hessian=cfg.min_sum_hessian_in_leaf,
        min_gain=cfg.min_gain_to_split,
        learning_rate=1.0 if is_rf else cfg.learning_rate,
    )
    grow = grow_tree_depthwise if cfg.growth_policy == "depthwise" else grow_tree
    renew = cfg.objective in objectives.RENEWED_KINDS and not is_rf
    q_renew = p1 if cfg.objective == "quantile" else torch.tensor(0.5).to(dev)
    # every round's host draws, made up front in the reference's order and
    # moved in one copy each, so no round waits on a host-to-device copy
    draws = sampling.draw_rounds(
        cfg.seed, T, d, cfg.feature_fraction, dart=is_dart,
        drop_rate=cfg.drop_rate, max_drop=cfg.max_drop, skip_drop=cfg.skip_drop,
    )
    fms_dev = torch.from_numpy(draws.feature_masks).to(dev)
    dart = drop_idx = None
    if is_dart:
        dart = _DartTrees(x, T * k, L, B, mapper, dev)
        flat = [r * k + c for sel in draws.drops for r in sel for c in range(k)]
        drop_idx = torch.tensor(flat, dtype=torch.int64).to(dev)

    # validation: every round's metric on the device, read once per chunk
    eval_on = valid is not None and bool(valid.any()) and not is_dart
    if eval_on:
        kind, eval_k = evaluation.eval_kind(cfg.objective, cfg.metric, cfg.eval_at)
        stopper = evaluation.EarlyStopping(kind, patience)
        valid_w = torch.from_numpy(valid.astype(np.float32)).to(dev)
        host_ndcg = kind == "ndcg" and rank is None
        rank_eval = _rank_pads(group_ids, valid, dev) if kind == "ndcg" and not host_ndcg else None
        chunk = 1 if host_ndcg else (T if patience == 0 else min(T, max(16, patience)))
        metric_name = (
            f"ndcg@{eval_k}" if kind == "ndcg"
            else objectives.regression_metric_name(kind)
            if kind in objectives.REGRESSION_KINDS else kind
        )

        def metric(s: torch.Tensor) -> Any:
            if host_ndcg:
                return objectives.grouped_ndcg(
                    _to_host(s)[valid], y[valid], np.asarray(group_ids)[valid], k=eval_k)
            if kind == "ndcg":
                return objectives.grouped_ndcg_device(s, y_enc, *rank_eval, k=eval_k)
            return evaluation.device_metric(s, y_enc, valid_w, kind, p1)

    pending: list = []
    history: list = []
    chunk_vals: list = []
    kept_rounds, it0, drop_at = T, 0, 0
    bag = None
    for it in range(T):
        w_it = w_dev
        if use_bag:
            if it % bagging_freq == 0:
                u = sampling.uniform(cfg.seed, it, sampling.BAGGING_STREAM, n, dev)
                bag = (u < bagging_fraction).float()
            w_it = w_dev * bag
        drop = draws.drops[it]
        eff = scores
        if drop:
            idx = drop_idx[drop_at: drop_at + len(drop) * k]
            drop_at += len(drop) * k
            contrib = dart.contrib(idx, k)
            eff = scores - contrib
        g, h = (g_rf, h_rf) if is_rf else gradients(eff)
        w_grow = w_it
        if is_goss:
            g_abs = g.abs()
            if k > 1:
                g_abs = g_abs.sum(1)
            u = sampling.uniform(cfg.seed, it, sampling.GOSS_STREAM, n, dev)
            w_grow = w_it * sampling.goss_weights(g_abs, w_it, u, cfg.top_rate, cfg.other_rate)
        nf_new = 1.0 / (len(drop) + 1)
        deltas = []
        for c in range(k):
            grown = grow(
                bins, g[:, c] if k > 1 else g, h[:, c] if k > 1 else h, w_grow,
                num_leaves=L, sp=sp, feature_mask=fms_dev[it],
                max_depth=int(cfg.max_depth),
                min_data_in_leaf=int(cfg.min_data_in_leaf), num_bins=B,
            )
            if renew:
                # the leaf's weighted percentile of residuals over the
                # sampled rows at their pre-GOSS weights (LightGBM's
                # RenewTreeOutput; GOSS amplification is not a data weight)
                w_sel = torch.where(w_grow > 0, w_it, 0.0)
                if cfg.objective == "mape":
                    w_sel = w_sel / torch.clamp_min(y_enc.abs(), 1.0)
                renewed = objectives.leaf_quantile_renewal(
                    grown.row_leaf, y_enc - eff, w_sel, L, q_renew) * sp.learning_rate
                grown = grown._replace(
                    leaf_values=torch.where(grown.leaf_counts > 0, renewed, 0.0))
            deltas.append(grown.leaf_values[grown.row_leaf])
            pending.append(_pack(grown))
            if is_dart:
                dart.store(it * k + c, grown, nf_new)
        step = torch.stack(deltas, 1) if k > 1 else deltas[0]
        new_scores = eff + step
        if drop:
            # dart: the new tree x 1/(m+1), the m dropped trees x m/(m+1);
            # the running scores keep the dropped trees' contribution
            nf_drop = len(drop) / (len(drop) + 1)
            scores = (scores - eff) + new_scores
            scores = scores + step * (nf_new - 1.0)
            dart.scale(idx, nf_drop)
            scores = scores - contrib * (1.0 - nf_drop)
        else:
            scores = new_scores
        if eval_on:
            chunk_vals.append(metric(rf_base + scores / (it + 1) if is_rf else scores))
            if len(chunk_vals) == chunk or it == T - 1:
                vals = (chunk_vals if host_ndcg
                        else _to_host(torch.stack(chunk_vals)).tolist())
                keep = stopper.replay(vals, it0)
                history += vals[: len(vals) if keep is None else keep]
                if keep is not None:
                    kept_rounds = it0 + keep
                    break
                it0, chunk_vals = it + 1, []

    booster = Booster(
        trees=[], objective=cfg.objective, num_class=k, num_features=d,
        base_score=base_score, boosting_type=cfg.boosting_type,
        objective_param=(
            p1_host if cfg.objective in ("quantile", "huber", "fair", "tweedie") else None
        ),
    )
    n_trees = kept_rounds * k
    if n_trees:
        recs = torch.stack(pending[:n_trees])
        if is_dart:  # the trees' final, rescaled values
            s = 5 * (L - 1)
            recs[:, s: s + L] = dart.values[:n_trees].double()
        records = _to_host(recs)  # the one transfer of the records
        booster.trees = [_tree_from_host(r, L, mapper) for r in records]
    if eval_on:
        booster.evals = {metric_name: history}
        if stopper.best_iter > 0:
            booster.best_iteration = stopper.best_iter
    return booster
