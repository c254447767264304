"""GBDT training loop on the device.

The port of ``mmlspark_tpu.models.gbdt.train``: per boosting round compute
gradients/hessians from the current scores, sample rows, grow one tree per
class (``treegrow``: histograms, split search and row assignment all on the
device), and update the scores from the grower's own row -> leaf output.
Scores, labels, gradients, row weights and the bin matrix (uint8) stay on
the device for the whole run. The host reads the device only where the
reference's algorithm needs a value there: the validation metrics, once per
chunk of rounds (every round's metric is computed on the device and the
stopping decision is replayed round by round; every round when a delegate
listens), LambdaRank's f64 host gradients for groups the padded device
layout cannot hold, a checkpoint's scores and records, and the split
records, once, after the last kept round.

Ported: boosting types ``gbdt``, ``goss``, ``dart`` and ``rf``; bagging;
validation rows with device eval metrics and early stopping; the
objectives binary, multiclass, the regression zoo (with the quantile-family
leaf renewal) and lambdarank; ``lossguide`` and ``depthwise`` growth;
categorical features (subset splits); continued training
(``init_booster``); round-level checkpoint/resume (``checkpoint``);
training delegates (``delegate``); ``feature_fraction``; sample weights;
``init_score``; ``base_score``; dense, sparse (CSR) and pre-binned
(``BinnedDataset``) input, binned on the fit's device (``binning``).
Random draws: ``sampling``.

Fused rounds (``fused_rounds``, the JAX package's scan-fused chunks): where
no round needs the host (no delegate, not dart, a device metric and device
LambdaRank gradients), one round runs as a function of static device
buffers only: the round index is a device scalar, and the round's Threefry
keys, feature mask and bag are derived from it on the device; scores and
bag are updated in place, the tree records go into a (T, k, W) buffer at
row ``it`` and the metric into a (T,) buffer. On the card that round is
captured once as a CUDA graph after one eager warm-up round and replayed,
so a round costs one graph launch instead of thousands of kernel launches;
on the CPU, and on the card with ``fused_rounds=1``, it runs eagerly. The
host reads the metrics once per chunk and the records once (and at each
checkpoint). That one round body serves every eligible fit, graph or
not; only dart, delegates and the host LambdaRank/NDCG cases take the
per-round loop, which reads the host between rounds.

Multi-rank training (the JAX package's multi-process branch): when the
default ``torch.distributed`` group has two or more ranks, each rank calls
``train`` with its own rows, as each JAX process does. The bin mapper is
fitted on an all-gathered sample (a CSR sample densified, absent entries
NaN), row draws (bagging, GOSS) are keyed to the rows' global positions,
every histogram and leaf sum is built over all the ranks
(``data_parallel``: ``ops/histogram.py``'s distributed form; or
``voting_parallel``: ``voting.grow_tree_voting``), and every rank grows the
same trees: the boosters are byte-identical across ranks. Whatever else
needs all the rows is gathered in global row order, so that every rank
makes the same host decision from the same arrays: GOSS's top-rate
threshold (every rank's masked |g|, the eligible count all-reduced), the
renewed objectives' leaf percentiles (every rank's leaf, residual and
weight), and the validation metric (labels, mask and query ids once, the
scores every round; query ids offset by rank, ``gid * world + rank``, so
two ranks' query 0 stay two queries). Dart's drops are host draws, the
same on every rank, and its replays score the rank's own rows, as do a
continued fit's starting scores and LambdaRank's gradients (a query's
rows on one rank, the reference's partition contract). The rounds run
eagerly (a collective is not captured in a CUDA graph). Checkpoint/resume
and pre-binned input are single-process only and raise ``ValueError`` at
two ranks or more, as in the JAX package. With one rank
``voting_parallel`` falls back to ``data_parallel``, as in the JAX package.
Elastic gang training is not ported yet (ROADMAP.md, A4 step 2).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.compiler.kernels import pairwise_sum
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.models.gbdt import checkpoint as ckpt
from mmlspark_tpu_torch.models.gbdt import evaluation, objectives, sampling
from mmlspark_tpu_torch.models.gbdt.binning import (
    BinMapper,
    BinnedDataset,
    densify_missing,
    is_sparse,
)
from mmlspark_tpu_torch.models.gbdt.booster import Booster, Tree
from mmlspark_tpu_torch.ops.histogram import NUM_BINS
from mmlspark_tpu_torch.models.gbdt.treegrow import (
    SplitParams,
    grow_tree,
    grow_tree_depthwise,
    grow_tree_partitioned,
    predict_scores,
)
from mmlspark_tpu_torch.models.gbdt.voting import grow_tree_voting
from mmlspark_tpu_torch.parallel import collectives, make_mesh, multihost_pad_target
from mmlspark_tpu_torch.parallel.mesh import group_rank_size

log = logging.getLogger("mmlspark_tpu_torch.gbdt")

BOOSTING_TYPES = ("gbdt", "goss", "dart", "rf")
OBJECTIVES = ("binary", "multiclass", "lambdarank") + objectives.REGRESSION_KINDS

# padded LambdaRank pair tensors are (G, M, M): above this many elements
# the f64 host gradients take over (the JAX package's bound)
MAX_RANK_PAIRS = 1 << 26

# device -> host reads made by the last ``train`` call (metric chunks,
# host LambdaRank gradients, checkpoints, the record transfer);
# chip_smoke.py prints it
host_reads = {"count": 0}
# the last ``train`` call's fused chunks (the JAX package's
# mmlspark_gbdt_fused_chunks_total), CUDA graph captures and replays
fused = {"chunks": 0, "captures": 0, "replays": 0}


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` field for field, so one config
    drives both packages (and a checkpoint's fingerprint is the same in
    both)."""

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


_DELEGATE_HOOKS = ("before_train_iteration", "after_train_iteration", "get_learning_rate")


def _partitioned() -> bool:
    """Lossguide fits use the data-partitioned grower when
    ``MMLSPARK_TPU_GBDT_PARTITION`` (the JAX package's switch) is set and
    not "0"/"false"; off by default, as in the JAX package. It is there for
    parity, not speed (``grow_tree_partitioned``)."""
    env = os.environ.get("MMLSPARK_TPU_GBDT_PARTITION")
    return env is not None and env not in ("0", "false")


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
    if cfg.parallelism not in ("data_parallel", "voting_parallel"):
        raise ValueError(
            f"parallelism must be 'data_parallel' or 'voting_parallel', got {cfg.parallelism!r}"
        )
    if cfg.growth_policy == "depthwise" and cfg.parallelism == "voting_parallel":
        # the voting grower is leaf-wise: an explicit depthwise request is
        # not quietly dropped
        raise ValueError("growth_policy='depthwise' is incompatible with voting_parallel")
    if cfg.delegate is not None:
        missing = [h for h in _DELEGATE_HOOKS if not hasattr(cfg.delegate, h)]
        if missing:
            raise TypeError(f"delegate lacks the LightGBMDelegate hooks {missing}")


def _pad_catmask(cm: np.ndarray) -> np.ndarray:
    """Histogram-space catmask (..., B) -> record-space (..., NUM_BINS):
    stored trees keep the whole uint8 bin space, so prediction's category
    lookup (clipped to NUM_BINS - 1) never leaves the mask; the padding
    bins are no category's, so an unseen category goes right."""
    pad = [(0, 0)] * (cm.ndim - 1) + [(0, NUM_BINS - cm.shape[-1])]
    return np.pad(cm, pad)


def _tree_from_host(rec: np.ndarray, L: int, mapper: BinMapper, B: int,
                    has_cat: bool) -> Tree:
    """One tree's packed f64 record vector -> a host Tree."""
    s = L - 1
    leaf, feature, bin_, active, gain = (rec[i * s:(i + 1) * s] for i in range(5))
    values, counts = rec[5 * s: 5 * s + L], rec[5 * s + L: 5 * s + 2 * L]
    is_cat = catmask = None
    if has_cat:
        is_cat = rec[5 * s + 2 * L: 6 * s + 2 * L] > 0.5
        words = rec[6 * s + 2 * L:].astype(np.int64)
        catmask = ((words[:, None] >> np.arange(16)) & 1).astype(bool).reshape(s, B)
    thr = np.array(
        [
            # a categorical split routes by its catmask, never by a threshold
            mapper.threshold_value(int(f), int(b))
            if f >= 0 and not (has_cat and is_cat[k]) else np.inf
            for k, (f, b) in enumerate(zip(feature, bin_))
        ],
        dtype=np.float64,
    )
    cat_tree = has_cat and bool(is_cat.any())
    return Tree(
        leaf=leaf.astype(np.int32),
        feature=feature.astype(np.int32),
        threshold=thr,
        active=active > 0.5,
        gain=gain.astype(np.float32),
        values=values.astype(np.float32),
        counts=counts.astype(np.int32),
        is_cat=is_cat if cat_tree else None,
        catmask=_pad_catmask(catmask) if cat_tree else None,
    )


def _pack(grown: Any) -> torch.Tensor:
    """A grown tree's records as one f64 vector (exact for every field),
    so all trees reach the host in one transfer. A categorical fit adds
    ``rec_is_cat`` and the catmask bits, 16 to a word."""
    parts = [
        grown.rec_leaf.double(), grown.rec_feature.double(),
        grown.rec_bin.double(), grown.rec_active.double(),
        grown.rec_gain.double(), grown.leaf_values.double(),
        grown.leaf_counts.double(),
    ]
    if grown.rec_is_cat is not None:
        bits = grown.rec_catmask.reshape(-1, 16).double()
        weights = 2.0 ** torch.arange(16, dtype=torch.float64, device=bits.device)
        parts += [grown.rec_is_cat.double(), (bits * weights).sum(1)]
    return torch.cat(parts)


def _pack_width(L: int, B: int, has_cat: bool) -> int:
    """Length of one tree's :func:`_pack` vector."""
    return 5 * (L - 1) + 2 * L + ((L - 1) * (1 + B // 16) if has_cat else 0)


def _densify(x: Any) -> np.ndarray:
    """CSR -> dense float32 with absent entries as NaN (what dart's replays
    and a continued fit's scores see: trees trained on sparse data route
    absent entries through the missing bin)."""
    if is_sparse(x):
        return densify_missing(x)
    return np.asarray(x, np.float32)


def _check_multirank(*, pre_binned: bool, checkpointing: bool) -> None:
    """What a fit over two or more ranks refuses, with the JAX package's
    errors: pre-binned input and checkpoint/resume are single-process
    only."""
    if pre_binned:
        raise ValueError("pre-binned input is single-process only")
    if checkpointing:
        raise ValueError(
            "GBDT checkpoint/resume is single-process only (multi-rank runs "
            "re-rendezvous through torch.distributed instead)"
        )


class _RankRows:
    """This rank's rows among all the ranks' rows, which stand in rank
    order as the JAX package's process-stacked global rows: ``at`` is the
    global position of the rank's first row in the padded layout (rank *
    share, share the largest rank's row count: row draws are keyed to it),
    ``counts`` every rank's row count. ``gather`` and ``gather32`` give
    every rank the same rows in global order, padding dropped."""

    def __init__(self, n: int, dev: torch.device):
        self.rank = group_rank_size()[0]
        self.counts = [int(c) for c in
                       collectives.all_gather(torch.tensor([n], dtype=torch.int64))]
        self.at = self.rank * multihost_pad_target(n, make_mesh(device=dev))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather_rows(t, counts=self.counts)

    def gather32(self, *ts: torch.Tensor) -> tuple:
        """Several (n,) tensors of 32-bit types in one collective: their
        bits side by side as int32 columns."""
        cols = torch.stack([t.view(torch.int32) for t in ts], 1)
        got = self.gather(cols)
        return tuple(got[:, i].contiguous().view(t.dtype) for i, t in enumerate(ts))

    def any(self, flag: bool) -> bool:
        """One decision for every rank: whether any rank's ``flag`` holds."""
        return bool(collectives.allreduce_max(torch.tensor([int(flag)], dtype=torch.int64)))


def _multirank_mapper(x: np.ndarray, cfg: TrainConfig, cat_features: tuple,
                      world: int, dev: torch.device) -> BinMapper:
    """Bin bounds identical on every rank: the mapper is fitted on a
    NaN-padded sample of ``max(1, 50,000 // world)`` rows a rank
    (``default_rng(seed).choice``; CSR rows densified, absent entries NaN),
    all-gathered (NaN rows are ignored by the quantile fit), with each
    categorical column's global maximum planted in every rank's sample, as
    the JAX package's multi-process branch builds it."""
    n, d = x.shape
    sparse_input = is_sparse(x)
    if cat_features and sparse_input:
        # the one-device mapper's error: the densified sample must not
        # accept what one process would refuse
        raise ValueError(
            "categorical features require dense input (sparse columns have no "
            "stable category<->bin identity for absent entries)"
        )
    k_s = max(1, 50_000 // world)
    samp = np.full((k_s, d), np.nan, np.float32)
    take = np.random.default_rng(cfg.seed).choice(n, min(n, k_s), replace=False)
    # a CSR sample densified: absent entries NaN, the missing bin's values
    samp[: len(take)] = _densify(x[take]) if sparse_input else np.asarray(x[take], np.float32)
    if cat_features:
        # the categorical range must cover every category of every rank,
        # and its check is one decision for all ranks
        ext = np.zeros((len(cat_features), 2), np.float64)
        for j, f in enumerate(cat_features):
            col = np.asarray(x[:, f], np.float64)
            col = col[~np.isnan(col)]
            ext[j] = (col.min(), col.max()) if len(col) else (0.0, 0.0)
        gext = collectives.all_gather(torch.from_numpy(ext), tiled=False).numpy()
        gmin, gmax = gext[..., 0].min(axis=0), gext[..., 1].max(axis=0)
        bad = np.flatnonzero((gmin < 0) | (gmax > cfg.max_bin - 2))
        if len(bad):
            raise ValueError(
                f"categorical features {[cat_features[b] for b in bad]} "
                f"have values outside [0, {cfg.max_bin - 2}] — re-index categories first"
            )
        for j, f in enumerate(cat_features):
            samp[0, f] = gmax[j]
    sample = collectives.all_gather(torch.from_numpy(samp)).to(dev)
    return BinMapper.fit(sample, max_bin=cfg.max_bin, seed=cfg.seed,
                         categorical_features=cat_features, device=dev)


def _to_host(t: torch.Tensor) -> np.ndarray:
    host_reads["count"] += 1
    return t.cpu().numpy()


class _DartTrees:
    """Dart's trees on the device: records, f32 thresholds and leaf values
    of every tree grown so far, so the dropped trees' contribution is a
    device replay (``predict_scores`` over the f32 features, as the
    reference's ``per_tree_raw``) and their rescaling a device multiply.
    The trees reach the host once, with everything else, at the end (and
    at each checkpoint)."""

    def __init__(self, x: np.ndarray, n_trees: int, L: int, B: int,
                 mapper: BinMapper, dev: torch.device, has_cat: bool):
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
        self.is_cat = self.catmask = None
        if has_cat:
            self.is_cat = torch.zeros((n_trees, L - 1), dtype=torch.bool, device=dev)
            self.catmask = torch.zeros((n_trees, L - 1, NUM_BINS), dtype=torch.bool,
                                       device=dev)

    def store(self, t: int, grown: Any, scale: float) -> None:
        feat = grown.rec_feature.clamp_min(0)
        numeric = grown.rec_active
        if self.is_cat is not None:
            numeric = numeric & ~grown.rec_is_cat
            self.is_cat[t] = grown.rec_is_cat
            self.catmask[t, :, : grown.rec_catmask.shape[1]] = grown.rec_catmask
        self.leaf[t] = grown.rec_leaf
        self.feature[t] = feat
        self.threshold[t] = torch.where(
            numeric, self.thr_table[feat, grown.rec_bin.clamp_min(0)], torch.inf
        )
        self.active[t] = grown.rec_active
        self.values[t] = grown.leaf_values * scale

    def load(self, t: int, tree: Tree) -> None:
        """A tree of a checkpoint (a resumed fit's earlier rounds)."""
        dev = self.leaf.device
        self.leaf[t] = torch.from_numpy(tree.leaf.astype(np.int64)).to(dev)
        self.feature[t] = torch.from_numpy(np.clip(tree.feature, 0, None).astype(np.int64)).to(dev)
        self.threshold[t] = torch.from_numpy(tree.threshold.astype(np.float32)).to(dev)
        self.active[t] = torch.from_numpy(tree.active).to(dev)
        self.values[t] = torch.from_numpy(tree.values).to(dev)
        if self.is_cat is not None and tree.is_cat is not None:
            self.is_cat[t] = torch.from_numpy(tree.is_cat).to(dev)
            self.catmask[t] = torch.from_numpy(tree.catmask).to(dev)

    def contrib(self, idx: torch.Tensor, k: int) -> torch.Tensor:
        """Summed raw output of the trees ``idx`` (rounds in drop order,
        classes inside): (n,), or (n, k) summed per class in that order."""
        cat = (None, None) if self.is_cat is None else (self.is_cat[idx], self.catmask[idx])
        per = predict_scores(
            self.x, self.leaf[idx], self.feature[idx], self.threshold[idx],
            self.active[idx], self.values[idx], None, *cat,
        )
        cols = list(per.unbind(1))
        if k == 1:
            return pairwise_sum(cols)
        out = []
        for c in range(k):
            acc = torch.zeros_like(cols[0])
            for col in cols[c::k]:
                acc = acc + col
            out.append(acc)
        return torch.stack(out, 1)

    def scale(self, idx: torch.Tensor, factor: float) -> None:
        self.values[idx] = self.values[idx] * factor


def _init_scores(booster: Booster, x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A continued fit's starting scores: every tree of ``booster`` (not
    its best-iteration prefix: ``merge`` keeps them all) replayed on the
    device and summed as the JAX package's ``predict_raw`` sums them
    (numpy's pairwise f32 order per class, / the rf tree count, +
    base_score), so both packages start from the same scores."""
    per = booster._per_tree(x, len(booster.trees) // booster.num_class, dev)
    return booster.raw_scores(per)


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
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    resume_from: Optional[str] = None,
    fused_rounds: int = 0,
) -> Booster:
    """Fit a booster on a dense (n, d) float matrix, a scipy-style CSR
    matrix (stored values binned per column, absent entries in the missing
    bin) or a :class:`BinnedDataset` (already binned: no dart, continued
    training or categorical features, and ``max_bin`` at least the
    mapper's).

    ``device``: where training runs; ``None`` means ``"cuda"``, which
    raises when no card is present. Pass ``"cpu"`` to train on the CPU
    through the plain PyTorch histogram versions.

    ``valid_mask``: (n,) bool, rows held out of training (weight 0, still
    binned) on which the metric of every round is computed; with
    ``early_stopping_round`` the fit stops after that many rounds without
    improvement and records ``best_iteration``. ``group_ids``: the query
    of every row (lambdarank).

    ``base_score``: boost_from_average baseline (scalar, or (k,) for
    multiclass), added to the initial scores and stored on the booster.

    ``init_booster``: continued training — the new trees fit on top of
    that booster's scores (all its trees) and are appended to it
    (``Booster.merge``).

    ``checkpoint_dir``: every ``checkpoint_every`` rounds (and after the
    last) the trees, scores, bag, host generator state and early-stopping
    counters go there (``checkpoint``); ``resume_from`` continues from the
    last complete checkpoint of a directory (a fresh fit if it holds
    none) and gives the model string of the uninterrupted fit, byte for
    byte. The same directory for both is a crash-loop-safe auto-resume.

    Over two or more ranks of the default ``torch.distributed`` group each
    rank passes its own rows and gets the same booster (module
    docstring); the rounds then run eagerly.

    ``fused_rounds``: 0 (the default) runs eligible fits as fused chunks
    sized automatically (the whole run without early stopping,
    ``min(T, max(16, patience))`` rounds with it); 1 runs the same rounds
    eagerly, one at a time, with no CUDA graph and no fused chunk; N > 1
    caps a chunk at N rounds. With ``checkpoint_dir`` chunks align to
    ``checkpoint_every``. Neither the chunk size nor the graph changes the
    model, only how often the host reads the device and how the rounds are
    launched. A fit with a delegate, dart, host LambdaRank gradients or a
    host metric takes the per-round loop. On the card a fused fit captures
    one round as a CUDA graph; a capture or replay that fails raises."""
    canon = objectives.canonical_objective(cfg.objective)
    if canon != cfg.objective:
        cfg = _dc_replace(cfg, objective=canon)
    _check_config(cfg)
    if canon in objectives.LOG_LINK_KINDS and np.any(np.asarray(y) < 0):
        # log-link objectives model a nonnegative mean; LightGBM errors too
        raise ValueError(f"objective {canon!r} requires non-negative labels")
    if canon == "lambdarank" and group_ids is None:
        raise ValueError("lambdarank needs group_ids (the query of every row)")
    pre_binned = isinstance(x, BinnedDataset)
    sparse_input = not pre_binned and is_sparse(x)
    if pre_binned:
        # rows binned elsewhere: whatever needs the float matrix is refused
        if cfg.boosting_type == "dart":
            raise ValueError(
                "pre-binned input does not support dart (dropped-tree "
                "re-prediction needs the float matrix)"
            )
        if init_booster is not None and init_booster.trees:
            raise ValueError(
                "pre-binned input does not support init_booster "
                "(warm-start scoring needs the float matrix)"
            )
        if cfg.categorical_features:
            raise ValueError(
                "pre-binned input does not support categorical_features "
                "(identity binning is a fit-time decision)"
            )
        if x.mapper.max_bin > cfg.max_bin:
            # the histogram space is sized from cfg.max_bin: a larger code
            # would land in the wrong plane
            raise ValueError(
                f"pre-binned input was quantized with max_bin="
                f"{x.mapper.max_bin} but cfg.max_bin={cfg.max_bin}; "
                "bin codes would overflow the histogram space"
            )
    world = group_rank_size()[1]
    dev = resolve_device(device)
    ranks = None   # this rank's place among the ranks' rows (two ranks or more)
    if world > 1:
        _check_multirank(pre_binned=pre_binned,
                         checkpointing=bool(checkpoint_dir or resume_from))
        ranks = _RankRows(x.shape[0], dev)
    elif cfg.parallelism == "voting_parallel":
        log.info("voting_parallel needs >1 data shard; falling back to data_parallel")
    host_reads["count"] = 0
    for key in fused:
        fused[key] = 0

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
    cat_features = tuple(int(f) for f in (cfg.categorical_features or ()))
    delegate = cfg.delegate

    if pre_binned:
        mapper = x.mapper
        bins = torch.from_numpy(x.bins).to(dev)
    else:
        # binned on the fit's device; a dense matrix crosses to it once
        src = x if sparse_input else torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if world > 1:
            mapper = _multirank_mapper(x, cfg, cat_features, world, dev)
        else:
            mapper = BinMapper.fit(src, max_bin=cfg.max_bin, seed=cfg.seed,
                                   categorical_features=cat_features, device=dev)
        bins = mapper.bin_tensor(src, dev)                    # (n, d) uint8
        del src
    cat_mask = None
    if cat_features:
        cat_np = np.zeros(d, bool)
        cat_np[list(cat_features)] = True
        cat_mask = torch.from_numpy(cat_np).to(dev)
    valid = None if valid_mask is None else np.asarray(valid_mask, bool).reshape(n)
    # validation: every round's metric on the device, read once per chunk
    # (dart too: its metric reaches a delegate, though it never stops early)
    eval_on = valid is not None and bool(valid.any())
    if ranks is not None:
        # one decision for every rank: a rank without validation rows still
        # takes every round's metric collective
        eval_on = ranks.any(eval_on)
        if eval_on and valid is None:
            valid = np.zeros(n, bool)
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
    # a rank's rows sit at global positions rank * share + i (share: the
    # largest rank's row count), so its bag and GOSS draws are the JAX
    # package's draws over the padded global rows
    row_at = 0 if ranks is None else ranks.at
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
    continued = init_booster is not None and bool(init_booster.trees)
    if continued and init_booster.num_class != k:
        raise ValueError(
            f"init_booster has {init_booster.num_class} classes, this fit {k}: "
            "continued training needs the same class count"
        )
    if continued:
        scores = scores + _init_scores(init_booster, _densify(x), dev)
    if k > 1:
        y_enc = torch.from_numpy(np.eye(k, dtype=np.float32)[y.astype(np.int64)]).to(dev)
    else:
        y_enc = torch.from_numpy(y.astype(np.float32)).to(dev)
    p1_host = _objective_p1(cfg)
    p1 = torch.tensor(p1_host, dtype=torch.float32).to(dev)

    rank = None    # device layout of the query groups (lambdarank)
    rank_fits = False
    if cfg.objective == "lambdarank":
        rank = _rank_pads(group_ids, None, dev)
        rank_fits = rank is not None
        if ranks is not None:
            # one path for every rank: the host's if any rank's groups
            # do not fit the device layout
            rank_fits = not ranks.any(not rank_fits)
    # dart refits from host scores each round, as the reference's
    # per-round loop does; so do groups the device layout cannot hold
    host_rank = cfg.objective == "lambdarank" and (not rank_fits or is_dart)

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
                _to_host(rf_base).astype(np.float64), y.astype(np.float64), group_ids)
            g_rf, h_rf = torch.from_numpy(g_np).to(dev), torch.from_numpy(h_np).to(dev)
        else:
            g_rf, h_rf = gradients(rf_base)
        scores = torch.zeros_like(scores)

    # -- checkpoint/resume --------------------------------------------------
    start, lr_cur, resumed = 0, float(cfg.learning_rate), None
    trees_done: list = []          # host trees of finished rounds (resumed, checkpointed)
    fingerprint = None
    checkpoint_every = max(1, int(checkpoint_every))
    if checkpoint_dir or resume_from:
        fingerprint = ckpt.config_fingerprint(cfg, n, d, k)
    if resume_from:
        resumed = ckpt.load_checkpoint(resume_from)
    if resumed is not None:
        if resumed.fingerprint != fingerprint:
            raise ValueError(
                f"checkpoint at {resume_from!r} was written by a different training "
                "configuration or dataset shape — refusing to resume (fingerprint mismatch)"
            )
        start, lr_cur = resumed.round, resumed.lr
        trees_done = list(resumed.booster.trees)
        scores = torch.from_numpy(
            np.ascontiguousarray(resumed.scores, np.float32).reshape(tuple(scores.shape))
        ).to(dev)
        log.info("resuming GBDT training from round %d", start)

    sp = SplitParams.make(
        dev, lambda_l2=cfg.lambda_l2, lambda_l1=cfg.lambda_l1,
        min_sum_hessian=cfg.min_sum_hessian_in_leaf,
        min_gain=cfg.min_gain_to_split,
        learning_rate=1.0 if is_rf else lr_cur,
    )
    grow = (grow_tree_depthwise if cfg.growth_policy == "depthwise"
            else grow_tree_partitioned if _partitioned() and world == 1 else grow_tree)
    grow_kw: dict = {}
    if world > 1:
        # every plane over all the ranks' rows (the default group)
        grow_kw["group"] = torch.distributed.group.WORLD
        if cfg.parallelism == "voting_parallel":
            grow, grow_kw["top_k"] = grow_tree_voting, int(cfg.top_k)
    renew = cfg.objective in objectives.RENEWED_KINDS and not is_rf
    q_renew = p1 if cfg.objective == "quantile" else torch.tensor(0.5).to(dev)
    # every round's host draws, made up front in the reference's order and
    # moved in one copy each, so no round waits on a host-to-device copy
    draws = sampling.draw_rounds(
        cfg.seed, T, d, cfg.feature_fraction, dart=is_dart,
        drop_rate=cfg.drop_rate, max_drop=cfg.max_drop, skip_drop=cfg.skip_drop,
        start=start, state=None if resumed is None else resumed.rng_state,
    )
    fms_dev = torch.from_numpy(draws.feature_masks).to(dev)
    dart = drop_idx = None
    if is_dart:
        dart = _DartTrees(_densify(x), max(T, start) * k, L, B, mapper, dev,
                          cat_mask is not None)
        for t, tree in enumerate(trees_done):
            dart.load(t, tree)
        flat = [r * k + c for sel in draws.drops for r in sel for c in range(k)]
        drop_idx = torch.tensor(flat, dtype=torch.int64).to(dev)

    bag = None
    if use_bag and start > 0:
        # the bag in force at ``start``: redrawn from its round, and held
        # against the one the checkpoint saved
        r0 = (start - 1) // bagging_freq * bagging_freq
        bag = (sampling.uniform(cfg.seed, r0, sampling.BAGGING_STREAM, n, dev, row_at)
               < bagging_fraction).float()
        if resumed.bag is None or not np.array_equal(_to_host(bag), resumed.bag):
            raise ValueError(
                f"checkpoint at {resume_from!r}: its bagging mask is not the draw of "
                f"round {r0} — refusing to resume"
            )

    # over ranks the metric is computed on every rank's rows gathered in
    # global order: labels, mask and query ids once, the scores every round
    if eval_on:
        kind, eval_k = evaluation.eval_kind(cfg.objective, cfg.metric, cfg.eval_at)
        stopper = evaluation.EarlyStopping(kind, patience)
        if resumed is not None:
            stopper.best, stopper.best_iter = resumed.best_val, resumed.best_iter
            stopper.since = resumed.rounds_no_improve
        ev_y, ev_valid, ev_gid, y_ev = y, valid, group_ids, y_enc
        if ranks is not None:
            gid_l = (np.zeros(n) if group_ids is None
                     else np.asarray(group_ids, np.float64) * world + ranks.rank)
            cols = ranks.gather(torch.from_numpy(
                np.stack([y.astype(np.float64), valid.astype(np.float64), gid_l], 1))).numpy()
            ev_y, ev_valid, ev_gid = cols[:, 0], cols[:, 1] > 0.5, cols[:, 2].astype(np.int64)
            y_ev = torch.from_numpy(
                np.eye(k, dtype=np.float32)[ev_y.astype(np.int64)] if k > 1
                else ev_y.astype(np.float32)).to(dev)
        valid_w = torch.from_numpy(ev_valid.astype(np.float32)).to(dev)
        rank_eval = (_rank_pads(ev_gid, ev_valid, dev)
                     if kind == "ndcg" and rank_fits else None)
        host_ndcg = kind == "ndcg" and rank_eval is None
        # a delegate reads every round's metric as it comes
        chunk = (1 if host_ndcg or delegate is not None
                 else T if patience == 0 else min(T, max(16, patience)))
        metric_name = (
            f"ndcg@{eval_k}" if kind == "ndcg"
            else objectives.regression_metric_name(kind)
            if kind in objectives.REGRESSION_KINDS else kind
        )

        def metric(s: torch.Tensor) -> Any:
            if ranks is not None:
                s = ranks.gather(s)
            if host_ndcg:
                return objectives.grouped_ndcg(
                    _to_host(s)[ev_valid], ev_y[ev_valid], np.asarray(ev_gid)[ev_valid],
                    k=eval_k)
            if kind == "ndcg":
                return objectives.grouped_ndcg_device(s, y_ev, *rank_eval, k=eval_k)
            return evaluation.device_metric(s, y_ev, valid_w, kind, p1)

    s_rec = 5 * (L - 1)  # offset of the leaf values in a packed record
    has_cat = cat_mask is not None

    def records_to_host(pending: list) -> list:
        """The pending trees' records (and, for dart, every tree's current
        values) to the host in one transfer each."""
        done = len(trees_done)
        if dart is not None and done:
            old = _to_host(dart.values[:done])
            for t, v in zip(trees_done, old):
                t.values = v.astype(np.float32)
        if not pending:
            return []
        recs = torch.stack(pending)
        if dart is not None:  # the trees' final, rescaled values
            recs[:, s_rec: s_rec + L] = dart.values[done: done + len(pending)].double()
        return [_tree_from_host(r, L, mapper, B, has_cat) for r in _to_host(recs)]

    def new_booster(trees: list) -> Booster:
        return Booster(
            trees=trees, objective=cfg.objective, num_class=k, num_features=d,
            base_score=base_score, boosting_type=cfg.boosting_type,
            objective_param=(
                p1_host if cfg.objective in ("quantile", "huber", "fair", "tweedie") else None
            ),
        )

    def save(next_round: int) -> None:
        ckpt.save_checkpoint(checkpoint_dir, ckpt.TrainCheckpoint(
            round=next_round, booster=new_booster(trees_done), scores=_to_host(scores),
            bag=_to_host(bag) if use_bag else None,
            rng_state=draws.states[next_round], fingerprint=fingerprint,
            best_val=stopper.best if eval_on else None,
            best_iter=stopper.best_iter if eval_on else -1,
            rounds_no_improve=stopper.since if eval_on else 0, lr=lr_cur,
        ))

    def grow_class(c: int, g: torch.Tensor, h: torch.Tensor, w_grow: torch.Tensor,
                   w_it: torch.Tensor, fm: torch.Tensor, eff: torch.Tensor) -> Any:
        """Class ``c``'s tree of one round, with its renewed leaves."""
        grown = grow(
            bins, g[:, c] if k > 1 else g, h[:, c] if k > 1 else h, w_grow,
            num_leaves=L, sp=sp, feature_mask=fm,
            max_depth=int(cfg.max_depth),
            min_data_in_leaf=int(cfg.min_data_in_leaf), num_bins=B,
            categorical_mask=cat_mask, **grow_kw,
        )
        if renew:
            # the leaf's weighted percentile of residuals over the sampled
            # rows at their pre-GOSS weights (LightGBM's RenewTreeOutput;
            # GOSS amplification is not a data weight)
            w_sel = torch.where(w_grow > 0, w_it, 0.0)
            if cfg.objective == "mape":
                w_sel = w_sel / torch.clamp_min(y_enc.abs(), 1.0)
            leaf, resid = grown.row_leaf, y_enc - eff
            if ranks is not None:
                # the percentile of every rank's rows, in global order
                leaf, resid, w_sel = ranks.gather32(leaf.to(torch.int32), resid, w_sel)
            renewed = objectives.leaf_quantile_renewal(
                leaf, resid, w_sel, L, q_renew) * sp.learning_rate
            grown = grown._replace(
                leaf_values=torch.where(grown.leaf_counts > 0, renewed, 0.0))
        return grown

    def goss(g: torch.Tensor, w_it: torch.Tensor, it: Any) -> torch.Tensor:
        g_abs = g.abs()
        if k > 1:
            g_abs = g_abs.sum(1)
        u = sampling.uniform(cfg.seed, it, sampling.GOSS_STREAM, n, dev, row_at)
        return w_it * sampling.goss_weights(g_abs, w_it, u, cfg.top_rate, cfg.other_rate,
                                            ranks=ranks)

    def eval_scores(it_plus_1: torch.Tensor) -> torch.Tensor:
        # rf averages its running sum; the round count is a device scalar
        # on both loops, so both divide alike
        return rf_base + scores / it_plus_1 if is_rf else scores

    history: list = []
    kept_rounds = T
    fast = (delegate is None and not is_dart and not host_rank
            and not (eval_on and host_ndcg))
    if fast:
        # -- one round as a function of static device buffers, run in
        # chunks: captured once and replayed on the card when fused
        # (fused_rounds != 1), eager otherwise
        # over ranks the rounds run eagerly: a collective is not captured
        fusing = int(fused_rounds) != 1 and world == 1
        C_full = T if patience == 0 else min(T, max(16, patience))
        if int(fused_rounds) > 1:
            C_full = max(1, min(C_full, int(fused_rounds)))
        if checkpoint_dir:
            # chunk ends are the checkpoint ends
            C_full = max(1, min(C_full, checkpoint_every))
        recs = torch.zeros((max(T, 1), k, _pack_width(L, B, has_cat)), dtype=torch.float64,
                           device=dev)
        mets = torch.zeros(max(T, 1), dtype=torch.float32, device=dev)
        it_dev = torch.full((), start, dtype=torch.int64, device=dev)
        scores = scores.clone()
        if use_bag and bag is None:
            bag = torch.ones(n, dtype=torch.float32, device=dev)   # redrawn at round 0

        def one_round() -> None:
            it = it_dev
            w_it = w_dev
            if use_bag:
                u = sampling.uniform(cfg.seed, it, sampling.BAGGING_STREAM, n, dev, row_at)
                bag.copy_(torch.where(it % bagging_freq == 0, (u < bagging_fraction).float(), bag))
                w_it = w_dev * bag
            g, h = (g_rf, h_rf) if is_rf else gradients(scores)
            w_grow = goss(g, w_it, it) if is_goss else w_it
            fm = fms_dev.index_select(0, it.view(1))[0]
            grown = [grow_class(c, g, h, w_grow, w_it, fm, scores) for c in range(k)]
            deltas = [t.leaf_values[t.row_leaf] for t in grown]
            recs.index_copy_(0, it.view(1), torch.stack([_pack(t) for t in grown])[None])
            scores.add_(torch.stack(deltas, 1) if k > 1 else deltas[0])
            if eval_on:
                m = metric(eval_scores(it.float() + 1.0))
                mets.index_copy_(0, it.view(1), m.reshape(1).float())
            it_dev.add_(1)

        graph = None

        def run(rounds: int) -> None:
            nonlocal graph
            for _ in range(rounds):
                if dev.type != "cuda" or not fusing:
                    one_round()
                elif graph is None:
                    # one eager round on a side stream (library loads,
                    # allocator warm-up), then the capture, which runs nothing
                    cur = torch.cuda.current_stream(dev)
                    side = torch.cuda.Stream(dev)
                    side.wait_stream(cur)
                    with torch.cuda.stream(side):
                        one_round()
                    cur.wait_stream(side)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        one_round()
                    fused["captures"] += 1
                else:
                    graph.replay()
                    fused["replays"] += 1

        def unpack(r0: int, r1: int) -> list:
            if r1 <= r0:
                return []
            rows = _to_host(recs[r0:r1]).reshape((r1 - r0) * k, -1)
            return [_tree_from_host(r, L, mapper, B, has_cat) for r in rows]

        it0, rec_read, stopped = start, start, False
        while it0 < T and not stopped:
            C = min(C_full, T - it0)
            run(C)
            fused["chunks"] += fusing
            if eval_on:
                vals = _to_host(mets[it0: it0 + C]).tolist()
                keep = stopper.replay(vals, it0)
                history += vals[: C if keep is None else keep]
                if keep is not None:
                    kept_rounds, stopped = it0 + keep, True
            it0 += C
            if checkpoint_dir and not stopped and (
                    (it0 - C) // checkpoint_every < it0 // checkpoint_every or it0 >= T):
                trees_done += unpack(rec_read, it0)
                rec_read = it0
                save(it0)
        graph = None
        trees_done += unpack(rec_read, kept_rounds)
    else:
        # -- the per-round loop (dart, delegates, host gradients or
        # metrics): each round reads the host before the next
        pending: list = []
        chunk_vals: list = []
        it0, drop_at = start, 0
        for it in range(start, T):
            if delegate is not None:
                delegate.before_train_iteration(it)
                lr = float(delegate.get_learning_rate(it, lr_cur))
                if lr != lr_cur and not is_rf:
                    # a fill on the device: no host copy, so no sync
                    sp = sp._replace(learning_rate=torch.full((), lr, dtype=torch.float32,
                                                              device=dev))
                lr_cur = lr
            w_it = w_dev
            if use_bag:
                if it % bagging_freq == 0:
                    u = sampling.uniform(cfg.seed, it, sampling.BAGGING_STREAM, n, dev, row_at)
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
            w_grow = goss(g, w_it, it) if is_goss else w_it
            nf_new = 1.0 / (len(drop) + 1)
            deltas = []
            for c in range(k):
                grown = grow_class(c, g, h, w_grow, w_it, fms_dev[it], eff)
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
            due = bool(checkpoint_dir) and ((it + 1) % checkpoint_every == 0 or it + 1 == T)
            stopped, eval_result = False, None
            if eval_on:
                rounds = torch.full((), it + 1.0, dtype=torch.float32, device=dev)
                chunk_vals.append(metric(eval_scores(rounds)))
                if len(chunk_vals) == chunk or it == T - 1 or due:
                    vals = (chunk_vals if host_ndcg
                            else _to_host(torch.stack(chunk_vals)).tolist())
                    keep = stopper.replay(vals, it0)
                    history += vals[: len(vals) if keep is None else keep]
                    if len(vals) == 1:
                        eval_result = (metric_name, vals[0], stopper.higher)
                    if keep is not None:
                        kept_rounds, stopped = it0 + keep, True
                    it0, chunk_vals = it + 1, []
            if delegate is not None:
                delegate.after_train_iteration(it, eval_result, stopped or it == T - 1)
            if stopped:
                break
            if due:
                trees_done += records_to_host(pending)
                pending = []
                save(it + 1)
        trees_done += records_to_host(pending[:max(kept_rounds * k - len(trees_done), 0)])
    booster = new_booster(trees_done)
    if eval_on:
        booster.evals = {metric_name: history}
        if stopper.best_iter > 0 and not is_dart:
            # dart rescales trees inside any prefix: none reproduces a score
            booster.best_iteration = stopper.best_iter
    if continued:
        new_best = booster.best_iteration
        booster = init_booster.merge(booster)
        if new_best > 0:
            # counted from the front of the merged trees
            booster.best_iteration = len(init_booster.trees) // k + new_best
    return booster
