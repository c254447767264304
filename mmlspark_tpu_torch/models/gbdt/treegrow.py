"""Tree growth and prediction on the device.

The port of ``mmlspark_tpu.models.gbdt.treegrow``: leaf-wise (lossguide)
growth, level-wise (depthwise) growth with sibling subtraction and the
vectorized level application, the shared split search (numerical
thresholds and categorical subsets), and the batched split-log replay used
for prediction.

Convention (the JAX package's): a split sends ``bin <= threshold_bin`` (and
missing/NaN) LEFT; the left child keeps the parent's leaf id, the right
child gets a fresh id, so a tree is its ordered split records plus leaf
values.

The growers are sync-free: the reference's ``lax.fori_loop`` over the L-1
split steps becomes a Python loop over device tensors whose every index is
a tensor (``index_select`` / ``index_copy_``), never ``.item()``, so the
host never waits on the device inside a tree and a later change can
capture a whole round as a CUDA graph. The records come to the host once,
after training (``train.py``).

Multi-rank growth (LightGBM's ``data_parallel``): ``grow_tree`` and
``grow_tree_depthwise`` take ``group``, a ``torch.distributed`` process
group whose ranks each pass their own rows. Every plane and leaf sum is
then built over all the ranks' rows (``ops/histogram.py``'s distributed
form, bit for bit one build on all of them), so split search runs on
identical planes on every rank and every rank grows the same tree with no
further collective; ``row_leaf`` stays the rank's own. The partitioned
grower stays single-device, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.ops.histogram import (
    NUM_BINS,
    global_rows,
    leaf_stat_sums,
    multi_plane_histogram,
    plane_histogram,
)


class GrownTree(NamedTuple):
    """Device outputs of one grown tree (fixed shapes; L = num_leaves)."""

    rec_leaf: torch.Tensor      # (L-1,) int64 parent leaf id per split (-1 none)
    rec_feature: torch.Tensor   # (L-1,) int64
    rec_bin: torch.Tensor       # (L-1,) int64 threshold bin (<= goes left)
    rec_active: torch.Tensor    # (L-1,) bool: split actually made
    rec_gain: torch.Tensor      # (L-1,) float32
    leaf_values: torch.Tensor   # (L,) float32 (shrinkage applied)
    leaf_counts: torch.Tensor   # (L,) int32
    row_leaf: torch.Tensor      # (n,) int32 final leaf of every row
    # categorical subset splits; None when the fit has no categorical feature
    rec_is_cat: Optional[torch.Tensor] = None   # (L-1,) bool
    rec_catmask: Optional[torch.Tensor] = None  # (L-1, B) bool: bins going LEFT


class SplitParams(NamedTuple):
    """The regularization scalars as f32 0-d tensors on the device, made
    once per training run: every comparison and product then happens in
    f32, as in the JAX package, and no scalar crosses to the device inside
    a tree."""

    lambda_l2: torch.Tensor
    lambda_l1: torch.Tensor
    min_sum_hessian: torch.Tensor
    min_gain: torch.Tensor
    learning_rate: torch.Tensor

    @staticmethod
    def make(device: torch.device, *, lambda_l2: float, lambda_l1: float,
             min_sum_hessian: float, min_gain: float,
             learning_rate: float) -> "SplitParams":
        vals = torch.tensor(
            [lambda_l2, lambda_l1, min_sum_hessian, min_gain, learning_rate],
            dtype=torch.float32,
        ).to(device)
        return SplitParams(*vals.unbind())


def threshold_l1(G: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """LightGBM ThresholdL1: sign(G) * max(|G| - l1, 0)."""
    return torch.sign(G) * torch.clamp_min(G.abs() - l1, 0.0)


def split_gain_term(G: torch.Tensor, H: torch.Tensor, lam: torch.Tensor,
                    l1: torch.Tensor) -> torch.Tensor:
    """One side's contribution to split gain: ThresholdL1(G)^2 / (H + lam)."""
    t = threshold_l1(G, l1)
    return t * t / (H + lam)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 prefix sum over the last axis, in the order XLA's CPU backend
    sums ``jnp.cumsum`` (blocks of 16 summed left to right, then each
    block offset by the running total of the blocks before it), so the
    split gains on the CPU equal the JAX package's bit for bit. The order
    is kept on CUDA too: one code path, and the card is held by quality."""
    B = x.shape[-1]
    if B % 16:
        raise ValueError(f"prefix_sum takes a multiple of 16 bins, got {B}")
    blk = x.reshape(*x.shape[:-1], B // 16, 16)
    acc = blk[..., 0]
    cols = [acc]
    for i in range(1, 16):
        acc = acc + blk[..., i]
        cols.append(acc)
    within = torch.stack(cols, -1)
    total = within[..., -1]
    run = torch.zeros_like(total[..., 0])
    before = []
    for b in range(B // 16):
        before.append(run)
        run = run + total[..., b]
    return (within + torch.stack(before, -1)[..., None]).reshape(x.shape)


def make_leaf_best(
    d: int,
    feature_mask: torch.Tensor,
    min_data_in_leaf: int,
    sp: SplitParams,
    num_bins: int = NUM_BINS,
    cat_f: Optional[torch.Tensor] = None,
):
    """Best-split search over a batch of (d*B, 3) histogram planes — the
    single source of split semantics both growers share. The reference's
    ``jax.vmap(leaf_best)`` over planes is the leading batch dimension
    here. Returns (gain (P,), feature (P,), bin (P,), catmask (P, B) bool
    or None).

    ``cat_f``: (d,) bool, the categorical features, or None (then none of
    the categorical search runs). A categorical feature's candidate splits
    are LightGBM's sorted-by-ratio scan: its bins ordered by G/H (empty bins
    last), the left set a prefix of that order; its ``bin`` is the prefix
    length - 1 and ``catmask`` the left set."""
    B = num_bins
    feat_ok = (feature_mask > 0)[None, :, None]
    mdl = float(min_data_in_leaf)

    def gscore(Gv: torch.Tensor, Hv: torch.Tensor) -> torch.Tensor:
        return split_gain_term(Gv, Hv, sp.lambda_l2, sp.lambda_l1)

    def valid(CL, CR, HL, HR) -> torch.Tensor:
        msh = sp.min_sum_hessian
        return feat_ok & (CL >= mdl) & (CR >= mdl) & (HL >= msh) & (HR >= msh)

    def leaf_best(planes: torch.Tensor) -> tuple:
        P = planes.shape[0]
        cube = planes.reshape(P, d, B, 3).permute(0, 3, 1, 2).contiguous()  # (P, 3, d, B)
        cs = prefix_sum(cube)
        GL, HL, CL = cs[:, 0], cs[:, 1], cs[:, 2]
        G, H, C = GL[..., -1:], HL[..., -1:], CL[..., -1:]
        GR, HR, CR = G - GL, H - HL, C - CL
        gain_num = gscore(GL, HL) + gscore(GR, HR) - gscore(G, H)
        gain = torch.where(valid(CL, CR, HL, HR), gain_num, -math.inf)
        if cat_f is not None:
            hg, hh, hc = cube[:, 0], cube[:, 1], cube[:, 2]
            ratio = torch.where(hc > 0, hg / (hh + 1e-12), -math.inf)
            # stable, and -0.0 made +0.0 first: jnp.argsort's comparator
            # holds them equal, a bitwise sort on the card would not
            order = torch.argsort(-ratio + 0.0, dim=-1, stable=True)  # (P, d, B)
            srt = prefix_sum(torch.gather(cube, 3, order[:, None].expand(P, 3, d, B)))
            cg, ch, cc = srt[:, 0], srt[:, 1], srt[:, 2]
            gain_cat = gscore(cg, ch) + gscore(G - cg, H - ch) - gscore(G, H)
            gain_cat = torch.where(valid(cc, C - cc, ch, H - ch), gain_cat, -math.inf)
            gain = torch.where(cat_f[None, :, None], gain_cat, gain)
        flat = gain.reshape(P, d * B)
        best = torch.argmax(flat, dim=1)  # first maximum, as jnp.argmax
        bf, bb = torch.div(best, B, rounding_mode="floor"), best % B
        catmask = None
        if cat_f is not None:
            # left set: the bins whose rank in the chosen feature's order is
            # at most bb (the rank is the inverse permutation of the order)
            order_sel = order.gather(1, bf[:, None, None].expand(P, 1, B))[:, 0]
            rank = torch.empty_like(order_sel).scatter_(
                1, order_sel, torch.arange(B, device=order.device).expand(P, B))
            catmask = rank <= bb[:, None]
        return flat.gather(1, best[:, None])[:, 0], bf, bb, catmask

    return leaf_best


def _row_stats(grad: torch.Tensor, hess: torch.Tensor,
               row_weight: torch.Tensor) -> torch.Tensor:
    return torch.stack([grad * row_weight, hess * row_weight, row_weight], -1)


def _leaf_values(row_leaf: torch.Tensor, row_stats: torch.Tensor, L: int,
                 sp: SplitParams, group: Any = None,
                 rows: Optional[torch.Tensor] = None) -> tuple:
    """-ThresholdL1(G)/(H+lambda) * lr per final leaf (0 for empty leaves);
    with ``group`` from the sums over its ranks."""
    sums = leaf_stat_sums(row_leaf, row_stats, L, group, rows)
    Gl, Hl, Cl = sums[:, 0], sums[:, 1], sums[:, 2]
    values = -threshold_l1(Gl, sp.lambda_l1) / (Hl + sp.lambda_l2) * sp.learning_rate
    return torch.where(Cl > 0, values, 0.0), Cl.to(torch.int32)


def grow_tree(
    bins: torch.Tensor,            # (n, d) uint8
    grad: torch.Tensor,            # (n,) f32
    hess: torch.Tensor,            # (n,) f32
    row_weight: torch.Tensor,      # (n,) f32 (0 = ignore)
    *,
    num_leaves: int,
    sp: SplitParams,
    feature_mask: torch.Tensor,    # (d,) f32 1/0 (feature_fraction)
    max_depth: int = -1,
    min_data_in_leaf: int = 20,
    num_bins: int = NUM_BINS,
    categorical_mask: Optional[torch.Tensor] = None,  # (d,) bool
    group: Any = None,
) -> GrownTree:
    """Leaf-wise (best-first) growth of one tree: the port of the JAX
    package's ``_grow_tree``. ``categorical_mask`` None leaves the
    categorical search and routing out entirely. ``group``: the ranks'
    rows together (module docstring).

    The (L, d*B, 3) histogram cube is carried incrementally and updated in
    place: each split histograms only the rows that moved to the new right
    child (one masked ``plane_hist`` over the rows) and the parent keeps
    parent - right (LightGBM's subtraction trick). The split-search cache
    is refreshed for those two leaves only."""
    n, d = bins.shape
    L, B = num_leaves, num_bins
    dev = bins.device
    row_stats = _row_stats(grad, hess, row_weight)
    cat_f = categorical_mask
    leaf_best = make_leaf_best(d, feature_mask, min_data_in_leaf, sp, num_bins=B, cat_f=cat_f)
    rows = None if group is None else global_rows(n, group, dev)

    hist = torch.zeros((L, d * B, 3), dtype=torch.float32, device=dev)
    hist[0] = plane_histogram(bins, row_stats, None, B, group, rows)
    leaf_ids = torch.arange(L, device=dev)
    row_leaf = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_depth = torch.zeros(L, dtype=torch.int32, device=dev)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    cache_gain = torch.full((L,), -math.inf, dtype=torch.float32, device=dev)
    cache_feat = torch.zeros(L, dtype=torch.int64, device=dev)
    cache_bin = torch.zeros(L, dtype=torch.int64, device=dev)
    prev_pair = torch.zeros(2, dtype=torch.int64, device=dev)  # root twice
    rec_leaf = torch.full((L - 1,), -1, dtype=torch.int64, device=dev)
    rec_feature = torch.full((L - 1,), -1, dtype=torch.int64, device=dev)
    rec_bin = torch.full((L - 1,), -1, dtype=torch.int64, device=dev)
    rec_active = torch.zeros(L - 1, dtype=torch.bool, device=dev)
    rec_gain = torch.zeros(L - 1, dtype=torch.float32, device=dev)
    rec_is_cat = rec_catmask = cache_catmask = None
    if cat_f is not None:
        rec_is_cat = torch.zeros(L - 1, dtype=torch.bool, device=dev)
        rec_catmask = torch.zeros((L - 1, B), dtype=torch.bool, device=dev)
        cache_catmask = torch.zeros((L, B), dtype=torch.bool, device=dev)

    for k in range(L - 1):
        # refresh the two planes the previous split changed
        pg, pf, pb, pcm = leaf_best(hist.index_select(0, prev_pair))
        cache_gain.index_copy_(0, prev_pair, pg)
        cache_feat.index_copy_(0, prev_pair, pf)
        cache_bin.index_copy_(0, prev_pair, pb)
        if cat_f is not None:
            cache_catmask.index_copy_(0, prev_pair, pcm)

        leaf_ok = leaf_ids <= k
        if max_depth > 0:
            leaf_ok = leaf_ok & (leaf_depth < max_depth)
        sel = torch.where(leaf_ok, cache_gain, -math.inf)
        bl = torch.argmax(sel).view(1)
        best_gain = sel.index_select(0, bl)
        bf = cache_feat.index_select(0, bl)
        bb = cache_bin.index_select(0, bl)
        do_split = ~done & (best_gain > sp.min_gain) & torch.isfinite(best_gain)

        row_bins = bins.index_select(1, bf)[:, 0]
        if cat_f is not None:
            is_cat = cat_f.index_select(0, bf)
            catmask = cache_catmask.index_select(0, bl)[0]
            right = torch.where(is_cat, ~catmask[row_bins.long()], row_bins > bb)
        else:
            right = row_bins > bb
        moved = do_split & (row_leaf == bl) & right
        row_leaf = torch.where(moved, k + 1, row_leaf)
        right = plane_histogram(bins, row_stats, moved.to(torch.float32), B, group, rows)
        hist[k + 1] = right
        parent = hist.index_select(0, bl)
        hist.index_copy_(0, bl, parent + torch.where(do_split, -right, 0.0))

        child_depth = leaf_depth.index_select(0, bl) + 1
        deeper = leaf_depth.index_copy(0, bl, child_depth)
        deeper[k + 1: k + 2] = child_depth
        leaf_depth = torch.where(do_split, deeper, leaf_depth)
        rec_leaf[k: k + 1] = torch.where(do_split, bl, -1)
        rec_feature[k: k + 1] = torch.where(do_split, bf, -1)
        rec_bin[k: k + 1] = torch.where(do_split, bb, -1)
        rec_active[k: k + 1] = do_split
        rec_gain[k: k + 1] = torch.where(do_split, best_gain, 0.0)
        if cat_f is not None:
            cat_split = do_split & is_cat
            rec_is_cat[k: k + 1] = cat_split
            rec_catmask[k] = catmask & cat_split
        done = done | ~do_split
        prev_pair = torch.cat([bl, leaf_ids[k + 1: k + 2]])

    values, counts = _leaf_values(row_leaf, row_stats, L, sp, group, rows)
    return GrownTree(rec_leaf, rec_feature, rec_bin, rec_active, rec_gain,
                     values, counts, row_leaf, rec_is_cat, rec_catmask)


def _range_sizes(n: int, min_size: int = 512) -> tuple:
    """The JAX package's power-of-2 row buckets for a range histogram."""
    sizes = []
    s = min(min_size, n)
    while s < n:
        sizes.append(s)
        s *= 2
    sizes.append(n)
    return tuple(sizes)


def grow_tree_partitioned(
    bins: torch.Tensor,            # (n, d) uint8
    grad: torch.Tensor,            # (n,) f32
    hess: torch.Tensor,            # (n,) f32
    row_weight: torch.Tensor,      # (n,) f32 (0 = ignore)
    *,
    num_leaves: int,
    sp: SplitParams,
    feature_mask: torch.Tensor,    # (d,) f32 1/0 (feature_fraction)
    max_depth: int = -1,
    min_data_in_leaf: int = 20,
    num_bins: int = NUM_BINS,
    categorical_mask: Optional[torch.Tensor] = None,  # (d,) bool
) -> GrownTree:
    """Leaf-wise growth over rows kept partitioned by leaf: the port of the
    JAX package's ``_grow_tree_partitioned`` (LightGBM's DataPartition with
    histogram subtraction). The split semantics are :func:`grow_tree`'s
    (the same ``make_leaf_best``, records and leaf values); the histogram
    work differs:

    - the rows live in a permuted order in which every leaf owns the
      contiguous range [start, start + count); each split stable-partitions
      the parent's range (left block, then right block);
    - only the smaller child is histogrammed, with ``plane_hist`` over a
      static power-of-two bucket of the permuted rows (the smallest of the
      JAX package's buckets that holds any smaller child, half the rows),
      gathered from a device-side start and masked to the child's range;
      the larger child is parent - smaller.

    Every shape is static and no value crosses to the host, so a round
    with this grower is capturable as a CUDA graph. (The JAX package picks
    the bucket per split with ``lax.switch``; a per-split choice here would
    read the child's size on the host.)

    This grower is kept for parity with the JAX package, not for speed: a
    split permutes all n rows and gathers a bucket of half of them, while
    the masked grower's ``plane_hist`` already reads only the kept rows, so
    on the card it is slower on every fit. It could become the default
    only once the histogram kernel reads a child's start and count on the
    device (a bucket per split), and then only where the card's trees/s
    say so. Its records are the masked grower's up to ties: it derives the
    larger child by subtraction where the masked grower derives the left
    one, and a derived plane carries f32 rounding residues in bins its
    leaf holds no weighted row of, so a threshold may move across such
    bins (a tie in exact arithmetic). The weighted rows' partition is the
    same; rows of weight 0 and new rows in those bins go the other way."""
    n, d = bins.shape
    L, B = num_leaves, num_bins
    dev = bins.device
    i64 = torch.int64
    row_stats = _row_stats(grad, hess, row_weight)
    cat_f = categorical_mask
    leaf_best = make_leaf_best(d, feature_mask, min_data_in_leaf, sp, num_bins=B, cat_f=cat_f)
    size = next(sz for sz in _range_sizes(n) if sz >= (n + 1) // 2)

    hist = torch.zeros((L, d * B, 3), dtype=torch.float32, device=dev)
    hist[0] = plane_histogram(bins, row_stats, None, B)
    pos = torch.arange(n, dtype=i64, device=dev)
    bucket = torch.arange(size, dtype=i64, device=dev)
    order, bins_ord, stats_ord = pos, bins, row_stats
    leaf_ids = torch.arange(L, device=dev)
    leaf_start = torch.zeros(L, dtype=i64, device=dev)
    leaf_count = torch.zeros(L, dtype=i64, device=dev)
    leaf_count[:1].fill_(n)        # a fill, not a host copy: capturable
    leaf_depth = torch.zeros(L, dtype=torch.int32, device=dev)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    cache_gain = torch.full((L,), -math.inf, dtype=torch.float32, device=dev)
    cache_feat = torch.zeros(L, dtype=i64, device=dev)
    cache_bin = torch.zeros(L, dtype=i64, device=dev)
    prev_pair = torch.zeros(2, dtype=i64, device=dev)  # root twice
    rec_leaf = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_feature = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_bin = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_active = torch.zeros(L - 1, dtype=torch.bool, device=dev)
    rec_gain = torch.zeros(L - 1, dtype=torch.float32, device=dev)
    rec_is_cat = rec_catmask = cache_catmask = None
    if cat_f is not None:
        rec_is_cat = torch.zeros(L - 1, dtype=torch.bool, device=dev)
        rec_catmask = torch.zeros((L - 1, B), dtype=torch.bool, device=dev)
        cache_catmask = torch.zeros((L, B), dtype=torch.bool, device=dev)

    for k in range(L - 1):
        pg, pf, pb, pcm = leaf_best(hist.index_select(0, prev_pair))
        cache_gain.index_copy_(0, prev_pair, pg)
        cache_feat.index_copy_(0, prev_pair, pf)
        cache_bin.index_copy_(0, prev_pair, pb)
        if cat_f is not None:
            cache_catmask.index_copy_(0, prev_pair, pcm)

        leaf_ok = leaf_ids <= k
        if max_depth > 0:
            leaf_ok = leaf_ok & (leaf_depth < max_depth)
        sel = torch.where(leaf_ok, cache_gain, -math.inf)
        bl = torch.argmax(sel).view(1)
        best_gain = sel.index_select(0, bl)
        bf = cache_feat.index_select(0, bl)
        bb = cache_bin.index_select(0, bl)
        do_split = ~done & (best_gain > sp.min_gain) & torch.isfinite(best_gain)

        # stable partition of the parent's range: left block, right block
        s = leaf_start.index_select(0, bl)
        c = leaf_count.index_select(0, bl)
        in_range = (pos >= s) & (pos < s + c)
        row_bins = bins_ord.index_select(1, bf)[:, 0]
        if cat_f is not None:
            is_cat = cat_f.index_select(0, bf)
            catmask = cache_catmask.index_select(0, bl)[0]
            decide = torch.where(is_cat, ~catmask[row_bins.long()], row_bins > bb)
        else:
            decide = row_bins > bb
        right_m = in_range & decide & do_split
        left_m = in_range & ~right_m & do_split
        c_right = right_m.sum().view(1)
        c_left = c - c_right
        dest = torch.where(
            left_m, s + torch.cumsum(left_m, 0) - 1,
            torch.where(right_m, s + c_left + torch.cumsum(right_m, 0) - 1, pos))
        inv = torch.empty_like(pos).index_put_((dest,), pos)
        order = order.index_select(0, inv)
        bins_ord = bins_ord.index_select(0, inv)
        stats_ord = stats_ord.index_select(0, inv)

        # the smaller child's plane from its (now contiguous) range
        small_left = c_left <= c_right
        s_small = torch.where(small_left, s, s + c_left)
        c_small = torch.where(do_split, torch.minimum(c_left, c_right), 0)
        p = torch.clamp(s_small, 0, n - size) + bucket
        keep = ((p >= s_small) & (p < s_small + c_small)).to(torch.float32)
        small = plane_histogram(bins_ord.index_select(0, p), stats_ord.index_select(0, p),
                                keep, B)
        parent = hist.index_select(0, bl)[0]
        big = parent - small
        split = do_split.view(1, 1)
        hist.index_copy_(0, bl, torch.where(split, torch.where(small_left, small, big),
                                            parent)[None])
        hist[k + 1] = torch.where(split, torch.where(small_left, big, small), hist[k + 1])

        leaf_start[k + 1: k + 2] = torch.where(do_split, s + c_left, leaf_start[k + 1: k + 2])
        counts = leaf_count.index_copy(0, bl, c_left)
        counts[k + 1: k + 2] = c_right
        leaf_count = torch.where(do_split, counts, leaf_count)
        child_depth = leaf_depth.index_select(0, bl) + 1
        deeper = leaf_depth.index_copy(0, bl, child_depth)
        deeper[k + 1: k + 2] = child_depth
        leaf_depth = torch.where(do_split, deeper, leaf_depth)
        rec_leaf[k: k + 1] = torch.where(do_split, bl, -1)
        rec_feature[k: k + 1] = torch.where(do_split, bf, -1)
        rec_bin[k: k + 1] = torch.where(do_split, bb, -1)
        rec_active[k: k + 1] = do_split
        rec_gain[k: k + 1] = torch.where(do_split, best_gain, 0.0)
        if cat_f is not None:
            cat_split = do_split & is_cat
            rec_is_cat[k: k + 1] = cat_split
            rec_catmask[k] = catmask & cat_split
        done = done | ~do_split
        prev_pair = torch.cat([bl, leaf_ids[k + 1: k + 2]])

    # position -> leaf from the final ranges (they tile [0, n)), then back
    # to the original row order through the permutation
    in_leaf = (pos[:, None] >= leaf_start[None, :]) & (
        pos[:, None] < (leaf_start + leaf_count)[None, :])
    row_leaf = torch.empty(n, dtype=torch.int32, device=dev).index_put_(
        (order,), torch.argmax(in_leaf.to(torch.uint8), dim=1).to(torch.int32))
    values, counts = _leaf_values(row_leaf, row_stats, L, sp)
    return GrownTree(rec_leaf, rec_feature, rec_bin, rec_active, rec_gain,
                     values, counts, row_leaf, rec_is_cat, rec_catmask)


def _put_drop(a: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``a.at[idx].set(vals, mode="drop")``: indices outside [0, len(a))
    land in a trash slot that is cut off."""
    n = a.shape[0]
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    return torch.cat([a, a[:1]]).index_put((idx,), vals.to(a.dtype))[:n]


def _set_drop(size: int, fill: int, idx: torch.Tensor, vals: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``full(size, fill).at[idx].set(vals, mode="drop")``."""
    return _put_drop(torch.full((size,), fill, dtype=dtype, device=idx.device), idx, vals)


def grow_tree_depthwise(
    bins: torch.Tensor,
    grad: torch.Tensor,
    hess: torch.Tensor,
    row_weight: torch.Tensor,
    *,
    num_leaves: int,
    sp: SplitParams,
    feature_mask: torch.Tensor,
    max_depth: int = -1,
    min_data_in_leaf: int = 20,
    num_bins: int = NUM_BINS,
    categorical_mask: Optional[torch.Tensor] = None,
    group: Any = None,
) -> GrownTree:
    """Level-wise growth: the port of the JAX package's
    ``_grow_tree_depthwise`` with sibling subtraction and the vectorized
    level application (its ``vector_split`` path).

    Every level's leaf histograms come from ONE ``multi_plane_hist`` pass
    over the rows. From level 1 on only the right child of every sibling
    pair is histogrammed; the left plane is parent - right from the
    previous level's cube. Within a level, the splits are applied all at
    once: the budget and record order come from a cumsum over the
    gain-sorted valid mask (``argsort`` is stable, as ``jnp.argsort``).

    With ``max_depth`` unset, depth caps at ceil(log2(num_leaves)).
    ``group``: the ranks' rows together (module docstring)."""
    n, d = bins.shape
    L, B = int(num_leaves), num_bins
    dev = bins.device
    n_levels = (
        min(int(max_depth), L - 1) if max_depth > 0
        else max(1, math.ceil(math.log2(L)))
    )
    row_stats = _row_stats(grad, hess, row_weight)
    cat_f = categorical_mask
    leaf_best = make_leaf_best(d, feature_mask, min_data_in_leaf, sp, num_bins=B, cat_f=cat_f)
    rows = None if group is None else global_rows(n, group, dev)

    i32, i64 = torch.int32, torch.int64
    row_slot = torch.zeros(n, dtype=i64, device=dev)
    k = torch.zeros((), dtype=i64, device=dev)  # splits made so far
    rec_leaf = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_feature = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_bin = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_active = torch.zeros(L - 1, dtype=torch.bool, device=dev)
    rec_gain = torch.zeros(L - 1, dtype=torch.float32, device=dev)
    rec_is_cat = rec_catmask = None
    if cat_f is not None:
        rec_is_cat = torch.zeros(L - 1, dtype=torch.bool, device=dev)
        rec_catmask = torch.zeros((L - 1, B), dtype=torch.bool, device=dev)
    # frontier of the current level: lut maps leaf id -> local plane index
    # (L = not in the frontier); inv maps plane index -> leaf id
    lut = torch.where(torch.arange(L, device=dev) == 0, 0, L).to(i64)
    inv = torch.zeros(1, dtype=i64, device=dev)
    cube_prev = parent_local = None

    for level in range(n_levels):
        S = int(inv.shape[0])
        local = torch.where(row_slot < L, lut[row_slot.clamp(0, L - 1)], S)
        if level > 0:
            P = S // 2
            is_right = (local < 2 * P) & (local % 2 == 1)
            slot_pair = torch.where(is_right, local // 2, P).to(i32)
            half = multi_plane_histogram(bins, row_stats, slot_pair, P, B, group, rows)
            ok = (parent_local >= 0)[:, None, None]
            parents = cube_prev[parent_local.clamp(0, cube_prev.shape[0] - 1)]
            left = torch.where(ok, parents - half, 0.0)
            right = torch.where(ok, half, 0.0)
            cube = torch.stack([left, right], 1).reshape(2 * P, d * B, 3)
            if S != 2 * P:
                cube = torch.cat(
                    [cube, torch.zeros((S - 2 * P, d * B, 3), device=dev)]
                )
        else:
            cube = multi_plane_histogram(bins, row_stats, local.to(i32), S, B, group, rows)
        cube_prev = cube
        gains, feats, bbs, catms = leaf_best(cube)
        order = torch.argsort(-gains, stable=True)
        S_next = min(2 * S, L)

        slot_s = inv[order]
        gain_s = gains[order]
        ok = (slot_s >= 0) & torch.isfinite(gain_s) & (gain_s > sp.min_gain)
        ok_i = ok.to(i64)
        rank = torch.cumsum(ok_i, 0) - ok_i
        ok = ok & (k + rank < L - 1)
        ks = k + rank                       # record index per sorted position
        new_id = ks + 1
        bf_s, bb_s = feats[order], bbs[order]
        idx = torch.where(ok, ks, L - 1)   # L - 1: out of range, dropped
        rec_leaf = _put_drop(rec_leaf, idx, slot_s)
        rec_feature = _put_drop(rec_feature, idx, bf_s)
        rec_bin = _put_drop(rec_bin, idx, bb_s)
        rec_active = _put_drop(rec_active, idx, torch.ones_like(ok))
        rec_gain = _put_drop(rec_gain, idx, gain_s)
        if cat_f is not None:
            is_cat_s, cm_s = cat_f[bf_s], catms[order]
            rec_is_cat = _put_drop(rec_is_cat, idx, is_cat_s)
            rec_catmask = _put_drop(rec_catmask, idx, cm_s & is_cat_s[:, None])
        # next frontier: pair p (= rank) at locals (2p, 2p+1)
        lut_idx = torch.cat([torch.where(ok, slot_s, L), torch.where(ok, new_id, L)])
        lut = _set_drop(L, L, lut_idx, torch.cat([2 * rank, 2 * rank + 1]), i64)
        inv_idx = torch.cat(
            [torch.where(ok, 2 * rank, S_next), torch.where(ok, 2 * rank + 1, S_next)]
        )
        inv = _set_drop(S_next, -1, inv_idx, torch.cat([slot_s, new_id]), i64)
        pl_n = S_next // 2
        parent_local = _set_drop(pl_n, -1, torch.where(ok, rank, pl_n), order, i64)
        # row routing: per original local j, this level's chosen split; the
        # lookups have S + 1 entries, entry S all-false for rows whose leaf
        # left the frontier (local == L clamps there, as a JAX gather clamps)
        sj = torch.where(ok, order, S + 1)
        split_ok = _set_drop(S + 1, 0, sj, torch.ones_like(ok), torch.bool)
        split_bf = _set_drop(S + 1, 0, sj, bf_s, i64)
        split_bb = _set_drop(S + 1, 0, sj, bb_s, i64)
        split_new = _set_drop(S + 1, 0, sj, new_id, i64)
        j_r = local.clamp(max=S)
        row_bins = torch.gather(bins, 1, split_bf[j_r][:, None])[:, 0]
        if cat_f is not None:
            split_iscat = _set_drop(S + 1, 0, sj, is_cat_s, torch.bool)
            split_cm = _put_drop(torch.zeros((S + 1, B), dtype=torch.bool, device=dev), sj, cm_s)
            right = torch.where(split_iscat[j_r], ~split_cm[j_r, row_bins.long()],
                                row_bins > split_bb[j_r])
        else:
            right = row_bins > split_bb[j_r]
        goes_right = split_ok[j_r] & right
        row_slot = torch.where(goes_right, split_new[j_r], row_slot)
        k = k + ok.sum()

    values, counts = _leaf_values(row_slot.to(i32), row_stats, L, sp, group, rows)
    return GrownTree(rec_leaf, rec_feature, rec_bin, rec_active, rec_gain,
                     values, counts, row_slot.to(i32), rec_is_cat, rec_catmask)


# -- prediction -------------------------------------------------------------


def category_bin_slot(vals, B: int = NUM_BINS):
    """Category value -> bin slot, the one encoding shared by training
    (identity binning), device prediction (:func:`predict_leaves`) and the
    host SHAP walks: NaN -> 0 (the missing bin), value v -> v+1, clipped
    into [0, B-1] (the clip is taken in float first, so +-1e30 and +-inf
    cannot overflow the integer cast). Takes a numpy array or a tensor."""
    if isinstance(vals, torch.Tensor):
        finite = torch.nan_to_num(vals, nan=-1.0)
        slot = torch.round(torch.clamp(finite, -1.0, float(B))).to(torch.int64) + 1
        return torch.clamp(torch.where(torch.isnan(vals), 0, slot), 0, B - 1)
    finite = np.nan_to_num(vals, nan=-1.0)
    slot = np.round(np.clip(finite, -1.0, float(B))).astype(np.int32) + 1
    return np.clip(np.where(np.isnan(vals), 0, slot), 0, B - 1)


def predict_leaves(
    x: torch.Tensor,               # (n, d) float32 raw features
    rec_leaf: torch.Tensor,        # (T, S) int64
    rec_feature: torch.Tensor,     # (T, S) int64
    rec_threshold: torch.Tensor,   # (T, S) float32 (<= goes left)
    rec_active: torch.Tensor,      # (T, S) bool
    rec_default_left: Optional[torch.Tensor] = None,  # (T, S) bool
    rec_is_cat: Optional[torch.Tensor] = None,        # (T, S) bool
    rec_catmask: Optional[torch.Tensor] = None,       # (T, S, NUM_BINS) bool
) -> torch.Tensor:
    """Replay the split logs of all trees at once -> (n, T) leaf indices.

    Numerical splits: NaN goes LEFT unless ``rec_default_left`` says
    otherwise per split (LightGBM's decision_type default-left bit).
    Categorical splits (``rec_is_cat``) route by set membership: value v
    goes left iff ``rec_catmask[t, k, category_bin_slot(v)]``, so NaN
    follows the missing bin and a category never seen in training goes
    right."""
    n = x.shape[0]
    T, S = rec_leaf.shape
    row_leaf = torch.zeros((n, T), dtype=torch.int64, device=x.device)
    feat = rec_feature.clamp(0, max(x.shape[1] - 1, 0))
    trees = torch.arange(T, device=x.device)[None, :]
    for k in range(S):  # the right child of step k is leaf k + 1
        vals = x[:, feat[:, k]]                         # (n, T)
        if rec_default_left is None:
            right = (vals > rec_threshold[:, k]) & ~torch.isnan(vals)
        else:
            right = torch.where(
                torch.isnan(vals), ~rec_default_left[:, k], vals > rec_threshold[:, k]
            )
        if rec_is_cat is not None:
            cm = rec_catmask[:, k]                      # (T, B)
            left_cat = cm[trees, category_bin_slot(vals, cm.shape[1])]
            right = torch.where(rec_is_cat[:, k], ~left_cat, right)
        goes_right = (row_leaf == rec_leaf[:, k]) & rec_active[:, k] & right
        row_leaf = torch.where(goes_right, k + 1, row_leaf)
    return row_leaf


def predict_scores(
    x: torch.Tensor,
    rec_leaf: torch.Tensor,
    rec_feature: torch.Tensor,
    rec_threshold: torch.Tensor,
    rec_active: torch.Tensor,
    leaf_values: torch.Tensor,     # (T, L) float32
    rec_default_left: Optional[torch.Tensor] = None,
    rec_is_cat: Optional[torch.Tensor] = None,
    rec_catmask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-tree outputs (n, T): the leaf value each row lands in."""
    leaves = predict_leaves(
        x, rec_leaf, rec_feature, rec_threshold, rec_active, rec_default_left,
        rec_is_cat, rec_catmask,
    )
    T = leaf_values.shape[0]
    return leaf_values[torch.arange(T, device=x.device)[None, :], leaves]
