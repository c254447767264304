"""Voting-parallel tree growth: LightGBM's ``voting_parallel`` (PV-Tree).

The port of ``mmlspark_tpu.models.gbdt.voting``. ``data_parallel``
all-reduces a leaf's whole (d*B, 3) plane every split; PV-Tree (Meng et al.,
"A Communication-Efficient Parallel Algorithm for Decision Tree", NeurIPS
2016) cuts that to two small rounds:

1. **local vote**: each rank ranks the features by the split gain of its
   own rows and nominates its ``top_k``;
2. **global vote**: the ballots are summed (one (2, d) all-reduce) and the
   ``2 * top_k`` features with the most votes become candidates (ties to
   the lower feature id);
3. **exact phase**: only the candidates' histogram columns are summed
   ((2, 2K, B, 3) cells) and the split is chosen exactly on them.

A rank is a mesh shard: each holds its own rows, and the local planes
never leave it. They are int64 cells at one scale per tree (``ops/
histogram.py``'s fixed point: the root's all-reduced column maxima and the
ranks' row count, which bound every leaf's rows too), so a child is parent
minus sibling exactly and the candidates' columns all-reduce as integers:
every rank derives the identical split records and catmasks from
identical sums. The local votes read the local cells rounded to f32. Leaf
values come from the leaves' global sums (the JAX package's one (L, 3)
``psum``). Categorical features vote with their sorted-prefix gain and
split by subset membership, as in the single-device grower.

Ties in the local gains break as ``jax.lax.top_k`` breaks them (the lower
feature index first), so the candidate sets are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from mmlspark_tpu_torch.ops.histogram import (
    NUM_BINS,
    from_fixed,
    global_rows,
    global_scale,
    plane_histogram_fixed,
)
from mmlspark_tpu_torch.models.gbdt.treegrow import (
    GrownTree,
    SplitParams,
    _leaf_values,
    _row_stats,
    prefix_sum,
    split_gain_term,
)
from mmlspark_tpu_torch.parallel import collectives


def _top_k(x: torch.Tensor, k: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """``jax.lax.top_k`` over the last axis: the k largest, equal values
    in index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def grow_tree_voting(
    bins: torch.Tensor,            # (n, d) this rank's rows
    grad: torch.Tensor,            # (n,) f32
    hess: torch.Tensor,            # (n,) f32
    row_weight: torch.Tensor,      # (n,) f32 (0 = ignore)
    *,
    num_leaves: int,
    sp: SplitParams,
    feature_mask: torch.Tensor,    # (d,) f32 1/0, the same on every rank
    max_depth: int = -1,
    min_data_in_leaf: int = 20,
    num_bins: int = NUM_BINS,
    categorical_mask: Optional[torch.Tensor] = None,  # (d,) bool
    top_k: int = 20,
    group: Any = None,
) -> GrownTree:
    """Grow one tree with PV-Tree voting over ``group``'s ranks (None =
    the default group). Records and leaf values are identical on every
    rank; ``row_leaf`` is this rank's rows'."""
    if not dist.is_initialized():
        raise ValueError("grow_tree_voting needs an initialised torch.distributed group")
    group = group if group is not None else dist.group.WORLD
    n, d = bins.shape
    L, B = int(num_leaves), num_bins
    K, C = min(top_k, d), min(2 * top_k, d)
    dev = bins.device
    i64 = torch.int64
    row_stats = _row_stats(grad, hess, row_weight)
    has_cat = categorical_mask is not None
    cat_f = categorical_mask if has_cat else torch.zeros(d, dtype=torch.bool, device=dev)
    mdl, msh = float(min_data_in_leaf), sp.min_sum_hessian
    fm_ok = feature_mask > 0

    def gscore(Gv: torch.Tensor, Hv: torch.Tensor) -> torch.Tensor:
        return split_gain_term(Gv, Hv, sp.lambda_l2, sp.lambda_l1)

    def scan(hg, hh, hc, ok) -> tuple:
        """Gains of every numerical threshold and, with categorical
        features, of every sorted-prefix subset (and that order); invalid
        splits at -inf. ``ok``: the features' mask, broadcast over bins."""
        cg, ch, cc = prefix_sum(hg), prefix_sum(hh), prefix_sum(hc)
        G, H, Ct = cg[..., -1:], ch[..., -1:], cc[..., -1:]

        def valid(cl, hl):
            return ok & (cl >= mdl) & (Ct - cl >= mdl) & (hl >= msh) & (H - hl >= msh)

        gain = torch.where(valid(cc, ch),
                           gscore(cg, ch) + gscore(G - cg, H - ch) - gscore(G, H), -math.inf)
        order = None
        if has_cat:
            ratio = torch.where(hc > 0, hg / (hh + 1e-12), -math.inf)
            order = torch.argsort(-ratio + 0.0, dim=-1, stable=True)
            cgs = prefix_sum(torch.gather(hg, -1, order))
            chs = prefix_sum(torch.gather(hh, -1, order))
            ccs = prefix_sum(torch.gather(hc, -1, order))
            gain_cat = torch.where(
                valid(ccs, chs),
                gscore(cgs, chs) + gscore(G - cgs, H - chs) - gscore(G, H), -math.inf)
            gain = (gain, gain_cat)
        return gain, order

    def local_feature_gains(planes: torch.Tensor) -> torch.Tensor:
        """(P, d*B, 3) local planes -> (P, d) each feature's best local gain."""
        cube = planes.reshape(-1, d, B, 3)
        gain, _ = scan(cube[..., 0], cube[..., 1], cube[..., 2], fm_ok[None, :, None])
        if not has_cat:
            return gain.amax(-1)
        return torch.where(cat_f[None, :], gain[1].amax(-1), gain[0].amax(-1))

    def candidate_best(cand: torch.Tensor, ids: torch.Tensor) -> tuple:
        """The exact split over the global candidate columns (P, C, B, 3)
        of features ``ids`` (P, C): (gain, feature, bin, catmask (P, B))."""
        P = cand.shape[0]
        gain, order = scan(cand[..., 0], cand[..., 1], cand[..., 2], fm_ok[ids][..., None])
        if has_cat:
            gain = torch.where(cat_f[ids][..., None], gain[1], gain[0])
        flat = gain.reshape(P, -1)
        best = torch.argmax(flat, dim=1)  # first maximum, as jnp.argmax
        ci, bb = torch.div(best, B, rounding_mode="floor"), best % B
        feat = ids.gather(1, ci[:, None])[:, 0]
        if has_cat:
            order_sel = order.gather(1, ci[:, None, None].expand(P, 1, B))[:, 0]
            rank = torch.empty_like(order_sel).scatter_(
                1, order_sel, torch.arange(B, device=dev).expand(P, B))
            catmask = (rank <= bb[:, None]) & cat_f[feat][:, None]
        else:
            catmask = torch.zeros((P, B), dtype=torch.bool, device=dev)
        return flat.gather(1, best[:, None])[:, 0], feat, bb, catmask

    rows = global_rows(n, group, dev)
    scale = global_scale(row_stats, rows, group)   # bounds every leaf's rows
    hist = torch.zeros((L, d * B, 3), dtype=i64, device=dev)
    hist[0] = plane_histogram_fixed(bins, row_stats, None, B, scale)
    leaf_ids = torch.arange(L, device=dev)
    row_leaf = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_depth = torch.zeros(L, dtype=torch.int32, device=dev)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    cache_gain = torch.full((L,), -math.inf, dtype=torch.float32, device=dev)
    cache_feat = torch.zeros(L, dtype=i64, device=dev)
    cache_bin = torch.zeros(L, dtype=i64, device=dev)
    cache_catmask = torch.zeros((L, B), dtype=torch.bool, device=dev)
    prev_pair = torch.zeros(2, dtype=i64, device=dev)  # root twice
    rec_leaf = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_feature = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_bin = torch.full((L - 1,), -1, dtype=i64, device=dev)
    rec_active = torch.zeros(L - 1, dtype=torch.bool, device=dev)
    rec_gain = torch.zeros(L - 1, dtype=torch.float32, device=dev)
    rec_is_cat = torch.zeros(L - 1, dtype=torch.bool, device=dev)
    rec_catmask = torch.zeros((L - 1, B), dtype=torch.bool, device=dev)
    feature_ids = torch.arange(d, dtype=torch.float32, device=dev)

    for k in range(L - 1):
        # vote phase: rank the features by LOCAL gain on the two changed planes
        pair = hist.index_select(0, prev_pair)                     # (2, d*B, 3) int64
        topv, topi = _top_k(local_feature_gains(from_fixed(pair, scale)), K)
        ballots = torch.zeros((2, d), dtype=torch.float32, device=dev).scatter_(
            1, topi, torch.isfinite(topv).float())
        votes = collectives.allreduce_sum(ballots, group)          # (2, d)
        _, cand = _top_k(votes * float(d + 1) - feature_ids, C)    # (2, C), ties to lower id
        # exact phase: only the candidates' columns cross the ranks
        cand_local = torch.gather(pair.view(2, d, B, 3), 1,
                                  cand[:, :, None, None].expand(2, C, B, 3))
        cand_global = from_fixed(collectives.allreduce_sum(cand_local, group), scale)
        bg, bf_, bb_, bcm_ = candidate_best(cand_global, cand)
        cache_gain.index_copy_(0, prev_pair, bg)
        cache_feat.index_copy_(0, prev_pair, bf_)
        cache_bin.index_copy_(0, prev_pair, bb_)
        cache_catmask.index_copy_(0, prev_pair, bcm_)

        # selection and split: identical on every rank (all-reduced inputs)
        leaf_ok = leaf_ids <= k
        if max_depth > 0:
            leaf_ok = leaf_ok & (leaf_depth < max_depth)
        sel = torch.where(leaf_ok, cache_gain, -math.inf)
        bl = torch.argmax(sel).view(1)
        best_gain = sel.index_select(0, bl)
        bf = cache_feat.index_select(0, bl)
        bb = cache_bin.index_select(0, bl)
        catmask = cache_catmask.index_select(0, bl)[0]
        do_split = ~done & (best_gain > sp.min_gain) & torch.isfinite(best_gain)

        row_bins = bins.index_select(1, bf)[:, 0]
        is_cat = cat_f.index_select(0, bf)
        if has_cat:
            right = torch.where(is_cat, ~catmask[row_bins.long()], row_bins > bb)
        else:
            right = row_bins > bb
        moved = do_split & (row_leaf == bl) & right
        row_leaf = torch.where(moved, k + 1, row_leaf)
        right_plane = plane_histogram_fixed(bins, row_stats, moved.to(torch.float32), B, scale)
        hist[k + 1] = right_plane
        hist.index_copy_(0, bl, hist.index_select(0, bl)
                         - torch.where(do_split, right_plane, 0)[None])

        child_depth = leaf_depth.index_select(0, bl) + 1
        deeper = leaf_depth.index_copy(0, bl, child_depth)
        deeper[k + 1: k + 2] = child_depth
        leaf_depth = torch.where(do_split, deeper, leaf_depth)
        rec_leaf[k: k + 1] = torch.where(do_split, bl, -1)
        rec_feature[k: k + 1] = torch.where(do_split, bf, -1)
        rec_bin[k: k + 1] = torch.where(do_split, bb, -1)
        rec_active[k: k + 1] = do_split
        rec_gain[k: k + 1] = torch.where(do_split, best_gain, 0.0)
        cat_split = do_split & is_cat
        rec_is_cat[k: k + 1] = cat_split
        rec_catmask[k] = catmask & cat_split
        done = done | ~do_split
        prev_pair = torch.cat([bl, leaf_ids[k + 1: k + 2]])

    values, counts = _leaf_values(row_leaf, row_stats, L, sp, group, rows)
    if not has_cat:
        rec_is_cat = rec_catmask = None
    return GrownTree(rec_leaf, rec_feature, rec_bin, rec_active, rec_gain,
                     values, counts, row_leaf, rec_is_cat, rec_catmask)
