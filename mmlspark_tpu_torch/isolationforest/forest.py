"""Isolation forest: host tree growth, device batch scoring — the port of
``mmlspark_tpu.isolationforest.forest``.

Algorithm (Liu et al. 2008, as shipped by the reference's linkedin
estimator): T trees each grown on a psi-row subsample by recursively
picking a random feature and a random split between the reaching data's
min/max until isolation or the depth cap ceil(log2(psi)); anomaly score
``s(x) = 2^(-E[h(x)] / c(psi))`` where h adds ``c(n)`` at unsplit leaves.

The fit is the JAX package's host numpy under one ``RandomState``, copied,
so both packages grow the same trees bit for bit from a seed. Layout:
perfect binary tree of depth D as flat arrays
``feature/threshold/is_leaf/path_len`` of width 2^(D+1)-1 per tree.
Scoring runs on the model's ``device`` (the card unless ``device="cpu"``):
D gather steps over all T trees at once, one (T, rows) index tensor, no
loop over trees. The path lengths are the table's values, so they are
bitwise the JAX package's (a NaN feature goes right everywhere); their
mean and the score stay numpy f32 on the host, so the scores are bitwise
too.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core.params import ComplexParam, HasFeaturesCol, HasPredictionCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model

# rows a scoring block: its (T, rows) int64 node indices hold at most this
# many entries
SCORE_BLOCK_ENTRIES = 1 << 25


def _avg_path_length(n: np.ndarray) -> np.ndarray:
    """c(n): average BST unsuccessful-search path length (the h(x) correction)."""
    n = np.asarray(n, np.float64)
    out = np.zeros_like(n)
    big = n > 2
    out[big] = 2.0 * (np.log(n[big] - 1.0) + np.euler_gamma) - 2.0 * (n[big] - 1.0) / n[big]
    out[n == 2] = 1.0
    return out


def _grow_tree(
    x: np.ndarray, rng: np.random.RandomState, depth_cap: int, feat_subset: np.ndarray
) -> dict:
    """Grow one tree into perfect-binary-tree arrays of depth depth_cap."""
    n_nodes = 2 ** (depth_cap + 1) - 1
    feature = np.zeros(n_nodes, np.int32)
    threshold = np.zeros(n_nodes, np.float32)
    is_leaf = np.ones(n_nodes, bool)
    path_len = np.zeros(n_nodes, np.float32)

    # stack of (node_id, row_indices, depth)
    stack = [(0, np.arange(len(x)), 0)]
    while stack:
        node, rows, depth = stack.pop()
        xs = x[rows]
        if depth >= depth_cap or len(rows) <= 1:
            path_len[node] = depth + _avg_path_length(np.array([len(rows)]))[0]
            continue
        # random feature with spread; give up (leaf) if all are constant
        cand = feat_subset[rng.permutation(len(feat_subset))]
        lo = hi = None
        f_pick = -1
        for f in cand:
            flo, fhi = xs[:, f].min(), xs[:, f].max()
            if fhi > flo:
                f_pick, lo, hi = int(f), flo, fhi
                break
        if f_pick < 0:
            path_len[node] = depth + _avg_path_length(np.array([len(rows)]))[0]
            continue
        thr = rng.uniform(lo, hi)
        is_leaf[node] = False
        feature[node] = f_pick
        threshold[node] = thr
        mask = xs[:, f_pick] < thr
        stack.append((2 * node + 1, rows[mask], depth + 1))
        stack.append((2 * node + 2, rows[~mask], depth + 1))
    return {
        "feature": feature,
        "threshold": threshold,
        "is_leaf": is_leaf,
        "path_len": path_len,
    }


def batch_path_lengths(
    x: torch.Tensor,
    feature: torch.Tensor,
    threshold: torch.Tensor,
    is_leaf: torch.Tensor,
    path_len: torch.Tensor,
    depth_cap: int,
) -> torch.Tensor:
    """(N, d) rows x (T, nodes) trees -> (T, N) path lengths, on the rows'
    device: ``depth_cap`` steps of ``x[row, feat[idx]] < thr[idx]``, each
    row stopping at its leaf."""
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)[None, :]
    idx = torch.zeros((feature.shape[0], n), dtype=torch.int64, device=x.device)
    for _ in range(depth_cap):
        go_left = x[rows, torch.gather(feature, 1, idx)] < torch.gather(threshold, 1, idx)
        child = torch.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(torch.gather(is_leaf, 1, idx), idx, child)  # stop at leaves
    return torch.gather(path_len, 1, idx)


class _IFParams(HasFeaturesCol, HasPredictionCol, HasDevice):
    num_estimators = Param("number of trees", default=100, type_=int)
    max_samples = Param("subsample rows per tree (psi)", default=256, type_=int)
    max_features = Param("fraction of features per tree", default=1.0, type_=float)
    bootstrap = Param("sample rows with replacement", default=False, type_=bool)
    contamination = Param(
        "expected outlier fraction; 0 means fixed 0.5 score threshold",
        default=0.0,
        type_=float,
    )
    score_col = Param("anomaly score output column", default="outlierScore")
    random_seed = Param("rng seed", default=1, type_=int)


class IsolationForest(Estimator, _IFParams):
    def fit(self, df: DataFrame) -> "IsolationForestModel":
        resolve_device(self.get("device"))  # the model scores there
        x = np.asarray(df[self.get("features_col")], np.float32)
        if x.ndim != 2 or len(x) == 0:
            raise ValueError(f"IsolationForest needs (n, d) features, got {x.shape}")
        rng = np.random.RandomState(self.get("random_seed"))
        t = self.get("num_estimators")
        psi = min(self.get("max_samples"), len(x))
        depth_cap = max(1, int(np.ceil(np.log2(max(psi, 2)))))
        n_feat = max(1, int(round(self.get("max_features") * x.shape[1])))

        trees = []
        for _ in range(t):
            if self.get("bootstrap"):
                rows = rng.randint(0, len(x), psi)
            else:
                rows = rng.choice(len(x), psi, replace=False)
            feat_subset = rng.choice(x.shape[1], n_feat, replace=False)
            trees.append(_grow_tree(x[rows], rng, depth_cap, feat_subset))

        m = IsolationForestModel(**{k: v for k, v in self._paramMap.items()})
        m.set(
            features=np.stack([tr["feature"] for tr in trees]),
            thresholds=np.stack([tr["threshold"] for tr in trees]),
            leaves=np.stack([tr["is_leaf"] for tr in trees]),
            path_lens=np.stack([tr["path_len"] for tr in trees]),
            depth_cap=depth_cap,
            subsample_size=psi,
        )
        if self.get("contamination") > 0.0:
            scores = m._scores(x)
            m.set(score_threshold=float(np.quantile(scores, 1.0 - self.get("contamination"))))
        return m


class IsolationForestModel(Model, _IFParams):
    features = ComplexParam("(T, nodes) split feature ids")
    thresholds = ComplexParam("(T, nodes) split thresholds")
    leaves = ComplexParam("(T, nodes) leaf mask")
    path_lens = ComplexParam("(T, nodes) leaf path lengths (depth + c(n))")
    depth_cap = Param("tree depth", type_=int)
    subsample_size = Param("psi used at fit", type_=int)
    score_threshold = Param("score above this = outlier", default=0.5, type_=float)

    def _scores(self, x: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.get("device"))
        trees = [
            torch.tensor(np.asarray(self.get_or_fail(name)), device=dev)
            for name in ("features", "thresholds", "leaves", "path_lens")
        ]
        trees[0] = trees[0].long()
        depth_cap = self.get_or_fail("depth_cap")
        block = max(1, SCORE_BLOCK_ENTRIES // max(trees[0].shape[0], 1))
        xd = torch.tensor(np.asarray(x, np.float32), device=dev)
        # (N, T) C-ordered on the host, as the JAX package's: numpy's f32
        # mean then sums each row in the same order
        lengths = np.ascontiguousarray(torch.cat([
            batch_path_lengths(xd[lo:lo + block], *trees, depth_cap)
            for lo in range(0, len(x), block)
        ], dim=1).T.cpu().numpy())
        e_h = lengths.mean(axis=1)
        c = _avg_path_length(np.array([self.get_or_fail("subsample_size")]))[0]
        return np.power(2.0, -e_h / max(c, 1e-9))

    def transform(self, df: DataFrame) -> DataFrame:
        def fn(p: dict) -> dict:
            x = np.asarray(p[self.get("features_col")], np.float32)
            q = dict(p)
            if len(x) == 0:
                q[self.get("score_col")] = np.zeros(0, np.float64)
                q[self.get("prediction_col")] = np.zeros(0, np.float64)
                return q
            scores = self._scores(x)
            q[self.get("score_col")] = scores.astype(np.float64)
            q[self.get("prediction_col")] = (
                scores >= self.get("score_threshold")
            ).astype(np.float64)
            return q

        return df.map_partitions(fn, parallel=False)
