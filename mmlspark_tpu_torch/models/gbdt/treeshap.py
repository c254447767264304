"""Exact TreeSHAP for the replay-log trees.

The port's copy of ``mmlspark_tpu.models.gbdt.treeshap`` (numpy, host
side). LightGBM's Spark package surfaces ``featuresShap`` (exact conditional-
expectation Shapley values, LightGBMBooster.scala:37-128); Saabas-style
attribution (booster.feature_contribs' fast path) is only its first-order
approximation. This module implements the exact polynomial-time algorithm
(Lundberg et al., "Consistent Individualized Feature Attribution for Tree
Ensembles": maintain, along each root->leaf path, the fraction of all
feature-subset permutations that flow to the leaf with each path feature
included ("one fraction") or excluded (cover-proportional "zero
fraction"), then read each feature's Shapley weight off the path by
unwinding it).

Cost is O(leaves * depth^2) per tree per row on the host — attribution is
an explanation workload, scored on demand for a handful of rows, unlike
the device scoring paths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mmlspark_tpu_torch.models.gbdt import treegrow


class _BinaryTree:
    """Replay log -> explicit binary tree with per-node covers."""

    __slots__ = (
        "left", "right", "feature", "threshold", "is_cat", "catmask",
        "value", "cover", "default_left",
    )

    def __init__(self, tree) -> None:
        S = len(tree.leaf)
        max_nodes = 2 * S + 1
        self.left = np.full(max_nodes, -1, np.int64)
        self.right = np.full(max_nodes, -1, np.int64)
        self.feature = np.full(max_nodes, -1, np.int64)
        self.threshold = np.zeros(max_nodes, np.float64)
        self.is_cat = np.zeros(max_nodes, bool)
        self.catmask = [None] * max_nodes
        self.default_left = np.ones(max_nodes, bool)
        self.value = np.zeros(max_nodes, np.float64)
        self.cover = np.zeros(max_nodes, np.float64)

        node_of_leaf = {0: 0}  # leaf-id -> current tree node
        next_node = 1
        for k in range(S):
            if not tree.active[k]:
                continue
            parent_leaf = int(tree.leaf[k])
            node = node_of_leaf[parent_leaf]
            l_node, r_node = next_node, next_node + 1
            next_node += 2
            self.left[node] = l_node
            self.right[node] = r_node
            self.feature[node] = int(tree.feature[k])
            self.threshold[node] = float(tree.threshold[k])
            if tree.is_cat is not None and tree.is_cat[k]:
                self.is_cat[node] = True
                self.catmask[node] = tree.catmask[k]
            if tree.default_left is not None:
                self.default_left[node] = bool(tree.default_left[k])
            node_of_leaf[parent_leaf] = l_node
            node_of_leaf[k + 1] = r_node
        for leaf_id, node in node_of_leaf.items():
            self.value[node] = float(tree.values[leaf_id])
            self.cover[node] = float(tree.counts[leaf_id])
        # internal covers bottom-up (children were always created after
        # their parent, so a reverse sweep sees children first)
        for node in range(next_node - 1, -1, -1):
            if self.left[node] >= 0:
                self.cover[node] = (
                    self.cover[self.left[node]] + self.cover[self.right[node]]
                )

    def goes_left(self, x_row: np.ndarray, node: int) -> bool:
        f = self.feature[node]
        v = x_row[f]
        if self.is_cat[node]:
            vbin = treegrow.category_bin_slot(np.asarray([v]), len(self.catmask[node]))[0]
            return bool(self.catmask[node][vbin])
        # NaN routes by the split's default direction (left unless an
        # imported default-right split), matching predict_leaves/Saabas
        if np.isnan(v):
            return bool(self.default_left[node])
        return bool(v <= self.threshold[node])


def shap_values(tree, x: np.ndarray) -> np.ndarray:
    """(n, d) -> (n, d+1) exact SHAP values for ONE replay-log tree; the
    last column is the expected value (base rate)."""
    bt = _BinaryTree(tree)
    n, d = x.shape
    out = np.zeros((n, d + 1), np.float64)
    if bt.cover[0] <= 0:
        return out
    base = _expected_value(bt, 0)
    for i in range(n):
        phi = out[i]
        _recurse(
            bt, x[i], phi,
            node=0,
            path=_Path(),
            zero_fraction=1.0,
            one_fraction=1.0,
            feature_index=-1,
        )
        phi[d] += base
    return out


def _expected_value(bt: _BinaryTree, node: int) -> float:
    if bt.left[node] < 0:
        return bt.value[node]
    l, r = bt.left[node], bt.right[node]
    c = bt.cover[node]
    return (
        bt.cover[l] / c * _expected_value(bt, l)
        + bt.cover[r] / c * _expected_value(bt, r)
    )


class _Path:
    """Subset-permutation bookkeeping along the active path."""

    __slots__ = ("d", "z", "o", "w")

    def __init__(self) -> None:
        self.d: list = []  # feature index per path element
        self.z: list = []  # zero fraction (cover-proportional flow)
        self.o: list = []  # one fraction (decision-path flow)
        self.w: list = []  # permutation weight

    def copy(self) -> "_Path":
        p = _Path.__new__(_Path)
        p.d, p.z, p.o, p.w = list(self.d), list(self.z), list(self.o), list(self.w)
        return p

    def extend(self, zero_fraction: float, one_fraction: float, feature_index: int) -> None:
        m = len(self.d)
        self.d.append(feature_index)
        self.z.append(zero_fraction)
        self.o.append(one_fraction)
        self.w.append(1.0 if m == 0 else 0.0)
        for i in range(m - 1, -1, -1):
            self.w[i + 1] += one_fraction * self.w[i] * (i + 1) / (m + 1)
            self.w[i] = zero_fraction * self.w[i] * (m - i) / (m + 1)

    def unwind(self, index: int) -> "_Path":
        m = len(self.d) - 1
        p = self.copy()
        one = p.o[index]
        zero = p.z[index]
        n_ = p.w[m]
        for j in range(m - 1, -1, -1):
            if one != 0:
                t = p.w[j]
                p.w[j] = n_ * (m + 1) / ((j + 1) * one)
                n_ = t - p.w[j] * zero * (m - j) / (m + 1)
            else:
                p.w[j] = p.w[j] * (m + 1) / (zero * (m - j))
        # after the loop w[0..m-1] are the rebuilt weights; the stale slot
        # is the LAST one. Only d/z/o shift at ``index``.
        del p.d[index], p.z[index], p.o[index], p.w[-1]
        return p

    def unwound_sum(self, index: int) -> float:
        m = len(self.d) - 1
        one = self.o[index]
        zero = self.z[index]
        total = 0.0
        if one != 0:
            n_ = self.w[m]
            for j in range(m - 1, -1, -1):
                t = n_ / ((j + 1) * one)
                total += t
                n_ = self.w[j] - t * zero * (m - j)
        else:
            for j in range(m - 1, -1, -1):
                total += self.w[j] / (zero * (m - j))
        return total * (m + 1)


def _recurse(
    bt: _BinaryTree,
    x_row: np.ndarray,
    phi: np.ndarray,
    node: int,
    path: _Path,
    zero_fraction: float,
    one_fraction: float,
    feature_index: int,
) -> None:
    path = path.copy()
    path.extend(zero_fraction, one_fraction, feature_index)

    if bt.left[node] < 0:  # leaf
        for i in range(1, len(path.d)):
            w = path.unwound_sum(i)
            phi[path.d[i]] += w * (path.o[i] - path.z[i]) * bt.value[node]
        return

    f = int(bt.feature[node])
    hot, cold = (
        (bt.left[node], bt.right[node])
        if bt.goes_left(x_row, node)
        else (bt.right[node], bt.left[node])
    )
    hot_zero = bt.cover[hot] / bt.cover[node]
    cold_zero = bt.cover[cold] / bt.cover[node]
    incoming_zero, incoming_one = 1.0, 1.0
    # a feature met twice on one path: undo its earlier element first so the
    # path never holds duplicates (its fractions multiply)
    for i in range(1, len(path.d)):
        if path.d[i] == f:
            incoming_zero, incoming_one = path.z[i], path.o[i]
            path = path.unwind(i)
            break
    _recurse(bt, x_row, phi, hot, path, hot_zero * incoming_zero,
             incoming_one, f)
    _recurse(bt, x_row, phi, cold, path, cold_zero * incoming_zero,
             0.0, f)
