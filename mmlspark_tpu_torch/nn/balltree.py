"""Serializable ball tree with max-inner-product search.

The port's copy of ``mmlspark_tpu.nn.balltree`` (host numpy code).

Parity target: the reference's in-JVM ``BallTree``/``ConditionalBallTree``
(nn/BallTree.scala:32-99) — exact top-k by inner product, with the
conditional variant restricting candidates to an allowed label set.

Construction splits on the direction between two approximately-farthest
points (median projection), giving balanced leaves; search is
best-first with the standard MIP bound ``q·c + |q|·r`` per ball.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np


@dataclass
class BestMatch:
    """One search hit: index into the fitted data, inner-product score."""

    index: int
    distance: float
    value: Any = None
    label: Any = None


class _Node:
    __slots__ = ("center", "radius", "lo", "hi", "left", "right")

    def __init__(self, center: np.ndarray, radius: float, lo: int, hi: int):
        self.center = center
        self.radius = radius
        self.lo = lo  # [lo, hi) range into the permuted point array
        self.hi = hi
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class BallTree:
    """Exact max-inner-product ball tree over dense vectors."""

    def __init__(self, points: np.ndarray, leaf_size: int = 50):
        points = np.asarray(points, np.float32)
        if points.ndim != 2:
            raise ValueError(f"points must be (n, d), got {points.shape}")
        self.leaf_size = int(leaf_size)
        self.perm = np.arange(len(points))
        self.points = points.copy()
        self.root = self._build(0, len(points)) if len(points) else None

    # -- construction --------------------------------------------------------

    def _make_node(self, lo: int, hi: int) -> _Node:
        pts = self.points[lo:hi]
        center = pts.mean(axis=0)
        radius = float(np.sqrt(((pts - center) ** 2).sum(-1)).max()) if len(pts) else 0.0
        return _Node(center, radius, lo, hi)

    def _build(self, lo: int, hi: int) -> _Node:
        node = self._make_node(lo, hi)
        if hi - lo <= self.leaf_size:
            return node
        pts = self.points[lo:hi]
        # two-step farthest-point heuristic for the split direction
        a = pts[int(np.argmax(((pts - pts[0]) ** 2).sum(-1)))]
        b = pts[int(np.argmax(((pts - a) ** 2).sum(-1)))]
        proj = pts @ (b - a)
        order = np.argsort(proj, kind="stable")
        mid = (hi - lo) // 2
        take = lo + order
        self.points[lo:hi] = self.points[take]
        self.perm[lo:hi] = self.perm[take]
        node.left = self._build(lo, lo + mid)
        node.right = self._build(lo + mid, hi)
        return node

    # -- search --------------------------------------------------------------

    def _search(
        self, query: np.ndarray, k: int, allowed: Optional[np.ndarray] = None
    ) -> list[BestMatch]:
        if self.root is None or k <= 0:
            return []
        q = np.asarray(query, np.float32)
        qnorm = float(np.linalg.norm(q))
        best: list[tuple[float, int]] = []  # min-heap of (score, original index)

        def bound(node: _Node) -> float:
            return float(q @ node.center) + qnorm * node.radius

        heap = [(-bound(self.root), 0, self.root)]
        tiebreak = 1
        while heap:
            neg_ub, _, node = heapq.heappop(heap)
            if len(best) == k and -neg_ub <= best[0][0]:
                continue  # this ball cannot beat the current k-th best
            if node.left is None:  # leaf
                idx = slice(node.lo, node.hi)
                scores = self.points[idx] @ q
                orig = self.perm[idx]
                if allowed is not None:
                    keep = allowed[orig]
                    scores, orig = scores[keep], orig[keep]
                for s, i in zip(scores, orig):
                    if len(best) < k:
                        heapq.heappush(best, (float(s), int(i)))
                    elif s > best[0][0]:
                        heapq.heapreplace(best, (float(s), int(i)))
            else:
                for child in (node.left, node.right):
                    ub = bound(child)
                    if len(best) < k or ub > best[0][0]:
                        heapq.heappush(heap, (-ub, tiebreak, child))
                        tiebreak += 1
        best.sort(key=lambda t: -t[0])
        return [BestMatch(index=i, distance=s) for s, i in best]

    def find_maximum_inner_products(self, query: np.ndarray, k: int = 1) -> list[BestMatch]:
        return self._search(query, k)

    # -- persistence ---------------------------------------------------------

    def __getstate__(self) -> dict:
        # the tree is cheap to rebuild relative to (de)serializing node objects
        return {
            "points": self.points[np.argsort(self.perm)],
            "leaf_size": self.leaf_size,
        }

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["points"], state["leaf_size"])


class ConditionalBallTree(BallTree):
    """Ball tree whose queries are restricted to an allowed set of labels
    (nn/ConditionalBallTree in the reference)."""

    def __init__(self, points: np.ndarray, labels: Sequence[Any], leaf_size: int = 50):
        if len(points) != len(labels):
            raise ValueError("points and labels must align")
        self.labels = np.asarray(labels)
        super().__init__(points, leaf_size)

    def find_maximum_inner_products(
        self, query: np.ndarray, k: int = 1, conditioner: Optional[Sequence[Any]] = None
    ) -> list[BestMatch]:
        allowed = None
        if conditioner is not None:
            allowed = np.isin(self.labels, np.asarray(list(conditioner)))
        out = self._search(query, k, allowed)
        for m in out:
            m.label = self.labels[m.index]
        return out

    def __getstate__(self) -> dict:
        state = super().__getstate__()
        state["labels"] = self.labels  # kept in original order (never permuted)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["points"], state["labels"], state["leaf_size"])
