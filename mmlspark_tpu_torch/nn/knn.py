"""KNN / ConditionalKNN pipeline stages: the port of ``mmlspark_tpu.nn.knn``.

Reference semantics (nn/KNN.scala, nn/ConditionalKNN.scala:68-102): ``fit``
captures the dataset (features + payload values + labels); the model answers
per-row top-k max-inner-product queries, emitting an array of ``{value,
distance[, label]}`` structs.

The index is placed once on the model's device (the card unless
``device="cpu"``) as one dense (N, d) f32 matrix; a query batch is
``scores = Q @ X.T`` and a top-k, chunk by chunk: each ``index_chunk_size``
rows give their top-k, and the chunks' winners merge by a final top-k, so
only (B, chunk) scores are ever live. The conditional variant masks the
scores with each row's allowed labels (a (B, labels) table gathered by
each index row's label code) before the top-k.

Ties go to the lower index row, as ``lax.top_k`` and the JAX package's
stable merge break them: duplicated index rows are ordinary in KNN data,
and ``torch.topk`` promises no order among equal values on the card. Each
top-k runs on one int64 key a candidate, its score's order-preserving
integer in the high 32 bits and the complement of its index in the low 32,
so the keys are distinct and the top-k of the keys is the scores' top-k
with ties broken by index. ``algorithm='balltree'`` is the exact host
tree (:mod:`mmlspark_tpu_torch.nn.balltree`).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasFeaturesCol,
    HasLabelCol,
    HasOutputCol,
    Param,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.nn.balltree import BallTree, ConditionalBallTree

_NEG_INF = np.float32(-np.inf)
_LOW = 0xFFFFFFFF


def _keys(scores: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (score, then lower index first): the f32
    score's bits made order-preserving as a signed int32 in the high half,
    ``2^32 - 1 - index`` in the low half."""
    bits = scores.contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (ordered.to(torch.int64) << 32) | (_LOW - index)


def topk_by_index(scores: torch.Tensor, index: torch.Tensor, k: int) -> tuple:
    """Top-k of (B, C) ``scores`` whose candidates carry global row numbers
    ``index`` ((C,) or (B, C), below 2^32), ties to the lower row: (scores,
    rows), each (B, k), in descending order."""
    idx = index.expand_as(scores) if index.dim() == 1 else index
    pos = torch.topk(_keys(scores, idx), k, dim=1).indices
    return torch.gather(scores, 1, pos), torch.gather(idx, 1, pos)


def chunked_topk(q: torch.Tensor, x: torch.Tensor, k: int, chunk: int,
                 allowed: Optional[torch.Tensor] = None,
                 codes: Optional[torch.Tensor] = None) -> tuple:
    """Top-k inner products of (B, d) ``q`` over the (N, d) index ``x`` in
    chunks of ``chunk`` rows, merged by a final top-k; with ``allowed`` (B,
    L) bool and each index row's label code ``codes`` (N,), a row whose
    label a query does not allow scores -inf. Returns (scores, rows) on the
    device, each (B, k)."""
    all_sc, all_ix = [], []
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk]
        s = q @ xc.T
        if allowed is not None:
            s = torch.where(allowed[:, codes[lo:lo + chunk]], s,
                            torch.tensor(float("-inf"), device=s.device))
        rows = torch.arange(lo, lo + xc.shape[0], device=q.device)
        sc, ix = topk_by_index(s, rows, min(k, xc.shape[0]))
        all_sc.append(sc)
        all_ix.append(ix)
    if len(all_sc) == 1:
        return all_sc[0], all_ix[0]
    return topk_by_index(torch.cat(all_sc, dim=1), torch.cat(all_ix, dim=1), k)


class _KNNParams(HasFeaturesCol, HasOutputCol, HasDevice):
    values_col = Param("payload column returned with each match", default="values")
    k = Param("number of matches", default=5, type_=int, validator=lambda v: v > 0)
    leaf_size = Param("ball tree leaf size (host algorithm)", default=50, type_=int)
    index_chunk_size = Param(
        "max index rows scored per device call (bounds device memory)", default=1 << 20,
        type_=int)
    algorithm = Param(
        "'brute' = device matmul top-k; 'balltree' = exact host tree",
        default="brute",
        validator=lambda v: v in ("brute", "balltree"),
    )

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "output_col" not in self._paramMap:
            self.set(output_col="matches")


class _HasConditionerCol(HasLabelCol):
    conditioner_col = Param("column of per-row allowed-label collections", default="conditioner")


class KNN(Estimator, _KNNParams):
    """Fit = capture the index; see module docstring."""

    def fit(self, df: DataFrame) -> "KNNModel":
        feats = np.asarray(df[self.get("features_col")], np.float32)
        values = df[self.get("values_col")] if self.get("values_col") in df.columns else None
        m = KNNModel(**{k: v for k, v in self._paramMap.items()})
        m.set(index_features=feats)
        if values is not None:
            m.set(index_values=np.asarray(values))
        return m


class KNNModel(Model, _KNNParams):
    index_features = ComplexParam("(N, d) index matrix")
    index_values = ComplexParam("(N,) payload values", default=None)

    _tree_cache: Any = None    # (conditional_flag, tree); cleared when index params change
    _placed_cache: Any = None  # (key, the index on the device)

    def set(self, *args: Any, **kw: Any) -> Any:
        names = set(kw)
        if args:
            names.add(args[0])
        if names & {"index_features", "index_labels", "leaf_size"}:
            self._tree_cache = None
            self._placed_cache = None
        return super().set(*args, **kw)

    def _tree(self, conditional: bool = False) -> Any:
        x = self.get_or_fail("index_features")
        if self._tree_cache is None or self._tree_cache[0] != conditional:
            if conditional:
                tree = ConditionalBallTree(
                    x, self.get_or_fail("index_labels"), self.get("leaf_size"))
            else:
                tree = BallTree(x, self.get("leaf_size"))
            self._tree_cache = (conditional, tree)
        return self._tree_cache[1]

    def _placed(self, dev: torch.device) -> torch.Tensor:
        """The index on ``dev``, copied there once."""
        x = self.get_or_fail("index_features")
        key = (id(x), dev)
        if self._placed_cache is None or self._placed_cache[0] != key:
            self._placed_cache = (key, torch.as_tensor(np.asarray(x, np.float32), device=dev))
        return self._placed_cache[1]

    def _brute(self, q: np.ndarray, k: int, allowed: Optional[np.ndarray] = None,
               codes: Optional[np.ndarray] = None) -> tuple:
        dev = resolve_device(self.get("device"))
        x = self._placed(dev)
        qd = torch.as_tensor(np.asarray(q, np.float32), device=dev)
        extra = {}
        if allowed is not None:
            extra = {"allowed": torch.as_tensor(allowed, device=dev),
                     "codes": torch.as_tensor(codes, device=dev)}
        sc, ix = chunked_topk(qd, x, k, self.get("index_chunk_size"), **extra)
        return sc.cpu().numpy(), ix.cpu().numpy()

    def _query(self, q: np.ndarray, k: int) -> tuple:
        """Return (scores, indices) each (B, k)."""
        x = self.get_or_fail("index_features")
        k = min(k, len(x))
        if len(q) == 0 or k == 0:
            return np.zeros((len(q), 0), np.float32), np.zeros((len(q), 0), np.int64)
        if self.get("algorithm") == "balltree":
            tree = self._tree()
            idx = np.zeros((len(q), k), np.int64)
            sc = np.zeros((len(q), k), np.float32)
            for i, row in enumerate(q):
                ms = tree.find_maximum_inner_products(row, k)
                idx[i] = [m.index for m in ms]
                sc[i] = [m.distance for m in ms]
            return sc, idx
        return self._brute(q, k)

    def _emit(self, df: DataFrame, scores: Any, indices: Any, labels: Any = None) -> DataFrame:
        values = self.get("index_values")
        out = np.empty(len(scores), dtype=object)
        for i, (sc, ix) in enumerate(zip(scores, indices)):
            row = []
            for s, j in zip(sc, ix):
                if not np.isfinite(s):
                    continue  # masked-out candidate (conditional variant)
                match = {"distance": float(s), "index": int(j)}
                if values is not None:
                    match["value"] = values[j]
                if labels is not None:
                    match["label"] = labels[j]
                row.append(match)
            out[i] = row
        return df.with_column(self.get("output_col"), out)

    def transform(self, df: DataFrame) -> DataFrame:
        q = np.asarray(df[self.get("features_col")], np.float32)
        scores, indices = self._query(q, self.get("k"))
        return self._emit(df, scores, indices)


class ConditionalKNN(Estimator, _KNNParams, _HasConditionerCol):
    """KNN whose queries restrict candidates to per-row allowed labels
    (ConditionalKNN.scala:68-102)."""

    def fit(self, df: DataFrame) -> "ConditionalKNNModel":
        feats = np.asarray(df[self.get("features_col")], np.float32)
        labels = np.asarray(df[self.get("label_col")])
        m = ConditionalKNNModel(**{k: v for k, v in self._paramMap.items()})
        m.set(index_features=feats, index_labels=labels)
        if self.get("values_col") in df.columns:
            m.set(index_values=np.asarray(df[self.get("values_col")]))
        return m


class ConditionalKNNModel(KNNModel, _HasConditionerCol):
    index_labels = ComplexParam("(N,) index labels")

    def transform(self, df: DataFrame) -> DataFrame:
        q = np.asarray(df[self.get("features_col")], np.float32)
        labels = self.get_or_fail("index_labels")
        x = self.get_or_fail("index_features")
        k = min(self.get("k"), len(x))
        if len(q) == 0 or k == 0:
            return self._emit(df, np.zeros((len(q), 0), np.float32),
                              np.zeros((len(q), 0), np.int64), labels=labels)
        conditioners = df[self.get("conditioner_col")]

        if self.get("algorithm") == "balltree":
            tree = self._tree(conditional=True)
            scores = np.full((len(q), k), _NEG_INF, np.float32)
            indices = np.zeros((len(q), k), np.int64)
            for i, row in enumerate(q):
                ms = tree.find_maximum_inner_products(row, k, conditioners[i])
                for j, m in enumerate(ms):
                    scores[i, j], indices[i, j] = m.distance, m.index
        else:
            # np.isin(labels, c) per row, as a (B, labels) table of the
            # label codes each row allows
            uniq, codes = np.unique(np.asarray(labels), return_inverse=True)
            allowed = np.stack([np.isin(uniq, np.asarray(list(c))) for c in conditioners])
            scores, indices = self._brute(q, k, allowed, codes.reshape(-1))
        return self._emit(df, scores, indices, labels=labels)
