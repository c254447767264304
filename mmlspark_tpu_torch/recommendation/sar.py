"""SAR recommender — co-occurrence similarity x time-decayed affinity: the
port of ``mmlspark_tpu.recommendation.sar``.

Reference semantics (recommendation/SAR.scala:66-119):
- item-item similarity from the co-occurrence matrix ``C = A^T A`` over the
  binarized user-item interaction matrix, rescaled per
  ``similarity_function``: cooccurrence (raw counts), jaccard
  ``c_ij / (c_ii + c_jj - c_ij)``, lift ``c_ij / (c_ii * c_jj)``;
  counts below ``support_threshold`` are zeroed.
- user-item affinity with exponential time decay
  ``sum_t rating * 2^(-(t_ref - t) / half_life)``.
- score(u, i) = affinity[u] . similarity[:, i]; top-k with seen items
  optionally removed.

The interaction and affinity matrices are built on the host exactly as the
JAX package builds them (``np.add.at`` in row order, the decay in f64 cast
to f32); the co-occurrence product, the rescaling, the scoring product and
the top-k run on the estimator's ``device`` (the card unless
``device="cpu"``). Both products are full f32: the port relies on
PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 = False``, as
XLA:CPU's dot is f32. The counts are then exact below 2^24 and each f32
``/`` is correctly rounded everywhere, so the similarity is bitwise the
JAX package's. Scores are sums in another order (within 1e-5 relative),
and the top-k breaks ties by the lower item index, as ``lax.top_k`` does
(``nn.knn.topk_by_index``): every item with no co-occurrence ties at 0.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core.params import ComplexParam, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.nn.knn import topk_by_index

# pair scoring gathers two (chunk, I) blocks at a time: at most this many
# f32 values each
PAIR_BLOCK_VALUES = 1 << 24


def similarity(a_bool: torch.Tensor, function: str, support: int) -> torch.Tensor:
    """(U, I) 0/1 interactions -> (I, I) f32 similarity, on their device."""
    # (I, I) co-occurrence counts, exact in f32; full f32 relies on
    # torch.backends.cuda.matmul.allow_tf32 being False (PyTorch's default)
    c = a_bool.T @ a_bool
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    c = torch.where(c >= support, c, zero)
    diag = torch.diagonal(c)
    if function == "jaccard":
        denom = diag[:, None] + diag[None, :] - c
    elif function == "lift":
        denom = diag[:, None] * diag[None, :]
    else:  # cooccurrence
        return c
    tiny = torch.tensor(np.float32(1e-12), device=c.device)
    return torch.where(denom > 0, c / torch.maximum(denom, tiny), zero)


def score_topk(affinity: torch.Tensor, sim: torch.Tensor, seen: torch.Tensor,
               k: int) -> tuple:
    """(U, I) affinity @ (I, I) similarity, seen items at -inf, then the
    top-k of each row, ties to the lower item: (scores, items), each (U, k)."""
    scores = affinity @ sim  # full f32 as XLA:CPU's dot: TF32 must stay off
    scores = torch.where(seen, torch.tensor(float("-inf"), device=scores.device), scores)
    items = torch.arange(sim.shape[0], device=scores.device)
    return topk_by_index(scores, items, k)


class _SARParams(HasDevice):
    user_col = Param("indexed user column", default="user_idx")
    item_col = Param("indexed item column", default="item_idx")
    rating_col = Param("rating column", default="rating")
    time_col = Param("event-time column (unix seconds); optional", default=None)
    similarity_function = Param(
        "cooccurrence | jaccard | lift",
        default="jaccard",
        validator=lambda v: v in ("cooccurrence", "jaccard", "lift"),
    )
    support_threshold = Param("min co-occurrence count kept", default=4, type_=int)
    time_decay_coeff = Param("affinity half-life in days", default=30.0, type_=float)
    reference_time = Param(
        "decay reference time (unix seconds; reference SAR.scala 'startTime' "
        "analogue). None decays relative to the latest training event, which "
        "keeps offline runs reproducible but does NOT age a stale dataset "
        "relative to now — pass time.time() for that.",
        default=None,
    )
    allow_seen_items = Param("keep already-seen items in recommendations", default=False, type_=bool)


class SAR(Estimator, _SARParams):
    def fit(self, df: DataFrame) -> "SARModel":
        dev = resolve_device(self.get("device"))
        users = np.asarray(df[self.get("user_col")], np.int64)
        items = np.asarray(df[self.get("item_col")], np.int64)
        n_users = int(users.max()) + 1 if len(users) else 0
        n_items = int(items.max()) + 1 if len(items) else 0
        rc = self.get("rating_col")
        ratings = (
            np.asarray(df[rc], np.float32)
            if rc and rc in df.columns
            else np.ones(len(users), np.float32)
        )

        weights = ratings
        tc = self.get("time_col")
        if tc and tc in df.columns:
            t = np.asarray(df[tc], np.float64)
            half_life_s = self.get("time_decay_coeff") * 86400.0
            ref = self.get("reference_time")
            t_ref = float(ref) if ref is not None else t.max()
            decay = np.exp2(-(t_ref - t) / half_life_s)
            weights = ratings * decay.astype(np.float32)

        # binarized interactions for similarity; decayed sums for affinity
        a_bool = np.zeros((n_users, n_items), np.float32)
        a_bool[users, items] = 1.0
        affinity = np.zeros((n_users, n_items), np.float32)
        np.add.at(affinity, (users, items), weights)

        sim = similarity(
            torch.as_tensor(a_bool, device=dev),
            self.get("similarity_function"),
            self.get("support_threshold"),
        ).cpu().numpy()
        m = SARModel(**{k: v for k, v in self._paramMap.items()})
        m.set(item_similarity=sim, user_affinity=affinity, seen_items=a_bool)
        return m


class SARModel(Model, _SARParams):
    item_similarity = ComplexParam("(I, I) item-item similarity")
    user_affinity = ComplexParam("(U, I) time-decayed user-item affinity")
    seen_items = ComplexParam("(U, I) binary seen matrix")
    prediction_col = Param("output column for pair scores / recommendations", default="prediction")

    _placed_cache: Any = None  # (key, (affinity, similarity) on the device)

    def _placed(self, dev: torch.device) -> tuple:
        """The affinity and similarity on ``dev``, copied there once per
        pair of arrays."""
        aff = self.get_or_fail("user_affinity")
        sim = self.get_or_fail("item_similarity")
        key = (id(aff), id(sim), dev)
        if self._placed_cache is None or self._placed_cache[0] != key:
            self._placed_cache = (key, (
                torch.tensor(np.asarray(aff, np.float32), device=dev),
                torch.tensor(np.asarray(sim, np.float32), device=dev)))
        return self._placed_cache[1]

    def transform(self, df: DataFrame) -> DataFrame:
        """Score (user, item) pairs — rating-prediction mode. Pairs whose
        user/item index was never seen at fit score NaN (cold start), rather
        than silently clamping to another entity's row. Each pair is the dot
        product of its two rows, gathered in blocks of at most
        ``PAIR_BLOCK_VALUES / I`` pairs so that memory stays bounded."""
        dev = resolve_device(self.get("device"))
        aff, sim = self._placed(dev)
        users = np.asarray(df[self.get("user_col")], np.int64)
        items = np.asarray(df[self.get("item_col")], np.int64)
        known = (
            (users >= 0) & (users < aff.shape[0]) & (items >= 0) & (items < sim.shape[0])
        )
        u_safe = torch.as_tensor(np.where(known, users, 0), device=dev)
        i_safe = torch.as_tensor(np.where(known, items, 0), device=dev)
        block = max(1, PAIR_BLOCK_VALUES // max(sim.shape[0], 1))
        parts = [
            (aff[u_safe[lo:lo + block]] * sim[:, i_safe[lo:lo + block]].T).sum(dim=1)
            for lo in range(0, len(users), block)
        ]
        pair_scores = (
            torch.cat(parts).cpu().numpy().astype(np.float64) if parts
            else np.zeros(0, np.float64)
        )
        pair_scores[~known] = np.nan
        return df.with_column(self.get("prediction_col"), pair_scores)

    def recommend_for_all_users(self, k: int) -> DataFrame:
        dev = resolve_device(self.get("device"))
        aff, sim = self._placed(dev)
        seen = torch.as_tensor(np.asarray(self.get_or_fail("seen_items")) != 0, device=dev)
        if self.get("allow_seen_items"):
            seen = torch.zeros_like(seen)
        k = min(k, sim.shape[0])
        sc, ix = score_topk(aff, sim, seen, k)
        sc, ix = sc.cpu().numpy(), ix.cpu().numpy()
        recs = np.empty(len(sc), dtype=object)
        ratings = np.empty(len(sc), dtype=object)
        for u in range(len(sc)):
            keep = np.isfinite(sc[u])
            recs[u] = ix[u][keep].tolist()
            ratings[u] = sc[u][keep].astype(np.float64).tolist()
        return DataFrame.from_dict(
            {
                self.get("user_col"): np.arange(len(sc), dtype=np.int64),
                "recommendations": recs,
                "ratings": ratings,
            }
        )
