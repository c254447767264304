"""Contextual bandit learning with action-dependent features.

The PyTorch port of ``mmlspark_tpu.vw.contextual_bandit``. Rebuilds
``VowpalWabbitContextualBandit`` (vw/VowpalWabbitContextualBandit.scala)
and ``ContextualBanditMetrics`` (IPS/SNIPS).

Row layout: a shared-context sparse column plus a column whose cells are
*lists* of sparse rows (one per action — the ADF ``ExampleStack``
analogue), the 1-based chosen action, its logged probability, and the
observed cost. Training is IPS-weighted cost regression on the chosen
action's (shared + action) features — ``--cb_type ips`` semantics — run
through the same device SGD kernels as the supervised learners, on the
stage's ``device`` (the card by default).
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice
from mmlspark_tpu_torch.core.params import ComplexParam, HasFeaturesCol, HasPredictionCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.vw.estimators import _PlacedWeights
from mmlspark_tpu_torch.vw.featurizer import HasNumBits
from mmlspark_tpu_torch.vw.learner import LOSS_SQUARED, predict_margin, train_sparse_sgd
from mmlspark_tpu_torch.vw.sparse import NUM_BITS_META, concat_sparse, pad_sparse_batch


class VowpalWabbitContextualBandit(
    Estimator, HasFeaturesCol, HasNumBits, HasDevice
):
    shared_col = Param("shared-context sparse column", default="shared", type_=str)
    features_col = Param(
        "column of per-action sparse feature lists", default="features", type_=str
    )
    chosen_action_col = Param("1-based chosen action", default="chosen_action", type_=str)
    probability_col = Param("logged action probability", default="probability", type_=str)
    label_col = Param("observed cost of the chosen action", default="label", type_=str)
    num_passes = Param("passes over the data", default=1, type_=int)
    learning_rate = Param("initial learning rate", default=0.5, type_=float)
    l2 = Param("L2 regularization", default=0.0, type_=float)
    batch_size = Param("device minibatch size", default=64, type_=int)
    max_importance_weight = Param(
        "clip 1/p IPS weights at this value", default=100.0, type_=float
    )

    def fit(self, df: DataFrame) -> "VowpalWabbitContextualBanditModel":
        shared_c = self.get("shared_col")
        act_c = self.get("features_col")
        has_shared = shared_c in df.columns
        num_bits = (
            df.column_metadata(act_c).get(NUM_BITS_META)
            or (df.column_metadata(shared_c).get(NUM_BITS_META) if has_shared else None)
            or self.get("num_bits")
        )
        chosen = df[self.get("chosen_action_col")].astype(np.int64)
        prob = df[self.get("probability_col")].astype(np.float32)
        cost = df[self.get("label_col")].astype(np.float32)
        actions = df[act_c]
        shared = df[shared_c] if has_shared else None
        rows = []
        for r in range(len(chosen)):
            a = int(chosen[r]) - 1  # VW chosen actions are 1-based
            acts = actions[r]
            if not 0 <= a < len(acts):
                raise ValueError(f"row {r}: chosen action {a + 1} out of range")
            parts = [acts[a]] if shared is None else [shared[r], acts[a]]
            rows.append(concat_sparse(parts))
        idx, val = pad_sparse_batch(rows)
        wt = np.minimum(1.0 / np.maximum(prob, 1e-6), self.get("max_importance_weight"))
        w = train_sparse_sgd(
            idx,
            val,
            cost,
            wt.astype(np.float32),
            int(num_bits),
            loss=LOSS_SQUARED,
            num_passes=self.get("num_passes"),
            batch=self.get("batch_size"),
            lr=self.get("learning_rate"),
            l2=self.get("l2"),
            device=self.get("device"),
        )
        m = VowpalWabbitContextualBanditModel(
            shared_col=shared_c if has_shared else "",
            features_col=act_c,
            device=self.get("device"),
        )
        m.set(weights=w, num_bits=int(num_bits))
        return m


class VowpalWabbitContextualBanditModel(Model, HasFeaturesCol, HasPredictionCol,
                                        _PlacedWeights):
    """Scores every action; prediction = argmin predicted cost (1-based)."""

    shared_col = Param("shared-context sparse column (empty = none)", default="", type_=str)
    features_col = Param("column of per-action sparse lists", default="features", type_=str)
    scores_col = Param("output per-action predicted-cost column", default="scores", type_=str)
    num_bits = Param("hashed space width", default=18, type_=int)
    weights = ComplexParam("(2^num_bits,) learned weights")

    def transform(self, df: DataFrame) -> DataFrame:
        dev, w = self._device_weights()
        shared_c = self.get("shared_col")
        act_c = self.get("features_col")

        def fn(p: dict) -> dict:
            actions = p[act_c]
            shared = p[shared_c] if shared_c else None
            n = len(actions)
            # flatten (row, action) pairs into one padded batch -> one kernel call
            flat: list = []
            counts = np.zeros(n, np.int64)
            for r in range(n):
                for a in actions[r]:
                    parts = [a] if shared is None else [shared[r], a]
                    flat.append(concat_sparse(parts))
                counts[r] = len(actions[r])
            scores_out = np.empty(n, dtype=object)
            pred = np.zeros(n, np.float64)
            if flat:
                idx, val = pad_sparse_batch(flat)
                margins = predict_margin(idx, val, w, device=dev)
                # flat is row-major: one linear split regroups per row
                for r, s in enumerate(np.split(margins, np.cumsum(counts)[:-1])):
                    scores_out[r] = s.astype(np.float64)
                    pred[r] = float(np.argmin(s)) + 1 if len(s) else 0.0
            q = dict(p)
            q[self.get("scores_col")] = scores_out
            q[self.get("prediction_col")] = pred
            return q

        return df.map_partitions(fn, parallel=False)


class ContextualBanditMetrics:
    """Offline policy-value estimators (IPS / SNIPS) — the
    ``ContextualBanditMetrics`` analogue. Accumulate logged (probability,
    cost) with the target policy's probability of the logged action."""

    def __init__(self) -> None:
        self.total_weighted_cost = 0.0
        self.total_weight = 0.0
        self.n = 0

    def add(self, target_prob: float, logged_prob: float, cost: float) -> None:
        w = float(target_prob) / max(float(logged_prob), 1e-9)
        self.total_weighted_cost += w * float(cost)
        self.total_weight += w
        self.n += 1

    def get_ips_estimate(self) -> float:
        return self.total_weighted_cost / max(self.n, 1)

    def get_snips_estimate(self) -> float:
        if self.total_weight == 0:
            return 0.0
        return self.total_weighted_cost / self.total_weight
