"""Booster: the model container, and scoring on the device.

The port of ``mmlspark_tpu.models.gbdt.booster``:

- ``to_model_string`` / ``from_model_string`` — the JAX package's JSON
  format (``mmlspark_tpu_gbdt_v1``), byte for byte, so a model string
  written by either package loads in the other;
- ``predict_raw`` / ``predict`` / ``predict_leaf`` — the batched split-log
  replay of every tree at once (``treegrow.predict_leaves``) on the device.

Not ported yet (ROADMAP.md, Queue A item 3): LightGBM's own text format,
categorical splits, SHAP contributions and ``merge`` (continued training).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.models.gbdt import treegrow


@dataclass
class Tree:
    leaf: np.ndarray        # (S,) int32 parent leaf per split (-1 inactive)
    feature: np.ndarray     # (S,) int32
    threshold: np.ndarray   # (S,) float64 real-valued, <= goes left
    active: np.ndarray      # (S,) bool
    gain: np.ndarray        # (S,) float32
    values: np.ndarray      # (L,) float32
    counts: np.ndarray      # (L,) int32
    # per-split missing-value direction (LightGBM decision_type default-left
    # bit): NaN routes LEFT iff default_left[k]. None = all left
    default_left: Optional[np.ndarray] = None  # (S,) bool

    def to_dict(self) -> dict:
        # non-finite thresholds are meaningful (+inf: inactive/"all left",
        # -inf: split on the missing bin) — keep their signs through JSON
        def enc(t: float):
            if np.isfinite(t):
                return float(t)
            return "inf" if t > 0 else "-inf"

        out = {
            "leaf": self.leaf.tolist(),
            "feature": self.feature.tolist(),
            "threshold": [enc(t) for t in self.threshold],
            "active": self.active.astype(int).tolist(),
            "gain": np.asarray(self.gain, dtype=np.float64).tolist(),
            "values": np.asarray(self.values, dtype=np.float64).tolist(),
            "counts": self.counts.tolist(),
        }
        if self.default_left is not None and not self.default_left.all():
            out["default_right"] = np.flatnonzero(~self.default_left).tolist()
        return out

    @staticmethod
    def from_dict(d: dict) -> "Tree":
        if d.get("cat_splits"):
            raise NotImplementedError(
                "categorical splits are not ported to mmlspark_tpu_torch yet "
                "(ROADMAP.md Queue A item 3: categorical splits)"
            )

        def dec(t) -> float:
            if t is None or t == "inf":
                return np.inf
            if t == "-inf":
                return -np.inf
            return float(t)

        default_left = None
        if d.get("default_right"):
            default_left = np.ones(len(d["leaf"]), bool)
            default_left[np.asarray(d["default_right"], np.int64)] = False
        return Tree(
            leaf=np.asarray(d["leaf"], np.int32),
            feature=np.asarray(d["feature"], np.int32),
            threshold=np.array([dec(t) for t in d["threshold"]], dtype=np.float64),
            active=np.asarray(d["active"], bool),
            gain=np.asarray(d["gain"], np.float32),
            values=np.asarray(d["values"], np.float32),
            counts=np.asarray(d["counts"], np.int32),
            default_left=default_left,
        )


@dataclass
class Booster:
    trees: list = field(default_factory=list)  # flat; class of tree t = t % num_class
    objective: str = "binary"
    num_class: int = 1
    num_features: int = 0
    best_iteration: int = -1
    feature_names: Optional[list] = None
    # boost_from_average baseline added to every raw score: float, or a
    # per-class list for multiclass
    base_score: Any = 0.0
    # gbdt|goss|dart|rf — rf predictions AVERAGE trees instead of summing
    boosting_type: str = "gbdt"
    # binary sigmoid slope: p = sigmoid(sigmoid * score)
    sigmoid: float = 1.0
    objective_param: Optional[float] = None
    # per-round validation metric of the fit that made this booster, by
    # metric name (not part of the model string)
    evals: dict = field(default_factory=dict, init=False, repr=False, compare=False)
    # device-resident stacked trees, per (device, tree count)
    _stacked: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    # -- serialization ------------------------------------------------------

    def to_model_string(self) -> str:
        return json.dumps(
            {
                "format": "mmlspark_tpu_gbdt_v1",
                "objective": self.objective,
                "num_class": self.num_class,
                "num_features": self.num_features,
                "best_iteration": self.best_iteration,
                "feature_names": self.feature_names,
                "base_score": (
                    self.base_score.tolist()
                    if isinstance(self.base_score, np.ndarray)
                    else self.base_score
                ),
                "boosting_type": self.boosting_type,
                "sigmoid": self.sigmoid,
                "objective_param": self.objective_param,
                "trees": [t.to_dict() for t in self.trees],
            }
        )

    @staticmethod
    def from_model_string(s: str) -> "Booster":
        if not s.lstrip().startswith("{"):
            raise NotImplementedError(
                "LightGBM's text model format is not ported to "
                "mmlspark_tpu_torch yet (ROADMAP.md Queue A item 3: LightGBM "
                "text format); pass a JSON model string"
            )
        d = json.loads(s)
        return Booster(
            trees=[Tree.from_dict(t) for t in d["trees"]],
            objective=d["objective"],
            num_class=d["num_class"],
            num_features=d["num_features"],
            best_iteration=d.get("best_iteration", -1),
            feature_names=d.get("feature_names"),
            base_score=d.get("base_score", 0.0),
            boosting_type=d.get("boosting_type", "gbdt"),
            sigmoid=d.get("sigmoid", 1.0),
            objective_param=d.get("objective_param"),
        )

    # -- device scoring ------------------------------------------------------

    def _trees(self, num_iteration: Optional[int]) -> list:
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        return self.trees[: num_iteration * self.num_class] if num_iteration else self.trees

    def _device_trees(self, n_trees: int, dev: torch.device) -> tuple:
        key = (str(dev), n_trees)
        hit = self._stacked.get(key)
        if hit is None:
            hit = tuple(
                None if a is None else torch.from_numpy(a).to(dev)
                for a in _stack_trees(self.trees[:n_trees])
            )
            self._stacked[key] = hit
        return hit

    def _per_tree(self, x: Any, num_iteration: Optional[int],
                  device: "str | torch.device | None") -> torch.Tensor:
        """(n, d) -> (n, T) f32 device tensor: each tree's output per row."""
        trees = self._trees(num_iteration)
        xt = _as_device_tensor(x, device)
        dev = xt.device
        if not trees:
            return torch.zeros((xt.shape[0], 0), dtype=torch.float32, device=dev)
        leaf, feat, thr, active, values, dleft = self._device_trees(len(trees), dev)
        return treegrow.predict_scores(xt, leaf, feat, thr, active, values, dleft)

    def predict_raw(self, x: Any, num_iteration: Optional[int] = None,
                    device: "str | torch.device | None" = None) -> np.ndarray:
        """(n, d) -> (n,) raw scores (binary/regression) or (n, k)
        multiclass, as numpy f32. Trees replay on ``device`` (``None`` =
        ``"cuda"``; a tensor ``x`` scores on its own device)."""
        n = x.shape[0]
        k = self.num_class
        base = np.asarray(self.base_score, np.float32)
        per_tree = self._per_tree(x, num_iteration, device)
        T = per_tree.shape[1]
        if T == 0:
            return np.broadcast_to(base, (n,) if k == 1 else (n, k)).astype(np.float32).copy()
        # rf averages the forest; boosting sums it. The tree sum is taken in
        # f64 and rounded once.
        denom = (T // k) if self.boosting_type == "rf" else 1
        per = per_tree.double().view(n, T // k, k).sum(1) / denom
        raw = per.float().cpu().numpy()
        return (raw[:, 0] if k == 1 else raw) + base

    def predict(self, x: Any, num_iteration: Optional[int] = None,
                device: "str | torch.device | None" = None) -> np.ndarray:
        """Raw scores through the objective's output transform (exp for the
        log-link objectives, raw otherwise)."""
        from mmlspark_tpu_torch.models.gbdt.objectives import LOG_LINK_KINDS

        raw = self.predict_raw(x, num_iteration=num_iteration, device=device)
        if self.objective in LOG_LINK_KINDS:
            return np.exp(raw)
        return raw

    def predict_leaf(self, x: Any, device: "str | torch.device | None" = None) -> np.ndarray:
        """(n, d) -> (n, T) int32 leaf index per tree."""
        if not self.trees:
            return np.zeros((x.shape[0], 0), np.int32)
        xt = _as_device_tensor(x, device)
        leaf, feat, thr, active, _, dleft = self._device_trees(len(self.trees), xt.device)
        leaves = treegrow.predict_leaves(xt, leaf, feat, thr, active, dleft)
        return leaves.to(torch.int32).cpu().numpy()


def _as_device_tensor(x: Any, device: "str | torch.device | None") -> torch.Tensor:
    """Rows to score as an f32 tensor: a tensor stays on its own device,
    anything else goes to ``device`` (``None`` = ``"cuda"``)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(resolve_device(device))


def _stack_trees(trees: list) -> tuple:
    """Pad a tree list to common split/leaf counts for the batched replay:
    (leaf, feature, threshold f32, active, values, default_left or None)."""
    S = max(len(t.leaf) for t in trees)
    L = max(len(t.values) for t in trees)
    T = len(trees)

    def pad(a: np.ndarray, n: int, fill: Any) -> np.ndarray:
        out = np.full((n,), fill, dtype=a.dtype)
        out[: len(a)] = a
        return out

    rec_leaf = np.stack([pad(t.leaf.astype(np.int64), S, -1) for t in trees])
    rec_feature = np.stack(
        [pad(np.clip(t.feature, 0, None).astype(np.int64), S, 0) for t in trees]
    )
    rec_threshold = np.stack(
        [pad(t.threshold.astype(np.float32), S, np.float32(np.inf)) for t in trees]
    )
    rec_active = np.stack([pad(t.active, S, False) for t in trees])
    values = np.stack([pad(t.values, L, np.float32(0)) for t in trees])
    rec_default_left = None
    if any(t.default_left is not None and not t.default_left.all() for t in trees):
        rec_default_left = np.ones((T, S), bool)
        for i, t in enumerate(trees):
            if t.default_left is not None:
                rec_default_left[i, : len(t.default_left)] = t.default_left
    return rec_leaf, rec_feature, rec_threshold, rec_active, values, rec_default_left
