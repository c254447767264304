"""Booster: the model container, and scoring on the device.

The port of ``mmlspark_tpu.models.gbdt.booster``:

- ``to_model_string`` / ``from_model_string`` — the JAX package's JSON
  format (``mmlspark_tpu_gbdt_v1``, categorical splits as ``cat_splits``),
  byte for byte, so a model string written by either package loads in the
  other; ``from_model_string`` also reads LightGBM's own text format;
- ``to_lightgbm_string`` / ``from_lightgbm_string`` — LightGBM's text
  format (``lgbm_format``);
- ``merge`` — continued training (the other booster's trees appended);
- ``predict_raw`` / ``predict`` / ``predict_leaf`` — the batched split-log
  replay of every tree at once (``treegrow.predict_leaves``) on the device;
- ``feature_contribs`` — exact TreeSHAP (``treeshap``) or, with
  ``approximate=True``, the Saabas walk; host numpy in f64, as in the JAX
  package; ``feature_importances`` and ``dump_model``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.compiler.kernels import pairwise_sum
from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.models.gbdt import treegrow
from mmlspark_tpu_torch.ops.histogram import NUM_BINS


@dataclass
class Tree:
    leaf: np.ndarray        # (S,) int32 parent leaf per split (-1 inactive)
    feature: np.ndarray     # (S,) int32
    threshold: np.ndarray   # (S,) float64 real-valued, <= goes left
    active: np.ndarray      # (S,) bool
    gain: np.ndarray        # (S,) float32
    values: np.ndarray      # (L,) float32
    counts: np.ndarray      # (L,) int32
    # categorical subset splits: for split k with is_cat[k], category value
    # v (bin v+1) goes LEFT iff catmask[k, v+1]. None = all-numerical tree
    is_cat: Optional[np.ndarray] = None     # (S,) bool
    catmask: Optional[np.ndarray] = None    # (S, NUM_BINS) bool
    # per-split missing-value direction (LightGBM decision_type default-left
    # bit): NaN routes LEFT iff default_left[k]. None = all left
    default_left: Optional[np.ndarray] = None  # (S,) bool

    @property
    def has_categorical(self) -> bool:
        return self.is_cat is not None and bool(np.any(self.is_cat))

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
        if self.has_categorical:
            # only the categorical splits, as lists of their left bins
            out["cat_splits"] = {
                str(k): np.flatnonzero(self.catmask[k]).tolist()
                for k in np.flatnonzero(self.is_cat)
            }
        if self.default_left is not None and not self.default_left.all():
            out["default_right"] = np.flatnonzero(~self.default_left).tolist()
        return out

    @staticmethod
    def from_dict(d: dict) -> "Tree":
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
        is_cat = catmask = None
        if d.get("cat_splits"):
            S = len(d["leaf"])
            is_cat = np.zeros(S, bool)
            catmask = np.zeros((S, NUM_BINS), bool)
            for k, left_bins in d["cat_splits"].items():
                is_cat[int(k)] = True
                catmask[int(k), np.asarray(left_bins, np.int64)] = True
        return Tree(
            leaf=np.asarray(d["leaf"], np.int32),
            feature=np.asarray(d["feature"], np.int32),
            threshold=np.array([dec(t) for t in d["threshold"]], dtype=np.float64),
            active=np.asarray(d["active"], bool),
            gain=np.asarray(d["gain"], np.float32),
            values=np.asarray(d["values"], np.float32),
            counts=np.asarray(d["counts"], np.int32),
            is_cat=is_cat,
            catmask=catmask,
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
        """The JSON model string, or LightGBM's own text format (which
        starts with its ``tree`` section)."""
        if not s.lstrip().startswith("{"):
            return Booster.from_lightgbm_string(s)
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

    def to_lightgbm_string(self) -> str:
        """LightGBM's v3 text model (``saveNativeModel``): loads in
        LightGBM itself and in the JAX package."""
        from mmlspark_tpu_torch.models.gbdt.lgbm_format import to_lightgbm_string

        return to_lightgbm_string(self)

    @staticmethod
    def from_lightgbm_string(s: str) -> "Booster":
        """Parse a LightGBM text model (``loadNativeModelFromString``)."""
        from mmlspark_tpu_torch.models.gbdt.lgbm_format import from_lightgbm_string

        return from_lightgbm_string(s)

    def merge(self, other: "Booster") -> "Booster":
        """Continued training: ``other``'s trees appended to this
        booster's. The baseline, sigmoid and boosting type stay this
        booster's (``other`` was fit on top of its predictions)."""
        if self.num_class != other.num_class:
            raise ValueError(
                f"cannot merge boosters of {self.num_class} and {other.num_class} classes"
            )
        return Booster(
            trees=self.trees + other.trees,
            objective=other.objective,
            num_class=self.num_class,
            num_features=max(self.num_features, other.num_features),
            feature_names=self.feature_names or other.feature_names,
            base_score=self.base_score,
            boosting_type=self.boosting_type,
            sigmoid=self.sigmoid,
            objective_param=(
                self.objective_param if self.objective_param is not None
                else other.objective_param
            ),
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
        leaf, feat, thr, active, values, dleft, is_cat, catmask = self._device_trees(
            len(trees), dev)
        return treegrow.predict_scores(xt, leaf, feat, thr, active, values, dleft,
                                       is_cat, catmask)

    def predict_raw(self, x: Any, num_iteration: Optional[int] = None,
                    device: "str | torch.device | None" = None) -> np.ndarray:
        """(n, d) -> (n,) raw scores (binary/regression) or (n, k)
        multiclass, as numpy f32. Trees replay on ``device`` (``None`` =
        ``"cuda"``; a tensor ``x`` scores on its own device)."""
        n = x.shape[0]
        k = self.num_class
        base = np.asarray(self.base_score, np.float32)
        per_tree = self._per_tree(x, num_iteration, device)
        if per_tree.shape[1] == 0:
            return np.broadcast_to(base, (n,) if k == 1 else (n, k)).astype(np.float32).copy()
        return self.raw_scores(per_tree).cpu().numpy()

    def raw_scores(self, per_tree: torch.Tensor) -> torch.Tensor:
        """(n, T) per-tree outputs -> raw scores on their device, (n,) or
        (n, k): the JAX package's host ``predict_raw`` bit for bit. Each
        class sums its columns ``c::k`` in numpy's pairwise f32 order (one
        add per tree), rf divides the forest by its tree count, then
        ``base_score`` is added, all in f32. The divisor is a device
        tensor: the card divides by a Python scalar as a multiply by its
        reciprocal. Capturable into a CUDA graph once called eagerly on
        the device (the constants are placed then)."""
        k = self.num_class
        T = per_tree.shape[1]
        key = ("consts", str(per_tree.device), T)
        consts = self._stacked.get(key)
        if consts is None:
            dev = per_tree.device
            denom = (torch.tensor(float(T // k), dtype=torch.float32, device=dev)
                     if self.boosting_type == "rf" else None)
            base = torch.from_numpy(np.asarray(self.base_score, np.float32)).to(dev)
            consts = self._stacked[key] = (denom, base)
        denom, base = consts
        sums = [pairwise_sum(per_tree[:, c::k]) for c in range(k)]
        if denom is not None:  # rf averages the forest; boosting sums it
            sums = [s / denom for s in sums]
        raw = sums[0] if k == 1 else torch.stack(sums, 1)
        return raw + base

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
        leaf, feat, thr, active, _, dleft, is_cat, catmask = self._device_trees(
            len(self.trees), xt.device)
        leaves = treegrow.predict_leaves(xt, leaf, feat, thr, active, dleft, is_cat, catmask)
        return leaves.to(torch.int32).cpu().numpy()

    # -- explanations (host, f64) --------------------------------------------

    def feature_contribs(self, x: np.ndarray, approximate: bool = False,
                         num_iteration: Optional[int] = None) -> np.ndarray:
        """Per-feature contributions (n, d+1), the last column the expected
        value: exact TreeSHAP (``treeshap.shap_values``) by default, the
        Saabas walk (each split's change of the subtree expectation
        credited to its feature) with ``approximate=True``. Rows sum to
        the raw score, under rf averaging and the best-iteration prefix
        too. Host numpy in f64, as in the JAX package."""
        x = np.asarray(x)
        n, d = x.shape
        trees = self._trees(num_iteration)
        out = np.zeros((n, d + 1), np.float64)
        out[:, d] += float(np.sum(np.asarray(self.base_score)))
        scale = 1.0
        if self.boosting_type == "rf" and trees:
            scale = 1.0 / (len(trees) // self.num_class)
        if approximate:
            for tree in trees:
                out += scale * _tree_contribs(tree, x)
            return out
        from mmlspark_tpu_torch.models.gbdt.treeshap import shap_values

        for tree in trees:
            out += scale * shap_values(tree, x)
        return out

    def feature_importances(self, importance_type: str = "split") -> np.ndarray:
        """Per feature: its number of splits (``"split"``) or their summed
        gain (``"gain"``), over every tree."""
        imp = np.zeros(max(self.num_features, 1), np.float64)
        for t in self.trees:
            for s in range(len(t.leaf)):
                if t.active[s]:
                    imp[int(t.feature[s])] += (
                        1.0 if importance_type == "split" else float(t.gain[s]))
        return imp

    def dump_model(self) -> dict:
        return json.loads(self.to_model_string())


def _as_device_tensor(x: Any, device: "str | torch.device | None") -> torch.Tensor:
    """Rows to score as an f32 tensor: a tensor stays on its own device,
    anything else goes to ``device`` (``None`` = ``"cuda"``)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(resolve_device(device))


def _stack_trees(trees: list) -> tuple:
    """Pad a tree list to common split/leaf counts for the batched replay:
    (leaf, feature, threshold f32, active, values, default_left or None,
    is_cat or None, catmask (T, S, NUM_BINS) or None)."""
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
    rec_is_cat = rec_catmask = None
    if any(t.has_categorical for t in trees):
        rec_is_cat = np.zeros((T, S), bool)
        rec_catmask = np.zeros((T, S, NUM_BINS), bool)
        for i, t in enumerate(trees):
            if t.is_cat is not None:
                rec_is_cat[i, : len(t.is_cat)] = t.is_cat
                rec_catmask[i, : t.catmask.shape[0]] = t.catmask
    return (rec_leaf, rec_feature, rec_threshold, rec_active, values, rec_default_left,
            rec_is_cat, rec_catmask)


def _tree_contribs(tree: Tree, x: np.ndarray) -> np.ndarray:
    """Saabas contributions of one tree by split replay: at every split a
    row passes, the change of the expected value of its node (the
    count-weighted mean of the final leaves below it) goes to the split's
    feature."""
    n, d = x.shape
    S = len(tree.leaf)
    counts = tree.counts.astype(np.float64)
    values = tree.values.astype(np.float64)
    # exp_steps[k][l]: the expected value at leaf id l just before split k,
    # built backwards by folding each split's right child into its parent
    ws, cs = values * counts, counts.copy()
    exp_steps = np.zeros((S + 1, len(values)), np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        exp_steps[S] = np.where(cs > 0, ws / cs, 0.0)
    for k in range(S - 1, -1, -1):
        if tree.active[k]:
            parent = int(tree.leaf[k])
            ws[parent] += ws[k + 1]
            cs[parent] += cs[k + 1]
        with np.errstate(invalid="ignore", divide="ignore"):
            exp_steps[k] = np.where(cs > 0, ws / cs, 0.0)

    row_leaf = np.zeros(n, np.int64)
    out = np.zeros((n, d + 1), np.float64)
    out[:, d] = exp_steps[0][0]
    for k in range(S):
        if not tree.active[k]:
            continue
        parent = int(tree.leaf[k])
        f = int(tree.feature[k])
        in_leaf = row_leaf == parent
        vals = x[:, f]
        if tree.is_cat is not None and tree.is_cat[k]:
            vbin = treegrow.category_bin_slot(vals, tree.catmask.shape[1])
            goes_right = in_leaf & ~tree.catmask[k][vbin]
        else:
            nan_right = not (tree.default_left is None or bool(tree.default_left[k]))
            goes_right = in_leaf & np.where(np.isnan(vals), nan_right, vals > tree.threshold[k])
        stays_left = in_leaf & ~goes_right
        before = exp_steps[k][parent]
        out[goes_right, f] += exp_steps[k + 1][k + 1] - before
        out[stays_left, f] += exp_steps[k + 1][parent] - before
        row_leaf[goes_right] = k + 1
    return out
