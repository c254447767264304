"""Native LightGBM text-model interop.

The port's copy of ``mmlspark_tpu.models.gbdt.lgbm_format`` (numpy, host
side; the text it writes is byte-equal to the JAX package's for the same
booster). LightGBM persists boosters in its own text format, and
``saveNativeModel`` / ``loadNativeModelFromFile`` move models between
Spark, Python lightgbm and the CLI:

- :func:`to_lightgbm_string` — serialize a :class:`Booster` as a LightGBM
  v3 text model (explicit left/right-child arrays, ``<= threshold`` goes
  left, categorical splits as cat_threshold bitsets).
- :func:`from_lightgbm_string` — parse a LightGBM text model (e.g. written
  by LightGBM's Spark package or by python ``lightgbm``) into a :class:`Booster`,
  rebuilding each explicit tree as our sequential split log (split ``k``
  turns slot ``l`` into an internal node; the right child becomes slot
  ``k + 1`` — any parent-before-child emission order is valid).

Semantics notes:
- Missing values: the replay honors each split's ``decision_type``
  default-left bit (NaN routes by the recorded direction; trained trees
  are all default-left). What it cannot reproduce is missing_type None
  (real LightGBM compares NaN as 0.0) and Zero (zero-as-missing); those
  imports warn once per model.
- Categorical values are capped at NUM_BINS - 2 (the identity-binning
  range); imported bitsets beyond that raise.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch.ops.histogram import NUM_BINS

log = logging.getLogger("mmlspark_tpu_torch.gbdt")

_CAT_BIT = 1       # decision_type bit 0: categorical split
_DEFAULT_LEFT = 2  # decision_type bit 1: missing goes left
_MISSING_NAN = 2 << 2  # bits 2-3: missing_type (0=None, 1=Zero, 2=NaN)


def _objective_string(booster: Any) -> str:
    """LightGBM's objective header line, with the objective's knobs in
    LightGBM's own key:value token format."""
    objective, num_class = booster.objective, booster.num_class
    p = booster.objective_param
    if objective == "binary":
        return f"binary sigmoid:{booster.sigmoid:g}"
    if objective == "multiclass":
        return f"multiclass num_class:{num_class}"
    if objective == "quantile":
        return f"quantile alpha:{0.9 if p is None else p:g}"
    if objective == "huber":
        return f"huber alpha:{0.9 if p is None else p:g}"
    if objective == "fair":
        return f"fair fair_c:{1.0 if p is None else p:g}"
    if objective == "tweedie":
        return (
            f"tweedie tweedie_variance_power:{1.5 if p is None else p:g}"
        )
    return objective


def _parse_objective(s: str) -> tuple:
    """objective= header -> (canonical name, num_class, param, sigmoid).

    ``param`` is the regression knob (alpha / tweedie_variance_power /
    fair_c) when present; ``sigmoid`` is the binary slope (default 1.0 —
    models trained with a non-default slope must predict through it or
    probabilities silently differ from real LightGBM)."""
    from mmlspark_tpu_torch.models.gbdt.objectives import (
        REGRESSION_KINDS,
        canonical_objective,
    )

    parts = s.split()
    name = parts[0]
    num_class = 1
    param = None
    sigmoid = 1.0
    for p in parts[1:]:
        if p.startswith("num_class:"):
            num_class = int(p.split(":", 1)[1])
        elif p.startswith("sigmoid:"):
            sigmoid = float(p.split(":", 1)[1])
        elif p.startswith(("alpha:", "tweedie_variance_power:", "fair_c:")):
            param = float(p.split(":", 1)[1])
    if name.startswith("binary"):
        return "binary", 1, None, sigmoid
    if name.startswith("multiclass") or name.startswith("softmax"):
        return "multiclass", num_class, None, 1.0
    if name.startswith("lambdarank") or name.startswith("rank"):
        return "lambdarank", 1, None, 1.0
    canon = canonical_objective(name)
    if canon in REGRESSION_KINDS:
        return canon, 1, param, 1.0
    return "regression", 1, None, 1.0


# ---------------------------------------------------------------------------
# export: split log -> explicit tree -> LightGBM text
# ---------------------------------------------------------------------------


def _tree_to_explicit(tree: Any) -> dict:
    """Split-log -> LightGBM-style arrays (children as node ids, leaves as
    ``~leaf_idx``)."""
    order = [k for k in range(len(tree.leaf)) if tree.active[k]]
    n_int = len(order)
    if n_int == 0:
        # single-leaf tree: LightGBM writes num_leaves=1 with just the value
        return {
            "num_leaves": 1,
            "leaf_value": [float(tree.values[0])],
            "leaf_count": [int(tree.counts[0])],
            "internal": 0,
        }
    split_feature, threshold, gain, decision_type = [], [], [], []
    left_child, right_child = [], []
    cat_sets: list = []
    # slot -> ("root", None) | (parent_internal, side)
    slot_parent: dict = {int(tree.leaf[order[0]]): ("root", None)}
    leaf_ids: dict = {}  # slot -> final leaf index (assigned on close)

    def set_child(parent: int, side: int, value: int) -> None:
        (left_child if side == 0 else right_child)[parent] = value

    for i, k in enumerate(order):
        slot = int(tree.leaf[k])
        parent = slot_parent.pop(slot)
        split_feature.append(int(tree.feature[k]))
        gain.append(float(tree.gain[k]))
        left_child.append(None)
        right_child.append(None)
        is_cat = tree.is_cat is not None and bool(tree.is_cat[k])
        if is_cat:
            # catmask slot v+1 = category value v goes left; slot 0 is the
            # missing (NaN) bin — LightGBM's bitset cannot carry it, so
            # NaN-goes-left rides the default_left bit (our importer
            # restores it; real LightGBM routes categorical NaN right and
            # ignores the bit — a documented semantic edge)
            dt = _CAT_BIT | (_DEFAULT_LEFT if tree.catmask[k][0] else 0)
            decision_type.append(dt)
            vals = np.flatnonzero(tree.catmask[k][1:]).tolist()
            cat_sets.append(vals)
            threshold.append(len(cat_sets) - 1)  # index into cat bitsets
        else:
            # missing_type NaN + the split's default direction (trained
            # trees are all default-left; imported default-right splits
            # round-trip their bit)
            dl = tree.default_left is None or bool(tree.default_left[k])
            decision_type.append((_DEFAULT_LEFT if dl else 0) | _MISSING_NAN)
            threshold.append(float(tree.threshold[k]))
        if parent[0] != "root":
            set_child(parent[0], parent[1], i)
        slot_parent[slot] = (i, 0)       # left child keeps the slot
        slot_parent[k + 1] = (i, 1)      # right child is the new slot

    # remaining open slots are final leaves
    for slot, (parent, side) in slot_parent.items():
        leaf_idx = len(leaf_ids)
        leaf_ids[slot] = leaf_idx
        set_child(parent, side, ~leaf_idx)
    leaf_value = [0.0] * len(leaf_ids)
    leaf_count = [0] * len(leaf_ids)
    for slot, idx in leaf_ids.items():
        leaf_value[idx] = float(tree.values[slot])
        leaf_count[idx] = int(tree.counts[slot])

    # internal aggregates (bottom-up): value = count-weighted mean of
    # leaves. Iterative post-order — a chain-shaped leaf-wise tree can be
    # thousands of levels deep, past Python's recursion limit
    int_count = [0] * n_int
    int_value = [0.0] * n_int
    stack = [(0, False)]
    while stack:
        node, expanded = stack.pop()
        if not expanded:
            stack.append((node, True))
            for child in (left_child[node], right_child[node]):
                if child >= 0:
                    stack.append((child, False))
            continue
        c_tot, v_tot = 0.0, 0.0
        for child in (left_child[node], right_child[node]):
            if child < 0:
                c, v = leaf_count[~child], leaf_value[~child]
            else:  # post-order: children already aggregated
                c, v = int_count[child], int_value[child]
            c_tot += c
            v_tot += v * c
        int_count[node] = int(c_tot)
        int_value[node] = v_tot / c_tot if c_tot else 0.0
    out = {
        "num_leaves": len(leaf_ids),
        "split_feature": split_feature,
        "split_gain": gain,
        "threshold": threshold,
        "decision_type": decision_type,
        "left_child": left_child,
        "right_child": right_child,
        "leaf_value": leaf_value,
        "leaf_count": leaf_count,
        "internal_value": int_value,
        "internal_count": int_count,
        "internal": n_int,
    }
    if cat_sets:
        boundaries = [0]
        bits: list = []
        for vals in cat_sets:
            # 32-bit word bitset, little-endian words (LightGBM layout)
            n_words = max(v // 32 for v in vals) + 1 if vals else 1
            words = [0] * n_words
            for v in vals:
                words[v // 32] |= 1 << (v % 32)
            bits.extend(words)
            boundaries.append(len(bits))
        out["num_cat"] = len(cat_sets)
        out["cat_boundaries"] = boundaries
        out["cat_threshold"] = bits
    else:
        out["num_cat"] = 0
    return out


def _fmt(xs: list) -> str:
    out = []
    for x in xs:
        if isinstance(x, float):
            out.append(repr(x) if np.isfinite(x) else ("inf" if x > 0 else "-inf"))
        else:
            out.append(str(x))
    return " ".join(out)


def to_lightgbm_string(booster: Any) -> str:
    """Serialize a Booster in LightGBM v3 text-model format."""
    lines = [
        "tree",
        "version=v3",
        f"num_class={booster.num_class}",
        f"num_tree_per_iteration={booster.num_class}",
        "label_index=0",
        f"max_feature_idx={booster.num_features - 1}",
        f"objective={_objective_string(booster)}",
    ]
    if booster.boosting_type == "rf":
        lines.append("average_output")
    names = booster.feature_names or [
        f"Column_{i}" for i in range(booster.num_features)
    ]
    lines.append("feature_names=" + " ".join(names))
    lines.append(
        "feature_infos=" + " ".join(["[-1e308:1e308]"] * booster.num_features)
    )
    # base_score is folded into leaf values on export (LightGBM's
    # boost_from_average bakes the average into the first trees the same way)
    base = np.broadcast_to(
        np.asarray(booster.base_score, np.float64).ravel(), (booster.num_class,)
    )
    # the text format carries no best_iteration: export the early-stopped
    # prefix (what predict_raw scores), like LightGBM's own save_model
    trees = booster.trees
    if booster.best_iteration > 0:
        trees = trees[: booster.best_iteration * booster.num_class]
    lines.append("")
    for t, tree in enumerate(trees):
        ex = _tree_to_explicit(tree)
        if booster.boosting_type == "rf":
            # rf predictions AVERAGE trees: base must ride every tree so
            # mean(v_t + base) == mean(v_t) + base
            fold = float(base[t % booster.num_class])
        else:
            fold = float(base[t % booster.num_class]) if t < booster.num_class else 0.0
        if fold:
            ex["leaf_value"] = [v + fold for v in ex["leaf_value"]]
            if ex["internal"]:
                ex["internal_value"] = [v + fold for v in ex["internal_value"]]
        lines.append(f"Tree={t}")
        lines.append(f"num_leaves={ex['num_leaves']}")
        lines.append(f"num_cat={ex.get('num_cat', 0)}")
        if ex["internal"]:
            lines.append("split_feature=" + _fmt(ex["split_feature"]))
            lines.append("split_gain=" + _fmt(ex["split_gain"]))
            lines.append("threshold=" + _fmt(ex["threshold"]))
            lines.append("decision_type=" + _fmt(ex["decision_type"]))
            lines.append("left_child=" + _fmt(ex["left_child"]))
            lines.append("right_child=" + _fmt(ex["right_child"]))
        lines.append("leaf_value=" + _fmt(ex["leaf_value"]))
        lines.append("leaf_count=" + _fmt(ex["leaf_count"]))
        if ex["internal"]:
            lines.append("internal_value=" + _fmt(ex["internal_value"]))
            lines.append("internal_count=" + _fmt(ex["internal_count"]))
        if ex.get("num_cat", 0):
            lines.append("cat_boundaries=" + _fmt(ex["cat_boundaries"]))
            lines.append("cat_threshold=" + _fmt(ex["cat_threshold"]))
        lines.append("shrinkage=1")
        lines.append("")
    lines.append("end of trees")
    lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# import: LightGBM text -> explicit tree -> split log
# ---------------------------------------------------------------------------


def _explicit_to_tree(fields: dict, notes: Optional[set] = None) -> Any:
    from mmlspark_tpu_torch.models.gbdt.booster import Tree

    num_leaves = int(fields["num_leaves"][0])
    if num_leaves <= 1:
        v = float(fields["leaf_value"][0])
        cnt = int(fields.get("leaf_count", [0])[0])
        return Tree(
            leaf=np.full(0, -1, np.int32), feature=np.zeros(0, np.int32),
            threshold=np.zeros(0, np.float64), active=np.zeros(0, bool),
            gain=np.zeros(0, np.float32), values=np.array([v], np.float32),
            counts=np.array([cnt], np.int32),
        )
    n_int = num_leaves - 1
    split_feature = np.asarray(fields["split_feature"], np.int64)
    raw_threshold = np.asarray(fields["threshold"], np.float64)
    decision_type = np.asarray(
        fields.get("decision_type", [_DEFAULT_LEFT] * n_int), np.int64
    )
    left = np.asarray(fields["left_child"], np.int64)
    right = np.asarray(fields["right_child"], np.int64)
    leaf_value = np.asarray(fields["leaf_value"], np.float64)
    leaf_count = np.asarray(
        fields.get("leaf_count", np.zeros(num_leaves)), np.float64
    )
    gain = np.asarray(fields.get("split_gain", np.zeros(n_int)), np.float64)
    cat_boundaries = [int(v) for v in fields.get("cat_boundaries", [])]
    cat_threshold = [int(v) for v in fields.get("cat_threshold", [])]
    has_cat = bool((decision_type & _CAT_BIT).any())
    numerical = (decision_type & _CAT_BIT) == 0
    missing_type = (decision_type >> 2) & 3
    # the replay honors each split's default-left bit (NaN direction); what
    # it cannot reproduce is missing_type None (LightGBM compares NaN as
    # 0.0) and Zero (zeros routed as missing) — collect the note, the
    # caller warns ONCE per model, not once per tree
    if notes is not None and (numerical & (missing_type != 2)).any():
        notes.add(
            "imported LightGBM tree has numerical splits with missing_type "
            "None or Zero (NaN-as-0.0 / zero-as-missing); this replay "
            "compares NaN by the default-left bit and zeros numerically — "
            "rows with missing values may route differently"
        )
    has_dright = bool(
        (numerical & ((decision_type & _DEFAULT_LEFT) == 0)).any()
    )

    S = n_int
    rec_leaf = np.full(S, -1, np.int32)
    rec_feature = np.zeros(S, np.int32)
    rec_threshold = np.full(S, np.inf, np.float64)
    rec_active = np.zeros(S, bool)
    rec_gain = np.zeros(S, np.float32)
    values = np.zeros(S + 1, np.float32)
    counts = np.zeros(S + 1, np.int32)
    is_cat = np.zeros(S, bool) if has_cat else None
    catmask = np.zeros((S, NUM_BINS), bool) if has_cat else None
    default_left = np.ones(S, bool) if has_dright else None

    queue = [(0, 0)]  # (internal node id, slot)
    k = 0
    while queue:
        node, slot = queue.pop(0)
        rec_leaf[k] = slot
        rec_feature[k] = split_feature[node]
        rec_active[k] = True
        rec_gain[k] = gain[node]
        if default_left is not None and not (decision_type[node] & _CAT_BIT):
            default_left[k] = bool(decision_type[node] & _DEFAULT_LEFT)
        if decision_type[node] & _CAT_BIT:
            ti = int(raw_threshold[node])
            words = cat_threshold[cat_boundaries[ti]: cat_boundaries[ti + 1]]
            vals = [
                w * 32 + b
                for w, word in enumerate(words)
                for b in range(32)
                if word >> b & 1
            ]
            if vals and max(vals) > NUM_BINS - 2:
                raise ValueError(
                    f"categorical value {max(vals)} exceeds the supported "
                    f"range [0, {NUM_BINS - 2}]"
                )
            is_cat[k] = True
            catmask[k, np.asarray(vals, np.int64) + 1] = True
            # default_left on a categorical split is our NaN-bin-left marker
            # (see export); real LightGBM never sets it on cat splits
            if decision_type[node] & _DEFAULT_LEFT:
                catmask[k, 0] = True
        else:
            rec_threshold[k] = raw_threshold[node]
        for side, child in ((0, left[node]), (1, right[node])):
            child_slot = slot if side == 0 else k + 1
            if child < 0:
                values[child_slot] = leaf_value[~child]
                counts[child_slot] = leaf_count[~child]
            else:
                queue.append((int(child), child_slot))
        k += 1
    return Tree(
        leaf=rec_leaf, feature=rec_feature, threshold=rec_threshold,
        active=rec_active, gain=rec_gain.astype(np.float32),
        values=values, counts=counts, is_cat=is_cat, catmask=catmask,
        default_left=default_left,
    )


def from_lightgbm_string(text: str) -> Any:
    """Parse a LightGBM text model into a Booster."""
    from mmlspark_tpu_torch.models.gbdt.booster import Booster

    header: dict = {}
    trees = []
    cur: Optional[dict] = None
    average_output = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line == "end of trees":
            break
        if line.startswith("Tree="):
            if cur is not None:
                trees.append(cur)
            cur = {}
            continue
        if line == "average_output":
            average_output = True
            continue
        if "=" not in line:
            continue
        key, val = line.split("=", 1)
        if cur is None:
            header[key] = val
        else:
            cur[key] = val.split()
    if cur is not None:
        trees.append(cur)
    if "objective" not in header:
        raise ValueError("not a LightGBM model string (no objective= header)")
    objective, num_class, obj_param, sigmoid = _parse_objective(
        header["objective"]
    )
    num_class = int(header.get("num_class", num_class))
    notes: set = set()
    parsed = [_explicit_to_tree(t, notes) for t in trees]
    for note in sorted(notes):
        log.warning(note)
    booster = Booster(
        trees=parsed,
        objective=objective,
        num_class=num_class,
        num_features=int(header.get("max_feature_idx", -1)) + 1,
        feature_names=header.get("feature_names", "").split() or None,
        base_score=0.0,  # LightGBM bakes the average into leaf values
        boosting_type="rf" if average_output else "gbdt",
        sigmoid=sigmoid,
        objective_param=obj_param,
    )
    return booster
