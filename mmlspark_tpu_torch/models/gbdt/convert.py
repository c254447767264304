"""Carry a model trained by the JAX package over to the port.

``booster_from_reference`` builds the port's ``Booster`` from the JAX
package's parameters: one dict of numpy arrays per tree, under the JAX
``Tree`` field names. The JSON model string is the other route
(``Booster.from_model_string`` reads the JAX package's strings as they are).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.models.gbdt.booster import Booster, Tree
from mmlspark_tpu_torch.ops.histogram import NUM_BINS

TREE_FIELDS = ("leaf", "feature", "threshold", "active", "gain", "values", "counts")


def booster_from_reference(
    trees: Sequence[dict],
    *,
    objective: str,
    num_class: int,
    num_features: int,
    base_score: Any,
    boosting_type: str = "gbdt",
    sigmoid: float = 1.0,
    best_iteration: int = -1,
    objective_param: Optional[float] = None,
) -> Booster:
    """Per tree, a dict with the JAX ``Tree`` fields ``leaf``, ``feature``,
    ``threshold``, ``active``, ``gain``, ``values`` and ``counts``, and
    optionally ``default_left`` and, for categorical splits, ``is_cat``
    (S,) with ``catmask`` (S, B): the left bins of each split, B at most
    ``NUM_BINS`` (padded to it).

    ``best_iteration`` (an early-stopped booster scores its best prefix of
    rounds) and ``objective_param`` (the regression objective's knob) come
    from the JAX ``Booster`` fields of the same names."""
    out = []
    for i, t in enumerate(trees):
        missing = [f for f in TREE_FIELDS if f not in t]
        if missing:
            raise KeyError(f"tree {i} lacks {missing}")
        is_cat = catmask = None
        if t.get("is_cat") is not None and np.any(t["is_cat"]):
            is_cat = np.asarray(t["is_cat"], bool)
            cm = np.asarray(t["catmask"], bool)
            catmask = np.zeros((len(is_cat), NUM_BINS), bool)
            catmask[:, : cm.shape[1]] = cm
        dl = t.get("default_left")
        out.append(Tree(
            leaf=np.asarray(t["leaf"], np.int32),
            feature=np.asarray(t["feature"], np.int32),
            threshold=np.asarray(t["threshold"], np.float64),
            active=np.asarray(t["active"], bool),
            gain=np.asarray(t["gain"], np.float32),
            values=np.asarray(t["values"], np.float32),
            counts=np.asarray(t["counts"], np.int32),
            is_cat=is_cat,
            catmask=catmask,
            default_left=None if dl is None else np.asarray(dl, bool),
        ))
    return Booster(
        trees=out, objective=objective, num_class=num_class,
        num_features=num_features, base_score=base_score,
        boosting_type=boosting_type, sigmoid=sigmoid,
        best_iteration=best_iteration, objective_param=objective_param,
    )
