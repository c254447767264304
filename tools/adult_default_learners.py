"""TrainClassifier() and TrainRegressor() with their default learners on
``chip_smoke.py``'s Adult-shaped rows, in the JAX package and in the port,
on the CPU.

It prints one JSON object: each package's held-out AUC (TrainClassifier
over LogisticRegression) and R^2 (TrainRegressor over LinearRegression,
``hours_per_week`` from the other columns), how far the port's weights lie
from the JAX package's (max |difference| over max |w|), and how far the
port's own fits move when only the order of the training rows changes
(four seeded permutations): on Adult's raw scales, and, for
LogisticRegression, on the featurized rows standardised as phase
``train_http`` standardises them.

    JAX_PLATFORMS=cpu python3 tools/adult_default_learners.py
"""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def adult_helpers() -> dict:
    """``chip_smoke.py``'s Adult frame and its helpers, read from its
    source (importing it exits without a card): the phase's constants,
    ``adult_frame``, ``_auc_f64``, ``_adult_indexed``, ``_standardised``."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    seed = int(re.search(r"^N, D, N_TEST, N_CPU, SEED = .*, (\d+)$", src, re.M).group(1))
    start = src.index("# -- phase train_http")
    end = src.index("\ndef _rel(")
    ns = {"np": np, "SEED": seed}
    exec(compile(src[start:end], "chip_smoke.py", "exec"), ns)
    return ns


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def main() -> None:
    import mmlspark_tpu as J
    from mmlspark_tpu.train import TrainClassifier as JTrainClassifier
    from mmlspark_tpu.train import TrainRegressor as JTrainRegressor

    import mmlspark_tpu_torch as P
    from mmlspark_tpu_torch.models.linear import (LinearRegression, LogisticRegression,
                                                  _device_fit_logistic)
    from mmlspark_tpu_torch.train import TrainClassifier, TrainRegressor

    a = adult_helpers()
    cols = a["adult_frame"]()
    n = a["ADULT_TRAIN"]
    frames = {}
    for pkg, mod in (("jax", J), ("port", P)):
        frames[pkg] = (mod.DataFrame.from_dict({k: v[:n] for k, v in cols.items()}),
                       mod.DataFrame.from_dict({k: v[n:] for k, v in cols.items()}))
    y_te = (cols["income"][n:] == ">50K").astype(np.int64)
    h_te = cols["hours_per_week"][n:]
    reg_cols = [c for c in cols if c != "income"]
    out, fits = {}, {}
    for pkg in ("jax", "port"):
        tr, te = frames[pkg]
        kw = {} if pkg == "jax" else {"model": LogisticRegression(device="cpu")}
        clf = (JTrainClassifier if pkg == "jax" else TrainClassifier)(
            label_col="income", **kw).fit(tr)
        prob = np.asarray(clf.transform(te)["probability"])
        pos = list(clf.get("levels")).index(">50K")
        kw = {} if pkg == "jax" else {"model": LinearRegression(device="cpu")}
        reg = (JTrainRegressor if pkg == "jax" else TrainRegressor)(
            label_col="hours_per_week", **kw).fit(tr.select(*reg_cols))
        pred = np.asarray(reg.transform(te.select(*reg_cols))["prediction"], np.float64)
        fits[pkg] = (clf, reg)
        out[pkg] = {"train_classifier_auc": a["_auc_f64"](y_te, prob[:, pos]),
                    "train_regressor_r2": float(1 - np.sum((h_te - pred) ** 2)
                                                / np.sum((h_te - h_te.mean()) ** 2))}
    out["port_vs_jax_rel"] = {
        "logistic_weights": _rel(fits["port"][0].get("inner_model").get("weights"),
                                 fits["jax"][0].get("inner_model").get("weights")),
        "linear_weights": _rel(fits["port"][1].get("inner_model").get("weights"),
                               fits["jax"][1].get("inner_model").get("weights"))}

    # the port's default LogisticRegression under row permutations
    clf = fits["port"][0]
    feats = clf.get("featurizer").transform(a["_adult_indexed"](frames["port"][0],
                                                                clf.get("levels")))
    x = np.asarray(feats["features"], np.float32)
    y = np.asarray(feats["income"], np.int64)
    lr = LogisticRegression()
    args = (lr.get("reg_param"), lr.get("learning_rate"), lr.get("max_iter"),
            torch.device("cpu"))
    moved = {}
    for name, xx in (("raw", x), ("standardised", a["_standardised"](x)[0])):
        w0, _ = _device_fit_logistic(xx, y, None, 2, *args)
        worst = 0.0
        for s in range(4):
            p = np.random.default_rng(s).permutation(len(y))
            w, _ = _device_fit_logistic(xx[p], y[p], None, 2, *args)
            worst = max(worst, _rel(w, w0))
        moved[name] = worst
    out["port_logistic_rel_under_row_order"] = moved
    print(json.dumps(out))


if __name__ == "__main__":
    main()
