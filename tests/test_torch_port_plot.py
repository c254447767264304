"""The port's ``plot.py`` against the JAX package's, on the CPU (Agg).

The same seeded inputs go through both packages' plots; each figure's
artists must equal: the confusion matrix's image and annotations, the
importance bars and their labels, the ROC curve's points and its AUC
legend. (That the port imports matplotlib only when a plot is drawn is
``tests/test_torch_port_imports.py``'s.)
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mmlspark_tpu import plot as JPlot  # noqa: E402
from mmlspark_tpu_torch import plot as PPlot  # noqa: E402


def _artists(ax) -> dict:
    return {
        "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
        "texts": [(t.get_text(), t.get_position(), t.get_color()) for t in ax.texts],
        "images": [np.asarray(im.get_array()).tolist() for im in ax.images],
        "lines": [(ln.get_xydata().tolist(), ln.get_label(), ln.get_linestyle())
                  for ln in ax.lines],
        "bars": [(p.get_width(), p.get_height(), p.get_y()) for p in ax.patches],
        "xticks": [t.get_text() for t in ax.get_xticklabels()],
        "yticks": [t.get_text() for t in ax.get_yticklabels()],
        "legend": [t.get_text() for t in ax.get_legend().get_texts()] if ax.get_legend() else [],
    }


def _both(name: str, *args, **kw) -> tuple:
    want = _artists(getattr(JPlot, name)(*args, **kw))
    got = _artists(getattr(PPlot, name)(*args, **kw))
    plt.close("all")
    return want, got


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("labels", [None, [2, 0, 1], [0, 1]])
def test_confusion_matrix_equals_jax(normalize, labels):
    r = np.random.default_rng(0)
    y = r.integers(0, 3, 200)
    p = np.where(r.random(200) < 0.7, y, r.integers(0, 3, 200))
    want, got = _both("confusion_matrix", y, p, labels=labels, normalize=normalize)
    assert got == want


def test_confusion_matrix_into_a_given_axis():
    fig, ax = plt.subplots()
    assert PPlot.confusion_matrix([0, 1, 1], [0, 1, 0], ax=ax) is ax
    assert "1" in {t.get_text() for t in ax.texts}
    plt.close(fig)


@pytest.mark.parametrize("names,top_n", [(None, 20), (["a", "b", "c", "d", "e"], 3)])
def test_feature_importance_equals_jax(names, top_n):
    imp = np.random.default_rng(1).random(5) * 10
    want, got = _both("feature_importance", imp, names, top_n=top_n)
    assert got == want
    assert len(got["bars"]) == min(top_n, 5)


@pytest.mark.parametrize("ties", [False, True])
def test_roc_curve_equals_jax(ties):
    r = np.random.default_rng(2)
    y = r.integers(0, 2, 500)
    s = y * 0.6 + r.random(500)
    if ties:
        s = np.round(s, 1)
    want, got = _both("roc_curve", y, s)
    assert got == want
    assert got["legend"][0].startswith("AUC = ")
