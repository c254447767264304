"""The port's ``nn/`` against the JAX package's.

- ``BallTree``/``ConditionalBallTree`` are the JAX package's host code
  (copied): the same matches, the same pickled state;
- ``KNN``/``ConditionalKNN`` (brute force, chunked or not): on an index
  with duplicated rows the matched indices equal the JAX package's exactly,
  ties to the lower index as ``lax.top_k`` breaks them; on other data
  equal wherever a score's gap to the next one exceeds 1e-5 relative;
  scores within 1e-5 relative; plus ``tests/test_nn.py``'s checks on the
  port.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

import mmlspark_tpu.nn as J
from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu_torch import DataFrame, load_stage
from mmlspark_tpu_torch.nn import KNN, BallTree, ConditionalBallTree, ConditionalKNN
from mmlspark_tpu_torch.nn import knn as K

REL = 1e-5


def _rand(n: int, d: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _dup_index(n: int = 300, d: int = 8) -> np.ndarray:
    """An index whose rows 100-149 repeat rows 0-49 and row 200 repeats row
    3: exact ties in every package."""
    x = _rand(n, d)
    x[100:150] = x[:50]
    x[200] = x[3]
    return x


def _matches(rows) -> tuple:
    idx = np.array([[m["index"] for m in r] for r in rows])
    sc = np.array([[m["distance"] for m in r] for r in rows])
    return idx, sc


def _hold(got_rows, want_rows, exact: bool) -> int:
    """Indices equal (everywhere, or where the score's gap to the next
    exceeds REL relative); scores within REL. Returns the positions left
    out."""
    gi, gs = _matches(got_rows)
    wi, ws = _matches(want_rows)
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gs, ws, rtol=REL, atol=REL * np.abs(ws).max())
    if exact:
        np.testing.assert_array_equal(gi, wi)
        return 0
    gap = np.abs(np.diff(ws, axis=1, append=-np.inf))
    gap = np.minimum(gap, np.abs(np.diff(ws, axis=1, prepend=np.inf)))
    clear = gap > REL * np.abs(ws)
    np.testing.assert_array_equal(gi[clear], wi[clear])
    return int((~clear).sum())


def _knn(pkg: str, x, q, chunk: int, k: int = 6, values=None):
    values = np.arange(len(x)) if values is None else values
    if pkg == "jax":
        m = J.KNN(k=k, index_chunk_size=chunk).fit(
            JDataFrame.from_dict({"features": x, "values": values}))
        return m.transform(JDataFrame.from_dict({"features": q}))["matches"]
    m = KNN(k=k, index_chunk_size=chunk, device="cpu").fit(
        DataFrame.from_dict({"features": x, "values": values}))
    return m.transform(DataFrame.from_dict({"features": q}))["matches"]


def _cknn(pkg: str, x, labels, q, conds, chunk: int, k: int = 6):
    cols = {"features": x, "values": np.arange(len(x)), "label": labels}
    if pkg == "jax":
        m = J.ConditionalKNN(k=k, index_chunk_size=chunk, label_col="label").fit(
            JDataFrame.from_dict(cols))
        return m.transform(JDataFrame.from_dict({"features": q, "conditioner": conds}))["matches"]
    m = ConditionalKNN(k=k, index_chunk_size=chunk, label_col="label", device="cpu").fit(
        DataFrame.from_dict(cols))
    return m.transform(DataFrame.from_dict({"features": q, "conditioner": conds}))["matches"]


def _conds(n: int, labels: int = 4) -> np.ndarray:
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = [i % labels, (i + 1) % labels]
    return out


@pytest.mark.parametrize("chunk", [1 << 20, 64, 37], ids=["one_chunk", "chunk64", "chunk37"])
def test_knn_with_duplicated_rows_equals_jax_exactly(chunk):
    x = _dup_index()
    q = _rand(24, 8, seed=5)
    q[:6] = x[:6]  # queries equal to index rows that are duplicated
    got, want = _knn("port", x, q, chunk), _knn("jax", x, q, chunk)
    _hold(got, want, exact=True)
    gi, gs = _matches(got)
    ties = gs[:, 1:] == gs[:, :-1]
    assert ties.any()  # the duplicated rows tie
    assert (gi[:, 1:][ties] > gi[:, :-1][ties]).all()


@pytest.mark.parametrize("chunk", [1 << 20, 50], ids=["one_chunk", "chunk50"])
def test_conditional_knn_with_duplicated_rows_equals_jax_exactly(chunk):
    x = _dup_index()
    labels = np.arange(300) % 4
    q = _rand(20, 8, seed=6)
    got = _cknn("port", x, labels, q, _conds(20), chunk)
    want = _cknn("jax", x, labels, q, _conds(20), chunk)
    _hold(got, want, exact=True)
    for i, row in enumerate(got):
        assert all(m["label"] in (i % 4, (i + 1) % 4) for m in row)


@pytest.mark.parametrize("chunk", [1 << 20, 250], ids=["one_chunk", "chunk250"])
def test_knn_wide_index_equals_jax_by_the_gap_rule(chunk):
    x, q = _rand(1000, 96, seed=1), _rand(40, 96, seed=2)
    left_out = _hold(_knn("port", x, q, chunk, k=10), _knn("jax", x, q, chunk, k=10), exact=False)
    assert left_out <= 40


def test_topk_breaks_ties_by_lower_index():
    scores = torch.tensor([[1.0, 3.0, 3.0, -0.5, 3.0, float("-inf")],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    rows = torch.tensor([10, 4, 7, 2, 1, 0])
    sc, ix = K.topk_by_index(scores, rows, 4)
    assert ix.tolist() == [[1, 4, 7, 10], [0, 1, 2, 4]]
    assert sc.tolist() == [[3.0, 3.0, 3.0, 1.0], [0.0, 0.0, 0.0, 0.0]]


# -- tests/test_nn.py's checks, on the port -------------------------------------------


def test_balltree_matches_bruteforce_and_jax():
    x = _rand(500, 16)
    tree, jtree = BallTree(x, leaf_size=10), J.BallTree(x, leaf_size=10)
    for row in _rand(20, 16, seed=1):
        got = tree.find_maximum_inner_products(row, k=7)
        want = np.argsort(-(x @ row))[:7]
        assert [m.index for m in got] == list(want)
        assert [m.index for m in got] == [m.index for m in jtree.find_maximum_inner_products(row, 7)]


def test_balltree_pickle_and_conditional():
    x = _rand(300, 8)
    tree = BallTree(x[:200], leaf_size=16)
    tree2 = pickle.loads(pickle.dumps(tree))
    q = _rand(1, 8, seed=3)[0]
    assert ([m.index for m in tree.find_maximum_inner_products(q, 5)]
            == [m.index for m in tree2.find_maximum_inner_products(q, 5)])
    labels = np.arange(300) % 3
    ct = ConditionalBallTree(x, labels, leaf_size=20)
    got = ct.find_maximum_inner_products(q, k=5, conditioner=[1])
    assert all(m.label == 1 for m in got)
    want = np.argsort(-np.where(labels == 1, x @ q, -np.inf))[:5]
    assert [m.index for m in got] == list(want)
    assert BallTree(np.zeros((0, 4))).find_maximum_inner_products(np.ones(4), 3) == []


@pytest.mark.parametrize("algorithm", ["brute", "balltree"])
def test_knn_stage(algorithm):
    x = _rand(100, 8)
    df = DataFrame.from_dict(
        {"features": x, "values": np.array([f"v{i}" for i in range(100)])}, num_partitions=2)
    model = KNN(k=3, algorithm=algorithm, device="cpu").fit(df)
    qx = _rand(10, 8, seed=5)
    matches = model.transform(DataFrame.from_dict({"features": qx}))["matches"]
    scores = qx @ x.T
    for i, row in enumerate(matches):
        want = np.argsort(-scores[i])[:3]
        assert [m["value"] for m in row] == [f"v{j}" for j in want]
        assert row[0]["distance"] >= row[1]["distance"] >= row[2]["distance"]


@pytest.mark.parametrize("algorithm", ["brute", "balltree"])
def test_conditional_knn_stage(algorithm):
    x = _rand(120, 8)
    labels = np.arange(120) % 4
    model = ConditionalKNN(k=4, algorithm=algorithm, label_col="label", device="cpu").fit(
        DataFrame.from_dict({"features": x, "values": np.arange(120), "label": labels}))
    qx = _rand(6, 8, seed=7)
    conds = np.empty(6, dtype=object)
    for i in range(6):
        conds[i] = [i % 4]
    out = model.transform(DataFrame.from_dict({"features": qx, "conditioner": conds}))
    for i, row in enumerate(out["matches"]):
        assert len(row) == 4 and all(m["label"] == i % 4 for m in row)
        want = set(np.argsort(-np.where(labels == i % 4, qx[i] @ x.T, -np.inf))[:4])
        assert {m["value"] for m in row} == want


def test_conditioner_excludes_everything():
    x = _rand(20, 4)
    model = ConditionalKNN(k=3, label_col="label", device="cpu").fit(
        DataFrame.from_dict({"features": x, "values": np.arange(20), "label": np.zeros(20)}))
    conds = np.empty(1, dtype=object)
    conds[0] = [99]
    out = model.transform(DataFrame.from_dict({"features": x[:1], "conditioner": conds}))
    assert out["matches"][0] == []


def test_knn_save_load(tmp_path):
    x = _rand(50, 4)
    model = KNN(k=2, device="cpu").fit(DataFrame.from_dict({"features": x,
                                                           "values": np.arange(50)}))
    p = str(tmp_path / "knn")
    model.save(p)
    loaded = load_stage(p)
    q = DataFrame.from_dict({"features": x[:5]})
    a, b = model.transform(q)["matches"], loaded.transform(q)["matches"]
    for ra, rb in zip(a, b):
        assert [m["value"] for m in ra] == [m["value"] for m in rb]
