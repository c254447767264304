"""The port's ``recommendation/`` against the JAX package's.

- SAR's similarity is bitwise for cooccurrence, jaccard and lift, with the
  support threshold applied (counts exact in f32, each ``/`` correctly
  rounded); the affinity and seen matrices are the same host numpy;
- recommendations: scores within 1e-5 relative; indices equal exactly
  where scores are exact (integer affinities under cooccurrence: many
  zero-score ties, lower item first), else wherever a score's gap to the
  next exceeds 1e-5 relative; the port's own exact ties lower index first;
- pair scores within 1e-5 relative, cold pairs NaN;
- the indexer, the evaluator's four metrics and ``per_user_split`` are
  the JAX package's host code: equal; TVS's metrics within 1e-6;
- a port SARModel built from the JAX model's params answers as the JAX
  model does; every stage round-trips ``save``/``load``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mmlspark_tpu.recommendation as J
from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu.recommendation.split import per_user_split as j_split
from mmlspark_tpu_torch import DataFrame, load_stage
from mmlspark_tpu_torch.recommendation import (
    SAR,
    RankingAdapter,
    RankingEvaluator,
    RankingTrainValidationSplit,
    RecommendationIndexer,
    SARModel,
)
from mmlspark_tpu_torch.recommendation import sar as S
from mmlspark_tpu_torch.recommendation.split import per_user_split

REL = 1e-5
FUNCTIONS = ("cooccurrence", "jaccard", "lift")


def _ratings(users: int = 80, items: int = 50, n: int = 900, seed: int = 0,
             integer: bool = False) -> dict:
    """Zipf-like item popularity, ratings 1-5, timestamps over ~3 years."""
    rng = np.random.RandomState(seed)
    item = (rng.zipf(1.4, n) - 1) % items
    cols = {"user_idx": rng.randint(0, users, n).astype(np.int64),
            "item_idx": item.astype(np.int64),
            "rating": rng.randint(1, 6, n).astype(np.float32)}
    if not integer:
        cols["t"] = 1.6e9 + rng.rand(n) * 9e7
    return cols


def _fit(cols: dict, **kw) -> tuple:
    kw.setdefault("time_col", "t" if "t" in cols else None)
    jm = J.SAR(**kw).fit(JDataFrame.from_dict(cols))
    pm = SAR(device="cpu", **kw).fit(DataFrame.from_dict(cols))
    return jm, pm


def _recs(df) -> tuple:
    k = max(len(r) for r in df["recommendations"])
    idx = np.full((df.count(), k), -1, np.int64)
    sc = np.full((df.count(), k), -np.inf)
    for u, (r, s) in enumerate(zip(df["recommendations"], df["ratings"])):
        idx[u, :len(r)], sc[u, :len(s)] = r, s
    return idx, sc


def _hold(got, want, exact: bool) -> int:
    """Scores within REL relative; indices equal (everywhere, or where the
    score's gap to its neighbours exceeds REL relative); the port's exact
    ties lower index first. Returns the positions the gap rule left out."""
    gi, gs = _recs(got)
    wi, ws = _recs(want)
    assert gi.shape == wi.shape
    assert [len(r) for r in got["recommendations"]] == [len(r) for r in
                                                         want["recommendations"]]
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=REL, atol=0)
    ties = (gs[:, 1:] == gs[:, :-1]) & fin[:, 1:]
    assert (gi[:, 1:][ties] > gi[:, :-1][ties]).all()
    if exact:
        np.testing.assert_array_equal(gi, wi)
        return 0
    gap = np.minimum(np.abs(np.diff(ws, axis=1, append=-np.inf)),
                     np.abs(np.diff(ws, axis=1, prepend=np.inf)))
    clear = (gap > REL * np.abs(ws)) & fin
    np.testing.assert_array_equal(gi[clear], wi[clear])
    return int((~clear & fin).sum())


@pytest.mark.parametrize("support", [1, 3])
@pytest.mark.parametrize("function", FUNCTIONS)
def test_similarity_and_affinity_bitwise(function, support):
    jm, pm = _fit(_ratings(), similarity_function=function, support_threshold=support)
    for name in ("item_similarity", "user_affinity", "seen_items"):
        a, b = jm.get(name), pm.get(name)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("function", FUNCTIONS)
def test_similarity_function_bitwise_on_wider_data(function):
    rng = np.random.RandomState(5)
    a = (rng.rand(300, 120) < 0.15).astype(np.float32)
    import jax.numpy as jnp
    from mmlspark_tpu.recommendation.sar import _similarity

    want = np.asarray(_similarity(jnp.asarray(a), function, 2))
    got = S.similarity(torch.as_tensor(a), function, 2).numpy()
    assert want.tobytes() == got.tobytes()


def test_exact_scores_give_equal_indices_with_zero_ties():
    """Integer ratings under cooccurrence: every score an exact integer, most
    of the tail 0; k past the nonzero scores, so the zero ties decide."""
    cols = _ratings(users=60, items=80, n=300, seed=1, integer=True)
    jm, pm = _fit(cols, similarity_function="cooccurrence", support_threshold=3)
    got, want = pm.recommend_for_all_users(25), jm.recommend_for_all_users(25)
    _hold(got, want, exact=True)
    _, sc = _recs(got)
    assert (sc == 0).sum() > 500  # the tail is zero ties


@pytest.mark.parametrize("function", ["jaccard", "lift"])
def test_fractional_scores_by_the_gap_rule(function):
    jm, pm = _fit(_ratings(seed=2), similarity_function=function, support_threshold=1)
    left_out = _hold(pm.recommend_for_all_users(12), jm.recommend_for_all_users(12),
                     exact=False)
    assert left_out < 0.5 * 80 * 12  # most positions are held by index (exact ties aside)


@pytest.mark.parametrize("k", [1, 10, 500])
def test_k_is_capped_and_seen_items_allowed(k):
    cols = _ratings(users=30, items=20, n=150, seed=3, integer=True)
    for allow in (False, True):
        jm, pm = _fit(cols, similarity_function="cooccurrence", support_threshold=1,
                      allow_seen_items=allow)
        _hold(pm.recommend_for_all_users(k), jm.recommend_for_all_users(k), exact=True)


def test_pair_scores_and_cold_pairs():
    cols = _ratings(seed=4)
    jm, pm = _fit(cols, similarity_function="jaccard", support_threshold=1)
    rng = np.random.RandomState(9)
    users = rng.randint(0, 80, 400)
    items = rng.randint(0, 50, 400)
    users[:5] = [-1, 80, 1000, 3, 4]
    items[3:7] = [-2, 50, 7, 999]
    pairs = {"user_idx": users, "item_idx": items}
    want = jm.transform(JDataFrame.from_dict(pairs))["prediction"]
    got = pm.transform(DataFrame.from_dict(pairs))["prediction"]
    cold = np.isnan(want)
    assert cold.sum() == 6
    np.testing.assert_array_equal(np.isnan(got), cold)
    np.testing.assert_allclose(got[~cold], want[~cold], rtol=REL, atol=0)


def test_pair_blocks_leave_each_pair_unchanged(monkeypatch):
    _, pm = _fit(_ratings(seed=6), similarity_function="lift", support_threshold=1)
    pairs = DataFrame.from_dict({"user_idx": np.arange(80) % 80,
                                 "item_idx": np.arange(80) % 50})
    whole = pm.transform(pairs)["prediction"]
    monkeypatch.setattr(S, "PAIR_BLOCK_VALUES", 3 * 50)
    assert pm.transform(pairs)["prediction"].tobytes() == whole.tobytes()


def test_carried_params_answer_as_the_jax_model():
    jm, _ = _fit(_ratings(seed=7), similarity_function="jaccard", support_threshold=2)
    pm = SARModel(device="cpu", **{p: jm.get(p) for p in (
        "item_similarity", "user_affinity", "seen_items", "user_col", "item_col")})
    _hold(pm.recommend_for_all_users(10), jm.recommend_for_all_users(10), exact=False)
    pairs = {"user_idx": np.arange(40), "item_idx": np.arange(40) % 50}
    np.testing.assert_allclose(pm.transform(DataFrame.from_dict(pairs))["prediction"],
                               jm.transform(JDataFrame.from_dict(pairs))["prediction"],
                               rtol=REL, atol=0)


def test_reference_checks_on_the_port():
    """tests/test_recommendation.py's SAR checks, on the port."""
    users = np.array([0, 0, 0, 1, 1, 1, 2, 2, 3, 3], np.int64)
    items = np.array([0, 1, 2, 0, 1, 3, 2, 3, 0, 2], np.int64)
    df = DataFrame.from_dict({"user_idx": users, "item_idx": items,
                              "rating": np.ones(10, np.float32)})
    sim = SAR(similarity_function="cooccurrence", support_threshold=1,
              device="cpu").fit(df).get("item_similarity")
    assert sim[0, 1] == 2.0 and sim[0, 0] == 3.0
    sim = SAR(similarity_function="jaccard", support_threshold=1,
              device="cpu").fit(df).get("item_similarity")
    np.testing.assert_allclose(sim[0, 1], 2.0 / 3.0, atol=1e-6)
    np.testing.assert_allclose(sim, sim.T, atol=1e-6)
    assert SAR(similarity_function="cooccurrence", support_threshold=2,
               device="cpu").fit(df).get("item_similarity")[1, 3] == 0.0
    recs = SAR(support_threshold=1, device="cpu").fit(df).recommend_for_all_users(2)
    seen = {0: {0, 1, 2}, 1: {0, 1, 3}, 2: {2, 3}, 3: {0, 2}}
    for u, rec in zip(recs["user_idx"], recs["recommendations"]):
        assert not (set(rec) & seen[int(u)])
    t = np.array([0.0, 30 * 86400.0])
    two = DataFrame.from_dict({"user_idx": np.array([0, 0]), "item_idx": np.array([0, 1]),
                               "rating": np.ones(2, np.float32), "t": t})
    base = SAR(time_col="t", support_threshold=1, device="cpu").fit(two)
    aged = SAR(time_col="t", support_threshold=1, reference_time=60 * 86400.0,
               device="cpu").fit(two)
    np.testing.assert_allclose(base.get("user_affinity")[0], [0.5, 1.0], atol=1e-6)
    np.testing.assert_allclose(aged.get("user_affinity"), base.get("user_affinity") * 0.5,
                               atol=1e-6)


def test_indexer_equals_the_reference():
    rng = np.random.RandomState(0)
    cols = {"user": np.array([f"u{v}" for v in rng.randint(0, 30, 200)], dtype=object),
            "item": np.array([f"i{v}" for v in rng.randint(0, 20, 200)], dtype=object),
            "rating": rng.rand(200)}
    jm = J.RecommendationIndexer().fit(JDataFrame.from_dict(cols))
    pm = RecommendationIndexer().fit(DataFrame.from_dict(cols))
    assert pm.get("user_labels") == jm.get("user_labels")
    a, b = jm.transform(JDataFrame.from_dict(cols)), pm.transform(DataFrame.from_dict(cols))
    for c in ("user_idx", "item_idx"):
        np.testing.assert_array_equal(a[c], b[c])
    assert pm.recover_item([3, 1]).tolist() == jm.recover_item([3, 1]).tolist()


def _lists(rng, n: int, k: int) -> np.ndarray:
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = rng.choice(30, rng.randint(0, k + 1), replace=False).tolist()
    return out


@pytest.mark.parametrize("metric", ["ndcgAt", "map", "precisionAtk", "recallAtK"])
def test_evaluator_metrics_equal(metric):
    rng = np.random.RandomState(1)
    cols = {"recommendations": _lists(rng, 40, 10), "label": _lists(rng, 40, 6)}
    want = J.RankingEvaluator(k=5, metric_name=metric).evaluate(JDataFrame.from_dict(cols))
    got = RankingEvaluator(k=5, metric_name=metric).evaluate(DataFrame.from_dict(cols))
    assert got == want


@pytest.mark.parametrize("ratio,seed", [(0.5, 1), (0.75, 3)])
def test_per_user_split_bitwise(ratio, seed):
    cols = _ratings(seed=seed)
    jt, jv = j_split(JDataFrame.from_dict(cols), "user_idx", ratio, 2, seed)
    pt, pv = per_user_split(DataFrame.from_dict(cols), "user_idx", ratio, 2, seed)
    for a, b in ((jt, pt), (jv, pv)):
        for c in cols:
            assert np.asarray(a[c]).tobytes() == np.asarray(b[c]).tobytes()


def test_adapter_and_tvs_match_the_reference():
    cols = _ratings(seed=8)
    grid = [{"similarity_function": "jaccard"}, {"similarity_function": "lift"}]
    jm = J.RankingTrainValidationSplit(
        estimator=J.SAR(support_threshold=1, time_col="t"), estimator_param_maps=grid,
        k=5).fit(JDataFrame.from_dict(cols))
    pm = RankingTrainValidationSplit(
        estimator=SAR(support_threshold=1, time_col="t", device="cpu"),
        estimator_param_maps=grid, k=5).fit(DataFrame.from_dict(cols))
    np.testing.assert_allclose(pm.get("validation_metrics"), jm.get("validation_metrics"),
                               rtol=0, atol=1e-6)
    _hold(pm.recommend_for_all_users(5), jm.recommend_for_all_users(5), exact=False)
    ja = J.RankingAdapter(recommender=J.SAR(support_threshold=1), k=4).fit(
        JDataFrame.from_dict(cols)).transform(JDataFrame.from_dict(cols))
    pa = RankingAdapter(recommender=SAR(support_threshold=1, device="cpu"), k=4).fit(
        DataFrame.from_dict(cols)).transform(DataFrame.from_dict(cols))
    assert [list(v) for v in pa["label"]] == [list(v) for v in ja["label"]]
    np.testing.assert_array_equal(pa["user_idx"], ja["user_idx"])


def test_save_load_round_trips(tmp_path):
    cols = _ratings(seed=9)
    df = DataFrame.from_dict(cols)
    sar = SAR(support_threshold=1, time_col="t", device="cpu").fit(df)
    adapter = RankingAdapter(recommender=SAR(support_threshold=1, device="cpu"), k=3).fit(df)
    raw = {"user": np.array(["a", "b", "a"], dtype=object),
           "item": np.array(["x", "y", "y"], dtype=object), "rating": np.ones(3)}
    indexer = RecommendationIndexer().fit(DataFrame.from_dict(raw))
    for name, stage, run, probe in (
            ("sar", sar, lambda m: m.recommend_for_all_users(5)["recommendations"], df),
            ("adapter", adapter, lambda m: m.transform(df)["recommendations"], df),
            ("indexer", indexer, lambda m: m.transform(DataFrame.from_dict(raw))["user_idx"],
             None)):
        stage.save(str(tmp_path / name))
        back = load_stage(str(tmp_path / name))
        assert type(back) is type(stage)
        assert [list(v) if isinstance(v, list) else v for v in run(back)] == \
            [list(v) if isinstance(v, list) else v for v in run(stage)]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    df = DataFrame.from_dict(_ratings(seed=10))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SAR().fit(df)
    model = SAR(device="cpu").fit(df)
    model.set(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.recommend_for_all_users(3)
