"""Multi-rank runs of the PyTorch port for the CPU tests: gloo ranks as
spawned processes.

``run(world, tmp_path, suite)`` starts ``world`` processes, each joining
one gloo group through ``parallel.distributed.initialize`` (a ``file://``
rendezvous under ``tmp_path``, so concurrent test workers never share a
port), runs ``suite(rank, world)`` of this module and returns every rank's
result. The ranks import neither JAX nor the JAX package; the tests hold
their results against the JAX package in the test process. The data every
suite uses is made here with numpy from fixed seeds, so the test process
can make the same arrays for the JAX side. A spawn costs about 3.5 s of
process start and imports, so each suite runs many checks at once.
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np
import torch
import torch.multiprocessing as mp

# -- the data, shared by the ranks and the test process -------------------

B4_N, B4_D, B4_S = 600, 5, 16
GROW_N, GROW_D, GROW_L, GROW_B = 800, 6, 15, 64
VW_ROWS, VW_K, VW_BITS, VW_BATCH, VW_PASSES = 512, 9, 10, 64, 2   # K = 9: XLA sums a margin in row order
BIN_N, BIN_D, BIN_CAT = 900, 4, (3,)
EST_N, EST_D = 1024, 5   # blocks of 512 and 256 rows: whole CPU vector widths
WIDE_N, WIDE_D, WIDE_SPLIT = 2400, 64, 1800
VOTE_N, VOTE_D, VOTE_L, VOTE_K = 512, 128, 15, 4


def blocks(n: int, world: int, uneven: bool) -> list:
    """Row ranges of the ranks: equal, or in the ratio 1 : 2 : 3 : 4."""
    w = np.arange(1, world + 1, dtype=np.float64) if uneven else np.ones(world)
    cut = np.concatenate([[0], np.round(np.cumsum(w) / w.sum() * n)]).astype(int)
    return [slice(int(cut[r]), int(cut[r + 1])) for r in range(world)]


def b4_data(B: int) -> dict:
    """Bins with codes outside [0, B), g spanning 2^20 and one far larger
    value in the last rows (a column maximum only the last rank holds), a
    0/1 mask and slots outside [0, S)."""
    r = np.random.default_rng(40 + B)
    n = B4_N
    stats = np.stack([r.normal(size=n) * 100, r.uniform(0.01, 0.3, n), np.ones(n)], 1)
    stats[-3, 0] = 3.0e6
    stats[-5, 1] = 9.5
    return {
        "bins": r.integers(-2, B + 2, (n, B4_D)).astype(np.int32),
        "stats": stats.astype(np.float32),
        "mask": (r.uniform(size=n) < 0.5).astype(np.float32),
        "slot": r.integers(-1, B4_S + 2, n).astype(np.int32),
    }


def grow_data(categorical: bool = False) -> dict:
    r = np.random.default_rng(7 + categorical)
    n, d = GROW_N, GROW_D
    bins = r.integers(0, GROW_B, (n, d)).astype(np.uint8)
    if categorical:
        bins[:, 2] = r.integers(0, 9, n)
    signal = (bins[:, 0] > 30).astype(np.float32) - (bins[:, 2] % 3 == 1) * 0.7
    w = (r.uniform(size=n) < 0.9).astype(np.float32)
    return {
        "bins": bins,
        "grad": (signal + r.normal(size=n) * 0.3).astype(np.float32),
        "hess": r.uniform(0.1, 0.3, n).astype(np.float32),
        "w": w,
        "cat": np.arange(d) == 2 if categorical else None,
    }


def vw_data() -> dict:
    r = np.random.default_rng(11)
    n, k = VW_ROWS, VW_K
    idx = r.integers(0, 1 << VW_BITS, (n, k)).astype(np.int32)
    val = r.normal(size=(n, k)).astype(np.float32)
    val[r.uniform(size=(n, k)) < 0.2] = 0.0
    w_true = r.normal(size=1 << VW_BITS).astype(np.float32)
    y = ((w_true[idx] * val).sum(1) + r.normal(size=n) * 0.1).astype(np.float32)
    return {"idx": idx, "val": val, "y": y, "wt": np.ones(n, np.float32)}


def bin_data() -> np.ndarray:
    """Numerical columns with NaN and a categorical column whose largest
    category only the last rows (the last rank) hold."""
    r = np.random.default_rng(5)
    x = r.normal(size=(BIN_N, BIN_D)).astype(np.float32)
    x[r.uniform(size=(BIN_N, BIN_D)) < 0.05] = np.nan
    x[:, 3] = r.integers(0, 6, BIN_N)
    x[-2:, 3] = 11.0
    return x


def est_data() -> tuple:
    """Integer-valued columns with fewer distinct values than bins, so
    every sample gives one mapper. The rows split into blocks of whole
    vector widths at 2 and 4 ranks: PyTorch's CPU kernels compute the last
    lanes of a block (the vector loop's tail) on a scalar path whose
    ``sigmoid`` rounds differently, so on the CPU a row's gradient would
    otherwise depend on its rank's block size (the card has one path)."""
    r = np.random.default_rng(3)
    x = r.integers(0, 20, (EST_N, EST_D)).astype(np.float32)
    y = ((x[:, 0] - 10) * 0.3 + (x[:, 1] > 12) + r.normal(size=EST_N) * 0.5 > 0.4)
    return x, y.astype(np.float64)


FIT_N, FIT_D, FIT_GROUP = 1024, 6, 16   # blocks of 512 / 256 rows at 2 / 4 ranks; queries of 16
FIT_BASE = dict(num_iterations=6, num_leaves=7, min_data_in_leaf=5, max_bin=63, seed=3)
_ES = dict(num_iterations=30, learning_rate=0.5, early_stopping_round=2)
# the multi-rank fits: name -> (label, TrainConfig fields, how the fit is called)
FITS = {
    "goss": ("binary", dict(boosting_type="goss", top_rate=0.3, other_rate=0.2), {}),
    "goss_multiclass": ("multiclass", dict(objective="multiclass", num_class=3,
                                           boosting_type="goss"), {}),
    "goss_l2": ("regression", dict(objective="regression", boosting_type="goss"), {}),
    "dart": ("binary", dict(boosting_type="dart", drop_rate=0.5, skip_drop=0.0), {}),
    "es_logloss": ("binary", _ES, {"valid": True}),
    "es_auc": ("binary", dict(_ES, metric="auc"), {"valid": True}),
    "es_error": ("binary", dict(_ES, metric="binary_error"), {"valid": True}),
    "es_multiclass": ("multiclass", dict(_ES, objective="multiclass", num_class=3),
                      {"valid": True}),
    "es_l2": ("regression", dict(_ES, objective="regression"), {"valid": True}),
    "es_quantile": ("regression", dict(_ES, objective="quantile", alpha=0.7), {"valid": True}),
    "es_rf": ("binary", dict(boosting_type="rf", bagging_fraction=0.6, bagging_freq=1,
                             num_iterations=10), {"valid": True}),
    "quantile": ("regression", dict(objective="quantile", alpha=0.7), {}),
    # rows split 1:2(:3:4): the padding to the largest block stays out of the
    # percentile and the metric (regression: no CPU tail-lane rounding)
    "quantile_uneven": ("regression", dict(objective="quantile", alpha=0.7), {"uneven": True}),
    "es_l2_uneven": ("regression", dict(_ES, objective="regression"),
                     {"valid": True, "uneven": True}),
    "regression_l1": ("regression", dict(objective="regression_l1"), {}),
    "mape": ("regression", dict(objective="mape"), {}),
    "lambdarank": ("rank", dict(objective="lambdarank"), {}),
    "lambdarank_es": ("rank", dict(_ES, objective="lambdarank", learning_rate=0.3),
                      {"valid": True}),
    "continued": ("binary", dict(seed=4, num_iterations=4), {"init": True}),
    "csr": ("binary", {}, {"csr": True}),
    "fused": ("binary", {}, {"fused_rounds": 4}),
}


def fit_data() -> dict:
    """Integer columns (fewer distinct values than bins: every sample
    gives one mapper) in blocks of whole 64-row vector widths at 2 and 4
    ranks, with binary, 3-class, regression and relevance labels, query
    ids (queries of ``FIT_GROUP`` rows, so every query lies inside a block)
    and a validation mask of whole queries."""
    r = np.random.default_rng(13)
    n = FIT_N
    x = r.integers(0, 24, (n, FIT_D)).astype(np.float32)
    score = (x[:, 0] - 12) * 0.25 + (x[:, 1] > 14) - (x[:, 2] % 4 == 0) * 0.6
    noisy = score + r.normal(size=n) * 0.6
    gid = np.arange(n) // FIT_GROUP
    return {
        "x": x,
        "binary": (noisy > 0).astype(np.float64),
        "multiclass": np.digitize(noisy, [-0.7, 0.6]).astype(np.float64),
        "regression": np.round(noisy * 4.0) + 10.0,
        "rank": np.clip(np.round(noisy + 1.0), 0, 3),
        "gid": gid,
        "valid": gid % 4 == 3,
        # CSR: the columns' small values absent (the missing bin)
        "x_csr": np.where(x < 6, 0.0, x).astype(np.float32),
    }


def wide_binary(n: int = WIDE_N, d: int = WIDE_D, seed: int = 0) -> tuple:
    """``tests/test_voting.py``'s data."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 7] * x[:, 19] + 0.5 * x[:, 3] + 0.3 * r.normal(size=n) > 0).astype(np.float64)
    return x, y


def voting_tree_data() -> dict:
    r = np.random.default_rng(9)
    n, d = VOTE_N, 24
    bins = r.integers(0, GROW_B, (n, d)).astype(np.uint8)
    g = ((bins[:, 4] > 40).astype(np.float32) * 1.5 - (bins[:, 11] < 10)
         + r.normal(size=n).astype(np.float32) * 0.2)
    return {"bins": bins, "grad": g.astype(np.float32),
            "hess": np.ones(n, np.float32), "w": np.ones(n, np.float32)}


def categorical_binary() -> tuple:
    """``tests/test_voting.py``'s categorical case: membership of {1, 5}."""
    r = np.random.default_rng(1)
    cat = r.integers(0, 8, size=600).astype(np.float32)
    x = np.column_stack([cat, r.normal(size=(600, 3))]).astype(np.float32)
    return x, np.isin(cat, [1, 5]).astype(np.float64)


# -- spawning ---------------------------------------------------------------


def _entry(rank: int, world: int, rdv: str, out: str, suite: str) -> None:
    torch.set_num_threads(1)
    from mmlspark_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{rdv}", world, rank, device="cpu")
    try:
        res = globals()[suite](rank, world)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def run(world: int, tmp_path, suite: str) -> list:
    """Every rank's result of ``suite`` on ``world`` gloo ranks."""
    rdv = os.path.join(str(tmp_path), f"rdv-{suite}-{world}")
    out = os.path.join(str(tmp_path), f"out-{suite}-{world}")
    mp.spawn(_entry, args=(world, rdv, out, suite), nprocs=world, join=True)
    res = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            res.append(pickle.load(f))
    return res


# -- what the ranks run -----------------------------------------------------


def _singleton_groups(world: int) -> list:
    """One group per rank holding that rank alone: world 1 inside the run
    (every rank creates every group, in the same order)."""
    import torch.distributed as dist

    return [dist.new_group([r]) for r in range(world)]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _collectives(rank: int, world: int) -> dict:
    from mmlspark_tpu_torch.parallel import (
        cluster_summary, collectives as C, distributed, make_mesh, multihost_pad_target,
        replicate, shard_batch, shard_batch_multihost)

    C.reset_counts()
    mesh = make_mesh(device="cpu")
    x = torch.arange(6, dtype=torch.float32) + 10 * rank
    xi = torch.arange(4 * world, dtype=torch.int64) * (rank + 1)
    ones = torch.ones(8)
    shard_sum = C.shard_apply(lambda t: C.allreduce_sum(t.sum().reshape(1)), mesh=mesh)
    mapped = C.shard_apply(lambda t: t * 2 + rank, mesh=mesh)
    sb = shard_batch({"a": np.arange(8 * 3, dtype=np.float32).reshape(8, 3)}, mesh)
    mh = shard_batch_multihost((np.full(rank + 1, rank, np.int64),), mesh)
    rep = replicate({"w": torch.full((3,), float(rank + 7))}, mesh)
    distributed.barrier("ranks-gate")
    distributed.barrier("ranks-gate-timed", timeout_s=60.0)
    res = {
        "rank": rank, "axis_index": C.axis_index(), "is_coordinator": distributed.is_coordinator(),
        "sum": _np(C.allreduce_sum(x)), "mean": _np(C.allreduce_mean(x)),
        "max": _np(C.allreduce_max(x)), "sum_i64": _np(C.allreduce_sum(xi)),
        "gather": _np(C.all_gather(x)), "gather_stacked": _np(C.all_gather(x, tiled=False)),
        "reduce_scatter": _np(C.reduce_scatter(xi)),
        "ring": _np(C.ring_permute(x)), "ring_back": _np(C.ring_permute(x, shift=-1)),
        "gather_rows": _np(C.all_gather_rows(torch.arange(rank + 1) * 10 + rank)),
        "gather_rows_counted": _np(C.all_gather_rows(
            torch.full((rank + 1, 2), float(rank)), counts=list(range(1, world + 1)))),
        "broadcast": _np(C.broadcast(x, src=world - 1)),
        "shard_sum": _np(shard_sum(ones)), "shard_mapped": _np(mapped(ones.reshape(8, 1) * 3)),
        "shard_batch": _np(sb["a"]), "multihost": _np(mh[0]),
        "pad_target": multihost_pad_target(rank + 1, mesh), "replicate": _np(rep["w"]),
        "summary": cluster_summary(mesh), "mesh_shape": mesh.shape,
        "counts": {k: dict(v) for k, v in C.counts.items()},
    }
    with_bad = []
    for shape in ({"data": world + 1}, {"data": -1, "model": 2}):
        try:
            make_mesh(shape, device="cpu")
        except ValueError:
            with_bad.append(True)
    res["bad_shapes_raise"] = with_bad
    return res


def _b4(rank: int, world: int, singles: list) -> dict:
    import torch.distributed as dist

    from mmlspark_tpu_torch.ops import histogram as H

    out = {}
    for B in (64, 256):
        data = {k: torch.from_numpy(v) for k, v in b4_data(B).items()}
        blk = blocks(B4_N, world, uneven=True)[rank]
        mine = {k: v[blk] for k, v in data.items()}
        g = dist.group.WORLD
        out[f"plane{B}"] = _np(H.plane_histogram(mine["bins"], mine["stats"], None, B, group=g))
        out[f"masked{B}"] = _np(H.plane_histogram(mine["bins"], mine["stats"], mine["mask"], B,
                                                  group=g))
        out[f"multi{B}"] = _np(H.multi_plane_histogram(mine["bins"], mine["stats"],
                                                       mine["slot"], B4_S, B, group=g))
        out[f"leaf{B}"] = _np(H.leaf_stat_sums(mine["slot"].clamp(0, B4_S - 1), mine["stats"],
                                               B4_S, group=g))
        out[f"timed{B}"] = _np(H.sharded_build_timed(mine["bins"], mine["stats"], g, B))
        if rank == 0:  # world 1: one rank, all the rows
            s = singles[0]
            out[f"plane{B}_w1"] = _np(H.plane_histogram(data["bins"], data["stats"], None, B,
                                                        group=s))
            out[f"masked{B}_w1"] = _np(H.plane_histogram(data["bins"], data["stats"],
                                                         data["mask"], B, group=s))
            out[f"multi{B}_w1"] = _np(H.multi_plane_histogram(data["bins"], data["stats"],
                                                              data["slot"], B4_S, B, group=s))
            out[f"leaf{B}_w1"] = _np(H.leaf_stat_sums(data["slot"].clamp(0, B4_S - 1),
                                                      data["stats"], B4_S, group=s))
            out[f"masked{B}_emulated"] = _np(H.plane_histogram_emulated(
                data["bins"], data["stats"], data["mask"], B))
    return out


def _grown(t) -> dict:
    return {k: _np(v) for k, v in t._asdict().items() if v is not None}


def _growers(rank: int, world: int, singles: list) -> dict:
    import torch.distributed as dist

    from mmlspark_tpu_torch.models.gbdt.treegrow import (
        SplitParams, grow_tree, grow_tree_depthwise)

    sp = SplitParams.make(torch.device("cpu"), lambda_l2=1.0, lambda_l1=0.1,
                          min_sum_hessian=1e-3, min_gain=0.0, learning_rate=0.1)
    out = {}
    for cat in (False, True):
        data = grow_data(cat)
        t = {k: torch.from_numpy(v) for k, v in data.items() if v is not None}
        blk = blocks(GROW_N, world, uneven=True)[rank]
        kw = dict(num_leaves=GROW_L, sp=sp, feature_mask=torch.ones(GROW_D),
                  min_data_in_leaf=5, num_bins=GROW_B,
                  categorical_mask=t.get("cat"))
        for name, grow in (("lossguide", grow_tree), ("depthwise", grow_tree_depthwise)):
            key = f"{name}{'_cat' if cat else ''}"
            out[key] = _grown(grow(t["bins"][blk], t["grad"][blk], t["hess"][blk], t["w"][blk],
                                   group=dist.group.WORLD, **kw))
            if rank == 0:
                out[key + "_w1"] = _grown(grow(t["bins"], t["grad"], t["hess"], t["w"],
                                               group=singles[0], **kw))
    return out


def _vw(rank: int, world: int) -> dict:
    from mmlspark_tpu_torch.vw.learner import train_sparse_sgd

    data = vw_data()
    blk = blocks(VW_ROWS, world, uneven=False)[rank]
    out = {}
    for loss in ("squared", "hinge"):
        y = data["y"] if loss == "squared" else np.where(data["y"] > 0, 1.0, -1.0)
        out[loss] = train_sparse_sgd(
            data["idx"][blk], data["val"][blk], y[blk].astype(np.float32), data["wt"][blk],
            VW_BITS, loss=loss, num_passes=VW_PASSES, batch=VW_BATCH, device="cpu")
    return out


def _binning(rank: int, world: int) -> dict:
    from mmlspark_tpu_torch.models.gbdt.train import TrainConfig, _multirank_mapper

    x = bin_data()[blocks(BIN_N, world, uneven=True)[rank]]
    cfg = TrainConfig(max_bin=63, seed=4, categorical_features=BIN_CAT)
    m = _multirank_mapper(x, cfg, BIN_CAT, world, torch.device("cpu"))
    return {"uppers": [np.asarray(u) for u in m.uppers]}


def _estimators(rank: int, world: int) -> dict:
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier, LightGBMRegressor

    x, y = est_data()
    blk = blocks(EST_N, world, uneven=False)[rank]
    df = DataFrame.from_dict({"features": x[blk], "label": y[blk]})
    out = {}
    for name, kw in (("lossguide", {}), ("depthwise", {"growth_policy": "depthwise"}),
                     ("bagged", {"bagging_fraction": 0.7, "bagging_freq": 1}),
                     ("voting", {"parallelism": "voting_parallel", "top_k": 2}),
                     ("rf", {"boosting_type": "rf", "bagging_fraction": 0.6,
                             "bagging_freq": 1})):
        m = LightGBMClassifier(num_iterations=4, num_leaves=7, min_data_in_leaf=5, seed=2,
                               device="cpu", **kw).fit(df)
        out[name] = m.get("model_string")
    if world == 2:
        y3 = (x[blk, 0] // 7).astype(np.float64)
        out["multiclass"] = LightGBMClassifier(
            num_iterations=3, num_leaves=5, min_data_in_leaf=5, device="cpu").fit(
            DataFrame.from_dict({"features": x[blk], "label": y3})).get("model_string")
        out["regression"] = LightGBMRegressor(
            num_iterations=3, num_leaves=5, min_data_in_leaf=5, device="cpu").fit(
            DataFrame.from_dict({"features": x[blk], "label": x[blk, 0] * 0.5 + y[blk]})
        ).get("model_string")
        # the fits the port refused over ranks before A4 step 1b: each now
        # runs, and every rank gets one model
        ran = {}
        for what, kw in (("goss", {"boosting_type": "goss"}), ("dart", {"boosting_type": "dart"}),
                         ("fused", {"fused_rounds": 4})):
            ran[what] = LightGBMClassifier(num_iterations=2, min_data_in_leaf=5, device="cpu",
                                           **kw).fit(df).get("model_string")
        ran["quantile"] = LightGBMRegressor(
            objective="quantile", num_iterations=2, min_data_in_leaf=5, device="cpu").fit(
            DataFrame.from_dict({"features": x[blk], "label": y[blk]})).get("model_string")
        out["ran"] = ran
        out["accepted"] = _accepted(rank, world)
    return out


def _accepted(rank: int, world: int) -> dict:
    """One small fit through ``train`` for each kind of fit the port
    refused over ranks before A4 step 1b: each model string."""
    import scipy.sparse as sp

    from mmlspark_tpu_torch.models.gbdt import TrainConfig, train

    x, y = est_data()
    blk = blocks(EST_N, world, uneven=False)[rank]
    x, y = x[blk], y[blk]
    base = dict(num_iterations=2, num_leaves=5, min_data_in_leaf=5)
    valid = np.arange(len(y)) % 4 == 3
    gid = np.arange(len(y)) // 16
    fits = {
        "GOSS": (dict(boosting_type="goss"), {}),
        "validation": (dict(early_stopping_round=1), {"valid_mask": valid}),
        "quantile": (dict(objective="quantile"), {}),
        "regression_l1": (dict(objective="regression_l1"), {}),
        "dart": (dict(boosting_type="dart", skip_drop=0.0), {}),
        "lambdarank": (dict(objective="lambdarank"), {"group_ids": gid}),
        "CSR": ({}, {}),
        "fused_rounds": ({}, {"fused_rounds": 2}),
    }
    out = {}
    for what, (cfg, kw) in fits.items():
        xx = sp.csr_matrix(x) if what == "CSR" else x
        out[what] = train(xx, y, TrainConfig(**base, **cfg), device="cpu", **kw)
    out["continued"] = train(x, y, TrainConfig(**base, seed=1), init_booster=out["GOSS"],
                             device="cpu")
    return {k: b.to_model_string() for k, b in out.items()}


def multirank_fits(rank: int, world: int) -> dict:
    """Every fit of ``FITS`` through ``train`` on this rank's block of
    ``fit_data``, and the estimator's ``num_batches`` chain: each model
    string, tree count and best iteration, and the refusals' messages."""
    import scipy.sparse as sp

    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.models.gbdt import LightGBMRegressor, TrainConfig, train

    data = fit_data()
    out: dict = {}
    boosters: dict = {}
    for name, (label, cfg, how) in FITS.items():
        blk = blocks(FIT_N, world, uneven=bool(how.get("uneven")))[rank]
        x = data["x"][blk]
        kw = {"device": "cpu"}
        if how.get("valid"):
            kw["valid_mask"] = data["valid"][blk]
        if label == "rank":
            kw["group_ids"] = data["gid"][blk] - data["gid"][blk][0]   # a rank's own ids
        if how.get("init"):
            kw["init_booster"] = boosters["goss"]
        if how.get("fused_rounds"):
            kw["fused_rounds"] = how["fused_rounds"]
        xx = sp.csr_matrix(data["x_csr"][blk]) if how.get("csr") else x
        b = train(xx, data[label][blk], TrainConfig(**{**FIT_BASE, **cfg}), **kw)
        boosters[name] = b
        out[name] = {"model": b.to_model_string(), "trees": len(b.trees),
                     "best": b.best_iteration}
    blk = blocks(FIT_N, world, uneven=False)[rank]
    x = data["x"][blk]
    m = LightGBMRegressor(num_batches=2, device="cpu", **FIT_BASE).fit(
        DataFrame.from_dict({"features": x, "label": data["regression"][blk]}))
    out["num_batches"] = {"model": m.get("model_string"), "trees": len(m.booster.trees),
                          "best": m.booster.best_iteration}
    y = data["binary"][blk]
    refused = {}
    for what, kw in (("checkpoint", {"checkpoint_dir": "unused"}),
                     ("resume", {"resume_from": "unused"})):
        try:
            train(x, y, TrainConfig(**FIT_BASE), device="cpu", **kw)
        except ValueError as e:
            refused[what] = str(e)
    try:
        train(sp.csr_matrix(data["x_csr"][blk]), y,
              TrainConfig(**FIT_BASE, categorical_features=(3,)), device="cpu")
    except ValueError as e:
        refused["csr_categorical"] = str(e)
    out["refused"] = refused
    return out


def parallel_suite(rank: int, world: int) -> dict:
    """The parallel layer, B4, the growers, VW, binning and the estimator."""
    singles = _singleton_groups(world)
    return {"collectives": _collectives(rank, world), "b4": _b4(rank, world, singles),
            "growers": _growers(rank, world, singles), "vw": _vw(rank, world),
            "binning": _binning(rank, world), "estimators": _estimators(rank, world)}


def _auc(y: np.ndarray, p: np.ndarray) -> float:
    from mmlspark_tpu_torch.core.metrics import binary_auc

    return float(binary_auc(y, p))


def voting_suite(rank: int, world: int) -> dict:
    """``tests/test_voting.py``'s cases at two ranks, and the voting grower
    against the JAX package's."""
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier
    from mmlspark_tpu_torch.models.gbdt.treegrow import SplitParams, grow_tree
    from mmlspark_tpu_torch.models.gbdt.voting import grow_tree_voting
    from mmlspark_tpu_torch.parallel import collectives as C

    out: dict = {}
    # comparable AUC
    x, y = wide_binary()
    blk = blocks(WIDE_SPLIT, world, uneven=False)[rank]
    tr = DataFrame.from_dict({"features": x[:WIDE_SPLIT][blk], "label": y[:WIDE_SPLIT][blk]})
    te = DataFrame.from_dict({"features": x[WIDE_SPLIT:], "label": y[WIDE_SPLIT:]})
    for mode in ("data_parallel", "voting_parallel"):
        m = LightGBMClassifier(num_iterations=15, num_leaves=15, min_data_in_leaf=5, seed=7,
                               parallelism=mode, top_k=8, device="cpu").fit(tr)
        out[f"auc_{mode}"] = _auc(y[WIDE_SPLIT:], m.transform(te)["probability"][:, 1])
        out[f"model_{mode}"] = m.get("model_string")

    # elements all-reduced per tree: data_parallel against voting
    r = np.random.default_rng(0)
    n, d = VOTE_N, VOTE_D
    bins = torch.from_numpy(r.integers(0, 255, (n, d)).astype(np.uint8))
    g = torch.from_numpy(r.normal(size=n).astype(np.float32))
    ones = torch.ones(n)
    sl = blocks(n, world, uneven=False)[rank]
    sp = SplitParams.make(torch.device("cpu"), lambda_l2=1.0, lambda_l1=0.0,
                          min_sum_hessian=1e-3, min_gain=0.0, learning_rate=0.1)
    kw = dict(num_leaves=VOTE_L, sp=sp, feature_mask=torch.ones(d), min_data_in_leaf=5,
              num_bins=256, group=torch.distributed.group.WORLD)
    elems = {}
    for name, fn, extra in (("data_parallel", grow_tree, {}),
                            ("voting_parallel", grow_tree_voting, {"top_k": VOTE_K})):
        C.reset_counts()
        t = fn(bins[sl], g[sl], ones[sl], ones[sl], **kw, **extra)
        elems[name] = sum(C.counts["elements"].values())
        elems[name + "_splits"] = int(_np(t.rec_active).sum())
    out["elements"] = elems

    # the voting grower against the JAX package's (equal halves = its shards)
    vt = {k: torch.from_numpy(v) for k, v in voting_tree_data().items()}
    sl = blocks(VOTE_N, world, uneven=False)[rank]
    sp2 = SplitParams.make(torch.device("cpu"), lambda_l2=1.0, lambda_l1=0.0,
                           min_sum_hessian=1e-3, min_gain=0.0, learning_rate=0.1)
    out["tree"] = _grown(grow_tree_voting(
        vt["bins"][sl], vt["grad"][sl], vt["hess"][sl], vt["w"][sl], num_leaves=VOTE_L, sp=sp2,
        feature_mask=torch.ones(24), min_data_in_leaf=5, num_bins=GROW_B, top_k=VOTE_K))

    # categorical subsets in the voting grower itself
    xc, yc = categorical_binary()
    blk = blocks(len(yc), world, uneven=False)[rank]
    records: list = []

    class _Catch(logging.Handler):
        def emit(self, rec: logging.LogRecord) -> None:
            records.append(rec.getMessage())

    log = logging.getLogger("mmlspark_tpu_torch.gbdt")
    h = _Catch()
    log.addHandler(h)
    log.setLevel(logging.INFO)
    try:
        m = LightGBMClassifier(num_iterations=4, num_leaves=4, min_data_in_leaf=5,
                               parallelism="voting_parallel", categorical_slot_indexes=[0],
                               device="cpu").fit(
            DataFrame.from_dict({"features": xc[blk], "label": yc[blk]}))
    finally:
        log.removeHandler(h)
    p = m.transform(DataFrame.from_dict({"features": xc, "label": yc}))["probability"][:, 1]
    out["cat_auc"] = _auc(yc, p)
    out["cat_split_used"] = any(t.is_cat is not None and bool(t.is_cat.any())
                                for t in m.booster.trees)
    out["cat_log"] = records
    out["cat_model"] = m.get("model_string")
    return out

