"""voting_parallel (PV-Tree) in the port, after ``tests/test_voting.py``:
quality beside data_parallel, fewer elements all-reduced per split (read
from the port's collective counters, where the JAX test reads HLO), the
fallback at one rank, categorical subsets, and the port's voting grower
against the JAX package's.

The two-rank cases run on gloo ranks spawned once for the module
(``torch_port_ranks.voting_suite``). Tolerances: the grower's split
features, thresholds and record order equal the JAX package's on a
2-device CPU mesh; leaf values agree within 1e-5 of the largest (the JAX
package sums leaves in f32, the port in fixed point).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_ranks as R
from mmlspark_tpu.models.gbdt.treegrow import grow_tree as jgrow_tree
from mmlspark_tpu.models.gbdt.voting import grow_tree_voting as jgrow_tree_voting
from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu.parallel.sharding import shard_batch as jshard_batch
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier
from mmlspark_tpu_torch.models.gbdt.train import TrainConfig, train

LEAF_TOL = 1e-5


@pytest.fixture(scope="module")
def voting2(tmp_path_factory):
    return R.run(2, tmp_path_factory.mktemp("voting2"), "voting_suite")


def test_comparable_auc(voting2):
    aucs = voting2[0]
    assert aucs["auc_voting_parallel"] > 0.8, aucs
    assert abs(aucs["auc_data_parallel"] - aucs["auc_voting_parallel"]) < 0.05


@pytest.mark.parametrize("mode", ["data_parallel", "voting_parallel"])
def test_models_identical_on_every_rank(voting2, mode):
    assert voting2[0][f"model_{mode}"] == voting2[1][f"model_{mode}"]


def test_reduced_allreduce_elements(voting2):
    """Voting all-reduces fewer than a third of data_parallel's elements
    for the same tree (n = 512, d = 128, B = 256, 15 leaves, K = 4: a full
    plane is 98,304 cells a split, voting's (2, d) ballots and (2, 2K, B, 3)
    candidate cells 12,544)."""
    e = voting2[0]["elements"]
    assert e["data_parallel_splits"] == e["voting_parallel_splits"] == R.VOTE_L - 1
    assert e["data_parallel"] > 0 and e["voting_parallel"] > 0
    assert e["voting_parallel"] < e["data_parallel"] / 3, e
    assert voting2[1]["elements"] == e


def test_voting_single_device_falls_back(caplog):
    """One rank: voting degenerates, and ``train`` falls back to
    data_parallel, saying so."""
    x, y = R.wide_binary(n=400, d=24)
    kw = dict(num_iterations=3, num_leaves=7, min_data_in_leaf=5)
    with caplog.at_level(logging.INFO, logger="mmlspark_tpu_torch.gbdt"):
        b = train(x, y, TrainConfig(parallelism="voting_parallel", **kw), device="cpu")
    assert len(b.trees) == 3
    assert any("falling back to data_parallel" in r.message for r in caplog.records)
    assert b.to_model_string() == train(x, y, TrainConfig(**kw), device="cpu").to_model_string()


def test_voting_with_categoricals(voting2):
    """Categorical features vote and split by subset membership in the
    voting grower itself, with no fallback: membership of {1, 5} is
    invisible to any single numeric threshold."""
    res = voting2[0]
    assert not any("falling back" in m for m in res["cat_log"])
    assert res["cat_auc"] > 0.95
    assert res["cat_split_used"]
    assert res["cat_model"] == voting2[1]["cat_model"]


def test_voting_config_checks():
    x, y = R.wide_binary(n=200, d=24)
    with pytest.raises(ValueError, match="voting_parallel"):
        train(x, y, TrainConfig(parallelism="voting_parallel", growth_policy="depthwise"),
              device="cpu")
    with pytest.raises(ValueError, match="parallelism"):
        train(x, y, TrainConfig(parallelism="feature_parallel"), device="cpu")
    with pytest.raises(ValueError, match="parallelism"):
        LightGBMClassifier(parallelism="feature_parallel", device="cpu").fit(
            DataFrame.from_dict({"features": x, "label": y}))


def test_grow_tree_voting_against_jax(voting2):
    """The port's ``grow_tree_voting`` at two ranks against the JAX
    package's on a 2-device mesh, the same halves on both. The data makes
    the local votes miss the global best split (the JAX voting tree
    differs from its one-device tree), so the candidate-miss path runs."""
    d = R.voting_tree_data()
    mesh = jmesh.make_mesh(devices=jax.devices()[:2])
    rows = [np.asarray(v) for v in (d["bins"].astype(np.int32), d["grad"], d["hess"], d["w"])]
    sharded = [jshard_batch(v, mesh) for v in rows]
    kw = dict(num_leaves=R.VOTE_L, lambda_l2=1.0, min_gain=0.0, learning_rate=0.1,
              feature_mask=jnp.ones(24, jnp.float32), min_data_in_leaf=5, num_bins=R.GROW_B)
    want = jgrow_tree_voting(*sharded, top_k=R.VOTE_K, mesh=mesh, **kw)
    one = jgrow_tree(*[jnp.asarray(v) for v in rows], **kw)
    assert not (np.array_equal(np.asarray(want.rec_feature), np.asarray(one.rec_feature))
                and np.array_equal(np.asarray(want.rec_bin), np.asarray(one.rec_bin)))
    for res in voting2:
        got = res["tree"]
        active = np.asarray(want.rec_active)
        assert active.sum() > 0
        np.testing.assert_array_equal(got["rec_active"], active)
        for field in ("rec_leaf", "rec_feature", "rec_bin"):
            np.testing.assert_array_equal(got[field], np.asarray(getattr(want, field)),
                                          err_msg=field)
        np.testing.assert_array_equal(got["leaf_counts"], np.asarray(want.leaf_counts))
        wv = np.asarray(want.leaf_values, np.float64)
        assert float(np.abs(got["leaf_values"] - wv).max()) <= LEAF_TOL * float(np.abs(wv).max())
        np.testing.assert_allclose(got["rec_gain"], np.asarray(want.rec_gain), rtol=1e-5)
    np.testing.assert_array_equal(voting2[0]["tree"]["rec_feature"],
                                  voting2[1]["tree"]["rec_feature"])
