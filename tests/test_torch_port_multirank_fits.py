"""The port's multi-rank GBDT fits against themselves across ranks and world
sizes, and against the JAX package's fit on all the rows.

Each fit of ``torch_port_ranks.FITS`` (GOSS, dart, validation rows with
early stopping under every metric, the renewed objectives, lambdarank with
and without early stopping, continued training, CSR input and
``fused_rounds > 1``) runs on gloo ranks spawned once per world size
(``torch_port_ranks.multirank_fits``, at 2 and 4 ranks), each rank on its
block of ``fit_data``: integer columns in blocks of whole 64-row vector
widths, every query inside a block. The JAX package's two-process gate has
the same modes (``tests/test_distributed_multiprocess.py``, ``GBDT_WORKER``).

Tolerances: every rank's model string is byte-identical, and equal at 2
and 4 ranks (the port's fixed-point histogram sums, and every global
decision taken from the same gathered rows), best iterations included.
Against the JAX package's ``train(..., shard=False)`` on the concatenated
rows (its device grower, f32 sums): the same tree count, best iteration
and split features, and raw scores within ``PRED_TOL * (1 + max |raw|)``
(measured up to 1.2e-6: f32 sums in another order, and for the sigmoid
and softmax objectives the standing ``exp`` difference, ROADMAP Queue C).
The estimator's ``num_batches`` cuts each rank's own rows, so its batches
depend on the world size: it is held against the JAX chain of the same
batches.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import scipy.sparse as sp

import torch_port_ranks as R
from mmlspark_tpu.models.gbdt.train import TrainConfig as JConfig
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.models.gbdt import Booster
from mmlspark_tpu_torch.models.gbdt.train import _check_multirank

PRED_TOL = 1e-5
ES_FITS = [name for name, (_, _, how) in R.FITS.items() if how.get("valid")]


@pytest.fixture(scope="module")
def fits2(tmp_path_factory):
    return R.run(2, tmp_path_factory.mktemp("fits2"), "multirank_fits")


@pytest.fixture(scope="module")
def fits4(tmp_path_factory):
    return R.run(4, tmp_path_factory.mktemp("fits4"), "multirank_fits")


@pytest.fixture(scope="module")
def jax_fits():
    """The JAX package's fit of each of ``FITS`` on all the rows (its
    device grower), made once a module."""
    old = os.environ.get("MMLSPARK_TPU_HIST_HOST")
    os.environ["MMLSPARK_TPU_HIST_HOST"] = "0"
    d = R.fit_data()
    out: dict = {}
    try:
        for name, (label, cfg, how) in R.FITS.items():
            kw = {}
            if how.get("valid"):
                kw["valid_mask"] = d["valid"]
            if label == "rank":
                kw["group_ids"] = d["gid"]
            if how.get("init"):
                kw["init_booster"] = out["goss"]
            if how.get("fused_rounds"):
                kw["fused_rounds"] = how["fused_rounds"]
            x = sp.csr_matrix(d["x_csr"]) if how.get("csr") else d["x"]
            out[name] = jtrain(x, d[label], JConfig(**{**R.FIT_BASE, **cfg}), shard=False, **kw)
    finally:
        if old is None:
            os.environ.pop("MMLSPARK_TPU_HIST_HOST")
        else:
            os.environ["MMLSPARK_TPU_HIST_HOST"] = old
    return out


def _scored_rows(name: str) -> np.ndarray:
    d = R.fit_data()
    if R.FITS[name][2].get("csr"):
        return np.where(d["x_csr"] == 0, np.nan, d["x_csr"]).astype(np.float32)
    return d["x"]


def _close_to_jax(model: str, want, x: np.ndarray) -> None:
    got = Booster.from_model_string(model)
    assert len(got.trees) == len(want.trees)
    for t, (a, b) in enumerate(zip(got.trees, want.trees)):
        np.testing.assert_array_equal(a.feature[a.active], np.asarray(b.feature)[b.active],
                                      err_msg=f"tree {t}")
    rounds = len(want.trees) // want.num_class
    pj = want.predict_raw(x, num_iteration=rounds)
    pp = got.predict_raw(x, num_iteration=rounds, device="cpu")
    assert float(np.abs(pp - pj).max()) <= PRED_TOL * (1.0 + float(np.abs(pj).max()))


@pytest.mark.parametrize("name", list(R.FITS))
def test_fit_is_one_model_on_every_rank_and_world(fits2, fits4, name):
    """Every rank's booster at 2 and at 4 ranks is byte for byte the same,
    and so are its tree count and best iteration."""
    want = fits2[0][name]
    assert want["trees"] > 0
    for res in fits2 + fits4:
        assert res[name] == want


@pytest.mark.parametrize("name", list(R.FITS))
def test_fit_against_jax(fits2, jax_fits, name):
    """The ranks' model against the JAX package's fit on all the rows."""
    want = jax_fits[name]
    got = fits2[0][name]
    assert got["best"] == want.best_iteration
    _close_to_jax(got["model"], want, _scored_rows(name))


@pytest.mark.parametrize("name", ["quantile", "es_l2"])
def test_uneven_blocks_give_the_even_blocks_model(fits2, fits4, name):
    """Rows split 1:2(:3:4) among the ranks: the padding to the largest
    block stays out of the leaf percentiles and the metric, so the model
    and its best iteration are the even split's, byte for byte."""
    for res in fits2 + fits4:
        assert res[f"{name}_uneven"] == res[name]


@pytest.mark.parametrize("name", ES_FITS)
def test_early_stopping_is_one_decision(fits2, fits4, jax_fits, name):
    """Early stopping on the gathered metric: every rank records the
    one-rank best iteration, and a fit with patience stops where the JAX
    package's stops (before its last round)."""
    label, cfg, _ = R.FITS[name]
    k = cfg.get("num_class", 1) if label == "multiclass" else 1
    for res in fits2 + fits4:
        assert res[name]["best"] == jax_fits[name].best_iteration > 0
    if cfg.get("early_stopping_round"):
        assert fits2[0][name]["trees"] // k < cfg["num_iterations"]


@pytest.mark.parametrize("world", [2, 4])
def test_num_batches_over_ranks_against_jax_chain(fits2, fits4, world):
    """``LightGBMRegressor(num_batches=2)`` over ranks: one model on every
    rank, equal to the JAX package's chain of the same batches (batch i =
    every rank's i-th half, in rank order; the first fit from the label
    mean over all the rows). (L2: a sigmoid objective's ``exp`` difference
    flips a near-tie threshold of this data.)"""
    ranks = fits2 if world == 2 else fits4
    want_s = ranks[0]["num_batches"]
    assert all(res["num_batches"] == want_s for res in ranks)
    d = R.fit_data()
    x, y = d["x"], d["regression"]
    halves = [[], []]
    for blk in R.blocks(R.FIT_N, world, uneven=False):
        idx = np.arange(blk.start, blk.stop)
        cut = np.linspace(0, len(idx), 3).astype(int)
        for i in range(2):
            halves[i].append(idx[cut[i]:cut[i + 1]])
    booster = None
    for i, part in enumerate(np.concatenate(h) for h in halves):
        booster = jtrain(x[part], y[part], JConfig(objective="regression", **R.FIT_BASE),
                         shard=False, init_booster=booster,
                         base_score=float(y.sum() / len(y)) if i == 0 else 0.0)
    _close_to_jax(want_s["model"], booster, x)


def test_refusals_over_ranks_are_the_jax_errors(fits2):
    """Checkpoint/resume and categorical columns with CSR input raise the
    JAX package's ValueErrors on every rank."""
    for res in fits2:
        r = res["refused"]
        assert sorted(r) == ["checkpoint", "csr_categorical", "resume"]
        assert "single-process only" in r["checkpoint"] and "single-process only" in r["resume"]
        assert "categorical features require dense input" in r["csr_categorical"]


@pytest.mark.parametrize("what", ["pre_binned", "checkpointing"])
def test_check_multirank_refuses_with_value_error(what):
    kw = {"pre_binned": False, "checkpointing": False, what: True}
    with pytest.raises(ValueError, match="single-process only"):
        _check_multirank(**kw)
    _check_multirank(pre_binned=False, checkpointing=False)
