"""The port's ``cyber/`` and ``lightgbm/`` against the JAX package's.

- ALS: the initial draws within 4 ulp of ``jax.random.normal``'s; dense
  and COO, explicit and implicit, ``uf @ rf.T`` within ``ALS_REL`` *
  max|ref| of the JAX package's (measured at most 1.2e-5: the solves' LU
  and the matmuls round differently); COO against dense at 1e-3, as in
  ``tests/test_cyber.py``; edges summed in edge order across blocks;
- the host stages (complement draws, the sampler, both scalers, the
  synthetic dataset) are the JAX package's code: bitwise;
- AccessAnomaly: scores within 1e-3 absolute in both modes (implicit at
  the chip phase's size; on a small tenant an implicit fit's tiny std
  magnifies the factors' differences, held there at the affinities);
  unseen entities and tenants score exactly 0; a port model built from the JAX
  model's params scores as the JAX model does; stages round-trip
  ``save``/``load``;
- ``mmlspark_tpu_torch.lightgbm`` exports the JAX alias's seven names.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import mmlspark_tpu.cyber as J
import mmlspark_tpu.cyber.als as JA
from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu_torch import DataFrame, load_stage
from mmlspark_tpu_torch.cyber import (
    AccessAnomaly,
    AccessAnomalyModel,
    ComplementSampler,
    LinearScalarScaler,
    StandardScalarScaler,
    als_predict,
    als_train,
    complement_sample,
    synthetic_access_df,
)
from mmlspark_tpu_torch.cyber import als as PA
from mmlspark_tpu_torch.lime.superpixel import segment_sum

ALS_REL = 1e-4
SCORE_ABS = 1e-3
TIGHT_AFF_REL = 5e-4   # implicit AccessAnomaly's affinities on a small tenant (alpha 40)


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def _observed(u: int, i: int, density: float, seed: int, top: int = 5) -> tuple:
    rng = np.random.default_rng(seed)
    mask = rng.random((u, i)) < density
    r = np.where(mask, rng.integers(1, top, size=(u, i)).astype(np.float32), 0.0)
    return mask, r.astype(np.float32)


def _rel(got: tuple, want: tuple) -> float:
    ref = want[0] @ want[1].T
    return float(np.abs(got[0] @ got[1].T - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("seed,n", [(0, 37), (3, 1000), (11, 4099)])
def test_initial_draws_within_4_ulp(seed, n):
    import jax

    ku, ki = jax.random.split(jax.random.PRNGKey(seed))
    x, y = PA.initial_factors(seed, n, n // 2 + 1, 7, torch.device("cpu"))
    assert _ulp(x.numpy(), np.asarray(0.1 * jax.random.normal(ku, (n, 7), np.float32))) <= 4
    assert _ulp(y.numpy(), np.asarray(0.1 * jax.random.normal(ki, (n // 2 + 1, 7),
                                                              np.float32))) <= 4


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
@pytest.mark.parametrize("shape,rank,iters,seed", [
    ((12, 9), 4, 8, 3), ((30, 20), 5, 10, 1), ((25, 18), 2, 6, 0)])
def test_dense_als_within_tolerance(shape, rank, iters, seed, implicit):
    mask, r = _observed(*shape, 0.4, seed)
    kw = dict(rank=rank, iters=iters, reg=0.1, implicit=implicit, alpha=10.0, seed=seed)
    want = JA.als_train(r, **kw)
    got = als_train(r, device="cpu", **kw)
    assert got[0].dtype == got[1].dtype == np.float32
    assert _rel(got, want) <= ALS_REL
    if not implicit:  # an explicit mask other than ratings != 0
        m = mask & (np.arange(shape[1]) % 3 != 0)
        assert _rel(als_train(r, m, device="cpu", **kw), JA.als_train(r, m, **kw)) <= ALS_REL


@pytest.mark.parametrize("implicit", [False, True], ids=["explicit", "implicit"])
@pytest.mark.parametrize("shape,density,rank,iters,seed", [
    ((12, 9), 0.4, 4, 8, 3), ((10, 8), 0.35, 3, 6, 5), ((400, 120), 0.4, 10, 4, 2)],
    ids=["small", "tiny", "three_blocks"])
def test_coo_als_within_tolerance_and_against_dense(shape, density, rank, iters, seed,
                                                    implicit):
    mask, r = _observed(*shape, density, seed)
    eu, ei = np.nonzero(mask)
    kw = dict(rank=rank, iters=iters, reg=0.1, implicit=implicit, alpha=10.0, seed=seed)
    want = JA.als_train_coo(eu, ei, r[eu, ei], *shape, **kw)
    got = PA.als_train_coo(eu, ei, r[eu, ei], *shape, device="cpu", **kw)
    assert _rel(got, want) <= ALS_REL
    dense = als_train(r, device="cpu", **kw)
    np.testing.assert_allclose(dense[0] @ dense[1].T, got[0] @ got[1].T, rtol=1e-3, atol=1e-3)


def test_edges_add_in_edge_order_across_blocks():
    """The accumulator is carried across blocks and each edge added onto
    the running sum: the same as one sequential loop over the edges."""
    rng = np.random.RandomState(0)
    scale = 10.0 ** rng.randint(-4, 4, (300, 1))
    vals = torch.as_tensor((rng.randn(300, 3) * scale).astype(np.float32))
    seg = torch.as_tensor(rng.randint(0, 7, 300))
    acc = torch.zeros(7, 3)
    for lo in range(0, 300, 64):
        segment_sum(vals[lo:lo + 64], seg[lo:lo + 64], 7, out=acc)
    want = np.zeros((7, 3), np.float32)
    for v, s in zip(vals.numpy(), seg.numpy()):
        want[s] = want[s] + v
    assert acc.numpy().tobytes() == want.tobytes()


def test_als_predict_is_the_reference():
    rng = np.random.RandomState(1)
    uf, vf = rng.randn(6, 3), rng.randn(5, 3)
    u, i = rng.randint(0, 6, 20), rng.randint(0, 5, 20)
    assert als_predict(uf, vf, u, i).tobytes() == J.als_predict(uf, vf, u, i).tobytes()


@pytest.mark.parametrize("factor,seed", [(2.0, 0), (10.0, 3), (0.5, 7)])
def test_complement_draws_bitwise(factor, seed):
    rng = np.random.RandomState(seed)
    users, items = rng.randint(0, 9, 30), rng.randint(0, 6, 30)
    a = J.complement_sample(users, items, 9, 6, factor, seed)
    b = complement_sample(users, items, 9, 6, factor, seed)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    cols = {"user_idx": users, "res_idx": items, "rating": np.ones(30),
            "tenant": rng.randint(0, 3, 30), "note": np.array(["n"] * 30, dtype=object)}
    ja = J.ComplementSampler(partition_key="tenant", factor=factor, seed=seed).transform(
        JDataFrame.from_dict(cols))
    pa = ComplementSampler(partition_key="tenant", factor=factor, seed=seed).transform(
        DataFrame.from_dict(cols))
    assert set(pa.columns) == set(ja.columns)
    for c in ("user_idx", "res_idx", "rating", "tenant"):
        assert np.asarray(pa[c]).tobytes() == np.asarray(ja[c]).tobytes(), c
    assert list(pa["note"]) == list(ja["note"])


@pytest.mark.parametrize("partition", [None, "tenant"])
def test_scalers_bitwise(partition):
    rng = np.random.RandomState(2)
    cols = {"tenant": rng.randint(0, 3, 50), "v": rng.randn(50) * 7 + 3}
    for jcls, pcls, kw in ((J.StandardScalarScaler, StandardScalarScaler, {}),
                           (J.StandardScalarScaler, StandardScalarScaler, {"use_std": False}),
                           (J.LinearScalarScaler, LinearScalarScaler,
                            {"min_required_value": -2.0, "max_required_value": 5.0})):
        jm = jcls(input_col="v", partition_key=partition, **kw).fit(JDataFrame.from_dict(cols))
        pm = pcls(input_col="v", partition_key=partition, **kw).fit(DataFrame.from_dict(cols))
        a = jm.transform(JDataFrame.from_dict(cols))["v_scaled"]
        b = pm.transform(DataFrame.from_dict(cols))["v_scaled"]
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kw", [{}, dict(n_tenants=2, n_departments=4, users_per_dept=5,
                                         resources_per_dept=3, cross_dept_prob=0.3, seed=4)])
def test_synthetic_dataset_bitwise(kw):
    a, b = J.synthetic_access_df(**kw), synthetic_access_df(**kw)
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        assert list(a[c]) == list(b[c]) and np.asarray(a[c]).dtype == np.asarray(b[c]).dtype


def _access(**kw) -> dict:
    df = J.synthetic_access_df(**kw)
    return {c: df[c] for c in df.columns}


def _probes() -> dict:
    users = ["t0_d0_u0", "t0_d1_u1", "t0_d2_u2", "t1_d0_u3", "nobody", "t0_d0_u1"]
    res = ["t0_d1_r0", "t0_d0_r1", "t0_d2_r2", "t1_d0_r0", "t0_d0_r0", "t0_nowhere"]
    return {"tenant": np.array([0, 0, 0, 1, 0, 0], np.int64),
            "user": np.array(users, dtype=object), "res": np.array(res, dtype=object)}


# the chip phase's deployment: 2 tenants x 1,000 users x 500 resources,
# 100,000 accesses
PHASE_ACCESS = dict(n_tenants=2, n_departments=10, users_per_dept=100, resources_per_dept=50,
                    accesses_per_user=50, cross_dept_prob=0.02)
SMALL_ACCESS = dict(n_tenants=2, n_departments=3, users_per_dept=8, resources_per_dept=6,
                    accesses_per_user=25, cross_dept_prob=0.05, seed=0)


def _anomaly_pair(cols: dict, **kw) -> tuple:
    jm = J.AccessAnomaly(**kw).fit(JDataFrame.from_dict(cols))
    pm = AccessAnomaly(device="cpu", **kw).fit(DataFrame.from_dict(cols))
    for t, tm in jm.get("tenant_models").items():
        ptm = pm.get("tenant_models")[t]
        assert ptm["user_labels"] == tm["user_labels"]
        assert ptm["res_labels"] == tm["res_labels"]
    return jm, pm


@pytest.mark.parametrize("implicit,data", [(False, "small"), (False, "phase"), (True, "phase")],
                         ids=["explicit-small", "explicit-phase", "implicit-phase"])
def test_access_anomaly_scores_within_1e3(implicit, data):
    """Measured: 7.1e-6 (explicit, small), 8.6e-6 / 1.2e-4 (explicit /
    implicit at the phase's size)."""
    cols = _access(**(SMALL_ACCESS if data == "small" else PHASE_ACCESS))
    kw = dict(rank=6, max_iter=10, seed=1) if data == "small" else {}
    jm, pm = _anomaly_pair(cols, implicit=implicit, **kw)
    for probe in (cols, _probes()):
        a = jm.transform(JDataFrame.from_dict(probe))["anomaly_score"]
        b = pm.transform(DataFrame.from_dict(probe))["anomaly_score"]
        np.testing.assert_allclose(b, a, rtol=0, atol=SCORE_ABS)
    b = pm.transform(DataFrame.from_dict(_probes()))["anomaly_score"]
    assert b[4] == 0.0 and b[5] == 0.0  # an unseen user, an unseen resource


def test_implicit_scores_on_a_tight_tenant_follow_the_affinities():
    """An implicit fit pulls every observed pair's affinity toward 1, so a
    small tenant's std over them is ~0.01 and the standardised score
    divides the factors' differences (the solves' LU, 1.4e-4 of max|aff|
    here after 10 iterations at alpha 40) by it: ~2e-3. The affinities are
    held within TIGHT_AFF_REL of max|aff|, and each score's difference
    times its tenant's std within 2 * TIGHT_AFF_REL of it."""
    cols = _access(**SMALL_ACCESS)
    jm, pm = _anomaly_pair(cols, rank=6, max_iter=10, implicit=True, seed=1)
    tenants = np.asarray(cols["tenant"])
    a = jm.transform(JDataFrame.from_dict(cols))["anomaly_score"]
    b = pm.transform(DataFrame.from_dict(cols))["anomaly_score"]
    for t, tm in jm.get("tenant_models").items():
        ptm = pm.get("tenant_models")[t]
        want = tm["user_factors"] @ tm["res_factors"].T
        got = ptm["user_factors"] @ ptm["res_factors"].T
        top = np.abs(want).max()
        assert np.abs(got - want).max() <= TIGHT_AFF_REL * top
        assert tm["std"] < 0.05
        sel = tenants == t
        assert np.abs(b[sel] - a[sel]).max() * tm["std"] <= 2 * TIGHT_AFF_REL * top


def test_reference_checks_on_the_port():
    """tests/test_cyber.py's AccessAnomaly checks, on the port."""
    df = DataFrame.from_dict(_access(n_departments=3, users_per_dept=8, resources_per_dept=6,
                                     accesses_per_user=25, cross_dept_prob=0.0, seed=0))
    users = np.array(["t0_d0_u0", "t0_d1_u1", "t0_d2_u2"], dtype=object)
    z = np.zeros(3, np.int64)
    for implicit in (False, True):
        model = AccessAnomaly(rank=6, max_iter=10, implicit=implicit, seed=1,
                              device="cpu").fit(df)
        ns = model.transform(DataFrame.from_dict({"tenant": z, "user": users, "res": np.array(
            ["t0_d0_r0", "t0_d1_r1", "t0_d2_r2"], dtype=object)}))["anomaly_score"]
        xs = model.transform(DataFrame.from_dict({"tenant": z, "user": users, "res": np.array(
            ["t0_d1_r0", "t0_d2_r1", "t0_d0_r2"], dtype=object)}))["anomaly_score"]
        assert xs.mean() > ns.mean() + 0.5, (implicit, ns, xs)
    probe = DataFrame.from_dict({"tenant": np.array([0, 99], np.int64),
                                 "user": np.array(["nobody", "t0_d0_u0"], dtype=object),
                                 "res": np.array(["t0_d0_r0", "t0_d0_r0"], dtype=object)})
    assert (model.transform(probe)["anomaly_score"] == 0.0).all()


def test_carried_params_score_as_the_jax_model():
    cols = _access(users_per_dept=4, accesses_per_user=10)
    jm = J.AccessAnomaly(rank=4, max_iter=5).fit(JDataFrame.from_dict(cols))
    pm = AccessAnomalyModel(device="cpu", tenant_models=jm.get("tenant_models"))
    for probe in (cols, _probes()):
        a = jm.transform(JDataFrame.from_dict(probe))["anomaly_score"]
        b = pm.transform(DataFrame.from_dict(probe))["anomaly_score"]
        assert a.tobytes() == b.tobytes()


def test_save_load(tmp_path):
    df = DataFrame.from_dict(_access(users_per_dept=4, accesses_per_user=10))
    model = AccessAnomaly(rank=4, max_iter=5, device="cpu").fit(df)
    scaler = StandardScalarScaler(input_col="likelihood", partition_key="tenant").fit(df)
    linear = LinearScalarScaler(input_col="likelihood").fit(df)
    for name, stage, col in (("aa", model, "anomaly_score"),
                             ("std", scaler, "likelihood_scaled"),
                             ("lin", linear, "likelihood_scaled")):
        stage.save(str(tmp_path / name))
        back = load_stage(str(tmp_path / name))
        assert back.transform(df)[col].tobytes() == stage.transform(df)[col].tobytes()
    sampler = ComplementSampler(factor=3.0, seed=5, user_col="user", item_col="res")
    sampler.save(str(tmp_path / "cs"))
    assert load_stage(str(tmp_path / "cs")).get("factor") == 3.0


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, r = _observed(6, 5, 0.5, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        als_train(r, rank=2, iters=1)
    eu, ei = np.nonzero(r)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PA.als_train_coo(eu, ei, r[eu, ei], 6, 5, rank=2, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AccessAnomaly(rank=2, max_iter=1).fit(synthetic_access_df(users_per_dept=2))


def test_lightgbm_alias_exports_the_seven_names():
    import mmlspark_tpu.lightgbm as JL
    import mmlspark_tpu_torch.lightgbm as PL
    from mmlspark_tpu_torch.models import gbdt

    assert PL.__all__ == JL.__all__ and len(PL.__all__) == 7
    assert PL.LightGBMBooster is gbdt.Booster
    for name in PL.__all__[1:]:
        assert getattr(PL, name) is getattr(gbdt, name)
