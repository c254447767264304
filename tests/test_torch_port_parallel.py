"""The port's parallel layer on ``torch.distributed``, against the JAX
package's ``parallel/`` and its sharded histogram builds.

Multi-rank cases run on gloo ranks spawned once per world size for the
whole module (``torch_port_ranks.parallel_suite``, at 2 and 4 ranks); the
tests read what the ranks returned and hold it against the JAX package,
here, on a 2- or 4-device CPU mesh. What needs no second rank (the mesh of
one process, ``pad_batch``, ``initialize`` on a single host, the barrier
timeouts with the port's ``FaultPlan``) runs in this process.

Tolerances: the distributed plane of any world size equals the same build
at one rank bit for bit (the port's fixed-point sums; on the CPU that is
``plane_histogram_emulated``); against the JAX package's f32 ``psum`` of
shard planes, counts are exact and g, h agree within 1e-5 * sum |stats_j|,
``tests/test_torch_port_hist_fixed.py``'s bound. VW's per-pass mean at two
ranks is bitwise the JAX package's ``pmean`` for the squared loss ((a + b)
/ 2 has one order) and within 1e-6 * max|w| otherwise.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as R
from mmlspark_tpu.models.gbdt.binning import BinMapper as JBinMapper
from mmlspark_tpu.ops import histogram as JH
from mmlspark_tpu.parallel import mesh as jmesh
from mmlspark_tpu.parallel.sharding import pad_batch as jpad_batch
from mmlspark_tpu.vw import learner as JL
from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core.faults import FaultPlan
from mmlspark_tpu_torch.models.gbdt.train import TrainConfig, _check_multirank
from mmlspark_tpu_torch.ops import histogram as H
from mmlspark_tpu_torch.parallel import (
    MODEL_AXIS, cluster_summary, collectives, distributed, get_mesh, make_mesh, pad_batch,
    set_mesh, shard_batch)
from mmlspark_tpu_torch.parallel.distributed import BarrierTimeoutError, barrier

HIST_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return R.run(2, tmp_path_factory.mktemp("ranks2"), "parallel_suite")


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return R.run(4, tmp_path_factory.mktemp("ranks4"), "parallel_suite")


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


@pytest.fixture()
def jax_mesh():
    """A JAX mesh of the first ``world`` CPU devices as the default, restored after."""
    made = []

    def make(world: int):
        m = jmesh.make_mesh(devices=jax.devices()[:world])
        jmesh.set_mesh(m)
        made.append(m)
        return m

    yield make
    jmesh.set_mesh(None)


# -- one process ---------------------------------------------------------------


def test_make_mesh_single_process():
    m = make_mesh(device="cpu")
    assert (m.rank, m.size, m.shape, m.axis_names) == (0, 1, {"data": 1}, ("data",))
    assert make_mesh({"data": -1, MODEL_AXIS: 1}, device="cpu").size == 1
    for bad in ({"data": 3}, {"data": -1, "model": 2}, {"rows": 1}):
        with pytest.raises(ValueError):
            make_mesh(bad, device="cpu")
    set_mesh(m)
    try:
        assert get_mesh() is m
    finally:
        set_mesh(None)


def test_cluster_summary_single_process():
    s = cluster_summary(make_mesh(device="cpu"))
    assert s["num_devices"] == 1 and s["num_hosts"] == 1 and s["process_index"] == 0


def test_pad_and_shard_single_process():
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    padded, n = pad_batch(x, 8)
    jpadded, jn = jpad_batch(x, 8)
    assert padded.shape == (16, 3) and n == 10 == jn
    np.testing.assert_array_equal(padded, jpadded)
    sharded = shard_batch(padded, make_mesh(device="cpu"))
    assert isinstance(sharded, torch.Tensor) and sharded.shape == (16, 3)
    np.testing.assert_array_equal(sharded.numpy()[:10], x)


def test_collectives_are_the_identity_without_a_group():
    x = torch.arange(4.0)
    collectives.reset_counts()
    for fn in (collectives.allreduce_sum, collectives.allreduce_mean,
               collectives.allreduce_max, collectives.all_gather, collectives.reduce_scatter,
               collectives.ring_permute, collectives.broadcast):
        np.testing.assert_array_equal(fn(x).numpy(), x.numpy())
    assert collectives.axis_index() == 0
    assert collectives.counts["calls"] == {}


def test_distributed_initialize_single_host(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_COORDINATOR", raising=False)
    distributed.initialize()  # no coordinator -> no-op
    assert distributed.is_coordinator()
    distributed.barrier()


def test_barrier_timeout_counter_increments_exactly_once_per_waiter():
    """An injected ``parallel.barrier`` delay under a tight timeout counts
    ``mmlspark_parallel_barrier_timeouts_total`` once per waiter."""
    name = "elastic-waiters-gate"

    def count() -> float:
        return obs.sum_samples(obs.parse_text(obs.render()),
                               "mmlspark_parallel_barrier_timeouts_total", {"name": name})

    before = count()
    errs: list = []

    def waiter() -> None:
        try:
            barrier(name, timeout_s=0.15)
        except BarrierTimeoutError as e:
            errs.append(e)

    with FaultPlan().on("parallel.barrier", delay_s=5.0).armed():
        threads = [threading.Thread(target=waiter) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10.0)
    assert len(errs) == 3
    assert count() - before == 3.0


def test_barrier_timeout_names_missing_host_partially_expired_roster():
    """The roster diagnosis with a partially expired roster names exactly
    the host still gone; a roster callable that itself dies gives no
    names, never a second exception. (The JAX package's case reads a
    ``DriverRegistry``, which the port has not yet: a dict with heartbeat
    times and a TTL stands in for it.)"""
    ttl = 0.4
    beats = {"host-a": time.monotonic(), "host-b": time.monotonic()}
    time.sleep(0.6)  # both expire...
    beats["host-a"] = time.monotonic()  # ...one comes back

    def live() -> list:
        return [h for h, t in beats.items() if time.monotonic() - t < ttl]

    with FaultPlan().on("parallel.barrier", delay_s=5.0).armed():
        with pytest.raises(BarrierTimeoutError) as ei:
            barrier("partial-expiry", timeout_s=0.15, expected=["host-a", "host-b"], alive=live)
    assert ei.value.missing == ["host-b"]
    assert "host-b" in str(ei.value)
    with FaultPlan().on("parallel.barrier", delay_s=5.0).armed():
        with pytest.raises(BarrierTimeoutError) as ei2:
            barrier("roster-dead", timeout_s=0.15, expected=["host-a"],
                    alive=lambda: (_ for _ in ()).throw(OSError("down")))
    assert ei2.value.missing == []


def test_sharded_build_timed_observes_its_seconds():
    """``sharded_build_timed`` records one sample a build (here one rank:
    the local plane)."""
    d = R.b4_data(64)
    bins, stats = torch.from_numpy(d["bins"]), torch.from_numpy(d["stats"])

    def samples() -> float:
        return obs.sum_samples(obs.parse_text(obs.render()),
                               "mmlspark_gbdt_hist_allreduce_seconds_count", {})

    before = samples()
    out = H.sharded_build_timed(bins, stats, None, 64)
    assert samples() - before == 1.0
    np.testing.assert_array_equal(out.numpy(), H.plane_histogram_plain(bins, stats, None, 64))


@pytest.mark.parametrize("what", [
    "GOSS", "validation", "quantile", "regression_l1", "dart", "lambdarank", "checkpoint",
    "continued", "CSR", "fused_rounds",
])
def test_multirank_refusals_name_their_roadmap_item(ranks2, what):
    """What a fit over ranks refused before A4 step 1b now runs: a small
    fit of each kind through ``train`` gives one model on every rank.
    Checkpoint/resume is still refused, with the JAX package's ValueError
    (single-process only)."""
    if what == "checkpoint":
        with pytest.raises(ValueError, match="single-process only"):
            _check_multirank(pre_binned=False, checkpointing=True)
        return
    got = [res["estimators"]["accepted"][what] for res in ranks2]
    assert got[0] and all(g == got[0] for g in got)


# -- the parallel layer over ranks ------------------------------------------


def test_collectives_over_ranks(ranks):
    world = len(ranks)
    xs = [np.arange(6, dtype=np.float32) + 10 * r for r in range(world)]
    xi = [np.arange(4 * world, dtype=np.int64) * (r + 1) for r in range(world)]
    for r, res in enumerate(ranks):
        c = res["collectives"]
        np.testing.assert_array_equal(c["sum"], np.sum(xs, 0))
        np.testing.assert_array_equal(c["mean"], np.sum(xs, 0) / world)
        np.testing.assert_array_equal(c["max"], np.max(xs, 0))
        np.testing.assert_array_equal(c["sum_i64"], np.sum(xi, 0))
        np.testing.assert_array_equal(c["gather"], np.concatenate(xs))
        np.testing.assert_array_equal(c["gather_stacked"], np.stack(xs))
        np.testing.assert_array_equal(c["reduce_scatter"], np.sum(xi, 0)[4 * r:4 * r + 4])
        np.testing.assert_array_equal(c["broadcast"], xs[-1])
        # ranks of 1, 2, ... rows: every rank's rows in rank order, no padding
        np.testing.assert_array_equal(
            c["gather_rows"], np.concatenate([np.arange(q + 1) * 10 + q for q in range(world)]))
        np.testing.assert_array_equal(
            c["gather_rows_counted"],
            np.concatenate([np.full((q + 1, 2), float(q)) for q in range(world)]))


def test_ring_permute_over_ranks(ranks):
    """Rank r receives rank r - 1's tensor (shift 1) and r + 1's (shift -1):
    ``lax.ppermute`` on a ring, as ``tests/test_parallel.py`` holds it."""
    world = len(ranks)
    for r, res in enumerate(ranks):
        c = res["collectives"]
        np.testing.assert_array_equal(c["ring"], np.arange(6) + 10 * ((r - 1) % world))
        np.testing.assert_array_equal(c["ring_back"], np.arange(6) + 10 * ((r + 1) % world))


def test_shard_apply_and_placement_over_ranks(ranks):
    world = len(ranks)
    per = 8 // world
    for r, res in enumerate(ranks):
        c = res["collectives"]
        # each rank's block summed, all-reduced, gathered back: 8 everywhere
        np.testing.assert_array_equal(c["shard_sum"], np.full(world, 8.0))
        np.testing.assert_array_equal(
            c["shard_mapped"][:, 0], np.repeat(6.0 + np.arange(world), per))
        np.testing.assert_array_equal(
            c["shard_batch"], np.arange(24, dtype=np.float32).reshape(8, 3)[r * per:(r + 1) * per])
        np.testing.assert_array_equal(c["multihost"], np.full(r + 1, r))
        assert c["pad_target"] == world
        np.testing.assert_array_equal(c["replicate"], np.full(3, 7.0))


def test_mesh_and_barrier_over_ranks(ranks):
    world = len(ranks)
    for r, res in enumerate(ranks):
        c = res["collectives"]
        assert c["mesh_shape"] == {"data": world} and c["axis_index"] == r
        assert c["is_coordinator"] == (r == 0)
        assert c["bad_shapes_raise"] == [True, True]
        s = c["summary"]
        assert (s["num_devices"], s["num_hosts"], s["process_index"]) == (world, 1, r)
        assert s["platform"] == "cpu" and sorted(s["host_devices"]) == [str(i) for i in range(world)]


def test_collective_counters_over_ranks(ranks):
    c = ranks[0]["collectives"]["counts"]
    assert c["calls"]["ring_permute"] == 2 and c["elements"]["ring_permute"] == 12
    assert c["calls"]["reduce_scatter"] == 1
    assert c["bytes"]["reduce_scatter"] == 4 * len(ranks) * 8
    for op, n in c["elements"].items():
        assert c["bytes"][op] >= n > 0


# -- B4: the distributed histogram builds ------------------------------------


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("kind", ["plane", "masked", "multi", "leaf"])
def test_b4_equals_one_rank_bitwise(ranks, B, kind):
    """Every rank's plane (cube, leaf sums) at 2 and 4 ranks, with the
    rows split 1:2(:3:4) and one column maximum on the last rank only, is
    bit for bit the build of one rank on all the rows."""
    want = ranks[0]["b4"][f"{kind}{B}_w1"]
    for res in ranks:
        np.testing.assert_array_equal(_bits(res["b4"][f"{kind}{B}"]), _bits(want))
    if kind == "masked":
        np.testing.assert_array_equal(_bits(want), _bits(ranks[0]["b4"][f"masked{B}_emulated"]))
    np.testing.assert_array_equal(_bits(ranks[0]["b4"][f"timed{B}"]),
                                  _bits(ranks[0]["b4"][f"plane{B}"]))


def _close_to_jax(got: np.ndarray, want: np.ndarray, stats: np.ndarray) -> None:
    got, want = got.astype(np.float64), np.asarray(want, np.float64).reshape(got.shape)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    for j in (0, 1):
        atol = HIST_TOL * float(np.abs(stats[:, j]).sum())
        assert float(np.abs(got[..., j] - want[..., j]).max()) <= atol


@pytest.mark.parametrize("B", [64, 256])
def test_b4_against_jax_sharded_builds(ranks, jax_mesh, B):
    """Against ``_plane_histogram_shard_map`` (via ``plane_histogram(mesh=...)``)
    and ``multi_plane_histogram(mesh=...)`` on a CPU mesh of as many
    devices as ranks."""
    world = len(ranks)
    mesh = jax_mesh(world)
    d = R.b4_data(B)
    b4 = ranks[0]["b4"]
    plane = JH.plane_histogram(jnp.asarray(d["bins"]), jnp.asarray(d["stats"]), None, B,
                               mesh=mesh, shard_axis="data")
    masked = JH.plane_histogram(jnp.asarray(d["bins"]), jnp.asarray(d["stats"]),
                                jnp.asarray(d["mask"]), B, mesh=mesh, shard_axis="data")
    multi = JH.multi_plane_histogram(jnp.asarray(d["bins"]), jnp.asarray(d["stats"]),
                                     jnp.asarray(d["slot"]), R.B4_S, B, mesh=mesh,
                                     shard_axis="data")
    _close_to_jax(b4[f"plane{B}"], plane, d["stats"])
    _close_to_jax(b4[f"masked{B}"], masked, d["stats"] * d["mask"][:, None])
    ok = (d["slot"] >= 0) & (d["slot"] < R.B4_S)
    _close_to_jax(b4[f"multi{B}"], multi, d["stats"] * ok[:, None])


# -- the growers over ranks ----------------------------------------------------


@pytest.mark.parametrize("policy", ["lossguide", "depthwise", "lossguide_cat", "depthwise_cat"])
def test_growers_over_ranks_equal_one_rank(ranks, policy):
    """``grow_tree`` and ``grow_tree_depthwise`` given each rank's block of
    the same bins and gradients (split 1:2(:3:4)): split records and leaf
    values bitwise the one-rank call on all the rows, on every rank; each
    rank's ``row_leaf`` is its block of the one-rank ``row_leaf``."""
    world = len(ranks)
    want = ranks[0]["growers"][f"{policy}_w1"]
    assert want["rec_active"].sum() > 0
    for r, res in enumerate(ranks):
        got = res["growers"][policy]
        assert sorted(got) == sorted(want)
        for field, v in got.items():
            w = want[field][R.blocks(R.GROW_N, world, uneven=True)[r]] if field == "row_leaf" \
                else want[field]
            np.testing.assert_array_equal(v, w, err_msg=field)


# -- binning, the estimator, VW ------------------------------------------------


def test_multirank_binning_equals_jax_mapper(ranks):
    """The all-gathered NaN-padded sample, built as the JAX package's
    multi-process branch builds it, fitted by the JAX ``BinMapper``."""
    world = len(ranks)
    x = R.bin_data()
    k_s = max(1, 50_000 // world)
    parts = []
    gmax = np.nanmax(x[:, 3])
    for blk in R.blocks(R.BIN_N, world, uneven=True):
        xr = x[blk]
        samp = np.full((k_s, R.BIN_D), np.nan, np.float32)
        take = np.random.default_rng(4).choice(len(xr), min(len(xr), k_s), replace=False)
        samp[: len(take)] = xr[take]
        samp[0, 3] = gmax
        parts.append(samp)
    want = JBinMapper.fit(np.concatenate(parts), max_bin=63, seed=4, categorical_features=R.BIN_CAT)
    for res in ranks:
        got = res["binning"]["uppers"]
        assert len(got) == len(want.uppers)
        for g, w in zip(got, want.uppers):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("fit", ["lossguide", "depthwise", "bagged", "rf"])
def test_estimator_models_equal_across_ranks_and_worlds(ranks2, ranks4, fit):
    """``LightGBMClassifier.fit`` on integer columns (every mapper gives the
    same bounds): the model strings of every rank at 2 and at 4 ranks are
    byte-equal. (One rank takes the one-device path, which on the CPU sums
    in f32; the card's one-device path sums in fixed point like this one,
    and ``chip_smoke.py`` holds two ranks against it there.)"""
    want = ranks2[0]["estimators"][fit]
    for res in ranks2 + ranks4:
        assert res["estimators"][fit] == want


@pytest.mark.parametrize("fit", ["voting", "multiclass", "regression"])
def test_estimator_models_equal_across_ranks(ranks, fit):
    """Voting (whose votes depend on how the rows are split), multiclass
    and regression fits: one model on every rank."""
    got = [res["estimators"].get(fit) for res in ranks]
    if got[0] is None:
        assert len(ranks) == 4  # multiclass and regression run at two ranks
        return
    assert all(g == got[0] for g in got)


def test_estimator_refusals_over_ranks(ranks2):
    """The estimator fits the port refused over ranks before A4 step 1b
    (goss, dart, fused_rounds > 1, quantile) run, and every rank gets one
    model."""
    ran = [res["estimators"]["ran"] for res in ranks2]
    assert sorted(ran[0]) == ["dart", "fused", "goss", "quantile"]
    for what in ran[0]:
        assert ran[0][what] and all(r[what] == ran[0][what] for r in ran)


@pytest.mark.parametrize("loss", ["squared", "hinge"])
def test_vw_per_pass_mean_against_jax(ranks, jax_mesh, loss):
    """``train_sparse_sgd`` over ranks, each on its block, against the JAX
    package's ``distributed=True`` program on a mesh of as many devices
    over the same blocks (its shards: the blocks are whole minibatches)."""
    world = len(ranks)
    jax_mesh(world)
    d = R.vw_data()
    y = d["y"] if loss == "squared" else np.where(d["y"] > 0, 1.0, -1.0).astype(np.float32)
    want = np.asarray(JL.train_sparse_sgd(
        d["idx"], d["val"], y, d["wt"], R.VW_BITS, loss=loss, num_passes=R.VW_PASSES,
        batch=R.VW_BATCH, distributed=True))
    for res in ranks:
        got = res["vw"][loss]
        np.testing.assert_array_equal(got, ranks[0]["vw"][loss])
        if loss == "squared" and world == 2:
            np.testing.assert_array_equal(_bits(got), _bits(want))
        else:
            assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())
