"""The port's CUDA kernels, GBDT, the pipeline compiler and serving on the card.

Every test here is marked ``cuda`` and skips, inside a fixture, without a
CUDA device. The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch; there, skip the JAX test harness's
conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_port_cuda.py

Tolerance: counts exact (integer row weights; fractional weights are held
like g and h); g and h within 1e-5 * sum_r |stats[r, j]| of the
plain PyTorch version (f32 sums against the kernels' fixed-point sums). Each
kernel must also give a bitwise-equal output when run twice, and equal its
PyTorch emulation (``*_emulated``: the same int64 arithmetic) bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.metrics import binary_auc
from mmlspark_tpu_torch.models.gbdt import TrainConfig, train
from mmlspark_tpu_torch.ops import histogram as PH

TOL = 1e-5
DATA_DIR = os.path.join(os.path.dirname(__file__), "resources", "data")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU body")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def masked_cpu_references(monkeypatch):
    """The CPU fits this file holds the card against are the masked growers
    on the plain versions (``MMLSPARK_TPU_HIST_HOST=0``, the JAX package's
    switch), not the CPU's default host growers; the card is unaffected."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")


def _inputs(n, d, B, seed):
    g = torch.Generator().manual_seed(seed)
    bins = torch.randint(-3, B + 3, (n, d), generator=g, dtype=torch.int32)
    stats = torch.stack(
        [torch.randn(n, generator=g), torch.rand(n, generator=g) * 0.25 + 0.01,
         torch.ones(n)], 1,
    )
    return bins, stats


def _assert_close(got, want, stats, integer_counts=True):
    got, want = got.double().cpu(), want.double().cpu()
    if integer_counts:
        assert torch.equal(got[..., 2], want[..., 2])
    for j in (0, 1) if integer_counts else (0, 1, 2):
        atol = TOL * float(stats[:, j].abs().sum())
        assert float((got[..., j] - want[..., j]).abs().max()) <= atol


def _bits(t):
    return t.contiguous().view(torch.int32).cpu()


def _check_plane(b, s, m, B, integer_counts=True):
    """Twice bitwise, equal to the emulation bitwise, close to the plain sum
    (counts exactly, when the row weights are integers)."""
    a = PH.plane_hist(b, s, m, B)
    a2 = PH.plane_hist(b, s, m, B)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(a2))
    assert torch.equal(_bits(a), _bits(PH.plane_histogram_emulated(b, s, m, B)))
    pre = s if m is None else s * m[:, None]
    if bool(pre.isfinite().all()):
        _assert_close(a, PH.plane_histogram_plain(b, s, m, B), pre.cpu(), integer_counts)
    return a


def _check_multi(b, s, sl, S, B, integer_counts=True):
    a = PH.multi_plane_hist(b, s, sl, S, B)
    a2 = PH.multi_plane_hist(b, s, sl, S, B)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(a2))
    assert torch.equal(_bits(a), _bits(PH.multi_plane_histogram_emulated(b, s, sl, S, B)))
    kept = torch.where(((sl >= 0) & (sl < S))[:, None], s, 0.0)
    _assert_close(a, PH.multi_plane_histogram_plain(b, s, sl, S, B), kept.cpu(), integer_counts)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("bin_dtype", [torch.int32, torch.uint8])
def test_plane_hist_matches_plain_and_is_deterministic(cuda_device, B, bin_dtype):
    bins, stats = _inputs(20_000, 9, B, seed=B)
    if bin_dtype == torch.uint8:
        bins = bins.clamp(0, 255).to(torch.uint8)
    mask = (torch.rand(20_000, generator=torch.Generator().manual_seed(1)) < 0.5).float()
    b, s, m = bins.to(cuda_device), stats.to(cuda_device), mask.to(cuda_device)
    _check_plane(b, s, m, B)
    _check_plane(b, s, None, B)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 16, 32, 64, 100])
def test_multi_plane_hist_matches_plain_and_is_deterministic(cuda_device, S):
    bins, stats = _inputs(20_000, 5, 256, seed=S)
    slot = torch.randint(-1, S + 2, (20_000,), generator=torch.Generator().manual_seed(S),
                         dtype=torch.int32)
    b, s, sl = bins.to(cuda_device), stats.to(cuda_device), slot.to(cuda_device)
    _check_multi(b, s, sl, S, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [0.03, 0.0, 1.0])
@pytest.mark.parametrize("d", [64, 33, 9])
def test_plane_hist_sparse_and_empty_masks(cuda_device, keep, d):
    """uint8 bins at the training layout; d not a multiple of the block's
    features (33: a group of 32 and one of 1; 9: one narrow group)."""
    bins, stats = _inputs(30_000, d, 256, seed=d)
    bins = bins.clamp(0, 255).to(torch.uint8)
    mask = (torch.rand(30_000, generator=torch.Generator().manual_seed(d)) < keep).float()
    a = _check_plane(bins.to(cuda_device), stats.to(cuda_device), mask.to(cuda_device), 256)
    if keep == 0.0:
        assert not bool(a.any())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 16, 64, 100])
def test_multi_plane_hist_uint8_with_dropped_rows(cuda_device, S):
    """The depthwise grower's call: uint8 bins, about half the rows dropped
    (slot S), the rest spread over S slots; slots below 0 drop too."""
    bins, stats = _inputs(30_000, 64, 256, seed=3 * S)
    bins = bins.clamp(0, 255).to(torch.uint8)
    g = torch.Generator().manual_seed(S)
    slot = torch.randint(0, S, (30_000,), generator=g, dtype=torch.int32)
    slot = torch.where(torch.rand(30_000, generator=g) < 0.5, slot, S)
    slot[::97] = -1
    _check_multi(bins.to(cuda_device), stats.to(cuda_device), slot.to(cuda_device), S, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("bin_dtype", [torch.uint8, torch.int32])
def test_one_bin_feature_and_large_mixed_sign_stats(cuda_device, bin_dtype):
    """Every row of feature 3 in one bin (every atomic of that feature on
    one cell); g large and of both signs; fractional row weights in the
    count column (as treegrow's row_weight puts them there)."""
    g = torch.Generator().manual_seed(9)
    bins = torch.randint(0, 64, (40_000, 40), generator=g, dtype=torch.int32)
    bins[:, 3] = 17
    w = torch.rand(40_000, generator=g) * 2.0
    stats = torch.stack([torch.randn(40_000, generator=g) * 1e6 * w,
                         torch.rand(40_000, generator=g) * w, w], 1)
    b, s = bins.to(bin_dtype).to(cuda_device), stats.to(cuda_device)
    a = _check_plane(b, s, None, 64, integer_counts=False)
    plane = a.view(40, 64, 3)
    assert int((plane[3, :, 2] != 0).sum()) == 1
    sl = torch.randint(0, 4, (40_000,), generator=g, dtype=torch.int32).to(cuda_device)
    _check_multi(b, s, sl, 4, 64, integer_counts=False)


def _f64_cells(bins, v, B, slot=None, S=1):
    """Exact (f64) per-cell sums of v: (S * d * B, 3)."""
    b = bins.cpu().numpy().astype(np.int64)
    v = v.cpu().numpy().astype(np.float64)
    n, d = b.shape
    sl = np.zeros(n, np.int64) if slot is None else slot.cpu().numpy().astype(np.int64)
    out = np.zeros((S, d, B, 3))
    for f in range(d):
        ok = (sl >= 0) & (sl < S) & (b[:, f] >= 0) & (b[:, f] < B)
        np.add.at(out, (sl[ok], f, b[ok, f]), v[ok])
    return out.reshape(-1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plane", "multi"])
def test_wide_range_column_keeps_f32_accuracy(cuda_device, kind):
    """One row with |g| = 1e6 among 200,000 rows of |g| ~ 1e-3: every cell
    within f32's own summation error of the exact sum, rows * 2^-24 *
    sum |v|, the small-valued cells too; bitwise equal to the emulation."""
    n, d, B, S = 200_000, 8, 64, 4
    g = torch.Generator().manual_seed(13)
    bins = torch.randint(0, B, (n, d), generator=g, dtype=torch.int32).to(torch.uint8)
    stats = torch.stack([torch.randn(n, generator=g) * 1e-3,
                         (torch.rand(n, generator=g) * 0.24 + 0.01) * 1e-3, torch.ones(n)], 1)
    stats[n // 3, :2] = torch.tensor([-1e6, 2.5e5])
    b, s = bins.to(cuda_device), stats.to(cuda_device)
    if kind == "multi":
        slot = torch.randint(-1, S + 1, (n,), generator=g, dtype=torch.int32)
        got = _check_multi(b, s, slot.to(cuda_device), S, B).reshape(-1, 3)
        exact = _f64_cells(bins, stats, B, slot, S)
        sum_abs = _f64_cells(bins, stats.abs(), B, slot, S)
    else:
        got = _check_plane(b, s, None, B)
        exact, sum_abs = _f64_cells(bins, stats, B), _f64_cells(bins, stats.abs(), B)
    got = got.double().cpu().numpy()
    assert np.array_equal(got[:, 2], exact[:, 2])
    for j in (0, 1):
        bound = exact[:, 2] * 2.0 ** -24 * sum_abs[:, j]
        assert np.all(np.abs(got[:, j] - exact[:, j]) <= bound)


@pytest.mark.cuda
def test_nan_gradient_reaches_the_output(cuda_device):
    bins, stats = _inputs(10_000, 8, 64, seed=5)
    bins = bins.clamp(0, 63)
    stats[123, 0] = float("nan")
    b, s = bins.to(cuda_device), stats.to(cuda_device)
    a = _check_plane(b, s, None, 64)
    assert bool(a[:, 0].isnan().all()) and bool(a[:, 1:].isfinite().all())
    slot = torch.zeros(10_000, dtype=torch.int32)
    slot[123] = -1  # the NaN row dropped: the output stays finite
    m = _check_multi(b, s, slot.to(cuda_device), 1, 64)
    assert bool(m.isfinite().all())


@pytest.mark.cuda
def test_leaf_stat_sums_launches_plane_hist(cuda_device):
    g = torch.Generator().manual_seed(4)
    leaf = torch.randint(0, 63, (5000,), generator=g, dtype=torch.int32)
    stats = torch.cat([torch.randn(5000, 2, generator=g), torch.ones(5000, 1)], 1)
    before = PH.launches["plane_hist"]
    got = PH.leaf_stat_sums(leaf.to(cuda_device), stats.to(cuda_device), 63)
    torch.cuda.synchronize()
    assert PH.launches["plane_hist"] == before + 1
    _assert_close(got, PH.leaf_stat_sums(leaf, stats, 63), stats)
    want = PH.plane_histogram_emulated(leaf[:, None].to(cuda_device), stats.to(cuda_device), None, 63)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("B,keep,S", [(64, None, None), (256, None, None), (256, 0.3, None),
                                      (64, None, 16), (256, None, 5)])
def test_fixed_scale_entries_equal_their_plain_version_bitwise(cuda_device, B, keep, S):
    """The distributed entries (B4): the int64 cells at a given scale equal
    the same fixed-point arithmetic in PyTorch on the card, bit for bit;
    at the scale of all the rows, rounded to f32 they are ``plane_hist`` /
    ``multi_plane_hist`` of the same call; each launch counts once."""
    n, d = 30_000, 12
    bins, stats = _inputs(n, d, B, seed=B + (S or 0))
    b, st = bins.to(cuda_device), stats.to(cuda_device)
    g = torch.Generator().manual_seed(9)
    if S is None:
        mask = None if keep is None else (torch.rand(n, generator=g) < keep).float().to(cuda_device)
        v = st if mask is None else st * mask[:, None]
        k, fin = PH._fixed_scale(v, n)
        scale = torch.cat([k, fin.long()])
        before = PH.launches["plane_hist_fixed"]
        got = PH.plane_hist_fixed(b, st, mask, B, scale)
        assert PH.launches["plane_hist_fixed"] == before + 1
        want = PH._fixed_sums(b, v, k, fin, B, None, d * B)
        one = PH.plane_hist(b, st, mask, B)
    else:
        slot = torch.randint(-1, S + 2, (n,), generator=g, dtype=torch.int32).to(cuda_device)
        ok, base = PH._slot_base(b, slot, S, B)
        k, fin = PH._fixed_scale(st[ok], n)
        scale = torch.cat([k, fin.long()])
        before = PH.launches["multi_plane_hist_fixed"]
        got = PH.multi_plane_hist_fixed(b, st, slot, S, B, scale)
        assert PH.launches["multi_plane_hist_fixed"] == before + 1
        want = PH._fixed_sums(b, st, k, fin, B, base, S * d * B).view(S, d * B, 3)
        one = PH.multi_plane_hist(b, st, slot, S, B)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert torch.equal(_bits(PH.from_fixed(got, scale)), _bits(one))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [None, 16])
def test_feature_blocks_equal_the_whole_plane_bitwise(cuda_device, S):
    """The gang's pipeline (``feature_blocks(64)``: four contiguous copies
    of 16 bin columns) at the build's one scale: the blocks' int64 cells,
    joined along the feature axis, are the whole-plane call's bit for bit,
    and each block is one launch."""
    n, d, B = 200_000, 64, 256
    g = torch.Generator().manual_seed(31)
    b = torch.randint(0, B, (n, d), generator=g, dtype=torch.int32).to(torch.uint8).to(cuda_device)
    st = torch.stack([torch.randn(n, generator=g), torch.rand(n, generator=g) + 0.01,
                      torch.ones(n)], 1).to(cuda_device)
    blocks = PH.feature_blocks(d)
    assert blocks == [(0, 16), (16, 32), (32, 48), (48, 64)]
    if S is None:
        k, fin = PH._fixed_scale(st, n)
        scale = torch.cat([k, fin.long()])

        def cells(bb):
            return PH.plane_hist_fixed(bb, st, None, B, scale)
        kernel, axis = "plane_hist_fixed", 0
    else:
        slot = torch.randint(-1, S + 1, (n,), generator=g, dtype=torch.int32).to(cuda_device)
        ok, _ = PH._slot_base(b, slot, S, B)
        k, fin = PH._fixed_scale(st[ok], n)
        scale = torch.cat([k, fin.long()])

        def cells(bb):
            return PH.multi_plane_hist_fixed(bb, st, slot, S, B, scale)
        kernel, axis = "multi_plane_hist_fixed", 1
    whole = cells(b)
    before = PH.launches[kernel]
    parts = torch.cat([cells(b[:, lo:hi].contiguous()) for lo, hi in blocks], axis)
    torch.cuda.synchronize()
    assert PH.launches[kernel] == before + 4
    assert torch.equal(parts, whole)


@pytest.mark.cuda
def test_nccl_collectives_leave_their_input_alone(cuda_device, tmp_path):
    """NCCL reduces in place: every collective hands it a copy, so the
    result is a new tensor and the caller's input keeps its values (a
    one-rank NCCL group on the card)."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import collectives

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        assert dist.get_backend() == "nccl"
        for op in (collectives.allreduce_sum, collectives.allreduce_mean,
                   collectives.allreduce_max, collectives.broadcast):
            x = torch.arange(12, dtype=torch.float32, device=cuda_device)
            keep = x.clone()
            out = op(x)
            torch.cuda.synchronize()
            assert out.data_ptr() != x.data_ptr(), op.__name__
            assert torch.equal(out, keep), op.__name__
            out.add_(1)
            torch.cuda.synchronize()
            assert torch.equal(x, keep), op.__name__
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_fixed_scale_entries_refuse_a_bad_scale(cuda_device):
    b = torch.zeros(10, 2, dtype=torch.int32, device=cuda_device)
    s = torch.zeros(10, 3, device=cuda_device)
    with pytest.raises(TypeError):
        PH.plane_hist_fixed(b, s, None, 16, torch.zeros(6, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        PH.plane_hist_fixed(b, s, None, 16, torch.zeros(3, dtype=torch.int64, device=cuda_device))


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda_device):
    b = torch.zeros(10, 2, dtype=torch.int64, device=cuda_device)
    s = torch.zeros(10, 3, device=cuda_device)
    with pytest.raises(TypeError):
        PH.plane_hist(b, s, None, 16)
    with pytest.raises(ValueError):
        PH.plane_hist(b.int(), s[:, :2].contiguous(), None, 16)
    with pytest.raises(ValueError):
        PH.plane_hist(b.int().t(), s, None, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["lossguide", "depthwise"])
def test_training_on_the_card_tracks_the_cpu(cuda_device, policy):
    """Card and CPU sum histograms in different orders, so near-tie splits
    may differ; the fitted models must score the same to 0.005 AUC."""
    a = np.loadtxt(os.path.join(DATA_DIR, "breast_cancer.csv"), delimiter=",", skiprows=1)
    x, y = a[:, :-1].astype(np.float32), a[:, -1]
    cfg = TrainConfig(num_iterations=20, num_leaves=15, min_data_in_leaf=5,
                      growth_policy=policy)
    PH.reset_launch_counts()
    gpu = train(x, y, cfg, device=cuda_device)
    kernel = "plane_hist" if policy == "lossguide" else "multi_plane_hist"
    assert PH.launches[kernel] > 0
    cpu = train(x, y, cfg, device="cpu")
    auc_gpu = binary_auc(y, gpu.predict_raw(x, device=cuda_device))
    auc_cpu = binary_auc(y, cpu.predict_raw(x, device="cpu"))
    assert abs(auc_gpu - auc_cpu) <= 0.005


@pytest.mark.cuda
def test_host_switch_refuses_a_card_fit(cuda_device, monkeypatch):
    """``MMLSPARK_TPU_HIST_HOST=1`` never moves a card fit to the host: the
    fit and the builders raise, naming device='cpu'; unset, the card fit
    runs its kernels and nothing of it takes the host lowering."""
    from mmlspark_tpu_torch.models.gbdt import hostgrow

    x, y = _breast_cancer()
    cfg = TrainConfig(num_iterations=3, num_leaves=15, min_data_in_leaf=5)
    b = torch.zeros(10, 2, dtype=torch.uint8, device=cuda_device)
    s = torch.zeros(10, 3, device=cuda_device)
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "1")
    with pytest.raises(ValueError, match="device='cpu'"):
        train(x, y, cfg, device=cuda_device)
    with pytest.raises(ValueError, match="device='cpu'"):
        PH.plane_histogram(b, s)
    monkeypatch.delenv("MMLSPARK_TPU_HIST_HOST")

    def refuse(*a, **k):
        raise AssertionError("a card fit reached the host lowering")

    for name in ("grow_lossguide", "grow_depthwise"):
        monkeypatch.setattr(hostgrow, name, refuse)
    monkeypatch.setattr(PH, "_host_plane_kernel", refuse)
    monkeypatch.setattr(PH, "_host_multi_kernel", refuse)
    for policy, kernel in (("lossguide", "plane_hist"), ("depthwise", "multi_plane_hist")):
        PH.reset_launch_counts()
        train(x, y, TrainConfig(num_iterations=3, num_leaves=15, min_data_in_leaf=5,
                                growth_policy=policy), device=cuda_device)
        assert PH.launches[kernel] > 0
    assert PH.hist_lowering(cuda_device) == "cuda"


# -- boosting types and objectives on the card ---------------------------------


def _breast_cancer():
    a = np.loadtxt(os.path.join(DATA_DIR, "breast_cancer.csv"), delimiter=",", skiprows=1)
    return a[:, :-1].astype(np.float32), a[:, -1]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["goss", "bagging", "dart"])
def test_same_seed_fits_are_byte_identical_on_the_card(cuda_device, mode):
    """The card's draws are seeded from (seed, round, stream) and every
    kernel is deterministic, so a fit repeats byte for byte; another seed
    draws other rows."""
    x, y = _breast_cancer()
    kw = dict(num_iterations=15, num_leaves=15, min_data_in_leaf=5, seed=11)
    if mode == "bagging":
        kw.update(bagging_fraction=0.7, bagging_freq=1)
    else:
        kw.update(boosting_type=mode, drop_rate=0.3, skip_drop=0.2)
    a = train(x, y, TrainConfig(**kw), device=cuda_device).to_model_string()
    assert train(x, y, TrainConfig(**kw), device=cuda_device).to_model_string() == a
    if mode != "dart":  # dart's draws are host draws, seeded alike
        kw["seed"] = 12
        assert train(x, y, TrainConfig(**kw), device=cuda_device).to_model_string() != a


@pytest.mark.cuda
def test_goss_weights_and_quantile_renewal_equal_the_cpu(cuda_device):
    from mmlspark_tpu_torch.models.gbdt import objectives as PO
    from mmlspark_tpu_torch.models.gbdt import sampling as PS

    g = torch.Generator().manual_seed(21)
    n, L = 200_000, 63
    g_abs = torch.round(torch.rand(n, generator=g) * 50) / 10     # many ties
    w = (torch.rand(n, generator=g) < 0.9).float()
    u = torch.rand(n, generator=g)
    for top, other in ((0.2, 0.1), (0.05, 0.3)):
        cpu = PS.goss_weights(g_abs, w, u, top, other)
        gpu = PS.goss_weights(g_abs.to(cuda_device), w.to(cuda_device), u.to(cuda_device),
                              top, other)
        assert torch.equal(gpu.cpu(), cpu)
    leaf = torch.randint(0, L - 1, (n,), generator=g, dtype=torch.int32)
    resid = torch.round(torch.randn(n, generator=g) * 10) / 10
    wq = torch.randint(0, 3, (n,), generator=g).float() * 0.75
    for alpha in (0.5, 0.9):
        a = torch.tensor(alpha)
        cpu = PO.leaf_quantile_renewal(leaf, resid, wq, L, a)
        gpu = PO.leaf_quantile_renewal(leaf.to(cuda_device), resid.to(cuda_device),
                                       wq.to(cuda_device), L, a.to(cuda_device))
        assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.cuda
def test_device_auc_and_ndcg_equal_the_cpu(cuda_device):
    """f32 sums in another order on the card: equal to 1e-6 relative; the
    device NDCG equals the host one to 1e-5."""
    from mmlspark_tpu_torch.models.gbdt import evaluation as PE
    from mmlspark_tpu_torch.models.gbdt import objectives as PO

    rng = np.random.default_rng(5)
    n = 100_000
    s = np.round(rng.normal(size=n), 2).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    vw = (rng.random(n) < 0.5).astype(np.float32)
    t = [torch.from_numpy(a) for a in (s, y, vw)]
    cpu = float(PE.device_metric(*t, "auc"))
    gpu = float(PE.device_metric(*[a.to(cuda_device) for a in t], "auc"))
    assert gpu == pytest.approx(cpu, rel=1e-6)
    assert cpu == pytest.approx(binary_auc(y[vw > 0], s[vw > 0]), rel=1e-5)
    groups = np.repeat(np.arange(n // 20), 20)
    rel = rng.integers(0, 5, n).astype(np.float32)
    pi, va = PO.lambdarank_pad_groups(groups)
    args = [torch.from_numpy(a) for a in (s, rel, pi, va)]
    cpu = float(PO.grouped_ndcg_device(*args, k=5))
    gpu = float(PO.grouped_ndcg_device(*[a.to(cuda_device) for a in args], k=5))
    assert gpu == pytest.approx(cpu, rel=1e-6)
    assert cpu == pytest.approx(PO.grouped_ndcg(s, rel, groups, k=5), rel=1e-5)
    gc, hc = PO.lambdarank_grad_hess_device(*args)
    gg, hg = PO.lambdarank_grad_hess_device(*[a.to(cuda_device) for a in args])
    torch.testing.assert_close(gg.cpu(), gc, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(hg.cpu(), hc, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["quantile", "poisson", "lambdarank"])
def test_objectives_on_the_card_track_the_cpu(cuda_device, objective):
    """Early-stopped fits on the card and the CPU reach validation metrics
    within 2% of each other (histograms summed in another order)."""
    rng = np.random.default_rng(6)
    n = 20_000
    x = rng.normal(size=(n, 8)).astype(np.float32)
    mean = np.exp(0.5 * x[:, 0] + 0.3 * x[:, 1] * x[:, 2])
    y = rng.poisson(mean).astype(np.float64)
    groups = None
    if objective == "lambdarank":
        y = np.digitize(x[:, 0] + 0.5 * x[:, 1], [-1.0, 0.0, 1.0, 2.0]).astype(np.float64)
        groups = np.repeat(np.arange(n // 20), 20)
    valid = np.arange(n) % 5 == 0
    cfg = TrainConfig(objective=objective, num_iterations=40, num_leaves=15,
                      early_stopping_round=5, learning_rate=0.2)
    base = float(np.log(y.mean())) if objective == "poisson" else 0.0
    PH.reset_launch_counts()
    gpu = train(x, y, cfg, valid_mask=valid, group_ids=groups, base_score=base,
                device=cuda_device)
    assert PH.launches["plane_hist"] > 0
    cpu = train(x, y, cfg, valid_mask=valid, group_ids=groups, base_score=base, device="cpu")
    (name, vg), = gpu.evals.items()
    vc = cpu.evals[name]
    best = max if objective == "lambdarank" else min
    assert best(vg) == pytest.approx(best(vc), rel=0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4097, 200_000])
def test_threefry_draws_on_the_card_equal_the_cpu(cuda_device, n):
    """Integer arithmetic on int64 tensors: the card's draw is the CPU's,
    bit for bit (the CPU's is JAX's, ``tests/test_torch_port_sampling.py``)."""
    from mmlspark_tpu_torch.models.gbdt import sampling as PS

    for seed, it, stream in ((0, 0, 1), (7, 13, 2), (-12345, 999, 1)):
        gpu = PS.uniform(seed, it, stream, n, cuda_device)
        cpu = PS.uniform(seed, it, stream, n, torch.device("cpu"))
        assert gpu.device.type == "cuda"
        assert torch.equal(gpu.cpu().view(torch.int32), cpu.view(torch.int32))


def _categorical_data(n, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 10)).astype(np.float32)
    levels = (4, 16, 64, 253)
    for j, lv in enumerate(levels):
        x[:, 6 + j] = rng.integers(0, lv, n)
    x[rng.random(n) < 0.03, 9] = np.nan
    e = rng.normal(size=253)
    y = (x[:, 0] + x[:, 1] * x[:, 2] + np.nan_to_num(e[np.nan_to_num(x[:, 9]).astype(int)])
         > 0).astype(np.float64)
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("policy,kernel", [("lossguide", "plane_hist"),
                                           ("depthwise", "multi_plane_hist")])
def test_categorical_fit_and_text_round_trip_on_the_card(cuda_device, policy, kernel):
    """A categorical fit on the card launches its histogram kernel, holds
    categorical splits, tracks the CPU's held-out AUC within 0.01, and its
    JSON and LightGBM-text round trips score bitwise equal on the card,
    unseen, NaN and out-of-range categories included."""
    from mmlspark_tpu_torch.models.gbdt import Booster

    x, y = _categorical_data(24_000)
    xt, yt = x[20_000:], y[20_000:]
    x, y = x[:20_000], y[:20_000]
    cfg = TrainConfig(num_iterations=10, num_leaves=31, growth_policy=policy,
                      categorical_features=(6, 7, 8, 9))
    PH.reset_launch_counts()
    gpu = train(x, y, cfg, device=cuda_device)
    assert PH.launches[kernel] > 0
    assert any(t.has_categorical for t in gpu.trees)
    cpu = train(x, y, cfg, device="cpu")
    auc_g = binary_auc(yt, gpu.predict_raw(xt, device=cuda_device))
    auc_c = binary_auc(yt, cpu.predict_raw(xt, device="cpu"))
    assert auc_g > 0.8 and abs(auc_g - auc_c) < 0.01
    odd = xt[:12].copy()
    odd[:, 9] = [np.nan, 300, -1, 1e30, -1e30, np.inf, -np.inf, 252.6, 253, 254, 0.4, 2.5]
    rows = np.concatenate([xt, odd])
    want = gpu.predict_raw(rows, device=cuda_device)
    for back in (Booster.from_model_string(gpu.to_model_string()),
                 Booster.from_lightgbm_string(gpu.to_lightgbm_string())):
        got = back.predict_raw(rows, device=cuda_device)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(gpu.predict_leaf(rows, device=cuda_device),
                                  gpu.predict_leaf(rows, device="cpu"))


# -- image featurization on the card --------------------------------------------
#
# The card against the port's own CPU result (this machine has no JAX).
# Float32 runs with TF32 off for both convolutions and matrix products
# (``no_tf32``): every output within 1e-3 * max |cpu| (cuDNN's float32
# algorithms sum in other orders, Winograd and FFT included). bf16 on the
# card against float32 on the CPU: relative L2 <= 3e-2 per output (a
# ResNet-50 at 224 stays under 1e-2, chip_smoke.py phase featurizer).

CARD_F32_REL = 1e-3
CARD_BF16_L2 = 3e-2


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _perturbed_resnet_vars(module, seed):
    """A seeded init with every leaf moved by a numpy draw (the last batch
    norm of a block starts at 0 and would hide the convs behind it)."""
    from mmlspark_tpu_torch.models import resnet as TR

    rng = np.random.default_rng(seed)

    def move(tree, key=None):
        if isinstance(tree, dict):
            return {k: move(x, k) for k, x in tree.items()}
        a = tree + rng.normal(size=tree.shape).astype(np.float32) * 0.1 * (np.abs(tree).mean() + 0.1)
        return np.abs(a) + 0.5 if key == "var" else a

    return move(TR.init_flax_variables(module, seed))


def _assert_card_close(card: dict, cpu: dict, f32: bool):
    assert list(card) == list(cpu)
    for k in cpu:
        a, b = cpu[k].float().numpy(), card[k].float().cpu().numpy()
        assert b.shape == a.shape and np.isfinite(b).all(), k
        if f32:
            assert float(np.abs(a - b).max()) <= CARD_F32_REL * float(np.abs(a).max()), k
        else:
            assert float(np.linalg.norm(a - b) / np.linalg.norm(a)) <= CARD_BF16_L2, k


@pytest.mark.cuda
@pytest.mark.parametrize("torch_padding", [False, True])
@pytest.mark.parametrize("net", ["resnet8", "resnet18", "resnet50"])
def test_resnet_on_the_card_tracks_the_cpu(cuda_device, no_tf32, net, torch_padding):
    from mmlspark_tpu_torch.models import resnet as TR

    kw, size = {"resnet8": (dict(num_classes=10, small_inputs=True), 32),
                "resnet18": (dict(num_classes=7, num_filters=8), 64),
                "resnet50": (dict(num_classes=5, num_filters=4), 64)}[net]
    make = getattr(TR, net)
    variables = _perturbed_resnet_vars(make(dtype=torch.float32, **kw), seed=1)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, size, size, 3)).astype(np.float32))
    cpu = TR.load_flax_variables(make(dtype=torch.float32, torch_padding=torch_padding, **kw),
                                 variables).eval()
    with torch.inference_mode():
        want = cpu(x)
        for dtype in (torch.float32, torch.bfloat16):
            m = TR.load_flax_variables(make(dtype=dtype, torch_padding=torch_padding, **kw),
                                       variables).to(cuda_device).eval()
            _assert_card_close(m(x.to(cuda_device)), want, dtype == torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resize_down", "resize_up", "blur", "gray", "normalize",
                                  "unroll", "flip"])
def test_image_ops_on_the_card_track_the_cpu(cuda_device, name):
    from mmlspark_tpu_torch.ops import image as T

    fn = {"resize_down": lambda x: T.resize(x, 37, 45), "resize_up": lambda x: T.resize(x, 96, 80),
          "blur": lambda x: T.gaussian_blur(x, 5, 1.5), "gray": T.to_grayscale,
          "normalize": T.normalize, "unroll": T.unroll, "flip": T.flip}[name]
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 60, 50, 3)).astype(np.uint8))
    want = fn(x)
    got = fn(x.to(cuda_device)).cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got.double() - want.double()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["module", "apply_fn"])
@pytest.mark.parametrize("n,bs", [(21, 4), (3, 8), (0, 4)])
def test_torch_model_on_the_card_pads_orders_and_selects(cuda_device, form, n, bs):
    """More batches than the in-flight window come back in order."""
    from mmlspark_tpu_torch.models import TorchModel

    class Two(torch.nn.Module):
        def forward(self, x):
            return {"a": x.float() * 2, "b": x.float() + 1}

    x = np.arange(n * 3, dtype=np.uint8).reshape(n, 3)
    t = TorchModel(input_col="x", output_col="y", batch_size=bs, output_node="b", input_dtype=None)
    if form == "module":
        t.set(module=Two())
    else:
        t.set(apply_fn=lambda vs, v: {"b": v.float() + vs["one"]},
              variables={"one": np.ones(1, np.float32)})
    got = t.apply_batch(x)
    assert got.shape == (n, 3)
    np.testing.assert_array_equal(got, x.astype(np.float32) + 1)


@pytest.mark.cuda
def test_featurizer_on_the_card_classifies_digits_and_tracks_the_cpu(cuda_device, tmp_path):
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.models import ImageFeaturizer

    raw = np.genfromtxt(os.path.join(DATA_DIR, "digits.csv"), delimiter=",", skip_header=1)
    x8, y = raw[:, :64].reshape(-1, 8, 8), raw[:, 64].astype(np.int64)
    img = np.kron(x8 / 16.0, np.ones((4, 4)))
    imgs = (np.repeat(img[..., None], 3, axis=-1).astype(np.float32) * 255).astype(np.uint8)
    df = DataFrame.from_dict({"image": imgs[1500:]})
    out = {}
    for dev in ("cuda", "cpu"):
        f = ImageFeaturizer(input_col="image", output_col="logits", cut_output_layers=0,
                            repo_dir=str(tmp_path), device=dev, batch_size=64)
        out[dev] = f.transform(df)["logits"]
    assert (out["cuda"].argmax(-1) == y[1500:]).mean() > 0.95
    rel = np.linalg.norm(out["cuda"] - out["cpu"]) / np.linalg.norm(out["cpu"])
    assert rel <= CARD_BF16_L2


@pytest.mark.cuda
def test_image_stages_on_the_card_track_the_cpu(cuda_device):
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.image import ImageSetAugmenter, ImageTransformer, UnrollImage

    rng = np.random.default_rng(4)
    col = np.empty(3, dtype=object)
    for i, (h, w) in enumerate([(16, 16), (20, 12), (16, 16)]):
        col[i] = (rng.random((h, w, 3)) * 255).astype(np.float32)
    df = DataFrame.from_dict({"image": col})
    for make in (lambda d: ImageTransformer(device=d).resize(8, 8).blur(3, 1.0).flip(),
                 lambda d: UnrollImage(device=d),
                 lambda d: ImageSetAugmenter(flip_up_down=True, device=d)):
        got = make("cuda").transform(df)
        want = make("cpu").transform(df)
        oc = "unrolled" if isinstance(make("cpu"), UnrollImage) else "image"
        for g, w in zip(got[oc], want[oc]):
            assert float(np.abs(np.asarray(g) - np.asarray(w)).max()) <= 1e-4 * 255


# -- device binning, CSR, fused rounds as CUDA graphs, the partitioned grower,
# the seeded init (slice 6) -----------------------------------------------------
#
# Tolerances: binning bitwise (bounds as f64 bit patterns, bins as values)
# against the port's own CPU binning; graph-replayed fits byte-identical to
# the same round run eagerly; the partitioned grower within the reference's
# tolerances of the masked grower (split leaves and features exact, leaf
# values 1e-5, gains rtol 1e-3), its thresholds equal or tied across bins
# without a weighted row, so the weighted rows' partition exact; the seeded
# init within 4 ulp of the CPU's (both within 4 ulp of flax's,
# test_torch_port_zoo.py).


def _binning_data(kind: str, dtype=np.float32):
    rng = np.random.default_rng(11)
    if kind == "wide":
        return rng.normal(size=(200_000, 16)).astype(dtype)
    x = rng.normal(size=(6000, 8))
    x[::7, 0] = np.nan
    x[::11, 1] = np.inf
    x[::13, 1] = -np.inf
    x[:, 2] = np.round(x[:, 2] * 3)
    x[:, 3] = 1.5
    x[:, 4] = np.nan
    x[:, 5] = np.where(rng.random(6000) < 0.5, 0.0, rng.lognormal(size=6000))
    x[:, 6] = np.repeat(rng.normal(size=600), 10)
    x[:, 7] = np.where(rng.random(6000) < 0.3, -0.0, x[:, 7])
    return x.astype(dtype)


def _same_mapper(a, b):
    assert len(a.uppers) == len(b.uppers)
    for u, v in zip(a.uppers, b.uppers):
        assert u.shape == v.shape and np.array_equal(u.view(np.uint64), v.view(np.uint64))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,max_bin", [
    ("special", np.float32, 2), ("special", np.float32, 63), ("special", np.float32, 255),
    ("special", np.float64, 63), ("special", np.float64, 255), ("wide", np.float32, 255),
    ("wide", np.float32, 63),
])
def test_device_binning_bitwise_equals_the_cpu(cuda_device, kind, dtype, max_bin):
    from mmlspark_tpu_torch.models.gbdt import BinMapper

    x = _binning_data(kind, dtype)
    cpu = BinMapper.fit(x, max_bin=max_bin, seed=3, device="cpu")
    card = BinMapper.fit(x, max_bin=max_bin, seed=3, device=cuda_device)
    _same_mapper(card, cpu)
    bins = card.bin_tensor(x, cuda_device)
    assert bins.device.type == "cuda" and bins.dtype == torch.uint8
    assert torch.equal(bins.cpu(), cpu.bin_tensor(x, "cpu"))


def _csr(n=4000, dim=512, seed=0):
    """12 stored normal values a row in random columns; positive when a
    row stores one of columns 0-7 (a presence a tree carves out)."""
    import scipy.sparse as sp

    r = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 12)
    cols = r.integers(0, dim, size=rows.size)
    x = sp.csr_matrix((r.normal(size=rows.size), (rows, cols)), shape=(n, dim))
    x.sum_duplicates()
    y = (np.bincount(rows, weights=cols < 8, minlength=n) > 0).astype(np.float64)
    return x, y


@pytest.mark.cuda
def test_csr_on_the_card(cuda_device):
    from mmlspark_tpu_torch.models.gbdt import BinMapper
    from mmlspark_tpu_torch.models.gbdt.binning import densify_missing

    x, y = _csr()
    cpu = BinMapper.fit(x, max_bin=63, sample=2000, seed=1, device="cpu")
    card = BinMapper.fit(x, max_bin=63, sample=2000, seed=1, device=cuda_device)
    _same_mapper(card, cpu)
    assert torch.equal(card.bin_tensor(x, cuda_device).cpu(), cpu.bin_tensor(x, "cpu"))
    cfg = TrainConfig(num_iterations=10, num_leaves=15, min_data_in_leaf=10, seed=0)
    b = train(x[:3000], y[:3000], cfg, device=cuda_device)
    p = b.predict(densify_missing(x[3000:]), device=cuda_device)
    assert binary_auc(y[3000:], p) > 0.95


def _fused_case(name):
    rng = np.random.default_rng(5)
    n = 20_000
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    kw, fit_kw = {}, {}
    if name == "depthwise":
        kw = dict(growth_policy="depthwise")
    elif name == "goss":
        kw = dict(boosting_type="goss")
    elif name == "rf":
        kw = dict(boosting_type="rf")
    elif name == "bagged":
        kw = dict(bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.7)
    elif name == "multiclass":
        y = np.digitize(x[:, 0], [-0.5, 0.5]).astype(np.float64)
        kw = dict(objective="multiclass", num_class=3)
    elif name == "categorical":
        x[:, 11] = rng.integers(0, 40, n)
        y = ((x[:, 11] % 3 == 0) ^ (x[:, 0] > 0)).astype(np.float64)
        kw = dict(categorical_features=(11,))
    elif name == "early_stopped":
        y = np.where(rng.random(n) < 0.15, 1 - y, y)
        valid = np.arange(n) >= n - 4000
        kw = dict(early_stopping_round=3, learning_rate=0.5)
        fit_kw = dict(valid_mask=valid)
    elif name == "quantile":
        y = x[:, 0] * 2.0 + rng.normal(size=n)
        kw = dict(objective="quantile", alpha=0.3, bagging_fraction=0.8, bagging_freq=1)
    elif name == "partitioned":
        kw = dict(boosting_type="goss")
    return x, y, dict(num_iterations=30, num_leaves=31, min_data_in_leaf=20, seed=2, **kw), fit_kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gbdt", "depthwise", "goss", "rf", "bagged", "multiclass",
                                  "categorical", "early_stopped", "quantile", "partitioned"])
def test_graph_and_eager_model_strings_byte_equal(cuda_device, name, monkeypatch):
    import importlib

    T = importlib.import_module("mmlspark_tpu_torch.models.gbdt.train")
    if name == "partitioned":
        monkeypatch.setenv("MMLSPARK_TPU_GBDT_PARTITION", "1")
    x, y, kw, fit_kw = _fused_case(name)
    cfg = TrainConfig(**kw)
    graph = train(x, y, cfg, device=cuda_device, **fit_kw)
    assert T.fused["captures"] == 1 and T.fused["replays"] > 0
    chunked = train(x, y, cfg, device=cuda_device, fused_rounds=4, **fit_kw)
    eager = train(x, y, cfg, device=cuda_device, fused_rounds=1, **fit_kw)
    assert T.fused == {"chunks": 0, "captures": 0, "replays": 0}
    assert graph.to_model_string() == eager.to_model_string() == chunked.to_model_string()
    if name == "early_stopped":
        assert 0 < graph.best_iteration < 30


@pytest.mark.cuda
def test_graph_checkpoint_and_resume_byte_identical(cuda_device, tmp_path):
    x, y, kw, _ = _fused_case("bagged")
    cfg = TrainConfig(**kw)
    full = train(x, y, cfg, device=cuda_device, fused_rounds=1).to_model_string()
    d = str(tmp_path / "ck")
    short = TrainConfig(**{**kw, "num_iterations": 20})
    train(x, y, short, device=cuda_device, checkpoint_dir=d, checkpoint_every=5)
    resumed = train(x, y, cfg, device=cuda_device, checkpoint_dir=d, checkpoint_every=5,
                    resume_from=d)
    assert resumed.to_model_string() == full


def _threshold_ties(bins, weight, a, b):
    """Each split at which ``a`` and ``b`` chose different thresholds, with
    the weighted rows of its leaf between the two (replaying ``a``'s
    records): 0 means both thresholds part the weighted rows alike."""
    bins, w = bins.cpu().numpy(), weight.cpu().numpy() > 0
    rl, rf, ra = (t.cpu().numpy() for t in (a.rec_leaf, a.rec_feature, a.rec_active))
    ab, bb = a.rec_bin.cpu().numpy(), b.rec_bin.cpu().numpy()
    leaf = np.zeros(len(bins), np.int64)
    out = []
    for k in np.flatnonzero(ra):
        col, in_leaf = bins[:, rf[k]], leaf == rl[k]
        if ab[k] != bb[k]:
            lo, hi = sorted((ab[k], bb[k]))
            out.append(int((in_leaf & w & (col > lo) & (col <= hi)).sum()))
        leaf[in_leaf & (col > ab[k])] = k + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 4])
def test_partitioned_grower_matches_the_masked_on_the_card(cuda_device, seed):
    from mmlspark_tpu_torch.models.gbdt.treegrow import (
        SplitParams,
        grow_tree,
        grow_tree_partitioned,
    )

    rng = np.random.default_rng(seed)
    n, d = 50_000, 10
    args = [torch.from_numpy(a).to(cuda_device) for a in (
        rng.integers(0, 200, size=(n, d)).astype(np.uint8),
        rng.normal(size=n).astype(np.float32),
        (np.abs(rng.normal(size=n)) + 0.1).astype(np.float32),
        (rng.random(n) > 0.1).astype(np.float32))]
    sp = SplitParams.make(cuda_device, lambda_l2=1.0, lambda_l1=0.0, min_sum_hessian=1e-3,
                          min_gain=0.0, learning_rate=0.1)
    kw = dict(num_leaves=31, sp=sp, feature_mask=torch.ones(d, device=cuda_device),
              min_data_in_leaf=20, num_bins=256)
    a, b = grow_tree(*args, **kw), grow_tree_partitioned(*args, **kw)
    # The records are not all equal. The growers derive different children
    # by subtraction, and a derived plane carries f32 residues in bins its
    # leaf holds no weighted row of, so a threshold may move across such
    # bins (a tie in exact arithmetic; rows of weight 0 there then land
    # elsewhere). Every differing threshold must be such a tie, and the
    # weighted rows' leaves equal.
    assert all(between == 0 for between in _threshold_ties(args[0], args[3], a, b))
    weighted = args[3] > 0
    assert torch.equal(a.row_leaf[weighted], b.row_leaf[weighted])
    assert torch.equal(a.leaf_counts, b.leaf_counts)
    assert torch.equal(a.rec_leaf, b.rec_leaf) and torch.equal(a.rec_feature, b.rec_feature)
    assert torch.equal(a.rec_active, b.rec_active)
    assert torch.allclose(a.leaf_values, b.leaf_values, atol=1e-5)
    assert torch.allclose(a.rec_gain, b.rec_gain, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_device_round_key_on_the_card(cuda_device):
    from mmlspark_tpu_torch.models.gbdt import sampling

    its = torch.arange(1001, dtype=torch.int64, device=cuda_device)
    for seed in (0, 7):
        for stream in (sampling.BAGGING_STREAM, sampling.GOSS_STREAM):
            k1, k2 = sampling.round_key(seed, its, stream)
            want = np.array([sampling.round_key(seed, i, stream) for i in range(1001)])
            assert np.array_equal(k1.cpu().numpy(), want[:, 0])
            assert np.array_equal(k2.cpu().numpy(), want[:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["ResNet18", "ResNet50"])
def test_seeded_init_on_the_card_equals_the_cpu(cuda_device, variant):
    from mmlspark_tpu_torch.models import resnet as TR

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, np.asarray(tree)

    cpu = dict(leaves(TR.init_flax_variables(TR.RESNETS[variant](), seed=4)))
    card = dict(leaves(TR.init_flax_variables(TR.RESNETS[variant](), seed=4,
                                              device=cuda_device)))
    assert list(cpu) == list(card)
    for k, a in cpu.items():
        b = card[k]
        ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert int(ulp.max()) <= 4, k


# -- the pipeline compiler on the card ------------------------------------------------------

P1B_SIZES = (0, 1, 2, 3, 5, 9, 17, 33, 65, 130, 400)


def _pipeline_cell(n, seed=7, classes=4):
    """The bench's pipeline cell, fitted on the card: Featurize ->
    UDFTransformer(tanh(0.5 x)) -> LogisticRegression(max_iter=30)."""
    from mmlspark_tpu_torch import DataFrame, Pipeline
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    from mmlspark_tpu_torch.stages import UDFTransformer

    rng = np.random.default_rng(seed)
    cols = {f"x{i}": rng.standard_normal(n) for i in range(16)}
    cols["vec"] = rng.standard_normal((n, 16)).astype(np.float32)
    cols["label"] = rng.integers(0, classes, n)
    model = Pipeline([
        Featurize(input_cols=[f"x{i}" for i in range(16)] + ["vec"], output_col="features"),
        UDFTransformer(input_col="features", output_col="features_s", jit_compatible=True,
                       vector_udf=lambda x: torch.tanh(x * 0.5)),
        LogisticRegression(features_col="features_s", label_col="label", max_iter=30),
    ]).fit(DataFrame.from_dict(cols, num_partitions=1))
    return cols, model


def _assert_exact(staged, fused):
    assert staged.columns == fused.columns
    for c in staged.columns:
        assert staged[c].dtype == fused[c].dtype, c
        assert np.array_equal(staged[c], fused[c], equal_nan=True), c


@pytest.mark.cuda
def test_fused_equals_staged_bitwise_at_every_batch_size_on_the_card(cuda_device):
    from mmlspark_tpu_torch import DataFrame

    cols, model = _pipeline_cell(400)
    comp = model.compile(max_bucket=64)
    for n in P1B_SIZES:
        sub = DataFrame.from_dict({c: v[:n] for c, v in cols.items()})
        _assert_exact(model.transform(sub), comp.transform(sub))
    seg = comp.fused_segments[0]
    assert seg.device.type == "cuda"
    assert all(g is not None for g in seg._graphs.values())   # captured graphs
    assert len(seg._graphs) <= 7                                # log2(64) + 1
    # chunks of 100/37/200/3/160 rows against the whole frame
    whole = DataFrame.from_dict(cols)
    staged, outs, off = model.transform(whole), [], 0
    for size in (100, 37, 200, 3, 160):
        outs.append(comp.transform(DataFrame.from_dict(
            {c: v[off:off + size] for c, v in cols.items()})))
        off += size
    for c in staged.columns:
        assert np.array_equal(np.concatenate([o[c] for o in outs]), staged[c]), c


@pytest.mark.cuda
@pytest.mark.parametrize("max_bucket", [1, 16, 1024])
def test_graph_count_is_bounded_by_the_buckets(cuda_device, max_bucket):
    from mmlspark_tpu_torch import DataFrame

    cols, model = _pipeline_cell(700, seed=3)
    comp = model.compile(max_bucket=max_bucket)
    for n in (1, 7, 100, 700, 33, 2):
        sub = DataFrame.from_dict({c: v[:n] for c, v in cols.items()})
        _assert_exact(model.transform(sub), comp.transform(sub))
    graphs = comp.fused_segments[0]._graphs
    assert len(graphs) <= int(np.log2(max_bucket)) + 1
    assert max(k[0] for k in graphs) <= max_bucket


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression", "rf"])
def test_predict_raw_card_equals_cpu_bitwise(cuda_device, kind):
    from mmlspark_tpu_torch.models.gbdt import Booster

    x = np.random.default_rng(0).standard_normal((4000, 8)).astype(np.float32)
    cfg = {"binary": dict(objective="binary"),
           "multiclass": dict(objective="multiclass", num_class=3),
           "regression": dict(objective="regression"),
           "rf": dict(objective="binary", boosting_type="rf", bagging_fraction=0.8,
                      bagging_freq=1, feature_fraction=0.8)}[kind]
    y = (np.digitize(x[:, 0], [-0.5, 0.5]) if kind == "multiclass"
         else 2 * x[:, 0] + np.sin(x[:, 1]) if kind == "regression"
         else (x[:, 0] + x[:, 1] * x[:, 2] > 0)).astype(np.float64)
    b = Booster.from_model_string(
        train(x, y, TrainConfig(num_iterations=60, num_leaves=15, **cfg), device="cpu",
              base_score=0.3).to_model_string())
    np.testing.assert_array_equal(b.predict_raw(x, device=cuda_device),
                                  b.predict_raw(x, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["classifier", "poisson"])
def test_gbdt_pipeline_fused_equals_staged_on_the_card(cuda_device, case):
    from mmlspark_tpu_torch import DataFrame, Pipeline
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier, LightGBMRegressor

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3000, 12)).astype(np.float32)
    if case == "classifier":
        y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
        est = LightGBMClassifier(features_col="features", label_col="y", num_iterations=10,
                                 num_leaves=15)
    else:
        y = np.exp(0.3 * x[:, 0])
        est = LightGBMRegressor(features_col="features", label_col="y", objective="poisson",
                                num_iterations=10, num_leaves=15)
    df = DataFrame.from_dict({"x": x, "y": y}, num_partitions=3)
    model = Pipeline([Featurize(input_cols=["x"], output_col="features"), est]).fit(df)
    comp = model.compile(max_bucket=256)
    assert comp.num_fused_stages == 2
    _assert_exact(model.transform(df), comp.transform(df))
    for n in (1, 5, 300):
        sub = DataFrame.from_dict({"x": x[:n], "y": y[:n]})
        _assert_exact(model.transform(sub), comp.transform(sub))


@pytest.mark.cuda
def test_image_stage_fuses_only_without_exact_on_the_card(cuda_device, tmp_path):
    from mmlspark_tpu_torch import DataFrame, PipelineModel
    from mmlspark_tpu_torch.models import ImageFeaturizer
    from mmlspark_tpu_torch.models.linear import LogisticRegressionModel

    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 255, size=(40, 28, 28, 3), dtype=np.uint8)
    df = DataFrame.from_dict({"image": imgs}, num_partitions=2)
    feat = ImageFeaturizer(input_col="image", output_col="features", repo_dir=str(tmp_path),
                           model_name="ResNet8_Digits", cut_output_layers=1)
    d = feat.transform(df)["features"].shape[1]
    lr = LogisticRegressionModel(features_col="features", num_classes=3)
    lr.set(weights=rng.standard_normal((d, 3)).astype(np.float32),
           bias=rng.standard_normal(3).astype(np.float32))
    model = PipelineModel(stages=[feat, lr])
    staged = model.transform(df)
    comp = model.compile()
    assert [type(s).__name__ for s in comp.segments] == ["HostSegment", "FusedSegment"]
    _assert_exact(staged, comp.transform(df))
    comp2 = model.compile(exact=False)
    assert comp2.num_fused_stages == 2
    out = comp2.transform(df)
    f, g = staged["features"].astype(np.float64), out["features"].astype(np.float64)
    assert np.linalg.norm(f - g) <= 1e-2 * np.linalg.norm(f)


@pytest.mark.cuda
def test_failed_segment_capture_raises(cuda_device):
    """A kernel that reads the host cannot be captured: the compiled
    transform raises, it does not run the stages staged or on the CPU."""
    from mmlspark_tpu_torch import DataFrame, obs
    from mmlspark_tpu_torch.compiler import CompiledPipeline, StageKernel

    class Syncing:
        def fusable_kernel(self):
            def fn(cols):
                x = cols["a"]
                return {"c": x * float(x.sum())}   # a host read: illegal while capturing

            return StageKernel(reads=("a",), writes=("c",), fn=fn)

        def transform(self, df):
            return df.with_column("c", lambda p: p["a"] * p["a"].sum())

    obs.reset()
    comp = CompiledPipeline(stages=[Syncing()])
    with pytest.raises(RuntimeError):
        comp.transform(DataFrame.from_dict({"a": np.arange(8, dtype=np.float32)}))
    torch.cuda.synchronize()
    assert all(v == "0" for v in re.findall(
        r"mmlspark_compiler_fallback_total\{[^}]*\} (\d+)", obs.render()))


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device, monkeypatch):
    """A round that syncs cannot be captured: the fit raises, it does not
    fall back to running the round eagerly."""
    from mmlspark_tpu_torch.models.gbdt import objectives as O

    real = O.binary_grad_hess

    def syncing(s, y):
        float(s.sum())          # a host read: illegal while capturing
        return real(s, y)

    monkeypatch.setattr(O, "binary_grad_hess", syncing)
    x, y, kw, _ = _fused_case("gbdt")
    with pytest.raises(RuntimeError):
        train(x, y, TrainConfig(**kw), device=cuda_device)
    torch.cuda.synchronize()   # (last in the file: a failed capture may leave state behind)


# -- VowpalWabbit's SGD kernels (ops/sgd.py, ops/csrc/sgd.cu) ----------------
#
# Tolerance: vw_grad, vw_apply and vw_margin equal the plain version run on
# the CPU bit for bit for the squared, quantile and hinge losses (the same
# rounding points, no atomics). Logistic and poisson call exp, which the card
# rounds differently from the CPU: weights within VW_EXP_TOL * max |w|. The
# plain version on the card scatters with atomics, in an order that changes
# from run to run: within VW_ATOMIC_TOL * max |w|.

VW_EXP_TOL = 1e-5
VW_ATOMIC_TOL = 1e-5


def _vw_rows(n, k, bits, seed, loss="squared"):
    """Hashed-text-like rows: k - 1 random slots (some padding zeros, some
    repeated indices across rows) and a Constant slot of value 1."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, min(1 << bits, 300), size=(n, k)).astype(np.int64)
    val = (rng.normal(size=(n, k)) * (rng.random((n, k)) < 0.8)).astype(np.float32)
    idx[:, -1], val[:, -1] = 7, 1.0
    y = rng.normal(size=n).astype(np.float32)
    if loss in ("logistic", "hinge"):
        y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    if loss == "poisson":
        y = rng.poisson(2.0, size=n).astype(np.float32)
        val *= np.float32(0.1)
    wt = (rng.random(n) + 0.5).astype(np.float32)
    return idx, val, y, wt


def _vw_fit(device, rows, bits, **kw):
    from mmlspark_tpu_torch.vw import learner as VL

    idx, val, y, wt = rows
    return VL.train_sparse_sgd(idx, val, y, wt, bits, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["squared", "quantile", "hinge"])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("batch,k", [(64, 9), (64, 17), (1024, 9), (1024, 17)])
def test_vw_kernels_equal_cpu_plain_bitwise(cuda_device, loss, adaptive, l2, batch, k):
    from mmlspark_tpu_torch.ops import sgd

    rows = _vw_rows(3000, k, 12, seed=k + batch, loss=loss)
    kw = dict(loss=loss, adaptive=adaptive, l2=l2, batch=batch, num_passes=2,
              lr=0.5 if adaptive else 0.05)
    sgd.reset_launch_counts()
    card = _vw_fit(cuda_device, rows, 12, **kw)
    # one launch a pass; no per-minibatch launches of the stand-alone entries
    assert sgd.launches["vw_pass"] == 2 and sgd.launches["vw_grad"] == sgd.launches["vw_apply"] == 0
    again = _vw_fit(cuda_device, rows, 12, **kw)
    cpu = _vw_fit("cpu", rows, 12, **kw)
    assert np.array_equal(card.view(np.int32), again.view(np.int32))
    assert np.array_equal(card.view(np.int32), cpu.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["logistic", "poisson"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_vw_exp_losses_within_tolerance(cuda_device, loss, adaptive):
    rows = _vw_rows(3000, 17, 12, seed=5, loss=loss)
    kw = dict(loss=loss, adaptive=adaptive, batch=64, num_passes=2, lr=0.5 if adaptive else 0.05)
    card = _vw_fit(cuda_device, rows, 12, **kw)
    again = _vw_fit(cuda_device, rows, 12, **kw)
    cpu = _vw_fit("cpu", rows, 12, **kw)
    assert np.array_equal(card.view(np.int32), again.view(np.int32))
    assert np.abs(card - cpu).max() <= VW_EXP_TOL * np.abs(cpu).max()


@pytest.mark.cuda
def test_vw_plain_on_the_card_within_tolerance(cuda_device):
    """The plain version on CUDA tensors (atomic index_add_) is close."""
    from mmlspark_tpu_torch.ops import sgd

    idx, val, y, wt = _vw_rows(4096, 17, 12, seed=9)
    t = [torch.from_numpy(a).to(cuda_device) for a in (idx.astype(np.int32), val, y, wt)]
    w = torch.zeros(1 << 12, device=cuda_device)
    g2 = torch.zeros_like(w)
    kw = dict(loss="squared", batch=64, tau=0.5, lr=0.5, l2=0.0, eps=1e-6, adaptive=True)
    sgd.sgd_pass_plain(*t, w, g2, None, **kw)
    cpu = _vw_fit("cpu", (idx, val, y, wt), 12, loss="squared", batch=64)
    assert np.abs(w.cpu().numpy() - cpu).max() <= VW_ATOMIC_TOL * np.abs(cpu).max()


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [True, False])
def test_vw_chunked_state_equals_one_call_on_the_card(cuda_device, adaptive):
    """Two calls of train_sparse_sgd_state over chunks of whole minibatches
    equal one call bit for bit; the non-adaptive case checks that the step
    table's counter carries across calls."""
    from mmlspark_tpu_torch.vw import learner as VL

    idx, val, y, wt = _vw_rows(2048, 9, 12, seed=3)
    kw = dict(loss="squared", adaptive=adaptive, batch=64, lr=0.5 if adaptive else 0.05,
              device=cuda_device)
    one = VL.train_sparse_sgd_state(idx, val, y, wt, 12, **kw)
    s = VL.train_sparse_sgd_state(idx[:1024], val[:1024], y[:1024], wt[:1024], 12, **kw)
    s = VL.train_sparse_sgd_state(idx[1024:], val[1024:], y[1024:], wt[1024:], 12, s, **kw)
    assert float(s.t) == float(one.t) == 32.0
    for a, b in ((s.w, one.w), (s.g2, one.g2)):
        assert torch.equal(_bits(a), _bits(b))


# vw_margin: K from one slot to newsgroup-length rows (481); row counts of 1,
# 127 and 5,000, and one row either side of a panel (one block: its first
# panel's edge) and of a full grid's worth of panels (every block's)
VW_MARGIN_KS = [1, 9, 17, 25, 41, 481]
VW_MARGIN_ROWS = ["1", "127", "5000", "panel-1", "panel+1", "grid-1", "grid+1"]
VW_MARGIN_BITS = 18


def _vw_margin_rows(n, k, seed):
    """Rows of ``_vw_rows`` over 2^VW_MARGIN_BITS weights, with every fifth
    row all padding (index 0, value 0) and some indices at 2^bits - 1."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << VW_MARGIN_BITS, size=(n, k)).astype(np.int32)
    val = (rng.normal(size=(n, k)) * (rng.random((n, k)) < 0.8)).astype(np.float32)
    idx[rng.random((n, k)) < 0.05] = (1 << VW_MARGIN_BITS) - 1
    idx[::5], val[::5] = 0, 0.0
    w = rng.normal(size=1 << VW_MARGIN_BITS).astype(np.float32)
    return idx, val, w


def _graph_replay(fn):
    """fn's output from one replay of a CUDA graph that captured it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out.clone()


def _check_margin(cuda_device, idx, val, w):
    """One launch, bitwise the plain version on the CPU, and a CUDA graph's
    replay bitwise the eager call."""
    from mmlspark_tpu_torch.ops import sgd
    from mmlspark_tpu_torch.vw import learner as VL

    sgd.reset_launch_counts()
    card = VL.predict_margin(idx, val, w, device=cuda_device)
    assert sgd.launches["vw_margin"] == 1
    cpu = VL.predict_margin(idx, val, w, device="cpu")
    assert np.array_equal(card.view(np.int32), cpu.view(np.int32))
    it, vt, wt = (torch.from_numpy(a).to(cuda_device) for a in (idx, val, w))
    replayed = _graph_replay(lambda: sgd.vw_margin(it, vt, wt))
    assert np.array_equal(replayed.cpu().numpy().view(np.int32), card.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", VW_MARGIN_ROWS)
@pytest.mark.parametrize("k", VW_MARGIN_KS)
def test_vw_margin_equals_cpu_plain_bitwise(cuda_device, monkeypatch, k, rows):
    from mmlspark_tpu_torch.ops import sgd

    monkeypatch.setattr(sgd, "MARGIN_MIN_SLOTS", 1 << 40)   # one block
    panel = sgd.margin_layout(100_000, k, 1).panel_rows      # a panel's rows, given enough
    monkeypatch.undo()
    if rows.startswith("panel"):   # one block, so its first panel edge falls by the row count
        monkeypatch.setattr(sgd, "MARGIN_MIN_SLOTS", 1 << 40)
        n = panel + (1 if rows.endswith("+1") else -1)
    elif rows.startswith("grid"):
        blocks = sgd.MARGIN_BLOCKS_PER_SM * sgd._sm_count(cuda_device.index or 0)
        n = blocks * panel + (1 if rows.endswith("+1") else -1)
    else:
        n = int(rows)
    _check_margin(cuda_device, *_vw_margin_rows(max(n, 1), k, seed=k + n))


@pytest.mark.cuda
@pytest.mark.parametrize("panel_rows,threads", [(64, 256), (16, 256), (8, 32), (2, 32),
                                                (64, 512), (4, 128)])
def test_vw_margin_k_chunk_edges_bitwise(cuda_device, monkeypatch, panel_rows, threads):
    """K = 481 cut into chunks of 69, 241, 61 or 121 slots (the chain carried
    across every edge), or in whole rows of a small panel, with 32 to 512
    threads a block; six blocks of 117 rows."""
    from mmlspark_tpu_torch.ops import sgd

    monkeypatch.setattr(sgd, "MARGIN_MIN_SLOTS", 1 << 16)
    monkeypatch.setattr(sgd, "MARGIN_PANEL_ROWS", panel_rows)
    monkeypatch.setattr(sgd, "MARGIN_THREADS", threads)
    _check_margin(cuda_device, *_vw_margin_rows(700, 481, seed=panel_rows + threads))


@pytest.mark.cuda
@pytest.mark.parametrize("direct_slots", [4096, 0])
def test_vw_margin_unaligned_rows_bitwise(cuda_device, monkeypatch, direct_slots):
    """Rows that start at every 4-byte offset of a 16-byte line (views into
    a larger allocation), through the direct path (8 rows a block) and
    through panels."""
    from mmlspark_tpu_torch.ops import sgd

    monkeypatch.setattr(sgd, "MARGIN_DIRECT_SLOTS", direct_slots)
    idx, val, w = _vw_margin_rows(2_003, 41, seed=4)
    it, vt, wt = (torch.from_numpy(a).to(cuda_device) for a in (idx, val, w))
    cpu = sgd.margin_plain(*(torch.from_numpy(a) for a in (idx, val, w)))
    for skip in range(1, 4):
        got = sgd.vw_margin(it.reshape(-1)[skip * 41:].reshape(-1, 41),
                            vt.reshape(-1)[skip * 41:].reshape(-1, 41), wt)
        assert torch.equal(got.cpu().view(torch.int32), cpu[skip:].view(torch.int32))


@pytest.mark.cuda
def test_vw_regressor_card_equals_cpu(cuda_device):
    """The estimator on the card: weights and predictions equal the CPU's."""
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.vw import VowpalWabbitFeaturizer, VowpalWabbitRegressor

    rng = np.random.default_rng(0)
    vocab = np.array([f"w{i}" for i in range(200)], dtype=object)
    texts = np.array([" ".join(rng.choice(vocab, 12)) for _ in range(3000)], dtype=object)
    score = np.array([sum(int(t[1:]) % 7 for t in s.split()) for s in texts], np.float64)
    df = DataFrame.from_dict({"text": texts, "label": score / 10.0})
    fdf = VowpalWabbitFeaturizer(input_cols=[], string_split_input_cols=["text"],
                                 num_bits=14).transform(df)
    models = {d: VowpalWabbitRegressor(num_passes=2, batch_size=256, device=d).fit(fdf)
              for d in ("cuda", "cpu")}
    wc, wp = (np.asarray(models[d].get("weights")) for d in ("cuda", "cpu"))
    assert np.array_equal(wc.view(np.int32), wp.view(np.int32))
    pc, pp = (models[d].transform(fdf)["prediction"] for d in ("cuda", "cpu"))
    assert np.array_equal(pc, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["squared", "hinge", "logistic"])
@pytest.mark.parametrize("adaptive", [True, False])
def test_vw_step_kernels_equal_plain_parts(cuda_device, loss, adaptive):
    """vw_grad and vw_apply alone, on one minibatch, against grad_plain and
    apply_plain on the CPU (logistic's g within the exp tolerance)."""
    from mmlspark_tpu_torch.ops import sgd

    idx, val, y, wt = _vw_rows(1024, 17, 12, seed=2, loss=loss)
    cpu = [torch.from_numpy(a) for a in (idx.astype(np.int32), val, y, wt)]
    card = [t.to(cuda_device) for t in cpu]
    w = torch.from_numpy(np.random.default_rng(1).normal(size=1 << 12).astype(np.float32))
    g2 = torch.rand(1 << 12, generator=torch.Generator().manual_seed(3))
    kw = dict(loss=loss, tau=0.5, l2=0.01)
    g_card = sgd.vw_grad_step(*card, w.to(cuda_device), **kw)
    g_cpu = sgd.grad_plain(*cpu, w, **kw)
    if loss == "logistic":
        assert float((g_card.cpu() - g_cpu).abs().max()) <= VW_EXP_TOL * float(g_cpu.abs().max())
    else:
        assert torch.equal(_bits(g_card), _bits(g_cpu))
    step = torch.tensor([0.01])
    wc, g2c = w.to(cuda_device), g2.to(cuda_device)
    plan = sgd.sgd_plan(card[0], card[1], 1024, 1 << 12)
    sgd.reset_launch_counts()
    sgd.vw_apply_step(card[0], g_cpu.to(cuda_device), wc, g2c, step.to(cuda_device), plan,
                      lr=0.5, eps=1e-6, adaptive=adaptive)
    assert sgd.launches["vw_apply"] == 1 and sgd.launches["vw_pass"] == 0
    sgd.apply_plain(cpu[0], g_cpu, w, g2, step[0], lr=0.5, eps=1e-6, adaptive=adaptive)
    assert torch.equal(_bits(wc), _bits(w)) and torch.equal(_bits(g2c), _bits(g2))


# Shapes of the pass kernel: batch 64, 1,000 (not a multiple of 32), 1,024 and
# 4,096 (more rows than a block's threads) x K 1, 9, 17 and 64; at 1,024 x 64
# and 4,096 x 17 or 64, g does not fit in shared memory and lives in scratch.
VW_PASS_BATCHES = [64, 1000, 1024, 4096]
VW_PASS_KS = [1, 9, 17, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("k", VW_PASS_KS)
@pytest.mark.parametrize("batch", VW_PASS_BATCHES)
def test_vw_pass_equals_cpu_plain_bitwise(cuda_device, batch, k, adaptive):
    """vw_pass equals the plain version on the CPU bit for bit, and itself
    twice; one launch a pass."""
    from mmlspark_tpu_torch.ops import sgd

    rows = _vw_rows(batch + batch // 2 + 3, k, 12, seed=batch + k, loss="hinge")
    kw = dict(loss="hinge", adaptive=adaptive, l2=0.01, batch=batch, num_passes=3,
              lr=0.5 if adaptive else 0.05)
    sgd.reset_launch_counts()
    card = _vw_fit(cuda_device, rows, 12, **kw)
    assert sgd.launches["vw_pass"] == 3
    again = _vw_fit(cuda_device, rows, 12, **kw)
    cpu = _vw_fit("cpu", rows, 12, **kw)
    lay = sgd.pass_layout(batch, k, 0, 0)
    assert (lay.g_off >= 0) == (sgd.SMEM_FIXED + batch * k * 4 <= sgd.SMEM_BYTES)
    assert np.array_equal(card.view(np.int32), again.view(np.int32))
    assert np.array_equal(card.view(np.int32), cpu.view(np.int32))


# (k, batch, n, seed, where every slot of a row, or every row, takes one index)
VW_LONG_RUN_SHAPES = {
    "k1_every_row_one_index": (1, 256, 700, 21, "rows"),
    "row_on_one_index": (32, 64, 300, 22, "row"),
    "batch_1000": (17, 1000, 2500, 23, None),
    "batch_4096": (9, 4096, 5000, 24, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(VW_LONG_RUN_SHAPES))
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("loss", ["squared", "quantile", "hinge"])
def test_vw_pass_long_runs_equal_cpu_plain_bitwise(cuda_device, loss, adaptive, case):
    """Runs applied by a warp (one run the size of the minibatch; a run
    across the slots of one row) give the CPU's bits, twice."""
    from mmlspark_tpu_torch.ops import sgd

    k, batch, n, seed, one = VW_LONG_RUN_SHAPES[case]
    idx, val, y, wt = _vw_rows(n, k, 12, seed=seed, loss=loss)
    if one == "rows":
        idx[:] = 7
        val[:] = np.where(val == 0, np.float32(0.5), val)
    elif one == "row":
        idx[5::batch] = 3
        val[5::batch] = np.where(val[5::batch] == 0, np.float32(-0.25), val[5::batch])
    plan = sgd.sgd_plan(torch.from_numpy(idx[: n // batch * batch].astype(np.int32)),
                        torch.from_numpy(val[: n // batch * batch]), batch, 1 << 12)
    assert plan.long_runs.numel() >= 1
    kw = dict(loss=loss, adaptive=adaptive, batch=batch, num_passes=2,
              lr=0.5 if adaptive else 0.05, quantile_tau=0.3)
    card = _vw_fit(cuda_device, (idx, val, y, wt), 12, **kw)
    again = _vw_fit(cuda_device, (idx, val, y, wt), 12, **kw)
    cpu = _vw_fit("cpu", (idx, val, y, wt), 12, **kw)
    assert np.array_equal(card.view(np.int32), again.view(np.int32))
    assert np.array_equal(card.view(np.int32), cpu.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k", [(1024, 17), (64, 9), (4096, 64)])
def test_vw_grad_step_is_the_pass_grad_phase(cuda_device, batch, k):
    """The stand-alone grad phase equals grad_plain on the CPU bit for bit
    (g in shared memory and copied out, or in device memory), one launch."""
    from mmlspark_tpu_torch.ops import sgd

    idx, val, y, wt = _vw_rows(batch, k, 12, seed=k, loss="squared")
    cpu = [torch.from_numpy(a) for a in (idx.astype(np.int32), val, y, wt)]
    w = torch.from_numpy(np.random.default_rng(k).normal(size=1 << 12).astype(np.float32))
    sgd.reset_launch_counts()
    g = sgd.vw_grad_step(*(t.to(cuda_device) for t in cpu), w.to(cuda_device), loss="squared",
                         tau=0.5, l2=0.01)
    assert sgd.launches["vw_grad"] == 1 and sgd.launches["vw_pass"] == 0
    assert torch.equal(_bits(g), _bits(sgd.grad_plain(*cpu, w, loss="squared", tau=0.5,
                                                      l2=0.01)))


# -- serving on the card (serving/, serving/modelstore/) --------------------------
#
# A compiled pipeline hot-swapped while it serves: version 2's warm-up
# captures its CUDA graphs while version 1's exec thread replays its own and
# waits on their results; every reply must be version 1's or version 2's
# answer, bitwise, and none may fail. And the card memory a version holds
# (the store's resident bytes) against the rise of memory_allocated plus
# graph-pool bytes at its load, and its return at unload, within
# SERVE_MEM_MARGIN (the caching allocator rounds blocks to 512 bytes and
# may leave a large block unsplit).

SERVE_MEM_MARGIN = 4 << 20


def _serve_tanh_half(x):
    return torch.tanh(x * 0.5)


def _card_mem():
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pools = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))
    return torch.cuda.memory_allocated() + int(pools)


def _served_pipeline(tmp_path, device):
    """A fitted Featurize -> UDFTransformer -> LogisticRegression on the
    card, saved as version 1 and, with the head's weights halved, as
    version 2, each with a warmup.json of 16 rows; and the request rows."""
    from mmlspark_tpu_torch import DataFrame, Pipeline, PipelineModel
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    from mmlspark_tpu_torch.stages import UDFTransformer

    rng = np.random.default_rng(11)
    cols = {f"x{i}": rng.standard_normal(256) for i in range(4)}
    cols["vec"] = rng.standard_normal((256, 4)).astype(np.float32)
    cols["label"] = rng.integers(0, 3, 256)
    v1 = Pipeline([
        Featurize(input_cols=["x0", "x1", "x2", "x3", "vec"], output_col="features"),
        UDFTransformer(input_col="features", output_col="fs", vector_udf=_serve_tanh_half,
                       jit_compatible=True, device=str(device)),
        LogisticRegression(features_col="fs", label_col="label", max_iter=10,
                           device=str(device)),
    ]).fit(DataFrame.from_dict(cols))
    lr = v1.get("stages")[-1]
    v2 = PipelineModel(stages=list(v1.get("stages")[:-1]) + [
        lr.copy({"weights": np.asarray(lr.get("weights")) * np.float32(0.5)})])
    inputs = ["x0", "x1", "x2", "x3", "vec"]
    rows = [{c: (cols[c][k].tolist() if c == "vec" else float(cols[c][k])) for c in inputs}
            for k in range(8)]
    for name, m in (("v1", v1), ("v2", v2)):
        m.save(str(tmp_path / name))
        (tmp_path / name / "warmup.json").write_text(json.dumps(
            {c: np.asarray(cols[c][:16]).tolist() for c in inputs}))
    want = {}
    for name, m in (("v1", v1), ("v2", v2)):
        comp = m.compile()
        out = comp.transform(DataFrame.from_dict({c: np.asarray([r[c] for r in rows]) for c in inputs}))
        want[name] = out["raw_prediction"]
        for seg in comp.fused_segments:
            seg.release()
    return rows, want


@pytest.mark.cuda
def test_compiled_pipeline_hot_swap_while_serving(cuda_device, tmp_path):
    import http.client
    import threading

    from mmlspark_tpu_torch.serving import WorkerServer
    from mmlspark_tpu_torch.serving.modelstore import ModelDispatcher, ModelStore

    rows, want = _served_pipeline(tmp_path, cuda_device)
    bodies = [json.dumps(r).encode() for r in rows]
    store = ModelStore(device="cuda")
    store.load("p", f"pipeline:{tmp_path / 'v1'}")
    srv = WorkerServer()
    info = srv.start()
    disp = ModelDispatcher(srv, store, default_model="p").start()
    log, errs, stop = [], [], threading.Event()

    def client():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", info.port, timeout=60)
            i = 0
            while not stop.is_set():
                k = i % len(bodies)
                t0 = time.perf_counter()
                conn.request("POST", "/", body=bodies[k])
                r = conn.getresponse()
                log.append((k, r.status, r.read(), t0))
                i += 1
        except Exception as e:  # surfaced by the assertion below
            errs.append(e)

    th = threading.Thread(target=client)
    try:
        th.start()
        time.sleep(0.2)
        v2 = store.load("p", f"pipeline:{tmp_path / 'v2'}", wait=True)
        store.swap("p", v2)
        t_flip = time.perf_counter()
        time.sleep(0.2)
    finally:
        stop.set()
        th.join(60)
        disp.stop()
        srv.stop()
    assert not errs and not th.is_alive()
    assert {s for _, s, _, _ in log} == {200}
    seen = set()
    for k, _, body, t0 in log:
        got = np.asarray(json.loads(body)["raw_prediction"], np.float32)
        v = next(v for v in ("v1", "v2") if np.array_equal(got, want[v][k]))
        assert t0 < t_flip or v == "v2"
        seen.add(v)
    assert seen == {"v1", "v2"} and disp.errors == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gbdt", "vw", "pipeline"])
def test_unload_frees_the_card_memory_the_store_counted(cuda_device, tmp_path, kind):
    from mmlspark_tpu_torch.serving.modelstore import ModelStore

    if kind == "gbdt":
        x = np.random.default_rng(0).standard_normal((20_000, 16)).astype(np.float32)
        b = train(x, (x[:, 0] > 0).astype(np.float64),
                  TrainConfig(num_iterations=20, num_leaves=63), device=cuda_device)
        (tmp_path / "m.json").write_text(b.to_model_string())
        spec = f"gbdt:{tmp_path / 'm.json'}"
    elif kind == "vw":
        meta = json.dumps({"num_bits": 22, "loss": "logistic"}).encode()
        np.savez(tmp_path / "m.npz", weights=np.ones(1 << 22, np.float32),
                 meta=np.frombuffer(meta, np.uint8))
        spec = f"vw:{tmp_path / 'm.npz'}"
    else:
        _served_pipeline(tmp_path, cuda_device)
        spec = f"pipeline:{tmp_path / 'v1'}"
    store = ModelStore(device="cuda")
    before = _card_mem()
    store.load("m", spec)
    held = store.resident_bytes()
    rise = _card_mem() - before
    assert held > 0 and abs(rise - held) <= SERVE_MEM_MARGIN, (rise, held)
    store.unload("m")
    assert abs(_card_mem() - before) <= SERVE_MEM_MARGIN


# -- the elastic gang on one card (parallel/elastic.py) -----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["lossguide", "depthwise"])
def test_gang_world2_on_one_card_equals_one_device(cuda_device, tmp_path, policy):
    """Two ``fleet train --device cuda`` members on this card sum their
    fixed-point histogram cells over the gang's TCP reducer: both models
    equal the same fit on one device byte for byte, and each member
    launched its fixed-scale kernel."""
    import subprocess
    import sys

    from mmlspark_tpu_torch.parallel.elastic import load_training_data
    from mmlspark_tpu_torch.serving import fleet

    data = "synth:20000x16:3"
    x, y = load_training_data(data)
    cfg = TrainConfig(num_iterations=4, num_leaves=31, min_data_in_leaf=20, seed=0,
                      growth_policy=policy)
    want = train(x, y, cfg, device=cuda_device).to_model_string()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=5.0)
    try:
        procs = {
            name: subprocess.Popen(
                [sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet", "train",
                 "--registry", reg.url, "--name", name, "--data", data,
                 "--ckpt-dir", str(tmp_path / "ck"), "--world-size", "2",
                 "--num-iterations", "4", "--num-leaves", "31", "--seed", "0",
                 "--growth-policy", policy, "--heartbeat-s", "1", "--device", "cuda",
                 "--out-model", str(tmp_path / f"model-{name}.txt"),
                 "--status-file", str(tmp_path / f"status-{name}.json")],
                cwd=root, env=dict(os.environ, PYTHONPATH=root),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for name in ("a", "b")}
        for name, p in procs.items():
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        reg.stop()
    kernel = "multi_plane_hist_fixed" if policy == "depthwise" else "plane_hist_fixed"
    for name in ("a", "b"):
        assert (tmp_path / f"model-{name}.txt").read_text() == want
        status = json.loads((tmp_path / f"status-{name}.json").read_text())
        assert status["hist_lowering"] == "cuda" and status["launches"][kernel] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["lossguide", "depthwise"])
def test_gang_pipelined_blocks_on_one_card_equal_one_device(cuda_device, tmp_path, policy):
    """On the card a member sums each plane whole (``pipeline_blocks``: a
    build is shorter than a round trip), overlapping no block; forced to
    the CPU's blocking (four blocks of 16 columns at d = 64, block i on the
    TCP reducer while block i+1 runs) it builds three blocks behind an
    earlier one a build, launching four fixed-scale kernels. Both gangs'
    members equal the one-device fit byte for byte."""
    from mmlspark_tpu_torch.parallel.elastic import load_training_data
    from mmlspark_tpu_torch.serving import fleet

    data = "synth:20000x64:3"
    x, y = load_training_data(data)
    cfg = TrainConfig(num_iterations=3, num_leaves=31, min_data_in_leaf=20, seed=0,
                      growth_policy=policy)
    want = train(x, y, cfg, device=cuda_device).to_model_string()
    args = ["--data", data, "--num-iterations", "3", "--num-leaves", "31", "--seed", "0",
            "--growth-policy", policy, "--no-growback"]
    forced = ["-c", "import sys; from mmlspark_tpu_torch.ops import histogram as H; "
              "H.pipeline_blocks = lambda bins: H.feature_blocks(bins.shape[1]); "
              "from mmlspark_tpu_torch.serving.fleet import main; main(sys.argv[1:])"]
    got = {}
    for how, head in (("whole", None), ("piped", forced)):
        # a registry each: both gangs take the same service name
        reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=5.0)
        try:
            got[how] = _gang_members(reg.url, tmp_path / how,
                                     {"a": ("cuda", 2), "b": ("cuda", 2)}, args,
                                     *([head] if head else []))
        finally:
            reg.stop()
    whole, piped = got["whole"], got["piped"]
    kernel = "multi_plane_hist_fixed" if policy == "depthwise" else "plane_hist_fixed"
    for name, (model, st) in whole.items():
        assert model == want and st["overlap_blocks"] == 0, name
        assert st["launches"][kernel] > 0
    for name, (model, st) in piped.items():
        assert model == want, name
        builds = st["overlap_blocks"] // 3
        assert builds > 0 and st["overlap_blocks"] == 3 * builds
        assert st["launches"][kernel] >= 4 * builds


def _gang_members(reg_url: str, tmp_path, names: dict, args: list,
                  head: tuple = ("-m", "mmlspark_tpu_torch.serving.fleet")) -> dict:
    """``fleet train`` members (name -> (device, world)) to their end: name
    -> (model string, status). ``head``: the interpreter's arguments before
    ``train``."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp_path.mkdir(parents=True, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [sys.executable, *head, "train",
             "--registry", reg_url, "--name", name, "--service-name", f"{dev}-w{world}",
             "--ckpt-dir", str(tmp_path / f"ck-{dev}-w{world}"), "--world-size", str(world),
             "--heartbeat-s", "1", "--device", dev, *args,
             "--out-model", str(tmp_path / f"model-{name}.txt"),
             "--status-file", str(tmp_path / f"status-{name}.json")],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for name, (dev, world) in names.items()}
    for name, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return {name: ((tmp_path / f"model-{name}.txt").read_text(),
                   json.loads((tmp_path / f"status-{name}.json").read_text()))
            for name in names}


@pytest.mark.cuda
def test_voting_gang_world2_on_one_card_equals_cpu_run(cuda_device, tmp_path):
    """Two voting members (``--tree-parallelism voting --top-k 4``) on this
    card against the same gang on the CPU (the JAX gang's semantics, held
    against the JAX package in ``tests/test_torch_port_voting_gang.py``):
    the card's members byte-equal, each launched ``plane_hist_fixed`` and
    voted; the split features and thresholds equal the CPU gang's, leaf
    values within 1e-5 of the largest (f32 ``sigmoid`` on the card and on
    the CPU may differ in the last bit)."""
    from mmlspark_tpu_torch.models.gbdt.booster import Booster
    from mmlspark_tpu_torch.serving import fleet

    args = ["--data", "synth:20000x16:3", "--num-iterations", "4", "--num-leaves", "31",
            "--seed", "0", "--tree-parallelism", "voting", "--top-k", "4", "--no-growback"]
    reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=5.0)
    try:
        got = _gang_members(reg.url, tmp_path, {"a": ("cuda", 2), "b": ("cuda", 2),
                                                "c": ("cpu", 2), "d": ("cpu", 2)}, args)
    finally:
        reg.stop()
    assert got["a"][0] == got["b"][0] and got["c"][0] == got["d"][0]
    for name in ("a", "b"):
        st = got[name][1]
        assert st["hist_lowering"] == "cuda" and st["launches"]["plane_hist_fixed"] > 0
        assert st["vote_rounds"] > 0
    card, cpu = Booster.from_model_string(got["a"][0]), Booster.from_model_string(got["c"][0])
    vmax = max(float(np.abs(t.values).max()) for t in cpu.trees)
    for a, b in zip(card.trees, cpu.trees):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.threshold, b.threshold)
        assert np.abs(a.values - b.values).max() <= 1e-5 * vmax


@pytest.mark.cuda
def test_streaming_gang_on_one_card_equals_one_device(cuda_device, tmp_path):
    """``stream-synth:`` members at worlds 2 and 1 on this card: every
    booster equals ``train`` on one device on the world-1 BinnedDataset,
    byte for byte; the world-2 members launched ``plane_hist_fixed`` and
    merged their sketches through the reducer."""
    from mmlspark_tpu_torch.parallel.elastic import ElasticTrainer, load_streaming_data
    from mmlspark_tpu_torch.serving import fleet

    spec = "stream-synth:20000x16:3:4096"
    cfg = TrainConfig(num_iterations=4, num_leaves=31, min_data_in_leaf=20, seed=0)
    factory, n, d = load_streaming_data(spec)
    binned, y = ElasticTrainer(None, "ingest", None, None, cfg, "", stream=factory, n_rows=n,
                               n_features=d)._ingest_stream(None, 0, n)
    want = train(binned, y, cfg, device=cuda_device).to_model_string()
    args = ["--data", spec, "--num-iterations", "4", "--num-leaves", "31", "--seed", "0",
            "--no-growback"]
    reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=5.0)
    try:
        got = _gang_members(reg.url, tmp_path, {"a": ("cuda", 2), "b": ("cuda", 2),
                                                "c": ("cuda", 1)}, args)
    finally:
        reg.stop()
    for name, (model, st) in got.items():
        assert model == want, name
        if name != "c":
            assert st["launches"]["plane_hist_fixed"] > 0 and st["ingest_payload_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("function", ["cooccurrence", "jaccard", "lift"])
def test_sar_similarity_on_the_card_is_the_cpu_plain_bitwise(cuda_device, function):
    """SAR's similarity with TF32 off: exact counts and correctly rounded
    ``/`` on both devices; integer affinities under cooccurrence make every
    score exact, so the card's top-k equals the CPU's, ties to the lower
    item."""
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.recommendation import SAR

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.RandomState(0)
    cols = {"user_idx": rng.randint(0, 300, 4000), "item_idx": (rng.zipf(1.3, 4000) - 1) % 400,
            "rating": rng.randint(1, 6, 4000).astype(np.float32)}
    df = DataFrame.from_dict(cols)
    card = SAR(similarity_function=function, support_threshold=2, device="cuda").fit(df)
    cpu = SAR(similarity_function=function, support_threshold=2, device="cpu").fit(df)
    assert card.get("item_similarity").tobytes() == cpu.get("item_similarity").tobytes()
    if function == "cooccurrence":
        a, b = card.recommend_for_all_users(50), cpu.recommend_for_all_users(50)
        assert [list(r) for r in a["recommendations"]] == [list(r) for r in b["recommendations"]]


@pytest.mark.cuda
def test_forest_path_lengths_on_the_card_are_the_cpu_plain_bitwise(cuda_device):
    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.isolationforest import IsolationForest

    rng = np.random.RandomState(1)
    x = rng.randn(5000, 6).astype(np.float32)
    x[::11, 3] = np.nan
    df = DataFrame.from_dict({"features": x})
    card = IsolationForest(num_estimators=50, contamination=0.02, device="cuda").fit(df)
    cpu = IsolationForest(num_estimators=50, contamination=0.02, device="cpu").fit(df)
    assert card.get("score_threshold") == cpu.get("score_threshold")
    a, b = card.transform(df), cpu.transform(df)
    for col in ("outlierScore", "prediction"):
        assert a[col].tobytes() == b[col].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", [False, True])
def test_coo_als_on_the_card_is_bitwise_run_to_run(cuda_device, implicit):
    """Edges add in edge order on the card (the sorted accumulating
    ``index_put_``), so two fits are bitwise equal; against the CPU within
    1e-4 * max|cpu| (LU rounding)."""
    from mmlspark_tpu_torch.cyber.als import als_train_coo

    rng = np.random.RandomState(2)
    u, i = rng.randint(0, 700, 30000), rng.randint(0, 300, 30000)
    r = rng.randint(1, 6, 30000).astype(np.float32)
    kw = dict(rank=8, iters=5, implicit=implicit, alpha=10.0, seed=3)
    a = als_train_coo(u, i, r, 700, 300, device="cuda", **kw)
    b = als_train_coo(u, i, r, 700, 300, device="cuda", **kw)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    c = als_train_coo(u, i, r, 700, 300, device="cpu", **kw)
    ref = c[0] @ c[1].T
    assert np.abs(a[0] @ a[1].T - ref).max() <= 1e-4 * np.abs(ref).max()


# -- model evaluation and compiled segments over ranks on one card ------------


@pytest.fixture(scope="module")
def sharded_card_case():
    """The sharded-evaluation inputs (``tests/torch_port_ranks.py``) with
    the port's seeded ResNet init and a P1 fitted here on the card, and
    world 1's outputs on the card (TF32 off, as in the ranks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_port_ranks as R

    from mmlspark_tpu_torch import DataFrame, Pipeline
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.models import resnet as TR
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    from mmlspark_tpu_torch.stages import UDFTransformer

    data = R.eval_data()
    data["resnet"] = R.perturbed(TR.init_flax_variables(R.eval_resnet(), 0), 5)
    p1 = Pipeline([
        Featurize(input_cols=[f"x{i}" for i in range(16)] + ["vec"], output_col="features"),
        UDFTransformer(input_col="features", output_col="features_s", vector_udf=R.tanh_half,
                       jit_compatible=True, device="cuda"),
        LogisticRegression(features_col="features_s", label_col="label", max_iter=15,
                           device="cuda"),
    ]).fit(DataFrame.from_dict(R.eval_cols(), num_partitions=2))
    lr = p1.get("stages")[2]
    data["p1"] = {"featurize": {"plans": p1.get("stages")[0].get("plans"),
                                "output_col": "features"},
                  "lr": {"features_col": "features_s", "num_classes": lr.get("num_classes"),
                         "weights": np.asarray(lr.get("weights")),
                         "bias": np.asarray(lr.get("bias"))}}
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        world1 = R.sharded_eval_outputs(data, "cuda", "auto")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return R, data, world1


def _np_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max(initial=0.0)) <= rel * float(np.abs(want).max(initial=0.0))


@pytest.mark.cuda
def test_sharded_eval_on_two_gloo_ranks_equals_world_1(cuda_device, sharded_card_case, tmp_path):
    """Two gloo ranks on the card, ``auto`` mode: TorchModel (the matrix
    product within 1e-6 and the ResNet within 1e-4 of max |world 1|, f32,
    TF32 off), P3 compiled (``exact=False``) and staged within 1e-4, P1
    compiled and the search case bitwise world 1, every rank's bytes
    equal; P1's graphs captured at each rank's block of the buckets the
    world divides; the search case's buckets run eagerly (a gloo gather
    inside); other rows on a rank raise on every rank."""
    R, data, w1 = sharded_card_case
    res = R.run(2, tmp_path, "sharded_eval_suite", data, "cuda", "auto", device="cuda:0")
    for r in res:
        for n in R.EVAL_SIZES:
            _np_close(r["apply_fn"][n], w1["apply_fn"][n], 1e-6)
            for c in w1["p1"][n]:
                assert np.array_equal(r["p1"][n][c], w1["p1"][n][c], equal_nan=True), (n, c)
                assert r["p1"][n][c].dtype == w1["p1"][n][c].dtype
        _np_close(r["module"], w1["module"], 1e-4)
        for key in ("p3_staged", "p3_compiled"):
            for c in ("features", "raw_prediction", "probability"):
                _np_close(r[key][c], w1[key][c], 1e-4)
        for n, want in w1["search"].items():
            for c in want:
                assert np.array_equal(r["search"][n][c], want[c]), (n, c)
        assert all(r["raised"].values())
        assert r["apply_fn_frame"].tobytes() == res[0]["apply_fn_frame"].tobytes()
        assert r["module"].tobytes() == res[0]["module"].tobytes()
    assert set(res[0]["p1_decisions"].values()) == {"batch"}
    for k in res[0]["p1_keys"]:
        sharded = k[0] % 2 == 0
        assert (k[-1] == ("block", k[0] // 2)) == sharded, k
    assert all(res[0]["p1_graphs"].values())  # every P1 bucket holds a captured graph
    assert res[0]["search_plan"]["steps"] and set(w1["search_plan"]["steps"]) == set()


@pytest.mark.cuda
def test_one_rank_group_takes_today_s_graphs(cuda_device, sharded_card_case, tmp_path):
    """In a one-rank group (NCCL, world 1) P1 compiles to the graphs it
    compiles to with no group at all (the same keys, every one captured)
    with bitwise the same outputs, and TorchModel returns the same bytes."""
    import torch.distributed as dist

    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.models import TorchModel

    R, data, w1 = sharded_card_case
    cols = R.eval_cols()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0)
    try:
        comp = R.eval_p1(data["p1"], "cuda").compile(max_bucket=R.EVAL_BUCKET)
        for n in R.EVAL_SIZES:
            out = comp.transform(DataFrame.from_dict({c: v[:n] for c, v in cols.items()}))
            for c in w1["p1"][n]:
                assert np.array_equal(out[c], w1["p1"][n][c], equal_nan=True), (n, c)
        seg = comp.fused_segments[0]
        assert sorted(seg._graphs, key=repr) == w1["p1_keys"]
        assert all(g is not None for g in seg._graphs.values())
        assert seg.sharding.mesh is None and seg.mesh.size == 1
        tm = TorchModel(input_col="x", output_col="y", batch_size=R.EVAL_BATCH, output_node="y",
                        device="cuda", apply_fn=R.eval_apply_fn,
                        variables={"w": data["w"], "b": data["b"]})
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for n in R.EVAL_SIZES:
                assert tm.apply_batch(data["x"][:n]).tobytes() == w1["apply_fn"][n].tobytes()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    finally:
        dist.destroy_process_group()
