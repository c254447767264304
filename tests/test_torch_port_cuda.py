"""The port's CUDA kernels and GBDT on the card.

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

import os

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
