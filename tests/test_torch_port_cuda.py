"""The port's CUDA kernels and GBDT on the card.

Every test here is marked ``cuda`` and skips, inside a fixture, without a
CUDA device. The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch; there, skip the JAX test harness's
conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_port_cuda.py

Tolerance: counts exact; g and h within 1e-5 * sum_r |stats[r, j]| of the
plain PyTorch version (both f32, summed in different orders). Each kernel
must also give a bitwise-equal output when run twice.
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


def _assert_close(got, want, stats):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.equal(got[..., 2], want[..., 2])
    for j in (0, 1):
        atol = TOL * float(stats[:, j].abs().sum())
        assert float((got[..., j] - want[..., j]).abs().max()) <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("bin_dtype", [torch.int32, torch.uint8])
def test_plane_hist_matches_plain_and_is_deterministic(cuda_device, B, bin_dtype):
    bins, stats = _inputs(20_000, 9, B, seed=B)
    if bin_dtype == torch.uint8:
        bins = bins.clamp(0, 255).to(torch.uint8)
    mask = (torch.rand(20_000, generator=torch.Generator().manual_seed(1)) < 0.5).float()
    b, s, m = bins.to(cuda_device), stats.to(cuda_device), mask.to(cuda_device)
    a = PH.plane_hist(b, s, m, B)
    a2 = PH.plane_hist(b, s, m, B)
    torch.cuda.synchronize()
    assert torch.equal(a, a2)
    _assert_close(a, PH.plane_histogram_plain(b, s, m, B), stats * mask[:, None])
    full = PH.plane_hist(b, s, None, B)
    torch.cuda.synchronize()
    _assert_close(full, PH.plane_histogram_plain(b, s, None, B), stats)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 16, 32, 100])
def test_multi_plane_hist_matches_plain_and_is_deterministic(cuda_device, S):
    bins, stats = _inputs(20_000, 5, 256, seed=S)
    slot = torch.randint(-1, S + 2, (20_000,), generator=torch.Generator().manual_seed(S),
                         dtype=torch.int32)
    b, s, sl = bins.to(cuda_device), stats.to(cuda_device), slot.to(cuda_device)
    a = PH.multi_plane_hist(b, s, sl, S, 256)
    a2 = PH.multi_plane_hist(b, s, sl, S, 256)
    torch.cuda.synchronize()
    assert torch.equal(a, a2)
    _assert_close(a, PH.multi_plane_histogram_plain(b, s, sl, S, 256), stats)


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
