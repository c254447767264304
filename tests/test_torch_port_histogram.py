"""The port's histogram builders against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. The
port's plain versions (the CPU body of each wrapper) are held against

- the JAX package's Pallas kernels in interpret mode, as
  tests/test_histogram.py runs them on the CPU: counts exact, g and h within
  3e-5 * sum_r |stats[r, j]| (the Pallas kernels split stats into bf16 hi +
  lo terms, which is not exact f32);
- the JAX package's f64 host bincount: counts exact, g and h within
  1e-5 * sum_r |stats[r, j]| (f32 accumulation against f64).

The kernels themselves run only on the card: tests/test_torch_port_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu.ops import histogram as JH
from mmlspark_tpu_torch.ops import histogram as PH

PALLAS_ATOL = 3e-5

# the suite runs one worker process per core: PyTorch's intra-op threads
# would only oversubscribe them (these tensors are small)
torch.set_num_threads(1)
F64_ATOL = 1e-5


def _inputs(n, d, B, seed, oob=False, with_mask=False):
    rng = np.random.default_rng(seed)
    lo, hi = (-3, B + 3) if oob else (0, B)
    bins = rng.integers(lo, hi, size=(n, d)).astype(np.int32)
    stats = np.stack(
        [rng.normal(size=n), rng.uniform(0.01, 0.25, size=n), np.ones(n)], 1
    ).astype(np.float32)
    mask = (rng.random(n) < 0.4).astype(np.float32) if with_mask else None
    return bins, stats, mask


def _assert_close(got, want, stats, rel):
    """Counts (column 2) exact; g, h within rel * sum |stats[:, j]|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    for j in (0, 1):
        atol = rel * float(np.abs(stats[:, j]).sum())
        np.testing.assert_allclose(got[..., j], want[..., j], rtol=0, atol=atol)


PLANE_CASES = [
    # (n, d, B, out-of-range bins, mask)
    (700, 5, 64, False, False),
    (700, 5, 64, True, True),
    (1500, 3, 256, False, True),
    (513, 4, 256, True, False),
    (1, 2, 64, False, False),
]


@pytest.mark.parametrize("n,d,B,oob,with_mask", PLANE_CASES)
def test_plane_plain_matches_pallas_interpret(n, d, B, oob, with_mask):
    import jax.numpy as jnp

    bins, stats, mask = _inputs(n, d, B, seed=n + d + B, oob=oob, with_mask=with_mask)
    pre = stats if mask is None else stats * mask[:, None]
    want = np.asarray(JH._plane_histogram_pallas(jnp.asarray(bins), jnp.asarray(pre), B))
    got = PH.plane_histogram(
        torch.from_numpy(bins), torch.from_numpy(stats),
        None if mask is None else torch.from_numpy(mask), num_bins=B,
    )
    _assert_close(got.numpy(), want, pre, PALLAS_ATOL)


@pytest.mark.parametrize("n,d,B,oob,with_mask", PLANE_CASES)
def test_plane_plain_matches_f64_bincount(n, d, B, oob, with_mask):
    bins, stats, mask = _inputs(n, d, B, seed=7 * n + d, oob=oob, with_mask=with_mask)
    want = JH._host_plane_kernel(B, False, bins, stats, mask)
    got = PH.plane_histogram(
        torch.from_numpy(bins), torch.from_numpy(stats),
        None if mask is None else torch.from_numpy(mask), num_bins=B,
    )
    pre = stats if mask is None else stats * mask[:, None]
    _assert_close(got.numpy(), want, pre, F64_ATOL)


def test_plane_plain_uint8_bins_and_oob_drop():
    """uint8 bins (the training layout) equal int32 bins; codes >= B drop."""
    bins, stats, _ = _inputs(900, 6, 256, seed=3)
    b8 = torch.from_numpy(bins.astype(np.uint8))
    a = PH.plane_histogram(b8, torch.from_numpy(stats), num_bins=64)
    want = JH._host_plane_kernel(64, False, bins, stats, None)
    _assert_close(a.numpy(), want, stats, F64_ATOL)
    kept = int(((bins >= 0) & (bins < 64)).sum())
    assert a[:, 2].sum().item() == kept


MULTI_CASES = [
    # (n, d, B, S)
    (700, 4, 64, 1),
    (900, 3, 64, 2),
    (600, 3, 256, 17),
    (1025, 2, 256, 2),
]


@pytest.mark.parametrize("n,d,B,S", MULTI_CASES)
def test_multi_plain_matches_pallas_interpret(n, d, B, S):
    import jax.numpy as jnp

    bins, stats, _ = _inputs(n, d, B, seed=n * S + B, oob=True)
    slot = np.random.default_rng(S).integers(-1, S + 2, size=n).astype(np.int32)
    want = np.asarray(
        JH._multi_plane_pallas(
            jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(slot), S, B
        )
    )
    got = PH.multi_plane_histogram(
        torch.from_numpy(bins), torch.from_numpy(stats), torch.from_numpy(slot), S, B
    )
    assert got.shape == (S, d * B, 3)
    _assert_close(got.numpy(), want, stats, PALLAS_ATOL)


@pytest.mark.parametrize("n,d,B,S", MULTI_CASES)
def test_multi_plain_matches_f64_bincount(n, d, B, S):
    bins, stats, _ = _inputs(n, d, B, seed=n + S, oob=True)
    slot = np.random.default_rng(S + 1).integers(-2, S + 1, size=n).astype(np.int32)
    want = JH._host_multi_kernel(S, B, False, bins, stats, slot)
    got = PH.multi_plane_histogram(
        torch.from_numpy(bins), torch.from_numpy(stats), torch.from_numpy(slot), S, B
    )
    _assert_close(got.numpy(), want, stats, F64_ATOL)


def test_leaf_stat_sums_plain_matches_scatter():
    rng = np.random.default_rng(5)
    leaf = rng.integers(0, 31, size=800).astype(np.int32)
    stats = rng.normal(size=(800, 3)).astype(np.float32)
    got = PH.leaf_stat_sums(torch.from_numpy(leaf), torch.from_numpy(stats), 31)
    want = np.zeros((31, 3), np.float64)
    np.add.at(want, leaf, stats.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    bins, stats, mask = _inputs(300, 3, 64, seed=1, with_mask=True)
    PH.reset_launch_counts()
    PH.plane_histogram(torch.from_numpy(bins), torch.from_numpy(stats),
                       torch.from_numpy(mask), num_bins=64)
    PH.multi_plane_histogram(torch.from_numpy(bins), torch.from_numpy(stats),
                             torch.zeros(300, dtype=torch.int32), 2, 64)
    assert PH.launches == {"plane_hist": 0, "multi_plane_hist": 0, "plane_hist_fixed": 0,
                           "multi_plane_hist_fixed": 0}
    assert PH.hist_lowering("cpu") == "torch"
    assert PH.hist_lowering("cuda") == "cuda"


def test_kernel_wrappers_refuse_cpu_tensors():
    bins, stats, _ = _inputs(10, 2, 16, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        PH.plane_hist(torch.from_numpy(bins), torch.from_numpy(stats), None, 16)
    with pytest.raises(ValueError, match="CUDA"):
        PH.multi_plane_hist(torch.from_numpy(bins), torch.from_numpy(stats),
                            torch.zeros(10, dtype=torch.int32), 1, 16)
