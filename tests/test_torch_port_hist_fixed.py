"""The fixed-point arithmetic of the port's histogram kernels, on the CPU.

``plane_hist`` and ``multi_plane_hist`` (ops/csrc/histogram.cu) sum each
row's stats as int64 at a power-of-two scale per column and round the sums
once to f32; ``plane_histogram_emulated`` and
``multi_plane_histogram_emulated`` repeat that arithmetic in PyTorch, and on
the card the kernels equal them bit for bit (tests/test_torch_port_cuda.py).
Here the emulation is held against the JAX package:

- the f64 host bincount (``JH._host_plane_kernel``, ``JH._host_multi_kernel``):
  counts exact; g and h within 1e-5 * sum_r |stats[r, j]|, and within the
  emulation's own error bound, 2^-24 * |cell| (the one rounding to f32) plus
  the cell's rows * 2^-(k_j + 1) (each row's rounding to the scale 2^k_j);
- the Pallas kernels in interpret mode: counts exact, g and h within
  3e-5 * sum_r |stats[r, j]| (the Pallas kernels split stats into bf16 hi + lo).

It also checks what the fixed-point scheme promises: integer weights stay
exact, the result does not depend on the order of the rows, a column whose
values span a range of 1e9 stays within f32's own summation error in every
cell, and a NaN or inf stat makes its column NaN instead of leaving the
plane all finite.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu.ops import histogram as JH
from mmlspark_tpu_torch.ops import cuda_build
from mmlspark_tpu_torch.ops import histogram as PH

# the suite runs one worker process per core: PyTorch's intra-op threads
# would only oversubscribe them (these tensors are small)
torch.set_num_threads(1)

F64_ATOL = 1e-5
PALLAS_ATOL = 3e-5

PLANE_CASES = [
    # (n, d, B, out-of-range bins, mask)
    (700, 5, 64, False, False),
    (700, 5, 64, True, True),
    (1500, 3, 256, False, True),
    (513, 4, 256, True, False),
    (1, 2, 64, False, False),
]

MULTI_CASES = [
    # (n, d, B, S)
    (700, 4, 64, 1),
    (900, 3, 64, 2),
    (600, 3, 256, 17),
    (1025, 2, 256, 2),
]


def _inputs(n, d, B, seed, oob=False, with_mask=False):
    rng = np.random.default_rng(seed)
    lo, hi = (-3, B + 3) if oob else (0, B)
    bins = rng.integers(lo, hi, size=(n, d)).astype(np.int32)
    stats = np.stack(
        [rng.normal(size=n), rng.uniform(0.01, 0.25, size=n), np.ones(n)], 1
    ).astype(np.float32)
    mask = (rng.random(n) < 0.4).astype(np.float32) if with_mask else None
    return bins, stats, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _assert_close(got, want, stats, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    for j in (0, 1):
        atol = rel * float(np.abs(stats[:, j]).sum())
        np.testing.assert_allclose(got[..., j], want[..., j], rtol=0, atol=atol)


def _f64_cells(bins, v, B, slot=None, S=1):
    """Exact (f64) sums of the f32 contributions v and the rows per cell:
    (S * d * B, 3) and (S * d * B,)."""
    n, d = bins.shape
    sl = np.zeros(n, np.int64) if slot is None else slot.astype(np.int64)
    sums, rows = np.zeros((S, d, B, 3)), np.zeros((S, d, B))
    for f in range(d):
        ok = (sl >= 0) & (sl < S) & (bins[:, f] >= 0) & (bins[:, f] < B)
        np.add.at(sums, (sl[ok], f, bins[ok, f]), v[ok].astype(np.float64))
        np.add.at(rows, (sl[ok], f, bins[ok, f]), 1.0)
    return sums.reshape(-1, 3), rows.reshape(-1)


def _assert_within_fixed_bound(got, exact, rows, v, n):
    """Per cell: each row rounds by at most 2^-(k_j + 1), the sum once to f32."""
    k, finite = PH._fixed_scale(torch.from_numpy(v), n)
    assert bool(finite.all())
    got = np.asarray(got, np.float64).reshape(-1, 3)
    for j in range(3):
        fixed = rows * 2.0 ** -(int(k[j]) + 1)
        bound = fixed + 2.0 ** -24 * (np.abs(exact[:, j]) + fixed)
        assert np.all(np.abs(got[:, j] - exact[:, j]) <= bound), j


@pytest.mark.parametrize("n,d,B,oob,with_mask", PLANE_CASES)
def test_plane_emulated_matches_f64_bincount(n, d, B, oob, with_mask):
    bins, stats, mask = _inputs(n, d, B, seed=3 * n + d, oob=oob, with_mask=with_mask)
    want = JH._host_plane_kernel(B, False, bins, stats, mask)
    got = PH.plane_histogram_emulated(_t(bins), _t(stats), _t(mask), B).numpy()
    pre = stats if mask is None else stats * mask[:, None]
    _assert_close(got, want, pre, F64_ATOL)
    exact, rows = _f64_cells(bins, pre, B)
    _assert_within_fixed_bound(got, exact, rows, pre, n)


@pytest.mark.parametrize("n,d,B,oob,with_mask", PLANE_CASES)
def test_plane_emulated_matches_pallas_interpret(n, d, B, oob, with_mask):
    import jax.numpy as jnp

    bins, stats, mask = _inputs(n, d, B, seed=n + 2 * d + B, oob=oob, with_mask=with_mask)
    pre = stats if mask is None else stats * mask[:, None]
    want = np.asarray(JH._plane_histogram_pallas(jnp.asarray(bins), jnp.asarray(pre), B))
    got = PH.plane_histogram_emulated(_t(bins), _t(stats), _t(mask), B).numpy()
    _assert_close(got, want, pre, PALLAS_ATOL)


@pytest.mark.parametrize("n,d,B,S", MULTI_CASES)
def test_multi_emulated_matches_f64_bincount(n, d, B, S):
    bins, stats, _ = _inputs(n, d, B, seed=n + 5 * S, oob=True)
    slot = np.random.default_rng(S + 7).integers(-2, S + 2, size=n).astype(np.int32)
    want = JH._host_multi_kernel(S, B, False, bins, stats, slot)
    got = PH.multi_plane_histogram_emulated(_t(bins), _t(stats), _t(slot), S, B).numpy()
    assert got.shape == (S, d * B, 3)
    _assert_close(got, want, stats, F64_ATOL)
    ok = (slot >= 0) & (slot < S)
    exact, rows = _f64_cells(bins, stats, B, slot, S)
    _assert_within_fixed_bound(got, exact, rows, stats[ok], n)


@pytest.mark.parametrize("n,d,B,S", MULTI_CASES)
def test_multi_emulated_matches_pallas_interpret(n, d, B, S):
    import jax.numpy as jnp

    bins, stats, _ = _inputs(n, d, B, seed=2 * n + S, oob=True)
    slot = np.random.default_rng(S).integers(-1, S + 2, size=n).astype(np.int32)
    want = np.asarray(
        JH._multi_plane_pallas(jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(slot), S, B)
    )
    got = PH.multi_plane_histogram_emulated(_t(bins), _t(stats), _t(slot), S, B).numpy()
    _assert_close(got, want, stats, PALLAS_ATOL)


@pytest.mark.parametrize("weights", ["ones", "small_ints", "large_ints"])
def test_power_of_two_scale_keeps_integer_weights_exact(weights):
    """Integer-valued stats (counts, integer row weights) sum exactly."""
    rng = np.random.default_rng(11)
    n, d, B = 2000, 3, 64
    bins = rng.integers(0, B, size=(n, d)).astype(np.int32)
    hi = {"ones": 1, "small_ints": 4, "large_ints": 1000}[weights]
    w = rng.integers(0 if hi > 1 else 1, hi + 1, size=n).astype(np.float32)
    stats = np.stack([w * rng.integers(-3, 4, size=n), w * 2.0, w], 1).astype(np.float32)
    got = PH.plane_histogram_emulated(_t(bins), _t(stats), None, B).numpy()
    exact, _ = _f64_cells(bins, stats, B)
    np.testing.assert_array_equal(got.astype(np.float64), exact)


@pytest.mark.parametrize("kind", ["plane", "plane_masked", "multi"])
def test_row_order_does_not_change_a_bit(kind):
    bins, stats, mask = _inputs(3000, 6, 256, seed=21, oob=True, with_mask=True)
    stats[:, 0] *= 1e4  # large, mixed-sign gradients
    slot = np.random.default_rng(2).integers(-1, 9, size=3000).astype(np.int32)
    perm = np.random.default_rng(3).permutation(3000)

    def run(idx):
        b, s, m, sl = (_t(np.ascontiguousarray(a[idx])) for a in (bins, stats, mask, slot))
        if kind == "multi":
            return PH.multi_plane_histogram_emulated(b, s, sl, 8, 256)
        return PH.plane_histogram_emulated(b, s, m if kind == "plane_masked" else None, 256)

    a, b = run(np.arange(3000)), run(perm)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_non_finite_stat_makes_its_column_nan(bad):
    bins, stats, _ = _inputs(500, 4, 64, seed=5)
    stats[17, 0] = bad
    plane = PH.plane_histogram_emulated(_t(bins), _t(stats), None, 64)
    assert bool(plane[:, 0].isnan().all())
    assert bool(plane[:, 1:].isfinite().all())
    want = JH._host_plane_kernel(64, False, bins, stats, None)
    np.testing.assert_array_equal(plane[:, 2].numpy(), want[:, 2])
    # a masked-out row still poisons its column, as stats * 0 = NaN does in f32
    mask = np.ones(500, np.float32)
    mask[17] = 0.0
    masked = PH.plane_histogram_emulated(_t(bins), _t(stats), _t(mask), 64)
    assert bool(masked[:, 0].isnan().all())
    # a row whose slot drops it does not
    slot = np.zeros(500, np.int32)
    slot[17] = -1
    multi = PH.multi_plane_histogram_emulated(_t(bins), _t(stats), _t(slot), 1, 64)
    assert bool(multi.isfinite().all())
    slot[17] = 0
    multi = PH.multi_plane_histogram_emulated(_t(bins), _t(stats), _t(slot), 1, 64)
    assert bool(multi[..., 0].isnan().all()) and bool(multi[..., 1:].isfinite().all())


@pytest.mark.parametrize("scale", [1e-38, 1e-42, 1e-3, 1.0, 7.5, 1e6, 3e38])
@pytest.mark.parametrize("n", [1, 2, 1000, 200_000, 10_000_000])
def test_scale_keeps_rows_and_sums_in_range(scale, n):
    """n * max|v| * 2^k < 2^62 (no int64 sum of n rows overflows), with k
    as large as that allows."""
    v = torch.tensor([[scale, -scale / 3, 0.0], [-scale, scale / 2, 0.0]], dtype=torch.float32)
    k, finite = PH._fixed_scale(v, n)
    amax = v.abs().amax(0).double()
    top = 62 - max(0, (n - 1).bit_length())
    for j in range(3):
        assert bool(finite[j])
        scaled = float(amax[j]) * 2.0 ** int(k[j])
        if amax[j] > 0:
            assert 2.0 ** (top - 1) <= scaled < 2.0 ** top
    q = PH._to_fixed(v, k, finite)
    assert n * int(q.abs().max()) <= 2 ** 62


def test_emulated_counts_equal_the_plain_version():
    bins, stats, mask = _inputs(4000, 7, 64, seed=8, oob=True, with_mask=True)
    a = PH.plane_histogram_emulated(_t(bins), _t(stats), _t(mask), 64)
    b = PH.plane_histogram_plain(_t(bins), _t(stats), _t(mask), 64)
    assert torch.equal(a[:, 2], b[:, 2])
    _assert_close(a.numpy(), b.numpy(), stats * mask[:, None], F64_ATOL)


# -- a wide range of magnitudes in one column ---------------------------------


def _wide_range_inputs(n, d, B, top, typical, seed):
    """Stats of magnitude ~typical, but one row's g and h at ~top: the scale
    follows the largest value, and the small ones must not lose to it."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, d)).astype(np.int32)
    stats = np.stack(
        [rng.normal(size=n) * typical, rng.uniform(0.01, 0.25, size=n) * typical, np.ones(n)], 1
    ).astype(np.float32)
    stats[n // 3, :2] = (-top, top / 4)
    return bins, stats


def _assert_f32_level(got, exact, rows, sum_abs):
    """Per cell, what f32 summation of its rows in any order may be off by:
    rows * 2^-24 * sum |v| (the rows - 1 additions and the last rounding)."""
    got = np.asarray(got, np.float64).reshape(exact.shape)
    np.testing.assert_array_equal(got[:, 2], exact[:, 2])
    for j in (0, 1):
        bound = rows * 2.0 ** -24 * sum_abs[:, j]
        err = np.abs(got[:, j] - exact[:, j])
        assert np.all(err <= bound), (j, float((err / np.maximum(bound, 1e-300)).max()))


@pytest.mark.parametrize("top,typical", [(1e6, 1e-3), (1.0, 1e-6)])
@pytest.mark.parametrize("kind", ["plane", "plane_masked", "multi"])
def test_wide_range_column_keeps_f32_accuracy(kind, top, typical):
    """One outlier row (|g| = top) among rows of magnitude ~typical, 1e9 and
    1e6 below it: every cell stays within f32's own summation error of the
    exact (f64) sum, the outlier's cell and the small-valued ones alike."""
    n, d, B, S = 8192, 4, 16, 3
    bins, stats = _wide_range_inputs(n, d, B, top, typical, seed=int(np.log10(top)) + 40)
    rng = np.random.default_rng(5)
    if kind == "multi":
        slot = rng.integers(-1, S + 1, size=n).astype(np.int32)
        slot[n // 3] = 1
        got = PH.multi_plane_histogram_emulated(_t(bins), _t(stats), _t(slot), S, B)
        exact, rows = _f64_cells(bins, stats, B, slot, S)
        sum_abs, _ = _f64_cells(bins, np.abs(stats), B, slot, S)
    else:
        mask = (rng.random(n) < 0.5).astype(np.float32) if kind == "plane_masked" else None
        if mask is not None:
            mask[n // 3] = 1.0
        got = PH.plane_histogram_emulated(_t(bins), _t(stats), _t(mask), B)
        pre = stats if mask is None else stats * mask[:, None]
        exact, _ = _f64_cells(bins, pre, B)
        sum_abs, _ = _f64_cells(bins, np.abs(pre), B)
        rows = exact[:, 2]
    _assert_f32_level(got.numpy(), exact, rows, sum_abs)


# -- the build cache key -----------------------------------------------------


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setenv("MMLSPARK_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = cuda_build._lib_path("kern.cu")
    assert cuda_build._lib_path("kern.cu") == before
    (tmp_path / "common.cuh").write_text("// v2\n")
    after = cuda_build._lib_path("kern.cu")
    assert after != before
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n// edited\n')
    assert cuda_build._lib_path("kern.cu") not in (before, after)
