"""The port's row draws (``sampling.uniform``) against JAX's Threefry, on
the CPU.

``sampling.uniform(seed, it, stream, n)`` must equal
``jax.random.uniform(fold_in(fold_in(PRNGKey(seed), it), stream), (n,))``
bit for bit (tolerance: none, the f32 words are compared as integers), for
any seed, round, stream and length, so the same seed gives the same bagged
and GOSS models in both packages. The host draws (feature masks, dart's
drops) must resume from a checkpoint's generator state exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.train import TrainConfig as JConfig
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.models.gbdt import TrainConfig, train
from mmlspark_tpu_torch.models.gbdt import sampling as PS

CPU = torch.device("cpu")
SEEDS = (0, 7, 2**31 - 1, -12345, 2**40 + 3)


def jax_uniform(seed: int, it: int, stream: int, n: int) -> np.ndarray:
    import jax

    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), it), stream)
    return np.array(jax.random.uniform(key, (n,)))


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_jax_bitwise(seed, n):
    for it in (0, 1, 13, 999):
        for stream in (PS.BAGGING_STREAM, PS.GOSS_STREAM):
            got = PS.uniform(seed, it, stream, n, CPU)
            assert got.dtype == torch.float32 and got.shape == (n,)
            want = jax_uniform(seed, it, stream, n)
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32),
                                          err_msg=f"seed={seed} it={it} stream={stream}")


@pytest.mark.parametrize("seed", SEEDS)
def test_round_key_equals_fold_in(seed):
    import jax

    for it, stream in ((0, 1), (5, 2), (2**31 + 3, 1)):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), it), stream)
        assert PS.round_key(seed, it, stream) == tuple(
            int(v) for v in np.array(jax.random.key_data(key)))


@pytest.mark.parametrize("key,counter,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answers(key, counter, want):
    """Random123's known-answer vectors, on ints and on int64 tensors."""
    assert PS._threefry2x32(*key, *counter) == want
    t = PS._threefry2x32(*key, torch.tensor([counter[0]]), torch.tensor([counter[1]]))
    assert (int(t[0]), int(t[1])) == want


def test_uniform_counts_past_32_bits():
    """Element i's counter is (hi(i), lo(i)): the draw at 2**32 + j uses
    the high word, so it is no repeat of element j."""
    k1, k2 = PS.round_key(3, 1, 1)
    lo = PS._threefry2x32(k1, k2, 0, 5)
    hi = PS._threefry2x32(k1, k2, 1, 5)
    assert lo != hi


def test_uniform_is_in_unit_interval():
    u = PS.uniform(11, 2, PS.GOSS_STREAM, 100_000, CPU)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


@pytest.mark.parametrize("dart", [False, True])
def test_draw_rounds_resume_from_state(dart):
    """Rounds drawn from a checkpoint's generator state equal the
    uninterrupted run's rounds."""
    kw = dict(feature_fraction=0.6, dart=dart, drop_rate=0.4, max_drop=2, skip_drop=0.3)
    full = PS.draw_rounds(5, 12, 9, **kw)
    for start in (1, 5, 11, 12):
        part = PS.draw_rounds(5, 12, 9, start=start, state=full.states[start], **kw)
        np.testing.assert_array_equal(part.feature_masks[start:], full.feature_masks[start:])
        assert part.drops[start:] == full.drops[start:]
        assert part.states[12] == full.states[12]


@pytest.fixture
def reference_device_grower(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_HOST", "0")


@pytest.mark.parametrize("kw", [
    dict(bagging_fraction=0.7, bagging_freq=2),
    dict(boosting_type="goss", top_rate=0.3, other_rate=0.2),
    dict(boosting_type="rf", bagging_fraction=0.6, bagging_freq=1),
], ids=["bagging", "goss", "rf"])
def test_sampled_regression_fit_equals_jax(reference_device_grower, kw):
    """A sampled fit of a regression (no ``exp`` in its gradients) on the
    port's own draws: the same split records as the JAX package's fit."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(400, 5)).astype(np.float32)
    y = (x[:, 0] * 2 + x[:, 1] * x[:, 2] + rng.normal(size=400) * 0.1).astype(np.float64)
    cfg = dict(objective="regression", num_iterations=5, num_leaves=7, min_data_in_leaf=5,
               seed=9, **kw)
    ref = jtrain(x, y, JConfig(**cfg), shard=False)
    port = train(x, y, TrainConfig(**cfg), device="cpu")
    assert len(port.trees) == len(ref.trees) == 5
    for a, b in zip(ref.trees, port.trees):
        for f in ("leaf", "feature", "active", "threshold", "counts"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        np.testing.assert_allclose(b.values, a.values, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("key", [(0, 5), (123456789, 3987654321), (0xFFFFFFFF, 0x80000000)])
def test_cpu_int32_rounds_equal_the_int64_rounds(key):
    """``random_bits`` with int keys on the CPU runs the rounds in int32:
    the same bits as the int64 form, across the 2^32 counter boundary."""
    got = PS.random_bits(key, 200_000, torch.device("cpu"), offset=(1 << 32) - 100_000)
    i = torch.arange((1 << 32) - 100_000, (1 << 32) + 100_000)
    b1, b2 = PS._threefry2x32(key[0], key[1], i >> 32, i & 0xFFFFFFFF)
    assert torch.equal(got, b1 ^ b2)
