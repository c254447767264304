"""Random draws of a GBDT fit: row sampling (bagging, GOSS), per-round
feature masks and dart's dropped rounds.

Device draws go through one function, :func:`uniform`: element ``i`` of
round ``it``'s draw of stream ``stream`` (1: bagging, 2: GOSS) is
``jax.random.uniform(fold_in(fold_in(PRNGKey(seed), it), stream), (n,))[i]``
bit for bit. With JAX's partitionable Threefry (its default) that element
is ``bits1 ^ bits2`` of ``threefry2x32(key, (hi(i), lo(i)))`` turned into a
float in [1, 2) by its top 23 bits, minus 1: pure 32-bit integer
arithmetic, computed here with PyTorch ops on int64 tensors of the
request's device. So the same seed gives the same bagged or GOSS model in
both packages, a round's draw depends on nothing drawn before it (a
resumed fit redraws it), and no draw needs a host copy or a sync.

Host draws (feature masks, dart) come from ``numpy.random.default_rng(seed)``
in the JAX package's order, so the same seed gives the same masks and the
same dropped rounds. None of them depends on the data, so they are all
drawn before the first round and reach the device in one copy.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from mmlspark_tpu_torch.parallel import collectives

BAGGING_STREAM = 1
GOSS_STREAM = 2


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1: int, k2: int, x1, x2) -> tuple:
    """Threefry-2x32 (20 rounds), as ``jax._src.prng._threefry2x32_lowering``
    computes it, on Python ints or int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1, x2 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) & _M32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def fold_in(key: tuple, data) -> tuple:
    """``jax.random.fold_in(key, data)`` of a raw (2,) uint32 key:
    ``threefry2x32(key, (0, data))``. ``key`` and ``data`` are ints or
    int64 tensors holding uint32 values (a device scalar ``data`` keeps
    the key on the device, with no host arithmetic)."""
    return _threefry2x32(key[0], key[1], 0, data & _M32)


def round_key(seed: int, it, stream: int) -> tuple:
    """``fold_in(fold_in(PRNGKey(seed), it), stream)`` as two uint32s:
    ``PRNGKey`` of JAX's default 32-bit integers keys ``(0, seed mod
    2**32)``. ``it`` is an int (host arithmetic) or an int64 device
    scalar (then the key is two int64 device scalars, computed by the
    same arithmetic, so a captured CUDA graph recomputes it on replay)."""
    key = (0, int(seed) & _M32)
    return fold_in(fold_in(key, it), stream)


def random_bits(key: tuple, n: int, device: torch.device, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, (N,))[offset:offset + n]`` (32 bits each, as
    int64 values) with JAX's partitionable Threefry: element i is
    ``bits1 ^ bits2`` of ``threefry2x32(key, (hi(i), lo(i)))``, whatever N;
    a multi-dimensional draw is the flat draw of its row-major element
    count."""
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(key[0], key[1], i >> 32, i & _M32)
    return b1 ^ b2


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> f32 in [0, 1): the top 23 as the mantissa of a
    float in [1, 2), minus 1 (``jax.random.uniform``)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(seed: int, it, stream: int, n: int, device: torch.device,
            offset: int = 0) -> torch.Tensor:
    """(n,) f32 uniform in [0, 1) on ``device`` for round ``it`` of draw
    stream ``stream``: the JAX package's Threefry draw, bit for bit. With
    an int ``it`` the key is host arithmetic; with an int64 device scalar
    it is computed on the device (the fused rounds' captured round).
    ``offset``: the draw's elements from there on, as a rank takes its
    block of the rows' global positions."""
    return bits_to_unit(random_bits(round_key(seed, it, stream), n, device, offset))


def goss_weights(g_abs: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                 top_rate: float, other_rate: float, ranks: Any = None) -> torch.Tensor:
    """Gradient-based one-side sampling weights: among rows with w > 0,
    every row whose |g| reaches the ``top_rate`` share's threshold keeps
    weight 1 (a value threshold: ties admit extra rows, as in the JAX
    package), a random ``other_rate / (1 - top_rate)`` share of the rest
    gets (1 - top_rate) / other_rate, the remainder 0. In f32 throughout,
    as the reference computes it; no host sync.

    ``ranks`` (a fit over two or more ranks): the threshold and the
    eligible count are those of every rank's rows, as the JAX package's
    sort over the process-spanning rows gives them: ``ranks.gather`` gives
    every rank the masked |g| of all the rows in global order and the
    counts are all-reduced, so the threshold's bits are one rank's on all
    the rows."""
    # the rates as f32 (host tensors: no copy to the device); a Python
    # float that holds an f32 value enters a device op as that f32
    tr = torch.tensor(top_rate, dtype=torch.float32)
    orr = torch.tensor(other_rate, dtype=torch.float32)
    eligible = w > 0
    n_eligible = eligible.sum()
    masked = torch.where(eligible, g_abs, -torch.inf)
    pool = masked
    if ranks is not None:
        n_eligible, pool = collectives.allreduce_sum(n_eligible), ranks.gather(masked)
    n_eligible = torch.clamp_min(n_eligible, 1)
    n_top = torch.clamp_min((n_eligible.float() * float(tr)).to(torch.int32), 1)
    srt = torch.sort(pool, descending=True).values
    at = torch.clamp(n_top - 1, 0, pool.shape[0] - 1).long().view(1)
    is_top = eligible & (masked >= srt.index_select(0, at))
    # each non-top row is kept with probability b / (1 - a) and amplified
    # by (1 - a) / b: its expected histogram weight is exactly 1
    p_other = float(torch.clamp_max(orr / torch.clamp_min(1 - tr, 1e-12), 1.0))
    amp = float((1.0 - tr) / torch.clamp_min(orr, 1e-12))
    is_other = eligible & ~is_top & (u < p_other)
    return torch.where(is_top, 1.0, torch.where(is_other, amp, 0.0))


class RoundDraws(NamedTuple):
    """The host draws of every round, in the JAX package's order."""

    feature_masks: np.ndarray   # (rounds, d) f32 1/0
    drops: list                 # per round, the dropped earlier rounds (dart)
    states: dict                # round r -> the generator's state before its draws


def draw_rounds(seed: int, rounds: int, d: int, feature_fraction: float,
                dart: bool = False, drop_rate: float = 0.1, max_drop: int = 50,
                skip_drop: float = 0.5, start: int = 0,
                state: "dict | None" = None) -> RoundDraws:
    """Per round: the feature mask (``rng.random(d) < feature_fraction``,
    one random feature if none is drawn), then for dart after round 0 the
    skip draw, the per-earlier-round drop draws and, past ``max_drop``,
    the choice among them — the reference's interleaving exactly.

    A resumed fit draws rounds ``start`` on from the generator ``state``
    its checkpoint saved (rounds before ``start`` get no draws); ``states``
    holds the state before each round's draws, and at ``rounds``, for the
    next checkpoint."""
    rng = np.random.default_rng(seed)
    if state is not None:
        rng.bit_generator.state = state
    fms = np.ones((rounds, d), np.float32)
    drops: list = [[] for _ in range(min(start, rounds))]
    states: dict = {}
    for it in range(start, rounds):
        states[it] = rng.bit_generator.state
        if feature_fraction < 1.0:
            fm = (rng.random(d) < feature_fraction).astype(np.float32)
            if fm.sum() == 0:
                fm[rng.integers(d)] = 1.0
            fms[it] = fm
        sel: list = []
        if dart and it > 0 and rng.random() >= skip_drop:
            picked = np.flatnonzero(rng.random(it) < drop_rate)
            if len(picked) > max_drop:
                picked = rng.choice(picked, max_drop, replace=False)
            sel = [int(s) for s in picked]
        drops.append(sel)
    states[max(start, rounds)] = rng.bit_generator.state
    return RoundDraws(fms, drops, states)
