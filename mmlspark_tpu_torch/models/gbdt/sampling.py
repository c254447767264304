"""Random draws of a GBDT fit: row sampling (bagging, GOSS), per-round
feature masks and dart's dropped rounds.

Device draws go through one function, :func:`uniform`, seeded from
``(seed, round, stream)`` alone (stream 1: bagging, stream 2: GOSS), so a
round's draw depends on nothing drawn before it. The JAX package draws
the same streams with ``jax.random.fold_in(fold_in(PRNGKey(seed), round),
stream)``; Threefry and PyTorch's generators cannot give the same bits, so
the two packages' draws differ by design, and the parity tests replace
:func:`uniform` with the JAX package's own draws.

Host draws (feature masks, dart) come from ``numpy.random.default_rng(seed)``
in the JAX package's order, so the same seed gives the same masks and the
same dropped rounds. None of them depends on the data, so they are all
drawn before the first round and reach the device in one copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BAGGING_STREAM = 1
GOSS_STREAM = 2


def uniform(seed: int, it: int, stream: int, n: int, device: torch.device) -> torch.Tensor:
    """(n,) f32 uniform in [0, 1) on ``device`` for round ``it`` of draw
    stream ``stream``. A generator on the device itself, so the draw needs
    no host-to-device copy (and no sync)."""
    key = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(it), int(stream)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return torch.rand(n, generator=gen, device=device, dtype=torch.float32)


def goss_weights(g_abs: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                 top_rate: float, other_rate: float) -> torch.Tensor:
    """Gradient-based one-side sampling weights: among rows with w > 0,
    every row whose |g| reaches the ``top_rate`` share's threshold keeps
    weight 1 (a value threshold: ties admit extra rows, as in the JAX
    package), a random ``other_rate / (1 - top_rate)`` share of the rest
    gets (1 - top_rate) / other_rate, the remainder 0. In f32 throughout,
    as the reference computes it; no host sync."""
    # the rates as f32 (host tensors: no copy to the device); a Python
    # float that holds an f32 value enters a device op as that f32
    tr = torch.tensor(top_rate, dtype=torch.float32)
    orr = torch.tensor(other_rate, dtype=torch.float32)
    eligible = w > 0
    n_eligible = torch.clamp_min(eligible.sum(), 1)
    n_top = torch.clamp_min((n_eligible.float() * float(tr)).to(torch.int32), 1)
    masked = torch.where(eligible, g_abs, -torch.inf)
    srt = torch.sort(masked, descending=True).values
    at = torch.clamp(n_top - 1, 0, masked.shape[0] - 1).long().view(1)
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


def draw_rounds(seed: int, rounds: int, d: int, feature_fraction: float,
                dart: bool = False, drop_rate: float = 0.1, max_drop: int = 50,
                skip_drop: float = 0.5) -> RoundDraws:
    """Per round: the feature mask (``rng.random(d) < feature_fraction``,
    one random feature if none is drawn), then for dart after round 0 the
    skip draw, the per-earlier-round drop draws and, past ``max_drop``,
    the choice among them — the reference's interleaving exactly."""
    rng = np.random.default_rng(seed)
    fms = np.ones((rounds, d), np.float32)
    drops: list = []
    for it in range(rounds):
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
    return RoundDraws(fms, drops)
