"""ASHA successive-halving rung math, as pure functions.

Everything the controller decides — rung boundaries, promotion sets,
leaderboards — lives here with no I/O, no clocks and no randomness
beyond an explicit seed, because the split-brain story depends on it:
two controllers (or one controller restarted mid-experiment) that see
the same registry records MUST derive byte-identical decisions, so the
generation-CAS commit is the only arbiter ever needed. Ties are broken
by a seeded hash of the trial name, not dict order or float whims.

The PyTorch port's copy of ``mmlspark_tpu.experiments.asha``: the same
reports give both packages the same boundaries, promotion sets and
leaderboard bytes.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional


def rung_boundaries(min_iters: int, max_iters: int, eta: int) -> list:
    """Cumulative training-iteration boundaries of each rung.

    Geometric schedule ``min_iters * eta^k`` capped by ``max_iters``;
    when the budget is not a power of eta the final rung lands at
    ``max_iters`` itself (the budget is spent, not rounded away):
    ``(2, 8, 2) -> [2, 4, 8]``, ``(2, 20, 3) -> [2, 6, 18, 20]``.
    """
    min_iters, max_iters, eta = int(min_iters), int(max_iters), int(eta)
    if min_iters < 1 or max_iters < min_iters:
        raise ValueError(
            f"bad rung budget min_iters={min_iters} max_iters={max_iters}"
        )
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    bounds: list = []
    b = min_iters
    while b < max_iters:
        bounds.append(b)
        b *= eta
    bounds.append(max_iters)
    return bounds


def n_promote(n_survivors: int, eta: int) -> int:
    """How many of ``n_survivors`` advance: top ``1/eta``, floor 1 —
    a rung never strands the experiment with zero survivors."""
    if n_survivors < 1:
        raise ValueError("a rung needs at least one survivor")
    return max(1, int(n_survivors) // int(eta))


def _tiebreak(seed: int, trial: str) -> str:
    """Deterministic seeded tiebreak token: equal metrics rank by this
    hash, so the promotion set is a pure function of (reports, seed) —
    never of dict iteration order or report arrival order."""
    return hashlib.sha256(f"{seed}:{trial}".encode()).hexdigest()


def leaderboard(
    metrics: dict, seed: int, higher_is_better: bool = True
) -> list:
    """Rank ``{trial: metric}`` into ``[[trial, metric], ...]``, best
    first. Ties break by the seeded trial-name hash (then the name
    itself, for the astronomically unlikely hash tie)."""
    sign = -1.0 if higher_is_better else 1.0
    return [
        [t, float(m)]
        for t, m in sorted(
            metrics.items(),
            key=lambda kv: (
                sign * float(kv[1]), _tiebreak(seed, kv[0]), kv[0],
            ),
        )
    ]


def promote(
    metrics: dict, eta: int, seed: int, higher_is_better: bool = True
) -> tuple:
    """One rung's decision: ``(promoted_trials, leaderboard)``.

    ``promoted_trials`` is the top ``n_promote`` of the leaderboard, in
    rank order — deterministic under seeded ties, so any two controllers
    with the same reports CAS-write the identical record."""
    board = leaderboard(metrics, seed, higher_is_better)
    return [t for t, _ in board[: n_promote(len(board), eta)]], board


def rung_record(
    rung: int, promoted: list, board: list, eta: int, seed: int,
) -> dict:
    """The canonical promotion record CAS-committed for one rung. Field
    order is fixed here so the registry-stored record — and therefore a
    resumed controller's adopted copy — is byte-stable."""
    return {
        "rung": int(rung),
        "promoted": list(promoted),
        "leaderboard": [list(row) for row in board],
        "eta": int(eta),
        "seed": int(seed),
    }


def leaderboard_bytes(rungs: dict) -> bytes:
    """Canonical serialization of every committed rung's leaderboard —
    the byte string the chaos drill compares between a disturbed and an
    undisturbed same-seed run."""
    canon = {
        str(r): {
            "promoted": rec.get("promoted"),
            "leaderboard": rec.get("leaderboard"),
        }
        for r, rec in sorted(rungs.items(), key=lambda kv: int(kv[0]))
    }
    return json.dumps(canon, sort_keys=True, separators=(",", ":")).encode()


def next_rung(
    trial: str, reports: dict, boundaries: list
) -> Optional[int]:
    """The first rung index ``trial`` has not reported, or None when its
    final rung is already in. ``reports`` is keyed ``(trial, rung)``."""
    for r in range(len(boundaries)):
        if (trial, r) not in reports:
            return r
    return None


def is_demoted(trial: str, rung: int, rungs: dict) -> bool:
    """Whether a committed rung record below ``rung`` excludes ``trial``
    — the self-reaping check a waiting trial (and the controller's
    charge reaper) both run against the same registry state."""
    for r in range(int(rung)):
        rec = rungs.get(r)
        if rec is not None and trial not in rec.get("promoted", ()):
            return True
    return False


__all__ = [
    "is_demoted",
    "leaderboard",
    "leaderboard_bytes",
    "n_promote",
    "next_rung",
    "promote",
    "rung_boundaries",
    "rung_record",
]
