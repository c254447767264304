"""Round-level checkpoint/resume for the GBDT boosting loop.

The port's copy of ``mmlspark_tpu.models.gbdt.checkpoint``: the same
on-disk layout and the same config fingerprint, so a checkpoint directory
written by either package loads in the other. A preempted host has
nothing to replay — the booster lives in process memory. These
checkpoints make the loop preemption-safe: every ``checkpoint_every``
rounds the trainer serializes the grown trees, the device score/bagging
state (exact f32), the host RNG stream and the early-stopping counters,
and ``train(resume_from=...)`` continues from the last completed round
producing a model **bit-identical** to an uninterrupted run
(tests/test_torch_port_continue.py proves it).

On-disk layout (atomic against preemption mid-save)::

    <dir>/round-0000012/state.json     # round, rng state, counters, fingerprint
                        booster.json   # trees grown so far (model string)
                        arrays.npz     # scores, bag (unpadded first-n rows)
    <dir>/LATEST                       # name of the last COMPLETE round dir

``LATEST`` is os.replace()d only after the round dir is fully written, so
a save torn by preemption leaves the previous checkpoint loadable; stale
round dirs beyond ``keep_last`` are pruned best-effort.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch.models.gbdt.booster import Booster

_FORMAT = "mmlspark_tpu_gbdt_ckpt_v1"
_LATEST = "LATEST"


def config_fingerprint(cfg: Any, n: int, d: int, k: int) -> str:
    """Hash of everything that must match for a resumed run to be the
    same run: determinism-relevant hyperparameters + data shape. Excludes
    ``num_iterations`` (resume may legitimately extend the budget) and
    the delegate (host callbacks carry no trained state)."""
    payload = {
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(cfg)
        if f.name not in ("num_iterations", "delegate", "verbosity")
    }
    payload.update(n=int(n), d=int(d), k=int(k))
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclass
class TrainCheckpoint:
    """Everything the boosting loop needs to continue from ``round``."""

    round: int                       # next iteration index to run
    booster: Booster                 # trees of completed rounds (new trees only)
    scores: np.ndarray               # (n,) or (n, k) f32 running scores
    bag: Optional[np.ndarray]        # (n,) f32 bagging mask carry, if bagging
    rng_state: dict                  # np.random.Generator bit_generator state
    fingerprint: str
    best_val: Optional[float] = None
    best_iter: int = -1
    rounds_no_improve: int = 0
    lr: float = 0.1


def save_checkpoint(
    ckpt_dir: str, ckpt: TrainCheckpoint, keep_last: int = 2
) -> str:
    """Write one checkpoint; returns the round directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"round-{ckpt.round:07d}"
    tmp = os.path.join(ckpt_dir, f".tmp-{name}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arrays = {"scores": np.asarray(ckpt.scores, np.float32)}
    if ckpt.bag is not None:
        arrays["bag"] = np.asarray(ckpt.bag, np.float32)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "booster.json"), "w") as f:
        f.write(ckpt.booster.to_model_string())
    with open(os.path.join(tmp, "state.json"), "w") as f:
        json.dump(
            {
                "format": _FORMAT,
                "round": ckpt.round,
                "rng_state": ckpt.rng_state,
                "fingerprint": ckpt.fingerprint,
                "best_val": ckpt.best_val,
                "best_iter": ckpt.best_iter,
                "rounds_no_improve": ckpt.rounds_no_improve,
                "lr": ckpt.lr,
            },
            f,
        )
    final = os.path.join(ckpt_dir, name)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    # the commit point: LATEST flips only once the round dir is complete
    latest_tmp = os.path.join(ckpt_dir, f".{_LATEST}-{os.getpid()}")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(ckpt_dir, _LATEST))
    if keep_last > 0:
        rounds = [e for e in os.listdir(ckpt_dir) if e.startswith("round-")]
        # newest by mtime, NOT by round number: a fresh run writing low
        # round numbers into a dir still holding a previous run's higher
        # rounds must never prune its own just-committed checkpoint (the
        # one LATEST points at) in favor of the stale leftovers
        rounds.sort(
            key=lambda e: os.path.getmtime(os.path.join(ckpt_dir, e))
        )
        keep = set(rounds[-keep_last:]) | {name}
        for stale in rounds:
            if stale not in keep:
                shutil.rmtree(
                    os.path.join(ckpt_dir, stale), ignore_errors=True
                )
    return final


def load_checkpoint(ckpt_dir: str) -> Optional[TrainCheckpoint]:
    """Load the last complete checkpoint, or None when the directory holds
    none (a fresh run). Torn saves are invisible: only round dirs named by
    ``LATEST`` are ever read."""
    latest_path = os.path.join(ckpt_dir, _LATEST)
    if not os.path.exists(latest_path):
        return None
    with open(latest_path) as f:
        name = f.read().strip()
    rdir = os.path.join(ckpt_dir, name)
    with open(os.path.join(rdir, "state.json")) as f:
        state = json.load(f)
    if state.get("format") != _FORMAT:
        raise ValueError(
            f"unrecognized checkpoint format {state.get('format')!r} in {rdir}"
        )
    with open(os.path.join(rdir, "booster.json")) as f:
        booster = Booster.from_model_string(f.read())
    with np.load(os.path.join(rdir, "arrays.npz")) as z:
        scores = z["scores"]
        bag = z["bag"] if "bag" in z.files else None
    return TrainCheckpoint(
        round=int(state["round"]),
        booster=booster,
        scores=scores,
        bag=bag,
        rng_state=state["rng_state"],
        fingerprint=state["fingerprint"],
        best_val=state.get("best_val"),
        best_iter=int(state.get("best_iter", -1)),
        rounds_no_improve=int(state.get("rounds_no_improve", 0)),
        lr=float(state.get("lr", 0.1)),
    )
