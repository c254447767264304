"""One ASHA trial: a single continuous process spanning rung boundaries.

A trial is a supervisor-charge-shaped process (``fleet trial``) the
controller spawns through the same pluggable ``--spawn-cmd`` hook every
other charge uses — placement is the supervisor's business, not ours.
Per rung it runs the REAL ``fleet train`` machinery (an elastic gang of
world size 1 by default) to the rung's cumulative iteration boundary,
evaluates on the held-out spec, packs its checkpoint dir and model
string into its own content-addressed store, CAS-reports
``(metric, ckpt digest, model digest)`` to the registry, then polls for
the rung's promotion record: promoted → train on to the next boundary
in-process; demoted → exit cleanly; record never arrives → exit with
the reschedule code and let the controller decide.

Rescheduling is digest-deep: a respawned trial (fresh workdir, possibly
a different host) finds its last report in the registry, fetches that
rung's checkpoint artifact from whoever advertises it, unpacks it into
its empty checkpoint dir, and trains on — checkpoint restore is exact,
so the rescheduled trial reproduces the booster (and therefore the
metric) the uninterrupted trial would have reported. That determinism
is what makes the chaos drill's byte-identical-leaderboard claim true
rather than hopeful.

Exit codes (the controller's classification input):
``0`` completed (final rung reported) · ``4`` demoted (self-reaped) ·
``3`` rung decision never arrived (controller restarts or reaps).

The PyTorch port of ``mmlspark_tpu.experiments.trial``: a trial trains on
``device`` (the card unless ``--device cpu``), where each rung's fit
launches the histogram kernels; the fixed-point histograms make a fit
bitwise repeatable there, so a stranded winner's retrain lands on the
committed digest.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

import numpy as np

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.experiments import asha, records

EXIT_COMPLETED = 0
EXIT_NO_DECISION = 3
EXIT_DEMOTED = 4

# hyperparameters a search space may legally bind — everything else in a
# sampled param map is a spawn-argv bug, rejected loudly (same contract
# TuneHyperparameters.fit enforces on estimator params)
TRAIN_PARAMS = (
    "num_leaves", "learning_rate", "min_data_in_leaf", "num_iterations",
)

_M_REPORTS = obs.counter(
    "mmlspark_experiments_reports_total",
    "Trial rung reports by result (committed | adopted | error)",
    labels=("result",),
)
_M_RUNG_SECONDS = obs.histogram(
    "mmlspark_experiments_rung_train_seconds",
    "Wall-clock of one trial's train-to-rung-boundary step",
    buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0),
)


def holdout_metric(
    booster: Any, x: np.ndarray, y: np.ndarray, device: Any = None,
) -> float:
    """Validation accuracy — deterministic in (model, data), which the
    drill's leaderboard-equivalence property requires. ``predict`` gives
    raw margins for the binary objective; the decision boundary is 0.
    ``device``: where the booster scores (None = the card)."""
    margin = np.asarray(booster.predict(x, device=device), dtype=np.float64)
    return float(np.mean((margin > 0.0) == (np.asarray(y) > 0.5)))


def _live_loop(
    urls: list, exp: str, trial: str, stop: threading.Event,
    heartbeat_s: float,
) -> None:
    info = {
        "name": records.live_service_name(exp),
        "host": trial,
        "port": os.getpid(),
    }
    while not stop.is_set():
        records.register(urls, info, timeout=2.0)
        stop.wait(heartbeat_s)


def _report_with_retry(
    urls: list, exp: str, trial: str, rung: int, metric: float,
    ckpt_digest: str, model_digest: str, iters: int, params: dict,
    attempts: int = 5, backoff_s: float = 0.2,
) -> Optional[dict]:
    """Rung reports must land: retry through injected faults and wire
    loss (the ``experiment.report`` chaos drill arms exactly this path).
    Returns the durable record, or None when every attempt failed."""
    for i in range(attempts):
        try:
            rec = records.report_trial(
                urls, exp, trial, rung, metric,
                ckpt_digest, model_digest, iters, params,
            )
            _M_REPORTS.labels(
                result="committed" if rec.get("ckpt") == ckpt_digest
                else "adopted"
            ).inc()
            return rec
        except Exception:  # noqa: BLE001 — injected or real, retry either
            _M_REPORTS.labels(result="error").inc()
            time.sleep(backoff_s * (i + 1))
    return None


def run_trial(
    registry_url: Any,
    experiment: str,
    trial: str,
    params: dict,
    data: str,
    valid: str,
    workdir: str,
    min_iters: int = 2,
    max_iters: int = 8,
    eta: int = 2,
    seed: int = 0,
    higher_is_better: bool = True,
    heartbeat_s: float = 0.5,
    poll_s: float = 0.25,
    decision_timeout_s: float = 120.0,
    partitions: int = 4,
    status_file: Optional[str] = None,
    device: Optional[str] = None,
) -> int:
    """``fleet trial``: run one trial across every rung it survives.
    ``device``: where it trains and scores (None = the card; it raises
    without one, before anything binds)."""
    from mmlspark_tpu_torch.parallel.elastic import load_training_data
    from mmlspark_tpu_torch.serving.artifacts import (
        ArtifactServer,
        ArtifactStore,
        registry_peers,
        unpack_dir,
    )
    from mmlspark_tpu_torch.core.device import resolve_device
    from mmlspark_tpu_torch.serving.fleet import run_train, split_registry_urls

    resolve_device(device)  # no card and no --device cpu: raise, bind nothing
    bad = sorted(k for k in params if k not in TRAIN_PARAMS)
    if bad:
        raise ValueError(
            f"trial {trial}: sampled param(s) {bad} are not train "
            f"hyperparameters {list(TRAIN_PARAMS)}"
        )
    urls = split_registry_urls(registry_url)
    obs.set_process_label(f"{experiment}-{trial}")
    os.makedirs(workdir, exist_ok=True)
    ckpt_dir = os.path.join(workdir, "ckpt")
    store = ArtifactStore(os.path.join(workdir, "artifacts"))
    server = ArtifactServer(
        store, registry_urls=urls,
        service=f"{experiment}-artifacts", heartbeat_s=heartbeat_s,
    )
    stop = threading.Event()
    threading.Thread(
        target=_live_loop, args=(urls, experiment, trial, stop, heartbeat_s),
        name=f"{trial}-live", daemon=True,
    ).start()
    try:
        return _run_rungs(
            urls, experiment, trial, params, data, valid, ckpt_dir,
            store, server, min_iters, max_iters, eta, seed,
            higher_is_better, heartbeat_s, poll_s, decision_timeout_s,
            partitions, status_file, registry_peers, unpack_dir,
            run_train, load_training_data, device,
        )
    finally:
        from mmlspark_tpu_torch.obs import watchdog

        watchdog.disarm("experiment.rung")
        stop.set()
        server.stop()


def _run_rungs(
    urls, experiment, trial, params, data, valid, ckpt_dir, store,
    server, min_iters, max_iters, eta, seed, higher_is_better,
    heartbeat_s, poll_s, decision_timeout_s, partitions, status_file,
    registry_peers, unpack_dir, run_train, load_training_data, device,
) -> int:
    boundaries = asha.rung_boundaries(min_iters, max_iters, eta)
    state = _read_state_retry(urls, experiment, decision_timeout_s, poll_s)
    if state is None:
        return EXIT_NO_DECISION
    rung = asha.next_rung(trial, state.reports, boundaries)
    if rung is None:
        # a twin already finished this trial — but if WE are the
        # committed winner and the model bytes have no live advertiser
        # (a controller died between winner-commit and publish, taking
        # its store with it; a successor respawned us to recover), the
        # bytes must be RE-DERIVED: re-run the final rung — training is
        # deterministic (same params, same seed), so the byte-identical
        # model lands back under the exact committed digest — and
        # linger until a replica lands elsewhere (docs/robustness.md).
        w = state.winner
        if (
            w is not None and w.get("trial") == trial and w.get("model")
            and not [
                p for p in registry_peers(urls, w["model"])
                if p != server.url
            ]
        ):
            rung = len(boundaries) - 1
        else:
            return EXIT_COMPLETED
    if asha.is_demoted(trial, rung, state.rungs):
        return EXIT_DEMOTED
    if rung > 0 and not os.path.exists(os.path.join(ckpt_dir, "LATEST")):
        # rescheduled incarnation: pull our own last rung checkpoint by
        # digest from whoever advertises it and train on from there
        prev = state.reports[(trial, rung - 1)]
        try:
            blob = store.fetch(
                prev["ckpt"], registry_peers(urls, prev["ckpt"]),
                name=f"{trial}-r{rung - 1}-ckpt",
                timeout_s=decision_timeout_s,
            )
            unpack_dir(blob, ckpt_dir)
        except Exception:  # noqa: BLE001 — nobody advertises the bytes
            # retrain from round 0 to the boundary instead: checkpointed
            # training is deterministic, so the rung metric (and the
            # leaderboard) is unchanged — only wall-clock suffers
            pass
    xv, yv = load_training_data(valid)
    from mmlspark_tpu_torch.obs import watchdog
    while rung is not None:
        t0 = time.monotonic()
        # stall forensics: a rung whose report never lands (wedged train
        # gang, dead controller) auto-dumps all-thread stacks well after
        # the controller's own decision timeout would have fired
        watchdog.tick(
            "experiment.rung", deadline_s=max(
                watchdog.DEFAULT_DEADLINE_S, 3 * decision_timeout_s,
            ),
        )
        with obs.span(
            "experiment.rung",
            attrs={"experiment": experiment, "trial": trial, "rung": rung},
        ):
            booster = run_train(
                ",".join(urls), trial, data, ckpt_dir,
                partitions=partitions, world_size=1,
                service_name=f"{experiment}-{trial}",
                num_iterations=int(boundaries[rung]),
                checkpoint_every=1, heartbeat_s=heartbeat_s,
                seed=seed, status_file=status_file,
                # a twin incarnation (controller respawn racing a live
                # orphan) must NEVER grow into this gang: two members
                # co-training would change the model and break the
                # leaderboard's same-seed determinism
                allow_growback=False,
                device=device,
                **{k: v for k, v in params.items()
                   if k != "num_iterations"},
            )
        _M_RUNG_SECONDS.observe(time.monotonic() - t0)
        metric = holdout_metric(booster, xv, yv, device=device)
        ck = store.put(ckpt_dir, name=f"{trial}-r{rung}-ckpt")
        model = store.put_bytes(
            booster.to_model_string().encode(),
            name=f"{trial}-r{rung}.gbdt.json",
        )
        server.heartbeat()  # advertise the new digests before reporting
        rec = _report_with_retry(
            urls, experiment, trial, rung, metric,
            ck.digest, model.digest, int(boundaries[rung]), params,
        )
        if rec is None:
            return EXIT_NO_DECISION
        if rung == len(boundaries) - 1:
            # linger until the winner record lands: the controller must
            # replicate this trial's model bytes from OUR artifact server
            # before it commits the winner (exiting now would strand the
            # digest with no advertiser — the publish path would starve)
            _await_winner(urls, experiment, poll_s, decision_timeout_s)
            # and if the committed winner names OUR bytes, hold the
            # server open until some OTHER peer advertises the digest —
            # exiting while we are the only advertiser re-opens the
            # stranded-winner window this linger exists to close
            _await_replica(
                urls, experiment, trial, model.digest, server,
                registry_peers, poll_s, decision_timeout_s,
            )
            return EXIT_COMPLETED
        verdict = _await_decision(
            urls, experiment, trial, rung, poll_s, decision_timeout_s,
        )
        if verdict is None:
            return EXIT_NO_DECISION
        if not verdict:
            return EXIT_DEMOTED
        rung += 1
    return EXIT_COMPLETED


def _read_state_retry(
    urls: list, exp: str, timeout_s: float, poll_s: float
) -> Optional[records.ExperimentState]:
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return records.read_state(urls, exp)
        except records.ExperimentWireError:
            if time.monotonic() > deadline:
                return None
            time.sleep(poll_s)


def _await_winner(
    urls: list, exp: str, poll_s: float, timeout_s: float
) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if records.read_state(urls, exp).winner is not None:
                return
        except records.ExperimentWireError:
            pass
        time.sleep(poll_s)


def _await_replica(
    urls: list, exp: str, trial: str, digest: str, server: Any,
    registry_peers: Any, poll_s: float, timeout_s: float,
) -> None:
    """Linger while this process is the committed winner's ONLY
    advertiser: return once another peer (the controller's store, a
    worker, a successor controller) advertises ``digest`` — or the
    bounded timeout passes. A controller killed between winner-commit
    and publish leaves a successor that must re-pull these exact bytes;
    this window is what it pulls through."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            state = records.read_state(urls, exp)
        except records.ExperimentWireError:
            state = None
        if state is None or state.winner is None:
            return  # record gone / unreadable: nothing left to guard
        if (
            state.winner.get("trial") != trial
            or state.winner.get("model") != digest
        ):
            return  # not our bytes: not our guard
        try:
            others = [
                p for p in registry_peers(urls, digest) if p != server.url
            ]
        except Exception:  # noqa: BLE001 — registry blinked; poll again
            others = []
        if others:
            return
        server.heartbeat()  # keep the advertisement fresh meanwhile
        time.sleep(poll_s)


def _await_decision(
    urls: list, exp: str, trial: str, rung: int,
    poll_s: float, timeout_s: float,
) -> Optional[bool]:
    """Poll for rung ``rung``'s promotion record: True promoted, False
    demoted, None when no decision landed inside the timeout."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            state = records.read_state(urls, exp)
        except records.ExperimentWireError:
            state = None
        if state is not None:
            rec = state.rungs.get(rung)
            if rec is not None:
                return trial in rec.get("promoted", ())
        if time.monotonic() > deadline:
            return None
        time.sleep(poll_s)


def params_json(params: dict) -> str:
    """Canonical argv form of a sampled param map — byte-stable, so a
    restarted controller rebuilds the identical spawn command."""
    return json.dumps(params, sort_keys=True, separators=(",", ":"))


__all__ = [
    "EXIT_COMPLETED",
    "EXIT_DEMOTED",
    "EXIT_NO_DECISION",
    "TRAIN_PARAMS",
    "holdout_metric",
    "params_json",
    "run_trial",
]
