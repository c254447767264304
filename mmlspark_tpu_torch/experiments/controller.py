"""ExperimentController: ASHA over the fleet (``fleet tune``).

The controller owns no truth. Every decision it makes — who reported
what, who advances, who won — is derived from registry records and
committed back as a write-once generation-CAS record, so a SIGKILLed
controller restarted cold resumes the experiment mid-rung from registry
state alone, and a split-brain twin derives the identical promotion set
(pure ASHA math, seeded ties) and simply adopts the CAS incumbent.

What it DOES own: processes and bytes. Trials are supervisor charges
(:class:`~mmlspark_tpu_torch.serving.supervisor.WorkerCharge`) spawned through
the same pluggable ``--spawn-cmd`` template the supervisor uses, so
placement is an operator concern; the controller respawns charges that
die unclassified (SIGKILL, wedge) and reaps the demoted. And it
replicates every reported checkpoint/model artifact into its OWN store
as soon as the report lands — trial processes exit, their artifact
servers with them, but the controller keeps advertising the bytes a
rescheduled trial (or the winner publication) will need.

Accounting is per-controller and classified exactly once per charge
death, which is what makes the invariant law exact::

    trials_spawned == completed + demoted + rescheduled + running

The PyTorch port of ``mmlspark_tpu.experiments.controller``: host code
whose charges run the port's fleet, ``python -m
mmlspark_tpu_torch.serving.fleet trial --device <device>`` (the card by
default), with the JAX package's records and metric names; a trial's
argv is the JAX controller's plus ``--device`` and its status file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Optional

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.experiments import asha, records
from mmlspark_tpu_torch.experiments.trial import (
    EXIT_DEMOTED,
    params_json,
)

_M_SPAWNS = obs.counter(
    "mmlspark_experiments_trials_spawned_total",
    "Trial charges spawned (incarnations, not distinct trials)",
)
_M_PROMOTIONS = obs.counter(
    "mmlspark_experiments_promotions_total",
    "Rung promotion records by result (committed | adopted)",
    labels=("result",),
)
_M_DEMOTIONS = obs.counter(
    "mmlspark_experiments_demotions_total",
    "Trial charges classified demoted (self-exited or reaped)",
)
_M_RESCHEDULES = obs.counter(
    "mmlspark_experiments_reschedules_total",
    "Trial charges that died unclassified and were respawned",
)
_M_RUNGS = obs.gauge(
    "mmlspark_experiments_rungs_committed_count",
    "Rung promotion records visible in the registry",
)
_M_EXPERIMENT_S = obs.histogram(
    "mmlspark_experiments_experiment_seconds",
    "Wall-clock of one full experiment (first spawn to winner)",
    buckets=(1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0),
)


class ExperimentError(Exception):
    """The experiment cannot make progress (reschedule budget spent,
    wall-clock deadline passed)."""


def default_space() -> list:
    """The stock GBDT search space (restricted to trial-legal params)."""
    from mmlspark_tpu_torch.automl.hyperparams import (
        DiscreteHyperParam,
        RangeHyperParam,
    )

    return [
        ("num_leaves", DiscreteHyperParam([7, 15, 31])),
        ("learning_rate", RangeHyperParam(0.05, 0.3, log=True)),
        ("min_data_in_leaf", DiscreteHyperParam([5, 10, 20])),
    ]


def space_from_json(obj: dict) -> list:
    """CLI search-space JSON -> ``RandomSpace`` pairs: a list is a
    :class:`DiscreteHyperParam`, ``{"low", "high", "log"?, "int"?}`` a
    :class:`RangeHyperParam`."""
    from mmlspark_tpu_torch.automl.hyperparams import (
        DiscreteHyperParam,
        RangeHyperParam,
    )

    out: list = []
    for name, spec in sorted(obj.items()):
        if isinstance(spec, list):
            out.append((name, DiscreteHyperParam(spec)))
        elif isinstance(spec, dict) and "low" in spec and "high" in spec:
            out.append((name, RangeHyperParam(
                spec["low"], spec["high"],
                is_int=bool(spec.get("int")), log=bool(spec.get("log")),
            )))
        else:
            raise ValueError(
                f"space entry {name!r}: want a value list or "
                '{"low": .., "high": .., "log"?: bool, "int"?: bool}'
            )
    return out


def sample_trials(space: list, n_trials: int, seed: int) -> dict:
    """``{trial_name: param_map}`` — pure in (space, n, seed), so a
    restarted controller regenerates the byte-identical spawn argvs."""
    from mmlspark_tpu_torch.automl.hyperparams import RandomSpace

    draws = list(RandomSpace(space, seed=seed).param_maps(n_trials))
    return {f"t{i:03d}": dict(pm) for i, pm in enumerate(draws)}


class ExperimentController:
    def __init__(
        self,
        registry_url: Any,
        experiment: str,
        n_trials: int = 6,
        space: Optional[list] = None,
        data: str = "synth:512x8:1",
        valid: str = "synth:256x8:99",
        min_iters: int = 2,
        max_iters: int = 8,
        eta: int = 2,
        seed: int = 0,
        higher_is_better: bool = True,
        workdir: Optional[str] = None,
        spawn_cmd: Optional[str] = None,
        placement: Any = None,
        python: Optional[str] = None,
        tick_s: float = 0.25,
        heartbeat_s: float = 0.5,
        poll_s: float = 0.25,
        decision_timeout_s: float = 120.0,
        partitions: int = 4,
        max_reschedules: int = 5,
        publish_model: Optional[str] = None,
        publish_service: str = "serving",
        publish_epoch: Optional[int] = None,
        status_file: Optional[str] = None,
        deadline_s: float = 600.0,
        device: str = "cuda",
    ):
        """``device``: the trials' ``--device`` (``cuda``, the default:
        each trial trains on the card and raises without one; or
        ``cpu``)."""
        from mmlspark_tpu_torch.serving.fleet import split_registry_urls
        from mmlspark_tpu_torch.serving.supervisor import (
            placement_from_spec,
            spawn_from_template,
        )

        if n_trials < 1:
            raise ValueError("n_trials must be >= 1")
        self.urls = split_registry_urls(registry_url)
        if not self.urls:
            raise ValueError("fleet tune needs --registry")
        self.experiment = experiment
        self.boundaries = asha.rung_boundaries(min_iters, max_iters, eta)
        self.min_iters, self.max_iters, self.eta = (
            int(min_iters), int(max_iters), int(eta),
        )
        self.seed = int(seed)
        self.higher_is_better = bool(higher_is_better)
        self.params = sample_trials(
            space if space is not None else default_space(),
            n_trials, self.seed,
        )
        self.trials = sorted(self.params)
        self.data, self.valid = data, valid
        self.workdir = workdir or os.path.join(
            os.getcwd(), f".experiments-{experiment}"
        )
        # trial placement mirrors the supervisor's hook: a
        # PlacementProvider (or its --placement spec string) decides
        # where trial processes land — remotely-placed trials publish
        # rung reports and model bytes through the artifact plane, so
        # the controller never needs to share a filesystem with them
        if isinstance(placement, str):
            placement = placement_from_spec(placement)
        if placement is not None:
            self._spawn_fn = placement.spawn
        else:
            self._spawn_fn = (
                spawn_from_template(spawn_cmd) if spawn_cmd
                else lambda argv: subprocess.Popen(argv)
            )
        self.python = python
        self.tick_s = tick_s
        self.heartbeat_s = heartbeat_s
        self.poll_s = poll_s
        self.decision_timeout_s = decision_timeout_s
        self.partitions = int(partitions)
        self.max_reschedules = int(max_reschedules)
        self.publish_model = publish_model
        self.publish_service = publish_service
        self.publish_epoch = publish_epoch
        self.status_file = status_file
        self.deadline_s = float(deadline_s)
        self.device = str(device)
        # charge bookkeeping (per-controller, per the conservation law)
        self.charges: dict = {}       # trial -> WorkerCharge (latest)
        self.incarnations: dict = {}  # trial -> spawn count
        self.spawned = 0
        self.completed = 0
        self.demoted = 0
        self.rescheduled = 0
        self.published = False
        self._publisher: Any = None
        self._store: Any = None
        self._server: Any = None

    # -- infrastructure -------------------------------------------------------

    def _ensure_artifact_plane(self) -> None:
        from mmlspark_tpu_torch.serving.artifacts import ArtifactServer, ArtifactStore

        if self._store is None:
            os.makedirs(self.workdir, exist_ok=True)
            self._store = ArtifactStore(
                os.path.join(self.workdir, "controller-artifacts")
            )
            self._server = ArtifactServer(
                self._store, registry_urls=self.urls,
                service=f"{self.experiment}-artifacts",
                heartbeat_s=self.heartbeat_s,
            )

    def close(self) -> None:
        for charge in self.charges.values():
            if charge.alive():
                charge.proc.kill()
                charge.proc.wait()
        if self._server is not None:
            self._server.stop()
            self._server = None

    # -- charges --------------------------------------------------------------

    def _trial_argv(self, trial: str, incarnation: int) -> list:
        """The trial's ``fleet trial`` argv: the JAX controller's, run by
        the port's fleet on ``self.device``, plus the trial's ``fleet
        train`` status file (its histogram launches among its fields) in
        its workdir."""
        workdir = os.path.join(self.workdir, trial, f"i{incarnation:02d}")
        argv = [
            self.python or sys.executable, "-m",
            "mmlspark_tpu_torch.serving.fleet", "trial",
            "--device", self.device,
            "--registry", ",".join(self.urls),
            "--experiment", self.experiment,
            "--trial", trial,
            "--params", params_json(self.params[trial]),
            "--data", self.data,
            "--valid", self.valid,
            "--workdir", workdir,
            "--min-iters", str(self.min_iters),
            "--max-iters", str(self.max_iters),
            "--eta", str(self.eta),
            "--seed", str(self.seed),
            "--heartbeat-s", str(self.heartbeat_s),
            "--poll-s", str(self.poll_s),
            "--decision-timeout-s", str(self.decision_timeout_s),
            "--partitions", str(self.partitions),
            "--status-file", os.path.join(workdir, "status.json"),
        ]
        if not self.higher_is_better:
            argv.append("--lower-is-better")
        return argv

    def _spawn(self, trial: str) -> None:
        from mmlspark_tpu_torch.serving.supervisor import WorkerCharge

        faults.inject(
            "experiment.spawn",
            context={"experiment": self.experiment, "trial": trial},
        )
        inc = self.incarnations.get(trial, 0) + 1
        if inc - 1 > self.max_reschedules:
            raise ExperimentError(
                f"trial {trial} exhausted its reschedule budget "
                f"({self.max_reschedules})"
            )
        self.incarnations[trial] = inc
        charge = WorkerCharge(
            self._trial_argv(trial, inc),
            name=f"{self.experiment}-{trial}-i{inc:02d}",
        )
        charge.proc = self._spawn_fn(charge.argv)
        charge.started_at = time.monotonic()
        self.charges[trial] = charge
        self.spawned += 1
        _M_SPAWNS.inc()

    def _is_live_elsewhere(
        self, trial: str, state: records.ExperimentState
    ) -> bool:
        """A fresh liveness heartbeat from an incarnation we do not hold
        (an orphan of a previous controller) — never double-spawn it."""
        entry = state.live.get(trial)
        if entry is None:
            return False
        ts = float(entry.get("ts") or 0.0)
        return time.time() - ts < max(3.0 * self.heartbeat_s, 2.0)

    def _classify_dead(
        self, trial: str, rc: Optional[int],
        state: records.ExperimentState,
    ) -> str:
        final = len(self.boundaries) - 1
        if (trial, final) in state.reports:
            return "completed"
        if rc == EXIT_DEMOTED or asha.is_demoted(
            trial, len(self.boundaries), state.rungs
        ):
            return "demoted"
        return "rescheduled"

    def _reap_and_respawn(self, state: records.ExperimentState) -> None:
        for trial in self.trials:
            charge = self.charges.get(trial)
            if charge is not None and not charge.alive():
                rc = charge.proc.poll() if charge.proc else None
                del self.charges[trial]
                kind = self._classify_dead(trial, rc, state)
                if kind == "completed":
                    self.completed += 1
                elif kind == "demoted":
                    self.demoted += 1
                    _M_DEMOTIONS.inc()
                else:
                    self.rescheduled += 1
                    _M_RESCHEDULES.inc()
            if trial in self.charges:
                continue  # alive
            if asha.next_rung(
                trial, state.reports, self.boundaries
            ) is None:
                continue  # experiment-complete for this trial
            if asha.is_demoted(trial, len(self.boundaries), state.rungs):
                continue
            if self._is_live_elsewhere(trial, state):
                continue  # an orphan incarnation is still working
            self._spawn(trial)

    def _reap_demoted(self, state: records.ExperimentState) -> None:
        """Stop live charges of demoted trials; classification happens
        at the next reap pass (their registry state says demoted)."""
        for trial, charge in self.charges.items():
            if charge.alive() and asha.is_demoted(
                trial, len(self.boundaries), state.rungs
            ):
                charge.proc.terminate()

    # -- artifacts ------------------------------------------------------------

    def _replicate(self, state: records.ExperimentState) -> None:
        """Pull every reported checkpoint/model blob we do not yet hold
        into the controller store. Trial servers are ephemeral; this
        store is what outlives them (reschedule + winner publication)."""
        from mmlspark_tpu_torch.serving.artifacts import registry_peers

        self._ensure_artifact_plane()
        for (trial, rung), rec in sorted(state.reports.items()):
            for key, suffix in (("ckpt", "-ckpt"), ("model", ".gbdt.json")):
                digest = rec.get(key)
                if not digest or self._store.has(digest):
                    continue
                peers = [
                    p for p in registry_peers(self.urls, digest)
                    if p != self._server.url
                ]
                if not peers:
                    continue  # advertiser gone; re-derived on reschedule
                try:
                    self._store.fetch(
                        digest, peers, name=f"{trial}-r{rung}{suffix}",
                        timeout_s=10.0,
                    )
                except Exception:  # noqa: BLE001 — retried next tick
                    pass

    def _recover_winner(self, state: records.ExperimentState) -> None:
        """The stranded-winner residual, closed: a successor
        controller that finds ``<exp>-winner-gen`` committed but holds
        none of the model bytes re-pulls them by digest — the record's
        spec hints first (they name the holders that confirmed at commit
        time), then every registry-advertised peer. Only when NOBODY
        advertises the digest does it fall back to the deterministic
        retrain: respawn the winner trial, whose same params + seed
        re-derive the byte-identical model under the exact committed
        digest (experiments/trial.py re-runs the final rung when it is
        the unadvertised committed winner)."""
        if state.winner is None or self._store is None:
            return
        digest = state.winner.get("model")
        if not digest or self._store.has(digest):
            return
        own = self._server.url if self._server is not None else None
        hints: list = []
        tail = (state.winner.get("spec") or "").rsplit("@", 1)[-1]
        if tail.startswith("http"):
            hints = [u for u in tail.split(",") if u and u != own]
        from mmlspark_tpu_torch.serving.artifacts import registry_peers

        peers = hints + [
            p for p in registry_peers(self.urls, digest)
            if p != own and p not in hints
        ]
        if peers:
            try:
                self._store.fetch(
                    digest, peers,
                    name=f"{state.winner.get('trial', 'winner')}.gbdt.json",
                    timeout_s=10.0,
                )
                self._server.heartbeat()  # advertise the recovered copy
                return
            except Exception:  # noqa: BLE001 — every peer gone: retrain
                pass
        trial = state.winner.get("trial")
        if (
            trial and trial in self.params
            and trial not in self.charges
            and not self._is_live_elsewhere(trial, state)
        ):
            self._spawn(trial)

    # -- decisions ------------------------------------------------------------

    def _survivors(self, rung: int, state: records.ExperimentState) -> list:
        trials = list(self.trials)
        for r in range(rung):
            rec = state.rungs.get(r)
            if rec is None:
                return []  # earlier rung undecided: nobody is at `rung`
            trials = [t for t in trials if t in rec.get("promoted", ())]
        return trials

    def _promote_ready_rungs(self, state: records.ExperimentState) -> None:
        for rung in range(len(self.boundaries)):
            if rung in state.rungs:
                continue
            survivors = self._survivors(rung, state)
            if not survivors:
                return
            metrics = state.rung_metrics(survivors, rung)
            if set(metrics) != set(survivors):
                return  # reports still outstanding; nothing deeper ready
            faults.inject(
                "experiment.promote",
                context={"experiment": self.experiment, "rung": rung},
            )
            promoted, board = asha.promote(
                metrics, self.eta, self.seed, self.higher_is_better
            )
            rec = asha.rung_record(
                rung, promoted, board, self.eta, self.seed
            )
            committed, current = records.cas_commit(
                self.urls, records.rung_record_name(self.experiment, rung),
                rec,
            )
            _M_PROMOTIONS.labels(
                result="committed" if committed else "adopted"
            ).inc()
            state.rungs[rung] = rec if committed else current
            return  # one decision per tick; reaping runs before the next

    def _commit_winner(self, state: records.ExperimentState) -> None:
        final = len(self.boundaries) - 1
        frec = state.rungs.get(final)
        if frec is None or state.winner is not None:
            return
        winner = frec["promoted"][0]
        report = state.reports.get((winner, final))
        if report is None:
            return
        if self._store is not None and not self._store.has(
            report["model"]
        ):
            # the winner record is only committed once WE hold the model
            # bytes: the winner trial lingers (advertising them) until
            # the record appears, so committing first would tear down
            # the last advertiser before replication — retried next tick
            return
        # replicate-before-commit: push the winner bytes to every other
        # rostered artifact plane (serving workers, lingering trials)
        # BEFORE the record lands, and bake the confirmed holders into
        # the record's spec hints — a controller SIGKILLed right after
        # this commit strands nothing a successor (or a worker's own
        # resolve path) cannot re-pull. Best-effort by design: with no
        # other holders on the roster our store + the lingering trial
        # still cover the normal path, and the successor's
        # deterministic-retrain fallback covers the rest.
        confirmed: list = []
        if self._store is not None:
            from mmlspark_tpu_torch.serving.artifacts import registry_holders

            own = [self._server.url] if self._server is not None else []
            try:
                # exclude the experiment's own ephemeral plane: a
                # replica confirmed on a lingering trial (or this very
                # controller) dies with the experiment — only DURABLE
                # holders (serving workers, gang members) count
                holders = registry_holders(
                    self.urls, exclude=own,
                    exclude_services=[f"{self.experiment}-artifacts"],
                )
                if holders:
                    confirmed = self._store.replicate(
                        report["model"], holders,
                        need=min(1, len(holders)), timeout_s=10.0,
                    )
            except Exception:  # noqa: BLE001 — below quorum: commit
                confirmed = []  # proceeds on the local + trial copies
        spec = (
            f"artifact:gbdt:{winner}-r{final}.gbdt.json@{report['model']}"
        )
        hints = [self._server.url] if self._server is not None else []
        hints += [u for u in confirmed if u not in hints]
        if hints:
            spec += "@" + ",".join(hints)
        rec = {
            "trial": winner,
            "metric": float(report["metric"]),
            "model": report["model"],
            "params": dict(report.get("params") or {}),
            "spec": spec,
        }
        committed, current = records.cas_commit(
            self.urls, records.winner_record_name(self.experiment), rec,
        )
        state.winner = rec if committed else current

    def _publish_winner(self, state: records.ExperimentState) -> None:
        if (
            self.published or state.winner is None
            or not self.publish_model
        ):
            return
        from mmlspark_tpu_torch.online.publisher import Publisher, PublishError

        if self._publisher is None:
            self._publisher = Publisher(
                model=self.publish_model,
                registry_url=",".join(self.urls),
                service_name=self.publish_service,
                epoch=self.publish_epoch,
            )
        spec = state.winner["spec"]
        if self._server is not None and not spec.rsplit(
            "@", 1
        )[-1].startswith("http"):
            # a winner record adopted from a dead controller hints that
            # controller's (gone) ingress — re-hint our own replica
            if self._store is not None and self._store.has(
                state.winner["model"]
            ):
                spec += f"@{self._server.url}"
        try:
            self._publisher.publish_spec(spec)
            self.published = True
        except PublishError:
            pass  # workers may still be warming; retried next tick

    # -- status ---------------------------------------------------------------

    def running(self) -> int:
        """Spawned and not yet classified — NOT process-alive: a charge
        that died microseconds ago still counts as running until the
        reap pass classifies it, which is what keeps the conservation
        law exact in every status snapshot (every spawn adds exactly one
        charge entry, every classification removes exactly one)."""
        return len(self.charges)

    def status(self, state: Optional[records.ExperimentState]) -> dict:
        rungs = dict(state.rungs) if state is not None else {}
        return {
            "experiment": self.experiment,
            "seed": self.seed,
            "eta": self.eta,
            "boundaries": list(self.boundaries),
            "trials": len(self.trials),
            "trials_spawned": self.spawned,
            "completed": self.completed,
            "demoted": self.demoted,
            "rescheduled": self.rescheduled,
            "running": self.running(),
            "rungs": {
                str(r): list(rec.get("promoted", ()))
                for r, rec in sorted(rungs.items())
            },
            "winner": (
                dict(state.winner)
                if state is not None and state.winner else None
            ),
            "published": self.published,
            "ts": time.time(),
        }

    def _write_status(self, state: Optional[records.ExperimentState]) -> None:
        if not self.status_file:
            return
        tmp = self.status_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.status(state), f, sort_keys=True)
        os.replace(tmp, self.status_file)

    # -- the loop -------------------------------------------------------------

    def tick(self) -> Optional[records.ExperimentState]:
        """One reconcile pass; returns the state it acted on (None when
        no registry answered — nothing was decided this tick)."""
        try:
            state = records.read_state(self.urls, self.experiment)
        except records.ExperimentWireError:
            self._write_status(None)
            return None
        self._replicate(state)
        self._promote_ready_rungs(state)
        _M_RUNGS.set(len(state.rungs))
        self._reap_demoted(state)
        self._reap_and_respawn(state)
        self._recover_winner(state)
        self._commit_winner(state)
        self._publish_winner(state)
        self._write_status(state)
        return state

    def done(self, state: Optional[records.ExperimentState]) -> bool:
        if state is None or state.winner is None:
            return False
        if self.publish_model and not self.published:
            return False
        return self.running() == 0

    def run(self) -> dict:
        """Drive the experiment to a published winner; returns the final
        status dict (plus the canonical leaderboard bytes digest)."""
        import hashlib

        t0 = time.monotonic()
        deadline = t0 + self.deadline_s
        self._ensure_artifact_plane()
        state: Optional[records.ExperimentState] = None
        with obs.span(
            "experiment.run",
            attrs={
                "experiment": self.experiment,
                "trials": len(self.trials),
            },
        ):
            while True:
                state = self.tick()
                if self.done(state):
                    break
                if time.monotonic() > deadline:
                    self.close()
                    raise ExperimentError(
                        f"experiment {self.experiment} missed its "
                        f"{self.deadline_s:.0f}s deadline"
                    )
                time.sleep(self.tick_s)
        _M_EXPERIMENT_S.observe(time.monotonic() - t0)
        out = self.status(state)
        out["leaderboard_sha256"] = hashlib.sha256(
            asha.leaderboard_bytes(state.rungs)
        ).hexdigest()
        print(
            f"tune: {self.experiment} winner {out['winner']['trial']} "
            f"metric {out['winner']['metric']:.4f} "
            f"leaderboard sha256 {out['leaderboard_sha256']}",
            flush=True,
        )
        return out


__all__ = [
    "ExperimentController",
    "ExperimentError",
    "default_space",
    "sample_trials",
    "space_from_json",
]
