"""Experiment state on the registry wire: write-once CAS records.

Every durable fact of an experiment — a trial's rung report, a rung's
promotion set, the winner — is a generation-CAS record (the registry's
``/generation/commit`` endpoint shape): named ``...-gen``, committed at
``gen=1`` with ``expected_gen=0``, so the FIRST writer wins and every
later attempt gets a 409 carrying the winning record to adopt. That one
property is the whole coordination story: reports from a rescheduled
trial, promotions from a restarted (or twin) controller, and the winner
stamp all converge without locks, and the records are TTL-exempt and
anti-entropy-merged like any other generation record — an experiment
survives registry restarts and partitions exactly as gangs do.

Record names under experiment ``<exp>``::

    <exp>-trial-<trial>-r<rung>-gen   one trial's rung report
    <exp>-rung-<rung>-gen             one rung's promotion record
    <exp>-winner-gen                  the published winner

Trial liveness rides plain (TTL-governed) roster entries under
``<exp>-trials-live`` keyed by trial name — presence means a trial
process is heartbeating somewhere, which is all the controller needs to
avoid double-spawning an orphan it did not itself start.

The PyTorch port's copy of ``mmlspark_tpu.experiments.records``: the same
record names and JSON, so records either package commits read back in
the other.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Optional

from mmlspark_tpu_torch.core import faults


class ExperimentWireError(Exception):
    """No registry majority answered — the caller retries next tick."""


def _post(url: str, path: str, body: dict, timeout: float) -> tuple:
    from mmlspark_tpu_torch.io.clients import send_request
    from mmlspark_tpu_torch.io.http_schema import HTTPRequestData

    resp = send_request(HTTPRequestData(
        url.rstrip("/") + path, "POST",
        {"Content-Type": "application/json"}, json.dumps(body),
    ), timeout=timeout)
    try:
        payload = json.loads(resp["entity"]) if resp["entity"] else {}
    except ValueError:
        payload = {}
    return resp["status_code"], payload


def cas_commit(
    registry_urls: Any,
    name: str,
    record: dict,
    gen: int = 1,
    expected_gen: int = 0,
    timeout: float = 5.0,
) -> tuple:
    """Commit ``record`` under ``name`` on a strict majority of
    registries. Returns ``(committed, current)``: ``(True, None)`` when
    this write won, ``(False, winner_record)`` when an earlier commit
    holds the name (adopt it — by construction it is what a same-seed
    peer derived from the same reports). Raises
    :class:`ExperimentWireError` when no majority of registries
    acknowledged either way (partition/registry loss: retry)."""
    from mmlspark_tpu_torch.serving.fleet import split_registry_urls

    urls = split_registry_urls(registry_urls)
    need = len(urls) // 2 + 1
    acks = 0
    current: Optional[dict] = None
    body = {
        "name": name, "gen": int(gen), "expected_gen": int(expected_gen),
        "record": record,
    }
    for url in urls:
        try:
            code, payload = _post(url, "/generation/commit", body, timeout)
        except Exception:  # noqa: BLE001 — a dead registry is a missing ack
            continue
        if code == 200 and payload.get("committed"):
            acks += 1
        elif code == 409:
            acks += 1  # a definitive answer IS an ack — the name is taken
            if current is None and payload.get("current"):
                current = dict(payload["current"])
    if acks < need:
        raise ExperimentWireError(
            f"{name}: only {acks}/{len(urls)} registries answered "
            f"(need {need})"
        )
    return current is None, current


def register(
    registry_urls: Any, info: dict, timeout: float = 5.0
) -> int:
    """Plain roster POST of ``info`` to every registry; returns how many
    acknowledged (liveness heartbeats — best-effort by design)."""
    from mmlspark_tpu_torch.serving.fleet import split_registry_urls

    ok = 0
    for url in split_registry_urls(registry_urls):
        try:
            code, _ = _post(url, "/", info, timeout)
            ok += code == 200
        except Exception:  # noqa: BLE001 — registry may be restarting
            pass
    return ok


def fetch_roster(registry_urls: Any, timeout: float = 5.0) -> dict:
    """The first answering registry's roster dump (registry HA: the
    anti-entropy loop keeps generation records converged across peers,
    and generation records are all the experiment state there is)."""
    from mmlspark_tpu_torch.io.clients import send_request
    from mmlspark_tpu_torch.io.http_schema import HTTPRequestData
    from mmlspark_tpu_torch.serving.fleet import split_registry_urls

    last: Optional[Exception] = None
    for url in split_registry_urls(registry_urls):
        try:
            resp = send_request(
                HTTPRequestData(url.rstrip("/") + "/", "GET"),
                timeout=timeout,
            )
            if resp["status_code"] == 200:
                return json.loads(resp["entity"])
        except Exception as e:  # noqa: BLE001 — try the next registry
            last = e
    raise ExperimentWireError(f"no registry answered a roster read: {last}")


# -- record naming ------------------------------------------------------------


def trial_record_name(exp: str, trial: str, rung: int) -> str:
    return f"{exp}-trial-{trial}-r{int(rung)}-gen"


def rung_record_name(exp: str, rung: int) -> str:
    return f"{exp}-rung-{int(rung)}-gen"


def winner_record_name(exp: str) -> str:
    return f"{exp}-winner-gen"


def live_service_name(exp: str) -> str:
    return f"{exp}-trials-live"


# -- reconstruction -----------------------------------------------------------


@dataclass
class ExperimentState:
    """Everything a controller needs, reconstructed from one roster
    read — the resume-from-registry contract: a restarted controller
    calling :func:`read_state` continues exactly where the records say
    the experiment is, with no local state at all."""

    reports: dict = field(default_factory=dict)  # (trial, rung) -> record
    rungs: dict = field(default_factory=dict)    # rung -> record
    winner: Optional[dict] = None
    live: dict = field(default_factory=dict)     # trial -> roster entry

    def rung_metrics(self, trials: list, rung: int) -> dict:
        """``{trial: metric}`` over the trials that reported ``rung`` —
        the input of :func:`~mmlspark_tpu_torch.experiments.asha.promote`."""
        out = {}
        for t in trials:
            rec = self.reports.get((t, rung))
            if rec is not None:
                out[t] = float(rec["metric"])
        return out


def state_from_roster(exp: str, roster: dict) -> ExperimentState:
    """Pure reconstruction of :class:`ExperimentState` from a registry
    roster dump — separated from the wire read so the resume-equivalence
    property (state built incrementally == state reconstructed) is
    testable without a registry."""
    st = ExperimentState()
    trial_re = re.compile(
        re.escape(exp) + r"-trial-(.+)-r(\d+)-gen$"
    )
    rung_re = re.compile(re.escape(exp) + r"-rung-(\d+)-gen$")
    for name, entries in roster.items():
        if not entries:
            continue
        m = trial_re.match(name)
        if m:
            st.reports[(m.group(1), int(m.group(2)))] = dict(entries[0])
            continue
        m = rung_re.match(name)
        if m:
            st.rungs[int(m.group(1))] = dict(entries[0])
            continue
        if name == winner_record_name(exp):
            st.winner = dict(entries[0])
        elif name == live_service_name(exp):
            for e in entries:
                st.live[str(e.get("host"))] = dict(e)
    return st


def read_state(
    registry_urls: Any, exp: str, timeout: float = 5.0
) -> ExperimentState:
    return state_from_roster(exp, fetch_roster(registry_urls, timeout))


def report_trial(
    registry_urls: Any,
    exp: str,
    trial: str,
    rung: int,
    metric: float,
    ckpt_digest: str,
    model_digest: str,
    iters: int,
    params: dict,
    timeout: float = 5.0,
) -> dict:
    """CAS-commit one trial's rung report; returns the DURABLE record —
    this write's on a win, the incumbent's on a lose (first report wins:
    a rescheduled trial re-deriving the same deterministic metric simply
    adopts its earlier self). Fault point ``experiment.report``: an
    injected error aborts the report before the wire (retried by the
    trial loop); a delay stalls it."""
    faults.inject(
        "experiment.report",
        context={"experiment": exp, "trial": trial, "rung": int(rung)},
    )
    record = {
        "trial": trial,
        "rung": int(rung),
        "metric": float(metric),
        "ckpt": ckpt_digest,
        "model": model_digest,
        "iters": int(iters),
        "params": dict(params),
    }
    committed, current = cas_commit(
        registry_urls, trial_record_name(exp, trial, rung), record,
        timeout=timeout,
    )
    return record if committed else current


__all__ = [
    "ExperimentState",
    "ExperimentWireError",
    "cas_commit",
    "fetch_roster",
    "live_service_name",
    "read_state",
    "register",
    "report_trial",
    "rung_record_name",
    "state_from_roster",
    "trial_record_name",
    "winner_record_name",
]
