"""ChaosConductor: timed hostile-wire scenarios against a live fleet.

One scenario = one seeded, replayable storm: at declared offsets it
swaps :class:`~mmlspark_tpu_torch.chaos.wire.WireRule` sets on named
:class:`~mmlspark_tpu_torch.chaos.wire.ChaosProxy` links, sends process
signals (SIGKILL / SIGSTOP / SIGCONT / SIGTERM) to named fleet pids,
and finally runs the :class:`~mmlspark_tpu_torch.chaos.invariants.
InvariantChecker`. Every action is journaled with its wall-clock time
and a trace id, and mirrored into the flight recorder
(``obs/flightrec.py``) — an incident found in a soak correlates with
``fleet trace`` / flight dumps the same way a production incident would.

The PyTorch port's copy of ``mmlspark_tpu.chaos.conductor``: host code
(proxies, signals, ``/metrics`` scrapes) with the JAX package's scenario
format and journal entries; the same seed gives the same proxies' schedule
digests in both packages.

Scenario JSON (inline or a file path; ``fleet chaos --scenario``)::

    {"seed": 7, "steps": [
      {"at_s": 0.0, "action": "rules", "link": "gw",
       "rules": [{"kind": "latency", "delay_ms": 5, "jitter_ms": 5}]},
      {"at_s": 2.0, "action": "signal", "target": "worker-1",
       "signal": "SIGSTOP"},
      {"at_s": 4.0, "action": "signal", "target": "worker-1",
       "signal": "SIGCONT"},
      {"at_s": 5.0, "action": "clear", "link": "gw"},
      {"at_s": 6.0, "action": "check"}
    ]}

``partition`` / ``heal`` are the split-brain macro: ``{"action":
"partition", "links": ["reg-b", "ar-a"]}`` expands to a symmetric
``blackhole`` rule (both directions) on EVERY named link, and ``heal``
clears those links — one step cuts a member off from the registry and
its peers at once, the drill docs/chaos.md builds on.

Steps run in ``at_s`` order against one monotonic clock, so the same
scenario against the same fleet replays the same storm; the wire-level
schedule inside each window is the proxy's own seeded contract
(chaos/wire.py). Unknown links/targets fail the scenario LOAD, not the
run — a typo'd chaos plan must not silently do nothing.
"""

from __future__ import annotations

import json
import signal as signal_mod
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.chaos.wire import WireRule

_M_ACTIONS = obs.counter(
    "mmlspark_chaos_actions_total",
    "Conductor scenario actions executed, by action kind",
    labels=("action",),
)

_ACTIONS = (
    "rules", "clear", "signal", "check", "sleep", "mark",
    "partition", "heal",
)
_SIGNALS = {
    "SIGKILL": signal_mod.SIGKILL,
    "SIGSTOP": signal_mod.SIGSTOP,
    "SIGCONT": signal_mod.SIGCONT,
    "SIGTERM": signal_mod.SIGTERM,
    "SIGUSR1": signal_mod.SIGUSR1,
}


@dataclass
class Scenario:
    """A validated chaos scenario: seed + time-ordered steps."""

    seed: int = 0
    steps: list = field(default_factory=list)

    @staticmethod
    def from_spec(spec: Any) -> "Scenario":
        """Dict / JSON string / path to a JSON file -> Scenario."""
        if isinstance(spec, str):
            s = spec.strip()
            if not s.startswith("{"):
                with open(spec) as f:
                    s = f.read()
            spec = json.loads(s)
        steps = []
        for raw in spec.get("steps", ()):
            step = dict(raw)
            action = step.get("action")
            if action not in _ACTIONS:
                raise ValueError(
                    f"unknown scenario action {action!r}; known: {_ACTIONS}"
                )
            if action == "signal" and step.get("signal") not in _SIGNALS:
                raise ValueError(
                    f"unknown signal {step.get('signal')!r}; known: "
                    f"{sorted(_SIGNALS)}"
                )
            if action == "rules":
                # validate eagerly: a typo'd rule kind must fail the load
                step["rules"] = [
                    r if isinstance(r, WireRule) else WireRule.from_dict(r)
                    for r in step.get("rules", ())
                ]
            if action in ("partition", "heal"):
                # normalize: a partition names the SET of links it cuts
                # (``links``; bare ``link`` accepted for a 1-link cut)
                links = step.get("links")
                if links is None:
                    links = [step["link"]] if step.get("link") else []
                if not links:
                    raise ValueError(
                        f"{action} step needs 'links' (or 'link'): the "
                        f"set of proxy links to cut/restore"
                    )
                step["links"] = list(links)
                step.pop("link", None)
            step["at_s"] = float(step.get("at_s", 0.0))
            steps.append(step)
        steps.sort(key=lambda s: s["at_s"])
        return Scenario(seed=int(spec.get("seed", 0)), steps=steps)


class ChaosConductor:
    """Drive one :class:`Scenario` against named proxies and pids.

    ``proxies``: name -> :class:`ChaosProxy` (already started).
    ``pids``: name -> pid (or a callable returning the CURRENT pid, for
    supervised charges whose pid changes across restarts).
    ``checker``: an :class:`~mmlspark_tpu_torch.chaos.invariants.
    InvariantChecker` the ``check`` action runs (optional)."""

    def __init__(
        self,
        scenario: Scenario,
        proxies: Optional[dict] = None,
        pids: Optional[dict] = None,
        checker: Any = None,
    ):
        self.scenario = scenario
        self.proxies = dict(proxies or {})
        self.pids = dict(pids or {})
        self.checker = checker
        self.journal: list = []
        self.violations: list = []
        for step in scenario.steps:
            link = step.get("link")
            if step["action"] in ("rules", "clear") and \
                    link not in self.proxies:
                raise ValueError(
                    f"scenario names unknown link {link!r}; known: "
                    f"{sorted(self.proxies)}"
                )
            if step["action"] in ("partition", "heal"):
                for ln in step["links"]:
                    if ln not in self.proxies:
                        raise ValueError(
                            f"scenario names unknown link {ln!r}; known: "
                            f"{sorted(self.proxies)}"
                        )
            if step["action"] == "signal" and \
                    step.get("target") not in self.pids:
                raise ValueError(
                    f"scenario names unknown target "
                    f"{step.get('target')!r}; known: {sorted(self.pids)}"
                )

    def _journal_action(self, step: dict, t_rel: float, **extra) -> None:
        trace_id = obs.new_trace_id()
        entry = {
            "t_wall": time.time(),
            "t_rel_s": round(t_rel, 4),
            "trace_id": trace_id,
            "action": step["action"],
            **{
                k: v for k, v in step.items()
                if k not in ("action", "rules") and v is not None
            },
            **extra,
        }
        if "rules" in step:
            entry["rules"] = [r.kind for r in step["rules"]]
        self.journal.append(entry)
        _M_ACTIONS.labels(action=step["action"]).inc()
        # mirror into the flight recorder: a chaos action interleaves
        # with the requests it broke in any post-incident dump
        from mmlspark_tpu_torch.obs import flightrec

        flightrec.record(
            "chaos", trace_id=trace_id, path=step["action"],
            detail=json.dumps(
                {k: v for k, v in entry.items()
                 if k in ("link", "target", "signal", "rules", "note")}
            ),
        )

    def _pid_of(self, target: str) -> int:
        p = self.pids[target]
        return int(p() if callable(p) else p)

    def run(self) -> list:
        """Execute the scenario; returns the journal. ``self.violations``
        accumulates EVERY ``check`` action's invariant violations — a
        mid-soak red followed by a green final check must still fail
        the run (docs/chaos.md: exit 1 when a check found violations)."""
        import os

        t0 = time.monotonic()
        for step in self.scenario.steps:
            delay = step["at_s"] - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            t_rel = time.monotonic() - t0
            action = step["action"]
            if action == "rules":
                self.proxies[step["link"]].set_rules(step["rules"])
                self._journal_action(step, t_rel)
            elif action == "clear":
                self.proxies[step["link"]].clear_rules()
                self._journal_action(step, t_rel)
            elif action == "signal":
                pid = self._pid_of(step["target"])
                try:
                    os.kill(pid, _SIGNALS[step["signal"]])
                    self._journal_action(step, t_rel, pid=pid)
                except ProcessLookupError:
                    self._journal_action(
                        step, t_rel, pid=pid, error="no such process"
                    )
            elif action == "check":
                if self.checker is not None:
                    found = self.checker.check(
                        final=bool(step.get("final", False))
                    )
                    self.violations.extend(found)
                    self._journal_action(
                        step, t_rel, violations=len(found)
                    )
                else:
                    self._journal_action(step, t_rel, skipped=True)
            elif action == "partition":
                # a symmetric partition is the paired blackhole: every
                # named link swallows BOTH directions — connects still
                # succeed (the proxy accepts), bytes never arrive, the
                # exact shape under which both halves suspect the other
                for ln in step["links"]:
                    self.proxies[ln].set_rules(
                        [WireRule(kind="blackhole", direction="both")]
                    )
                self._journal_action(step, t_rel)
            elif action == "heal":
                for ln in step["links"]:
                    self.proxies[ln].clear_rules()
                self._journal_action(step, t_rel)
            elif action == "sleep":
                self._journal_action(step, t_rel)
            elif action == "mark":
                self._journal_action(step, t_rel)
        return self.journal


def run_chaos_cli(
    scenario_spec: str,
    proxy_specs: list,
    pid_specs: list,
    gateway_url: Optional[str] = None,
    registry_url: Optional[str] = None,
    service_name: str = "serving",
    seed: Optional[int] = None,
    status_files: Any = (),
    online_url: Optional[str] = None,
    experiment_status_files: Any = (),
) -> int:
    """``fleet chaos`` entrypoint: build proxies from ``name=listen_port:
    target_host:target_port`` specs, pids from ``name=PID``, run the
    scenario, print the journal JSON. Exit code 1 when a ``check``
    action found violations. ``online_url`` (a ``fleet online`` ingress)
    and ``experiment_status_files`` (``fleet tune`` status files) add the
    checker's ``online_conservation`` and ``experiment_conservation`` /
    ``single_promotion`` laws."""
    from mmlspark_tpu_torch.chaos.invariants import InvariantChecker
    from mmlspark_tpu_torch.chaos.wire import ChaosProxy

    scenario = Scenario.from_spec(scenario_spec)
    if seed is not None:
        scenario.seed = seed
    proxies: dict = {}
    try:
        for spec in proxy_specs:
            name, _, rest = spec.partition("=")
            parts = rest.split(":")
            if len(parts) != 3:
                raise ValueError(
                    f"--proxy wants name=listen_port:target_host:"
                    f"target_port, got {spec!r}"
                )
            proxies[name] = ChaosProxy(
                parts[1], int(parts[2]), listen_port=int(parts[0]),
                seed=scenario.seed, name=name,
            ).start()
        pids = {}
        for spec in pid_specs:
            name, _, pid = spec.partition("=")
            pids[name] = int(pid)
        checker = None
        if (
            gateway_url or registry_url or status_files or online_url
            or experiment_status_files
        ):
            checker = InvariantChecker(
                gateway_url=gateway_url, registry_url=registry_url,
                service_name=service_name, status_files=status_files,
                online_url=online_url,
                experiment_status_files=experiment_status_files,
            )
        conductor = ChaosConductor(
            scenario, proxies=proxies, pids=pids, checker=checker
        )
        journal = conductor.run()
        print(json.dumps({
            "journal": journal,
            "violations": [str(v) for v in conductor.violations],
            "schedules": {
                name: p.schedule_digest() for name, p in proxies.items()
            },
        }, indent=2), flush=True)
        return 1 if conductor.violations else 0
    finally:
        for p in proxies.values():
            p.stop()


__all__ = ["ChaosConductor", "Scenario", "run_chaos_cli"]
