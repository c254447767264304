"""Fleet-wide conservation-law checker: nothing accepted goes unaccounted.

A hostile wire (chaos/wire.py) may flip, drop, drip or reset anything —
the fleet's contract is not "no errors", it is **accounting**: every
request the gateway accepted was answered (forwarded or failed, never
lost), every worker reply matches a worker accept, every ingested online
example is trained, buffered, shed or poisoned — never silently gone —
and control-plane state (breakers, refcounts, quarantine) stays sane.

:class:`InvariantChecker` scrapes every role's ``/metrics`` (the same
Prometheus text any external scraper reads) and evaluates the invariant
catalogue (docs/chaos.md):

==========================  ==================================================
``gateway_conservation``    gateway accepted == forwarded + failed (final;
                            ``>=`` while traffic is still in flight)
``fleet_conservation``      sum(worker accepted) >= gateway forwarded —
                            every answered forward was accepted by SOME
                            worker (retries/hedges only ever inflate the
                            worker side); skipped when any worker's
                            /metrics is unreachable, and DISABLED for the
                            checker's lifetime once any worker churns: a
                            previously-seen URL gone from the roster
                            (SIGKILL then TTL-prune/scale-in takes its
                            accepted counter with it) or an accepted
                            counter going BACKWARD at a same-port URL (a
                            supervisor respawn restarts the counter while
                            gateway forwarded spans both eras) — either
                            way the cross-era sum can never balance, and
                            a conservative skip beats a false red
``worker_conservation``     per role: the ingress in-flight gauge (accepted
                            requests not yet replied — the routing table)
                            drains to zero (final)
``modelstore_refs_drain``   in-flight version refcounts drain to zero
                            (final) — hot-swap/continuous-batching leaks
                            show up here
``admission_drain``         admission in-flight gauge drains to zero (final)
``online_conservation``     ingested + spill-replayed examples == trained
                            + buffered + shed + poisoned (replay re-enters
                            a fresh process whose ingested counter died
                            with the previous incarnation)
``breaker_sane``            every breaker-state gauge is 0/1/2
``retry_budget_sane``       retry-budget-remaining gauge is in [0, 1]
``generation_monotonic``    every registry's committed ``<service>-gen``
                            record only moves forward across checker
                            passes — a backward step is a resurrected,
                            superseded world (split-brain rollback)
``single_writer``           across trainer status files, no two members
                            claim to have committed the same generation
                            (``committed_gens`` join) — commit makes a
                            member the epoch's writer, so a double claim
                            is split-brain made visible
``experiment_conservation`` per experiment-controller status file:
                            trials_spawned == completed + demoted +
                            rescheduled + running — a trial the
                            controller spawned but lost track of is an
                            orphan process burning fleet capacity
``single_promotion``        across every controller status file of the
                            same experiment, at most ONE promoted set
                            per rung — two controllers promoting
                            different survivors is the tuning-plane
                            flavour of split-brain, which the rung
                            records' write-once generation CAS exists
                            to forbid
``artifact_quarantine``     every failed verification quarantined
                            (verify_failures == quarantines, final only:
                            the failure counter lands before the
                            quarantine's disk work, so a mid-soak scrape
                            can see the gap); with a live
                            :class:`~mmlspark_tpu_torch.serving.artifacts.
                            ArtifactStore` handle, no quarantined digest is
                            advertised or servable
==========================  ==================================================

``check(final=False)`` (DURING a soak) evaluates only the inequality
forms; ``check(final=True)`` (after traffic drains) demands equalities.
Used by ``fleet chaos``.

The PyTorch port's copy of ``mmlspark_tpu.chaos.invariants``: host code
that reads metric families by name, so it gives the JAX checker's
verdicts on the same ``/metrics`` texts and status files, whichever
package's roles wrote them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from mmlspark_tpu_torch import obs

_M_CHECKS = obs.counter(
    "mmlspark_chaos_invariant_checks_total",
    "Invariant-checker passes, by verdict (green / violated)",
    labels=("verdict",),
)
_M_VIOLATIONS = obs.gauge(
    "mmlspark_chaos_invariant_violations_count",
    "Violations found by the most recent invariant-checker pass",
)


@dataclass
class Violation:
    """One broken conservation law."""

    name: str
    where: str
    detail: str

    def __str__(self) -> str:
        return f"{self.name}@{self.where}: {self.detail}"


def _sum(parsed: dict, name: str, match: Optional[dict] = None) -> float:
    return obs.sum_samples(parsed, name, match)


def _series(parsed: dict, name: str) -> list:
    """Every (labels, value) sample of a family."""
    return [
        (dict(labels), v)
        for (n, labels), v in parsed.items()
        if n == name
    ]


class InvariantChecker:
    """Scrape-and-verify. ``scrape`` is injectable for unit tests (takes
    a base URL, returns parsed samples or None)."""

    def __init__(
        self,
        gateway_url: Optional[str] = None,
        worker_urls: Any = (),
        online_url: Optional[str] = None,
        registry_url: Optional[str] = None,
        service_name: str = "serving",
        scrape: Optional[Callable] = None,
        stores: Any = (),
        tolerance: int = 0,
        status_files: Any = (),
        experiment_status_files: Any = (),
    ):
        """``stores``: live ArtifactStore handles for the in-process
        never-serve-quarantined check (metrics alone cannot prove it).
        ``tolerance``: absolute slack allowed on equality checks (for
        counters read while a scrape races a reply). ``status_files``:
        elastic-trainer status JSON paths — when given, the
        ``single_writer`` law joins their ``committed_gens`` claims.
        ``experiment_status_files``: experiment-controller status JSON
        paths — when given, the ``experiment_conservation`` and
        ``single_promotion`` laws join them."""
        from mmlspark_tpu_torch.serving import fleet as fleet_mod

        self.gateway_url = gateway_url
        self.worker_urls = list(worker_urls or ())
        self.online_url = online_url
        self.registry_url = registry_url
        self.service_name = service_name
        self.stores = list(stores or ())
        self.tolerance = int(tolerance)
        self.status_files = list(status_files or ())
        self.experiment_status_files = list(experiment_status_files or ())
        # per (registry_url, record) committed-gen high-water across
        # check() passes: a registry whose generation record goes
        # BACKWARD resurrected a superseded world — the exact rollback
        # the quorum CAS exists to forbid
        self._gen_high: dict = {}
        self._scrape = scrape or fleet_mod.scrape_metrics
        # every worker URL any check() has resolved: a worker that later
        # vanishes from the roster (TTL-pruned after a SIGKILL) must not
        # silently shrink the fleet_conservation sum
        self._known_workers: set = set()
        # per-URL high-water accepted counter: a counter that goes
        # BACKWARD is a restarted process re-registered at the same URL
        # — its pre-restart accepts died with it, so the cross-era
        # fleet sum can never balance again for this checker's lifetime
        self._accepted_high: dict = {}
        self._fleet_sound = True

    # -- role resolution ------------------------------------------------------

    def _workers(self) -> list:
        urls = list(self.worker_urls)
        if self.registry_url:
            from mmlspark_tpu_torch.serving.fleet import worker_urls_from_registry

            try:
                for u in worker_urls_from_registry(
                    self.registry_url, self.service_name
                ):
                    if u not in urls:
                        urls.append(u)
            except Exception:  # noqa: BLE001 — check what is reachable
                pass
        return urls

    # -- the catalogue --------------------------------------------------------

    def check(self, final: bool = True) -> list:
        """Evaluate every applicable invariant; returns the violations
        (empty == green). ``final=True`` demands the equality forms —
        call it only after traffic has drained."""
        violations: list = []
        tol = self.tolerance
        svc = self.service_name

        gw = self._scrape(self.gateway_url) if self.gateway_url else None
        if self.gateway_url and gw is None:
            violations.append(Violation(
                "scrape", self.gateway_url, "gateway /metrics unreachable"
            ))
        forwarded = 0.0
        if gw is not None:
            accepted = _sum(
                gw, "mmlspark_serving_requests_total",
                {"server": f"{svc}-gateway"},
            )
            forwarded = _sum(gw, "mmlspark_gateway_requests_total")
            failed = _sum(gw, "mmlspark_gateway_failures_total")
            answered = forwarded + failed
            if final:
                if abs(accepted - answered) > tol:
                    violations.append(Violation(
                        "gateway_conservation", self.gateway_url,
                        f"accepted {accepted:.0f} != forwarded "
                        f"{forwarded:.0f} + failed {failed:.0f}",
                    ))
            elif answered - accepted > tol:
                violations.append(Violation(
                    "gateway_conservation", self.gateway_url,
                    f"answered {answered:.0f} > accepted {accepted:.0f}",
                ))
            if final:
                infl = _sum(
                    gw, "mmlspark_serving_inflight_requests",
                    {"server": f"{svc}-gateway"},
                )
                if infl > 0:
                    violations.append(Violation(
                        "worker_conservation", self.gateway_url,
                        f"{infl:.0f} accepted request(s) never replied",
                    ))
            for labels, v in _series(gw, "mmlspark_gateway_breaker_state"):
                if v not in (0.0, 1.0, 2.0):
                    violations.append(Violation(
                        "breaker_sane", self.gateway_url,
                        f"breaker {labels.get('backend')} state {v}",
                    ))
            for _labels, v in _series(
                gw, "mmlspark_gateway_retry_budget_remaining_ratio"
            ):
                if not 0.0 <= v <= 1.0:
                    violations.append(Violation(
                        "retry_budget_sane", self.gateway_url,
                        f"retry budget remaining {v}",
                    ))
            violations.extend(self._artifact_checks(gw, self.gateway_url, final))

        worker_accepted = 0.0
        worker_urls = self._workers()
        # no workers known at all (no registry, no explicit URLs): the
        # cross-role sum is vacuously zero — skipping beats reporting a
        # false violation against every healthy gateway-only check
        all_workers_seen = bool(worker_urls)
        # a worker seen by an earlier check() but gone from the roster
        # now (SIGKILLed, then TTL-pruned by the registry) took its
        # accepted counter with it — the sum can never balance again,
        # so the law is disabled for this checker's lifetime (a
        # conservative skip beats a false red; same for scale-in)
        if self._known_workers - set(worker_urls):
            self._fleet_sound = False
        self._known_workers.update(worker_urls)
        for u in worker_urls:
            parsed = self._scrape(u)
            if parsed is None:
                # a down worker is the chaos's doing, not an accounting
                # hole — but its accepted counter is now invisible, so
                # the cross-role sum below would be PARTIAL: skip the
                # fleet law rather than report a false violation
                all_workers_seen = False
                continue
            accepted = _sum(
                parsed, "mmlspark_serving_requests_total", {"server": svc}
            )
            # counter went backward: same URL, NEW process (supervisor
            # respawn on a fixed port) — pre-restart accepts are gone
            # while the gateway's forwarded counter spans both eras
            if accepted + 0.5 < self._accepted_high.get(u, 0.0):
                self._fleet_sound = False
            self._accepted_high[u] = max(
                self._accepted_high.get(u, 0.0), accepted
            )
            worker_accepted += accepted
            if final:
                infl = _sum(
                    parsed, "mmlspark_serving_inflight_requests",
                    {"server": svc},
                )
                if infl > 0:
                    violations.append(Violation(
                        "worker_conservation", u,
                        f"{infl:.0f} accepted request(s) never replied",
                    ))
                refs = _sum(
                    parsed, "mmlspark_modelstore_version_refs_count"
                )
                if refs > 0:
                    violations.append(Violation(
                        "modelstore_refs_drain", u,
                        f"{refs:.0f} version refcount(s) still held",
                    ))
                infl = _sum(
                    parsed, "mmlspark_admission_inflight_requests",
                    {"server": svc},
                )
                if infl > 0:
                    violations.append(Violation(
                        "admission_drain", u,
                        f"{infl:.0f} admission slot(s) still held",
                    ))
            violations.extend(self._artifact_checks(parsed, u, final))

        if (
            gw is not None and all_workers_seen and self._fleet_sound
            and worker_accepted + tol < forwarded
        ):
            violations.append(Violation(
                "fleet_conservation", self.gateway_url,
                f"workers accepted {worker_accepted:.0f} < gateway "
                f"forwarded {forwarded:.0f}",
            ))

        if self.online_url:
            parsed = self._scrape(self.online_url)
            if parsed is None:
                violations.append(Violation(
                    "scrape", self.online_url, "online /metrics unreachable"
                ))
            else:
                # spill-replayed examples re-enter THIS process's buffer
                # but were pushed (and counted ingested) by a previous
                # incarnation whose counters died with it — they belong
                # on the ingested side or every post-restart check reads
                # a false violation for exactly the kill-and-recover
                # path the checker exists to bless
                ingested = _sum(
                    parsed, "mmlspark_online_ingested_total"
                ) + _sum(parsed, "mmlspark_online_spill_replayed_total")
                trained = _sum(parsed, "mmlspark_online_examples_total")
                buffered = _sum(
                    parsed, "mmlspark_online_buffered_examples_count"
                )
                shed = _sum(parsed, "mmlspark_online_shed_examples_total")
                poisoned = _sum(
                    parsed, "mmlspark_online_poisoned_examples_total"
                )
                accounted = trained + buffered + shed + poisoned
                bad = (
                    abs(ingested - accounted) > tol if final
                    else accounted - ingested > tol
                )
                if bad:
                    violations.append(Violation(
                        "online_conservation", self.online_url,
                        f"ingested+replayed {ingested:.0f} != trained "
                        f"{trained:.0f} + buffered {buffered:.0f} + shed "
                        f"{shed:.0f} + poisoned {poisoned:.0f}",
                    ))
                violations.extend(
                    self._artifact_checks(parsed, self.online_url, final)
                )

        violations.extend(self._generation_checks())
        violations.extend(self._writer_checks())
        violations.extend(self._experiment_checks())

        for store in self.stores:
            violations.extend(self._store_checks(store))

        _M_CHECKS.labels(
            verdict="green" if not violations else "violated"
        ).inc()
        _M_VIOLATIONS.set(len(violations))
        return violations

    def _generation_checks(self) -> list:
        """``generation_monotonic``: every registry's committed
        generation record (``<service>-gen``) only ever moves FORWARD
        across this checker's passes. A backward step means a
        superseded world was resurrected — a restarted registry that
        anti-entropy failed to reconcile, or a last-writer-wins commit
        the CAS endpoint exists to reject. Unreachable registries are
        skipped (blindness is chaos's doing, not a rollback)."""
        if not self.registry_url:
            return []
        import json as json_mod

        from mmlspark_tpu_torch.io.clients import send_request
        from mmlspark_tpu_torch.io.http_schema import HTTPRequestData
        from mmlspark_tpu_torch.serving.fleet import split_registry_urls

        out: list = []
        for url in split_registry_urls(self.registry_url):
            try:
                resp = send_request(
                    HTTPRequestData(url.rstrip("/") + "/", "GET"),
                    timeout=5.0,
                )
                if resp["status_code"] != 200:
                    continue
                roster = json_mod.loads(resp["entity"])
            except Exception:  # noqa: BLE001 — blind registry: skip
                continue
            for name, entries in roster.items():
                if not name.endswith("-gen"):
                    continue
                gens = [
                    int(e.get("port") or 0) for e in entries
                    if isinstance(e, dict)
                ]
                if not gens:
                    continue
                gen = max(gens)
                key = (url, name)
                high = self._gen_high.get(key, 0)
                if gen < high:
                    out.append(Violation(
                        "generation_monotonic", url,
                        f"{name} rolled back: committed gen {gen} after "
                        f"this checker saw gen {high}",
                    ))
                self._gen_high[key] = max(high, gen)
        return out

    def _writer_checks(self) -> list:
        """``single_writer``: across every trainer status file, no two
        members claim to have COMMITTED the same generation — commit is
        what makes a member that epoch's writer, so a doubly-claimed gen
        is split-brain made visible (both halves of a partition fenced
        off the same epoch number)."""
        if not self.status_files:
            return []
        import json as json_mod

        out: list = []
        claimed: dict = {}  # gen -> (member, path) that claimed it first
        for path in self.status_files:
            try:
                with open(path) as f:
                    st = json_mod.load(f)
            except (OSError, ValueError):
                continue  # not written yet / mid-rewrite: no claim
            member = st.get("name") or path
            for gen in st.get("committed_gens", ()):
                prev = claimed.get(gen)
                if prev is not None and prev[0] != member:
                    out.append(Violation(
                        "single_writer", path,
                        f"gen {gen} committed by both {prev[0]!r} "
                        f"({prev[1]}) and {member!r}",
                    ))
                else:
                    claimed[gen] = (member, path)
        return out

    def _experiment_checks(self) -> list:
        """``experiment_conservation`` + ``single_promotion`` across
        experiment-controller status files. Conservation holds in EVERY
        snapshot, not just the final one: the controller's accounting is
        membership-based (a charge is "running" from spawn until it is
        classified exactly once), so a mid-experiment read is as bound
        by the law as a final one. Promotion agreement is joined across
        controllers of the same experiment — a restarted (or split)
        controller must adopt the incumbent rung records, never mint
        rival ones."""
        if not self.experiment_status_files:
            return []
        import json as json_mod

        out: list = []
        # (experiment, rung) -> (promoted tuple, path) first seen
        promoted_by_rung: dict = {}
        for path in self.experiment_status_files:
            try:
                with open(path) as f:
                    st = json_mod.load(f)
            except (OSError, ValueError):
                continue  # not written yet / mid-rewrite: no claim
            spawned = int(st.get("trials_spawned", 0))
            accounted = (
                int(st.get("completed", 0)) + int(st.get("demoted", 0))
                + int(st.get("rescheduled", 0)) + int(st.get("running", 0))
            )
            if spawned != accounted:
                out.append(Violation(
                    "experiment_conservation", path,
                    f"trials_spawned {spawned} != completed "
                    f"{st.get('completed', 0)} + demoted "
                    f"{st.get('demoted', 0)} + rescheduled "
                    f"{st.get('rescheduled', 0)} + running "
                    f"{st.get('running', 0)}",
                ))
            exp = st.get("experiment") or path
            for rung, promoted in (st.get("rungs") or {}).items():
                key = (exp, str(rung))
                claim = tuple(sorted(promoted or ()))
                prev = promoted_by_rung.get(key)
                if prev is not None and prev[0] != claim:
                    out.append(Violation(
                        "single_promotion", path,
                        f"experiment {exp!r} rung {rung}: promoted "
                        f"{list(claim)} but {prev[1]} promoted "
                        f"{list(prev[0])}",
                    ))
                else:
                    promoted_by_rung[key] = (claim, path)
        return out

    @staticmethod
    def _artifact_checks(parsed: dict, where: str, final: bool) -> list:
        out: list = []
        vfail = _sum(parsed, "mmlspark_artifact_verify_failures_total")
        quar = _sum(parsed, "mmlspark_artifact_quarantines_total")
        # equality demanded only once traffic drains: the failure
        # counter increments BEFORE quarantine()'s disk work lands, so
        # a mid-soak scrape can legitimately see vfail == quar + 1
        if final and vfail > quar:
            out.append(Violation(
                "artifact_quarantine", where,
                f"{vfail:.0f} verify failure(s) but only {quar:.0f} "
                "quarantine(s) — corrupt bytes may still be servable",
            ))
        return out

    @staticmethod
    def _store_checks(store: Any) -> list:
        """In-process: a quarantined digest must be invisible to both
        advertisement and the ranged-GET handler."""
        out: list = []
        quarantined = set(getattr(store, "_quarantined", ()))
        refs = store.refs()
        for d in quarantined:
            if any(r.endswith("@" + d) for r in refs):
                out.append(Violation(
                    "artifact_quarantine", store.root,
                    f"quarantined digest {d[:12]}… still advertised",
                ))
            code, _body, _hdrs = store.handle_http(
                f"/artifacts/{d}", {}
            )
            if code != 404:
                out.append(Violation(
                    "artifact_quarantine", store.root,
                    f"quarantined digest {d[:12]}… served with {code}",
                ))
        return out

    def report(self, violations: list) -> str:
        if not violations:
            return "invariants: green"
        lines = [f"invariants: {len(violations)} violation(s)"]
        lines += [f"  - {v}" for v in violations]
        return "\n".join(lines)


__all__ = ["InvariantChecker", "Violation"]
