"""Publisher: snapshot online-learner weights into a versioned ``vw:``
artifact and drive the ModelStore load -> warm -> swap path.

Zero-drop by construction: publication rides the SAME machinery the
chaos suite already gates — a new version loads and warms in the
background while the old one keeps serving, the alias flip is atomic,
and in-flight batches drain on the old weights (serving/modelstore).
The publisher never touches the dispatch path; a failed publish leaves
the serving alias exactly where it was (the rollback property pinned in
tests/test_online.py).

Targets:

- **in-process store** (``store=``) — the loop runs inside a serving
  worker (tests, bench, single-process deployments);
- **remote workers** (``worker_urls=`` and/or ``registry_url=``) — each
  publish re-resolves the roster and drives every worker's model
  control plane (``POST /models/<m>/load`` with ``activate=never``,
  then ``POST /models/<m>/swap``), so a worker the supervisor just
  restarted picks the fresh version up on the next publish.

Fault point ``online.publish`` fires before the snapshot is written: an
injected error aborts the whole publication (nothing written, nothing
loaded, alias untouched — retried at the next due time), ``delay_s``
stalls only the control path while serving continues.

Freshness: ``publish(trainer, oldest_ts)`` returns — and observes into
``mmlspark_online_freshness_seconds`` — the time from the OLDEST example
folded in since the last successful publish to the moment the new
version was servable everywhere it was pushed.

The PyTorch port's copy of ``mmlspark_tpu.online.publisher``: host code.
Snapshots are the JAX package's files (``<model>-vNNNNNN.npz`` holding
``weights`` and the ``meta`` JSON), so a snapshot either package writes
loads and scores the same in the other's workers; the port's workers
score a ``vw:`` snapshot on the card through ``vw_margin``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Optional

import numpy as np

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core import faults

# freshness is seconds-scale (publish cadence + load/warm/swap), not the
# request-latency scale of DEFAULT_BUCKETS — widen to 50 ms .. 2 min
FRESHNESS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

_M_ATTEMPTS = obs.counter(
    "mmlspark_online_publish_attempts_total",
    "Publication attempts (the freshness SLO's total-events metric)",
)
_M_PUBLISHES = obs.counter(
    "mmlspark_online_publishes_total",
    "Successful online-model publications (servable version flips)",
)
_M_FAILURES = obs.counter(
    "mmlspark_online_publish_failures_total",
    "Publications that failed (fault, store error, no worker flipped)",
)
_M_PUBLISH_S = obs.histogram(
    "mmlspark_online_publish_seconds",
    "Wall time of one publication (snapshot + load + warm + swap)",
)
_M_FRESHNESS = obs.histogram(
    "mmlspark_online_freshness_seconds",
    "Oldest-example-ingested to new-version-servable, per publication",
    buckets=FRESHNESS_BUCKETS,
)
_M_VERSION = obs.gauge(
    "mmlspark_online_published_version_count",
    "Monotonic publication sequence number of the serving online model",
)


class PublishError(Exception):
    """A publication failed end-to-end (the serving alias is unchanged)."""


class Publisher:
    def __init__(
        self,
        model: str = "vw-online",
        snapshot_dir: Optional[str] = None,
        store: Any = None,
        worker_urls: Optional[list] = None,
        registry_url: Optional[str] = None,
        service_name: str = "serving",
        keep_snapshots: int = 4,
        request_timeout_s: float = 60.0,
        time_fn: Callable[[], float] = time.monotonic,
        artifact_store: Any = None,
        artifact_url: Optional[str] = None,
        epoch: Optional[int] = None,
        replicas: int = 0,
    ):
        """``artifact_store`` (an :class:`~mmlspark_tpu_torch.serving.artifacts.
        ArtifactStore`) switches publication to **artifact mode**: each
        snapshot is ``put()`` into the store and workers receive an
        ``artifact:vw:<name>@<sha256>`` spec instead of a filesystem path
        — they pull the bytes over HTTP (hash-verified, resumable) from
        ``artifact_url`` (this process's ingress serving ``/artifacts``)
        or any registry-advertised peer, so the fleet needs NO shared
        filesystem. Leaving it None keeps the shared-fs ``vw:<path>``
        fast path exactly as before.

        ``epoch``: the coordination epoch (committed training
        generation) stamped onto every worker load/swap as a fencing
        token — a worker that has already seen a higher epoch rejects
        the publication with 409 (a SIGSTOP'd zombie coordinator waking
        after a reshard cannot roll the serving fleet back). Bump it
        with :meth:`set_epoch` when the gang reshards; None publishes
        unstamped (pre-fencing behaviour).

        ``replicas``: replication-before-ack (artifact mode only) — the
        snapshot blob must be confirmed installed on this many OTHER
        artifact holders (registry-advertised artifact planes and/or the
        explicit ``worker_urls``) BEFORE any target is driven to load
        it; below quorum the publication raises and the serving alias is
        untouched. The confirmed holders ride the published spec as peer
        hints, so a worker can pull the snapshot even after this
        process's host is gone — the no-shared-fs durability contract.
        0 (default) keeps the single-copy behaviour."""
        if store is None and not worker_urls and not registry_url:
            raise ValueError(
                "Publisher needs a target: store=, worker_urls= or "
                "registry_url="
            )
        self.model = model
        self.snapshot_dir = snapshot_dir or os.path.join(
            os.getcwd(), ".online_snapshots"
        )
        self.store = store
        self.worker_urls = list(worker_urls or ())
        self.registry_url = registry_url
        self.service_name = service_name
        self.keep_snapshots = max(1, int(keep_snapshots))
        self.request_timeout_s = request_timeout_s
        self._now = time_fn
        self.artifact_store = artifact_store
        self.artifact_url = artifact_url
        self.replicas = max(0, int(replicas))
        self.epoch = int(epoch) if epoch is not None else None
        # version ledger for _gc: (snapshot path, artifact digest | None)
        # in publication order — GC never touches a version it cannot
        # first unadvertise (pinned / mid-pull artifacts stay)
        self._published: list = []
        if artifact_store is not None:
            # adopt a previous incarnation's snapshot blobs (the store's
            # index survives restarts): without this, a restarted
            # publisher would re-advertise and retain them forever —
            # the ledger is what keep-last pruning acts on
            import re as _re

            pat = _re.compile(_re.escape(self.model) + r"-v\d{6}\.npz$")
            for ref in artifact_store.refs():
                n, _, d = ref.rpartition("@")
                if pat.match(n):
                    self._published.append(
                        (os.path.join(self.snapshot_dir, n), d)
                    )
        self.seq = 0
        self.publishes = 0
        self.failures = 0
        self.last_freshness_s: Optional[float] = None
        self.freshness_history: list = []  # seconds, per successful publish

    # -- snapshot artifact ---------------------------------------------------

    def _write_snapshot(self, trainer: Any) -> str:
        os.makedirs(self.snapshot_dir, exist_ok=True)
        path = os.path.join(
            self.snapshot_dir, f"{self.model}-v{self.seq:06d}.npz"
        )
        tmp = path + ".tmp"
        meta = trainer.snapshot_meta()
        # atomic: a concurrently-restarting worker re-loading its --load
        # spec must never see a torn file
        with open(tmp, "wb") as f:
            np.savez(
                f,
                weights=trainer.weights_host(),
                meta=json.dumps(meta).encode(),
            )
        os.replace(tmp, path)
        return path

    def _gc(self) -> None:
        """Keep-last pruning with replication safety: a version beyond
        ``keep_snapshots`` is deleted only once it is DRAINED and
        UNADVERTISED — in artifact mode that means the store agreed to
        ``remove()`` its blob (refused while pinned or mid-pull, so a
        worker half-way through a ranged fetch, or an operator pin, keeps
        both the blob and the snapshot file alive). Refused versions are
        retried at the next publication; pruning is hygiene, never
        correctness."""
        try:
            retained: list = []
            for path, digest in self._published[: -self.keep_snapshots]:
                if (
                    digest is not None
                    and self.artifact_store is not None
                    and not self.artifact_store.remove(digest)
                ):
                    # still pinned or mid-pull: stays advertised AND on
                    # disk — never yank bytes a puller is reading;
                    # retried at the next publication
                    retained.append((path, digest))
                    continue
                try:
                    os.remove(path)
                except OSError:
                    pass
            self._published = retained + self._published[-self.keep_snapshots:]
            # legacy sweep (shared-fs mode, pre-restart leftovers): prune
            # by filename, but never a file the ledger says must stay
            keep_names = {os.path.basename(p) for p, _ in self._published}
            snaps = sorted(
                f for f in os.listdir(self.snapshot_dir)
                if f.startswith(f"{self.model}-v") and f.endswith(".npz")
            )
            for f in snaps[: -self.keep_snapshots]:
                if f not in keep_names:
                    os.remove(os.path.join(self.snapshot_dir, f))
        except OSError:
            pass  # pruning is hygiene, not correctness

    # kept as an alias: pre-artifact callers and docs name the old verb
    _prune_snapshots = _gc

    def set_epoch(self, epoch: int) -> None:
        """Advance the publication fencing token (never backwards — a
        publisher cannot un-see an epoch)."""
        e = int(epoch)
        if self.epoch is None or e > self.epoch:
            self.epoch = e

    # -- targets -------------------------------------------------------------

    def _replica_holders(self) -> list:
        """Candidate push targets for replication-before-ack: every
        registry-rostered artifact plane that is not this process, plus
        the explicit worker URLs (their ingress serves ``/artifacts``
        too)."""
        own = (
            [self.artifact_url.rstrip("/")] if self.artifact_url else []
        )
        holders: list = []
        if self.registry_url:
            from mmlspark_tpu_torch.serving.artifacts import registry_holders

            try:
                holders = registry_holders(self.registry_url, exclude=own)
            except Exception:  # noqa: BLE001 — worker_urls still replicate
                holders = []
        for u in self.worker_urls:
            u = u.rstrip("/")
            if u not in holders and u not in own:
                holders.append(u)
        return holders

    def _publish_store(self, spec: str) -> int:
        v = self.store.load(self.model, spec, wait=True, activate="never")
        self.store.swap(self.model, v)
        return 1

    def _resolve_workers(self) -> list:
        urls = list(self.worker_urls)
        if self.registry_url:
            from mmlspark_tpu_torch.serving.fleet import worker_urls_from_registry

            try:
                for u in worker_urls_from_registry(
                    self.registry_url, self.service_name
                ):
                    if u not in urls:
                        urls.append(u)
            except Exception:  # noqa: BLE001 — explicit urls still publish
                pass
        return urls

    def _publish_workers(self, spec: str) -> int:
        from mmlspark_tpu_torch.io.clients import send_request
        from mmlspark_tpu_torch.io.http_schema import HTTPRequestData

        load_body: dict = {"spec": spec, "activate": "never"}
        swap_body: dict = {}
        if self.epoch is not None:
            # the fencing token: workers reject (409) any publication
            # stamped older than the highest epoch they have seen
            load_body["epoch"] = self.epoch
            swap_body["epoch"] = self.epoch
        flipped = 0
        for base in self._resolve_workers():
            base = base.rstrip("/")
            try:
                loaded = send_request(HTTPRequestData(
                    f"{base}/models/{self.model}/load", "POST",
                    {"Content-Type": "application/json"},
                    json.dumps(load_body),
                ), timeout=self.request_timeout_s)
                if loaded["status_code"] not in (200, 202):
                    continue
                swapped = send_request(HTTPRequestData(
                    f"{base}/models/{self.model}/swap", "POST",
                    {"Content-Type": "application/json"},
                    json.dumps(swap_body),
                ), timeout=self.request_timeout_s)
                if swapped["status_code"] == 200:
                    flipped += 1
            except Exception:  # noqa: BLE001 — a dead worker skips, not aborts
                continue
        return flipped

    # -- the publication -----------------------------------------------------

    def publish(self, trainer: Any, oldest_ts: Optional[float] = None) -> dict:
        """Snapshot + load + warm + swap. Returns ``{"version", "path",
        "targets", "freshness_s"}``; raises :class:`PublishError` (after
        counting the failure) when no target flipped — the serving alias
        is unchanged and the caller retries with the same watermark."""
        t0 = self._now()
        _M_ATTEMPTS.inc()
        replicated: list = []
        try:
            # fault point online.publish: an injected error aborts the
            # publication before anything is written or loaded
            faults.inject("online.publish", context={"model": self.model})
            self.seq += 1
            path = self._write_snapshot(trainer)
            digest = None
            if self.artifact_store is not None:
                # artifact mode (no shared fs): workers pull the snapshot
                # over HTTP by digest — from this process's own ingress
                # (the spec-embedded hint) or any registry-advertised
                # peer — hash-verified and resumable
                ref = self.artifact_store.put(
                    path, name=os.path.basename(path)
                )
                digest = ref.digest
                hints = (
                    [self.artifact_url.rstrip("/")]
                    if self.artifact_url else []
                )
                if self.replicas > 0:
                    # replication-before-ack: the snapshot must be
                    # durable on `replicas` OTHER holders before any
                    # worker is told to load it — below quorum this
                    # raises (wrapped into PublishError) and the alias
                    # stays put. Confirmed holders become spec hints so
                    # pullers survive this host dying.
                    confirmed = self.artifact_store.replicate(
                        digest, self._replica_holders(),
                        need=self.replicas,
                        timeout_s=self.request_timeout_s,
                    )
                    replicated = list(confirmed)
                    hints += [
                        u.rstrip("/") for u in confirmed
                        if u.rstrip("/") not in hints
                    ]
                spec = f"artifact:vw:{ref.spec}"
                if hints:
                    spec += "@" + ",".join(hints)
            else:
                spec = f"vw:{path}"
            self._published.append((path, digest))
            targets = 0
            if self.store is not None:
                targets += self._publish_store(spec)
            if self.worker_urls or self.registry_url:
                targets += self._publish_workers(spec)
            if targets == 0:
                raise PublishError(
                    f"no target made {self.model} v{self.seq} servable"
                )
        except Exception as e:
            self.failures += 1
            _M_FAILURES.inc()
            if isinstance(e, PublishError):
                raise
            raise PublishError(f"{type(e).__name__}: {e}") from e
        ready = self._now()
        _M_PUBLISH_S.observe(ready - t0)
        freshness = None
        if oldest_ts is not None:
            freshness = max(0.0, ready - oldest_ts)
            self.last_freshness_s = freshness
            self.freshness_history.append(freshness)
            _M_FRESHNESS.observe(freshness)
        self.publishes += 1
        _M_PUBLISHES.inc()
        _M_VERSION.set(self.seq)
        self._gc()
        return {
            "version": self.seq,
            "path": path,
            "targets": targets,
            "freshness_s": freshness,
            "replicas": replicated,
        }

    def publish_spec(self, spec: str) -> dict:
        """Publish an already-materialized model ``spec`` (any loader
        grammar the targets understand — ``artifact:gbdt:…``, ``zoo:…``)
        through the same epoch-fenced load → warm → swap path as
        :meth:`publish`. No snapshot is written and nothing is GC'd:
        the caller owns the bytes (an experiment controller's artifact
        store, a shared-fs file). Raises :class:`PublishError` when no
        target flipped — the serving alias is unchanged."""
        t0 = self._now()
        _M_ATTEMPTS.inc()
        try:
            faults.inject(
                "online.publish", context={"model": self.model, "spec": spec}
            )
            self.seq += 1
            targets = 0
            if self.store is not None:
                targets += self._publish_store(spec)
            if self.worker_urls or self.registry_url:
                targets += self._publish_workers(spec)
            if targets == 0:
                raise PublishError(
                    f"no target made {self.model} v{self.seq} servable"
                )
        except Exception as e:
            self.failures += 1
            _M_FAILURES.inc()
            if isinstance(e, PublishError):
                raise
            raise PublishError(f"{type(e).__name__}: {e}") from e
        _M_PUBLISH_S.observe(self._now() - t0)
        self.publishes += 1
        _M_PUBLISHES.inc()
        _M_VERSION.set(self.seq)
        return {"version": self.seq, "spec": spec, "targets": targets}


__all__ = ["FRESHNESS_BUCKETS", "PublishError", "Publisher"]
