"""ModelStore: versioned, HBM-budgeted model residency on a serving worker.

The PyTorch port's copy of ``mmlspark_tpu.serving.modelstore.store``. The
store holds models on one device (``device``: None = the card; tests pass
``"cpu"``), and its budget counts the bytes each version really holds
there: the loader's estimate before the version is placed, then what it
measures after its warm-up (weights as placed, cached device copies, the
CUDA graphs' memory pool). The budget's error keeps the JAX package's
name, :class:`HBMBudgetExceeded`: on the card it is the H100's HBM.

The reference bakes one handler into each serving worker at startup; any
weight update means killing the process. Production model servers
(TF-Serving's server-side model management, arxiv 1605.08695) own the
model *lifecycle* instead: named models, integer versions, background
load + warmup off the hot path, an atomic serving alias, and accounting
of what actually lives in accelerator memory. This module is that layer:

- **Versions** — ``load(name, spec)`` builds version ``n+1`` while
  version ``n`` keeps serving; nothing ever blocks the dispatch path.
- **Warmup before visibility** — a version is ``ready`` only after its
  loader ran and its warmup batch ran on the device (kernel selection,
  CUDA graph captures), so the first real request never pays for them.
- **Atomic hot-swap** — ``swap`` flips the serving alias under the store
  lock. In-flight batches hold a refcount on the version they resolved,
  so they finish on the old weights; the next batch resolves the new
  ones. Zero requests dropped, by construction (asserted under chaos in
  tests/test_modelstore.py).
- **Budgeted residency** — ``budget_bytes`` caps resident device bytes.
  Loading past the budget evicts least-recently-used unpinned,
  non-serving, drained versions; a swap's outgoing version auto-evicts
  once its last in-flight batch releases it (unless pinned for instant
  rollback). When nothing evictable remains, the load FAILS with
  :class:`HBMBudgetExceeded` rather than silently thrashing device memory.

Fault points ``modelstore.load`` / ``modelstore.swap`` (core/faults.py)
fire at the top of the respective operations: an injected delay
simulates a slow deserialize/flip (the hot-swap chaos test drives
traffic through one), an injected error a failed load/swap.

Metrics (docs/observability.md): ``mmlspark_modelstore_resident_bytes``
/ ``_resident_models_count`` gauges, ``_loads_total`` / ``_swaps_total``
/ ``_evictions_total`` counters, ``_load_seconds`` / ``_warmup_seconds``
histograms.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core import faults

_M_RESIDENT = obs.gauge(
    "mmlspark_modelstore_resident_bytes",
    "Model weight bytes currently resident in device memory",
)
_M_RESIDENT_N = obs.gauge(
    "mmlspark_modelstore_resident_models_count",
    "Model versions currently resident (warming or ready)",
)
_M_REFS = obs.gauge(
    "mmlspark_modelstore_version_refs_count",
    "In-flight batch references held on model versions (acquire minus "
    "release). MUST drain to zero after traffic stops — a stuck "
    "refcount pins swapped-out versions forever; the invariant "
    "checker's drain law (chaos/invariants.py)",
)
_M_LOADS = obs.counter(
    "mmlspark_modelstore_loads_total",
    "Model versions loaded to ready", labels=("model",),
)
_M_LOAD_FAILS = obs.counter(
    "mmlspark_modelstore_load_failures_total",
    "Model version loads that failed", labels=("model",),
)
_M_SWAPS = obs.counter(
    "mmlspark_modelstore_swaps_total",
    "Serving-alias flips to a new version", labels=("model",),
)
_M_EVICTIONS = obs.counter(
    "mmlspark_modelstore_evictions_total",
    "Versions evicted from device memory (budget LRU or post-swap drain)",
    labels=("model",),
)
_M_LOAD_S = obs.histogram(
    "mmlspark_modelstore_load_seconds",
    "Deserialize+build wall time per version", labels=("model",),
)
_M_WARMUP_S = obs.histogram(
    "mmlspark_modelstore_warmup_seconds",
    "Warmup (dummy bucket batch incl. compile) wall time per version",
    labels=("model",),
)

# version lifecycle states (listed in GET /models)
LOADING = "loading"
WARMING = "warming"
READY = "ready"
FAILED = "failed"
EVICTED = "evicted"


class ModelStoreError(Exception):
    """Invalid lifecycle operation (unknown version, swap to non-ready...)."""


class HBMBudgetExceeded(ModelStoreError):
    """The residency budget cannot fit the new version even after evicting
    every eligible (unpinned, non-serving, drained) resident version."""


@dataclass
class LoadedModel:
    """What a loader returns: the batch handler plus residency hooks.

    ``handler``  — ``list[CachedRequest] -> dict[id, (code, body, hdrs)]``,
    the same contract as :class:`~mmlspark_tpu_torch.serving.query.ServingQuery`.
    ``nbytes``   — device bytes the model will hold once placed, known
    before it is (the budget is checked against it first; 0 for weightless
    handlers like ``echo``). ``warmup`` — run one bucket batch through the
    real handler on the device, so kernel selection and graph capture
    happen off the hot path. ``measure`` — the device bytes the model
    holds after its warm-up (weights, cached device copies, graph pools);
    the store accounts that instead of ``nbytes`` from then on.
    ``release`` — drop device residency (called at eviction; the default is
    dropping the Python references so the tensors free)."""

    handler: Callable[[list], dict]
    nbytes: int = 0
    warmup: Optional[Callable[[], None]] = None
    release: Optional[Callable[[], None]] = None
    meta: dict = field(default_factory=dict)
    measure: Optional[Callable[[], int]] = None


class ModelVersion:
    """One (name, version) entry. Mutable fields are guarded by the owning
    store's lock; ``inflight`` counts batches currently executing on this
    version (the hot-swap drain barrier)."""

    __slots__ = (
        "name", "version", "spec", "state", "error", "pinned", "loaded",
        "nbytes", "inflight", "retiring", "resident", "last_used",
        "loaded_at", "unloaded",
    )

    def __init__(self, name: str, version: int, spec: Any):
        self.name = name
        self.version = version
        self.spec = spec
        self.state = LOADING
        self.error: Optional[str] = None
        self.pinned = False
        self.loaded: Optional[LoadedModel] = None
        self.nbytes = 0
        self.inflight = 0
        self.retiring = False
        self.resident = False
        self.last_used = 0.0
        self.loaded_at = 0.0
        # tombstone: unload() of an in-progress (loading/warming) version
        # cannot stop its loader thread, so it marks the version instead;
        # the loader checks the mark and cleans up rather than turning the
        # orphan resident/serving
        self.unloaded = False

    def describe(self) -> dict:
        return {
            "version": self.version,
            "state": self.state,
            "nbytes": self.nbytes,
            "pinned": self.pinned,
            "inflight": self.inflight,
            "error": self.error,
            "spec": self.spec if isinstance(self.spec, str) else None,
        }


class ModelStore:
    """Thread-safe model registry + residency manager for one worker
    process. ``loader`` maps a spec to a :class:`LoadedModel` and places
    its models itself. Without one the store uses
    :func:`~mmlspark_tpu_torch.serving.modelstore.loaders.build_loaded_model`,
    which understands the ``echo`` / ``zoo:`` / ``pipeline:`` / ``vw:`` /
    ``gbdt:`` / ``module:`` specs and passes :class:`LoadedModel` instances
    through, placing every model on ``device`` (None is the card, which
    raises without one) with ``zoo:`` backbones from the zoo under
    ``zoo_dir`` (None: the default zoo). ``device`` and ``zoo_dir`` are
    refused beside a custom ``loader``."""

    # dead (evicted/failed) version entries kept per model for
    # post-mortem visibility in GET /models; older tombstones are pruned
    # at the next load so long-lived hot-swapping workers stay bounded
    KEEP_DEAD_VERSIONS = 8

    def __init__(
        self,
        budget_bytes: Optional[int] = None,
        loader: Optional[Callable[[Any], LoadedModel]] = None,
        device: Any = None,
        zoo_dir: Optional[str] = None,
    ):
        if loader is None:
            from mmlspark_tpu_torch.serving.modelstore.loaders import (
                build_loaded_model,
            )

            loader = functools.partial(build_loaded_model, device=device, zoo_dir=zoo_dir)
        elif device is not None or zoo_dir is not None:
            raise ValueError("device and zoo_dir are the default loader's; "
                             "a custom loader places its models itself")
        self._loader = loader
        self.budget_bytes = budget_bytes
        self._lock = threading.RLock()
        self._models: dict[str, dict[int, ModelVersion]] = {}
        self._alias: dict[str, int] = {}
        self._resident_bytes = 0
        self._resident_count = 0
        self._refs_total = 0  # acquire minus release, store-wide

    # -- introspection -------------------------------------------------------

    def model_names(self) -> list:
        with self._lock:
            return sorted(self._models)

    def serving_version(self, name: str) -> Optional[int]:
        with self._lock:
            return self._alias.get(name)

    def serving_state(self, name: str) -> Optional[str]:
        """None = unknown model; else the state a data-path request would
        see: ``ready`` when the alias points at a ready version, otherwise
        the most advanced version's state (what /health and the 503
        ``x-mmlspark-model-state`` header report)."""
        with self._lock:
            vers = self._models.get(name)
            if not vers:
                return None
            v = self._alias.get(name)
            if v is not None and v in vers and vers[v].state == READY:
                return READY
            for mv in sorted(vers.values(), key=lambda m: -m.version):
                if mv.state in (LOADING, WARMING):
                    return mv.state
            return next(iter(vers.values())).state

    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    def models(self) -> dict:
        """The GET /models listing shape."""
        with self._lock:
            return {
                name: {
                    "serving": self._alias.get(name),
                    "versions": [
                        vers[v].describe() for v in sorted(vers)
                    ],
                }
                for name, vers in self._models.items()
            }

    # -- residency accounting (call under lock) ------------------------------

    def _set_resident(self, mv: ModelVersion, resident: bool) -> None:
        if resident and not mv.resident:
            mv.resident = True
            self._resident_bytes += mv.nbytes
            self._resident_count += 1
        elif not resident and mv.resident:
            mv.resident = False
            self._resident_bytes -= mv.nbytes
            self._resident_count -= 1
        _M_RESIDENT.set(self._resident_bytes)
        _M_RESIDENT_N.set(self._resident_count)

    def _evict_locked(self, mv: ModelVersion) -> None:
        """Drop a version's device residency. Caller holds the lock and has
        checked eligibility (not serving, drained)."""
        loaded, mv.loaded = mv.loaded, None
        mv.state = EVICTED
        mv.retiring = False
        self._set_resident(mv, False)
        _M_EVICTIONS.labels(model=mv.name).inc()
        if loaded is not None and loaded.release is not None:
            try:
                loaded.release()
            except Exception:  # noqa: BLE001 — eviction must not wedge the store
                pass

    def _ensure_budget_locked(self, needed: int, protect: ModelVersion) -> None:
        """Evict LRU eligible versions until ``needed`` more bytes fit.
        Eligible: READY (a warming version's load thread is still using
        the weights — evicting it would brick the version), resident, not
        pinned, not the serving alias, drained, and not the version being
        loaded."""
        if self.budget_bytes is None:
            return
        while self._resident_bytes + needed > self.budget_bytes:
            candidates = [
                mv
                for name, vers in self._models.items()
                for mv in vers.values()
                if mv.resident
                and mv.state == READY
                and mv is not protect
                and not mv.pinned
                and mv.inflight == 0
                and self._alias.get(name) != mv.version
            ]
            if not candidates:
                raise HBMBudgetExceeded(
                    f"cannot fit {needed} bytes: {self._resident_bytes} "
                    f"resident of {self.budget_bytes} budget and no "
                    "evictable (unpinned, non-serving, drained) version"
                )
            self._evict_locked(min(candidates, key=lambda m: m.last_used))

    def _resize_locked(self, mv: ModelVersion, nbytes: int) -> None:
        """Account a resident version at the bytes it measured after its
        warm-up; growth must fit the budget like a load (caller holds the
        lock)."""
        grow = nbytes - mv.nbytes
        if grow > 0:
            self._ensure_budget_locked(grow, protect=mv)
        mv.nbytes = nbytes
        self._resident_bytes += grow
        _M_RESIDENT.set(self._resident_bytes)
    # -- lifecycle -----------------------------------------------------------

    def load(
        self,
        name: str,
        spec: Any,
        version: Optional[int] = None,
        wait: bool = True,
        pin: bool = False,
        activate: str = "auto",
    ) -> int:
        """Load ``spec`` as a new version of ``name``. Returns the version
        number immediately when ``wait=False`` (the load+warmup runs on a
        background thread; progress is visible in :meth:`models`), else
        after the version is ready (raising on failure).

        ``activate``: ``"auto"`` aliases the version only when the model
        has no serving version yet (first load serves immediately; later
        loads wait for an explicit :meth:`swap`); ``"always"`` flips the
        alias as soon as the version is ready; ``"never"`` never does."""
        if activate not in ("auto", "always", "never"):
            raise ValueError(f"unknown activate mode {activate!r}")
        with self._lock:
            vers = self._models.setdefault(name, {})
            if version is None:
                version = max(vers) + 1 if vers else 1
            existing = vers.get(version)
            if existing is not None and existing.state not in (FAILED, EVICTED):
                raise ModelStoreError(
                    f"{name} v{version} already exists ({existing.state})"
                )
            mv = ModelVersion(name, version, spec)
            mv.pinned = pin
            vers[version] = mv
            # bounded version history: a worker hot-swapping for months
            # must not grow the listing (and every swap/serving_state
            # scan) with dead tombstones forever — keep the newest few
            dead = sorted(
                v for v, m in vers.items()
                if m.state in (FAILED, EVICTED) and not m.pinned
            )
            for v in dead[:-self.KEEP_DEAD_VERSIONS or None]:
                del vers[v]
        if wait:
            self._do_load(mv, activate)
        else:
            threading.Thread(
                target=self._do_load_quiet, args=(mv, activate),
                name=f"modelstore-load-{name}-v{version}", daemon=True,
            ).start()
        return version

    def _do_load_quiet(self, mv: ModelVersion, activate: str) -> None:
        try:
            self._do_load(mv, activate)
        except Exception:  # noqa: BLE001 — state FAILED carries the error
            pass

    @staticmethod
    def _release_quietly(loaded: Optional[LoadedModel]) -> None:
        if loaded is not None and loaded.release is not None:
            try:
                loaded.release()
            except Exception:  # noqa: BLE001 — cleanup is best effort
                pass

    def _do_load(self, mv: ModelVersion, activate: str) -> None:
        t0 = time.perf_counter()
        loaded: Optional[LoadedModel] = None
        try:
            # fault point modelstore.load: an injected delay is a slow
            # deserialize (the background path must keep serving through
            # it); an injected error a corrupt artifact
            faults.inject(
                "modelstore.load",
                context={"model": mv.name, "version": mv.version},
            )
            loaded = self._loader(mv.spec)
            if not isinstance(loaded, LoadedModel):
                raise TypeError(
                    f"loader returned {type(loaded).__name__}, "
                    "expected LoadedModel"
                )
            with self._lock:
                if mv.unloaded:
                    mv.state = EVICTED
                else:
                    mv.nbytes = int(loaded.nbytes or 0)
                    self._ensure_budget_locked(mv.nbytes, protect=mv)
                    mv.loaded = loaded
                    mv.state = WARMING
                    self._set_resident(mv, True)
            if mv.state == EVICTED:  # unloaded while the loader ran
                self._release_quietly(loaded)
                return
            _M_LOAD_S.labels(model=mv.name).observe(time.perf_counter() - t0)
            if loaded.warmup is not None:
                w0 = time.perf_counter()
                loaded.warmup()
                _M_WARMUP_S.labels(model=mv.name).observe(
                    time.perf_counter() - w0
                )
            held = None if loaded.measure is None else int(loaded.measure())
            with self._lock:
                if mv.unloaded or mv.state != WARMING:
                    # unloaded while warming: do not resurrect the version
                    # as READY or recreate the alias of a deleted model —
                    # release the residency this thread took instead
                    if mv.resident:
                        self._set_resident(mv, False)
                    mv.loaded = None
                    mv.state = EVICTED
                else:
                    if held is not None:
                        self._resize_locked(mv, held)
                    mv.state = READY
                    mv.loaded_at = mv.last_used = time.monotonic()
                    if activate == "always" or (
                        activate == "auto" and mv.name not in self._alias
                    ):
                        self._alias[mv.name] = mv.version
            if mv.state == EVICTED:
                self._release_quietly(loaded)
                return
            _M_LOADS.labels(model=mv.name).inc()
        except Exception as e:
            with self._lock:
                mv.error = f"{type(e).__name__}: {e}"
                if mv.resident:
                    self._set_resident(mv, False)
                mv.loaded = None
                mv.state = FAILED
            # the loader may have put weights on device before the
            # failure (budget rejection, warmup crash): release them like
            # the eviction path would, don't rely on GC
            self._release_quietly(loaded)
            _M_LOAD_FAILS.labels(model=mv.name).inc()
            raise

    def swap(self, name: str, version: Optional[int] = None) -> int:
        """Atomically flip the serving alias of ``name`` to ``version``
        (default: the newest ready non-serving version). In-flight batches
        drain on the old version; once drained it is evicted unless
        pinned (pin the old version first for instant rollback)."""
        # fault point modelstore.swap: fires BEFORE the flip, so an
        # injected delay stalls only the control operation — traffic keeps
        # serving the old version (the zero-downtime property under test)
        faults.inject("modelstore.swap", context={"model": name})
        retire: Optional[ModelVersion] = None
        with self._lock:
            vers = self._models.get(name)
            if not vers:
                raise KeyError(f"unknown model {name!r}")
            cur = self._alias.get(name)
            if version is None:
                ready = [
                    v for v, mv in vers.items()
                    if mv.state == READY and v != cur
                ]
                if not ready:
                    raise ModelStoreError(
                        f"{name}: no ready non-serving version to swap to"
                    )
                version = max(ready)
            mv = vers.get(version)
            if mv is None:
                raise KeyError(f"unknown version {name} v{version}")
            if version == cur:
                return version
            mv.retiring = False  # a rollback target is no longer outgoing
            if mv.state != READY:
                raise ModelStoreError(
                    f"cannot swap {name} to v{version}: state {mv.state}"
                )
            self._alias[name] = version
            mv.last_used = time.monotonic()
            if cur is not None:
                old = vers.get(cur)
                if old is not None:
                    # retiring marks the version as swap-displaced; a
                    # pinned one stays resident (instant rollback) until
                    # unpinned, then goes
                    old.retiring = True
                    if old.inflight == 0 and old.resident and not old.pinned:
                        retire = old
            _M_SWAPS.labels(model=name).inc()
            if retire is not None:
                self._evict_locked(retire)
        return version

    def unload(self, name: str, version: Optional[int] = None) -> int:
        """Remove a version (or, with ``version=None``, the whole model
        incl. its serving alias). Returns the number of versions removed.
        In-flight batches finish — they hold their own reference — but no
        new batch resolves an unloaded version."""
        with self._lock:
            vers = self._models.get(name)
            if not vers:
                raise KeyError(f"unknown model {name!r}")
            doomed = (
                list(vers.values()) if version is None
                else [vers[version]] if version in vers
                else []
            )
            if not doomed:
                raise KeyError(f"unknown version {name} v{version}")
            for mv in doomed:
                if self._alias.get(name) == mv.version:
                    self._alias.pop(name, None)
                del vers[mv.version]
                mv.unloaded = True
                if mv.state in (LOADING, WARMING):
                    # the loader thread is still using the weights (a
                    # mid-warmup release would crash the warmup); it sees
                    # the tombstone and releases residency itself
                    continue
                if mv.resident:
                    if mv.inflight > 0:
                        # the last release() drops the residency (the
                        # version object keeps its own byte accounting;
                        # it no longer appears in the listing)
                        mv.pinned = False
                        mv.retiring = True
                    else:
                        self._evict_locked(mv)
            if version is None or not vers:
                self._models.pop(name, None)
                self._alias.pop(name, None)
            return len(doomed)

    def pin(self, name: str, version: Optional[int] = None,
            pinned: bool = True) -> int:
        """Pin (exempt from eviction — budget LRU and post-swap retire
        alike) or unpin a version; default: the serving version."""
        with self._lock:
            vers = self._models.get(name)
            if not vers:
                raise KeyError(f"unknown model {name!r}")
            if version is None:
                version = self._alias.get(name)
                if version is None:
                    raise ModelStoreError(f"{name}: no serving version to pin")
            mv = vers.get(version)
            if mv is None:
                raise KeyError(f"unknown version {name} v{version}")
            mv.pinned = pinned
            if not pinned and mv.retiring and mv.inflight == 0 and mv.resident:
                self._evict_locked(mv)
            return version

    # -- dispatch-path resolution (hot path) ---------------------------------

    def acquire(self, name: str) -> Optional[ModelVersion]:
        """Resolve the serving version and take an in-flight reference on
        it. Returns None when the model has no ready serving version. The
        caller MUST :meth:`release` after its batch completes — that
        reference is what lets a swapped-out version drain before
        eviction."""
        with self._lock:
            v = self._alias.get(name)
            if v is None:
                return None
            mv = self._models.get(name, {}).get(v)
            if mv is None or mv.state != READY or mv.loaded is None:
                return None
            mv.inflight += 1
            mv.last_used = time.monotonic()
            self._refs_total += 1
            if _M_REFS._on:
                _M_REFS.set(self._refs_total)
            return mv

    def release(self, mv: ModelVersion) -> None:
        with self._lock:
            mv.inflight -= 1
            self._refs_total -= 1
            if _M_REFS._on:
                _M_REFS.set(self._refs_total)
            if (
                mv.retiring and mv.inflight <= 0 and mv.resident
                and not mv.pinned
            ):
                self._evict_locked(mv)
