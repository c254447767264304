"""Fleet entrypoint: the registry, serving, supervision, training,
continuous-learning, tuning and chaos roles.

The PyTorch port of ``mmlspark_tpu.serving.fleet``. The unit of deployment
is a registry, model workers on the card, a gateway in front of them and a
supervisor that keeps them alive. Each role is one process, with the JAX
role's argv plus ``--device`` on ``worker``, ``train``, ``online``,
``tune`` and ``trial``:

    python -m mmlspark_tpu_torch.serving.fleet registry --port 9090
    python -m mmlspark_tpu_torch.serving.fleet worker \\
        --registry http://registry:9090/ --model gbdt:/models/churn.json
    python -m mmlspark_tpu_torch.serving.fleet gateway \\
        --registry http://registry:9090/ --port 8080
    python -m mmlspark_tpu_torch.serving.fleet supervise \\
        --registry http://registry:9090/ --worker "--model echo --port 9101"
    python -m mmlspark_tpu_torch.serving.fleet train \\
        --registry http://registry:9090/ --name host-a --data npz:/d.npz \\
        --ckpt-dir /shared/ck --world-size 2 --heartbeat-s 1
    python -m mmlspark_tpu_torch.serving.fleet online \\
        --registry http://registry:9090/ --port 9300 --snapshot-dir /s
    python -m mmlspark_tpu_torch.serving.fleet tune \\
        --registry http://registry:9090/ --experiment e1 --trials 6
    python -m mmlspark_tpu_torch.serving.fleet chaos \\
        --scenario plan.json --proxy gw=9400:127.0.0.1:8080

Workers register with the driver registry once their models are loaded
and warmed, and heartbeat by re-registering; the gateway discovers them by
polling the registry (``serving/distributed.py``), so workers can
join, leave and restart without touching the gateway. A ``worker``,
``train``, ``online`` or ``trial`` process runs on the card (``--device
cuda``, the default; it raises without one, before it binds) unless given
``--device cpu``; ``tune`` passes its ``--device`` to the trials it
spawns. The gateway, registry, supervisor, experiment controller and
chaos conductor are host processes and touch no tensor.

``online`` trains the VW learner on ingested feedback (``vw_pass`` on the
card) and publishes snapshots to the workers, which score them through
``vw_margin``. ``tune`` runs ASHA over ``trial`` processes, each training
through ``fleet train``'s GBDT member. ``chaos`` drives a seeded scenario
of wire faults and signals against a running fleet and checks its
invariants. The verbs ``model``, ``top``, ``trace``, ``traces`` and
``profile`` drive and inspect a running fleet over HTTP.
"""


from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from typing import Any, Callable, Optional


def make_model_handler(model_spec: str, device: Any = None) -> Callable:
    """Model spec -> batch handler for :class:`ServingQuery`.

    - ``echo``           — replies with the parsed request body (smoke tests)
    - ``zoo:<name>``     — ImageFeaturizer on the named zoo backbone; body
      ``{"image": [[...]]}`` (H, W, C) uint8 -> ``{"features": [...]}``
    - ``module:pkg.fn``  — import ``pkg.fn``; it may return a handler or a
      :class:`~mmlspark_tpu_torch.serving.modelstore.LoadedModel`

    The spec grammar lives in serving/modelstore/loaders.py (the fleet
    workers' ModelStore path, which adds byte accounting, warmup and
    eviction hooks); this is the bare-handler view of the same resolver
    for embedding a single model in a :class:`ServingQuery`. ``device``:
    where the model runs (None = the card, which raises without one)."""
    from mmlspark_tpu_torch.serving.modelstore import build_loaded_model

    return build_loaded_model(model_spec, device=device).handler


def run_registry(
    host: str = "0.0.0.0", port: int = 9090, ttl_s: Optional[float] = None,
    peers: Optional[list] = None, reconcile_s: float = 5.0,
) -> Any:
    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.serving.registry import DriverRegistry

    reg = DriverRegistry(
        host=host, port=port, ttl_s=ttl_s, peers=peers,
        reconcile_s=reconcile_s,
    )
    obs.set_process_label(f"registry@{reg.host}:{reg.port}")
    print(f"registry: {reg.url}", flush=True)
    return reg


def split_registry_urls(registry_url: Any) -> list:
    """Registry HA: one URL, a comma-separated string, or a sequence ->
    the list of registries a role talks to (workers heartbeat to ALL,
    the gateway fails roster refreshes over to the next live one)."""
    if not registry_url:
        return []
    if isinstance(registry_url, str):
        return [u.strip() for u in registry_url.split(",") if u.strip()]
    return list(registry_url)


def beat_timeout(heartbeat_s: float, factor: float = 1.0) -> float:
    """Socket timeout for one registry heartbeat/deregister call: short
    and explicit — a blackholed registry (asymmetric partition, chaos
    proxy) must cost a bounded slice of the beat period, never the
    transport default. ONE clamp for every role's beat policy."""
    return max(1.0, min(3.0, factor * float(heartbeat_s)))


class _WorkerStopper:
    """Shutdown handle for a fleet worker: stops the heartbeat AND
    deregisters from every registry, so a clean SIGTERM removes the
    roster entries immediately instead of leaving them stale until TTL
    expiry or gateway-failure eviction. Keeps the Event surface (``set``/
    ``is_set``/``wait``) callers and tests already use.

    Every registry HTTP call carries an explicit SHORT socket timeout
    (``beat_timeout_s``): a blackholed registry (asymmetric partition,
    chaos proxy) costs one bounded beat, never parks the heartbeat
    thread — and can never hang a clean SIGTERM shutdown (the TTL covers
    a goodbye the registry never heard)."""

    def __init__(self, ev: threading.Event, registry_url: str, info: Any,
                 beat_timeout_s: float = 3.0):
        self._ev = ev
        self._registry_urls = split_registry_urls(registry_url)
        self._info = info
        self._beat: Optional[threading.Thread] = None
        self.beat_timeout_s = float(beat_timeout_s)
        self.slo_engine: Any = None
        # the serving pieces a graceful drain sequences (run_worker sets
        # them); None leaves drain() equivalent to set()
        self._srv: Any = None

    def set(self) -> None:
        from mmlspark_tpu_torch.serving.registry import DriverRegistry

        if self._ev.is_set():
            return
        self._ev.set()
        if self.slo_engine is not None:
            self.slo_engine.stop()
        if self._beat is not None:
            # no heartbeat may land AFTER the goodbye, or the entry would
            # resurrect until the next expiry — outwait a beat stuck at
            # its full (short, explicit) timeout against every registry
            self._beat.join(
                2.0 + self.beat_timeout_s * max(1, len(self._registry_urls))
            )
        for url in self._registry_urls:
            try:
                DriverRegistry.deregister(
                    url, self._info, timeout=self.beat_timeout_s
                )
            except Exception as e:  # noqa: BLE001 — registry may already be gone
                print(
                    f"worker: deregister from {url} failed: {e}",
                    file=sys.stderr, flush=True,
                )

    stop = set

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Graceful-drain lifecycle for a fleet roll (SIGTERM path):
        deregister (gateways stop routing within one roster refresh) ->
        stop accepting new connections -> wait until every accepted
        request AND staged continuous batch has been replied to. The
        caller then stops the dispatcher and ingress as usual — with
        zero dropped requests (pinned by the rolling-restart drill)."""
        self.set()
        # the goodbye above is separately bounded (every registry call
        # carries beat_timeout_s); the drain budget starts AFTER it, or
        # a blackholed registry would eat the whole timeout and starve
        # the in-flight wait down to its 0.5 s floor — dropping exactly
        # the requests the drain exists to protect
        t0 = time.monotonic()
        if self._srv is None:
            return True
        # the deregistration must propagate: gateways refresh their
        # roster every ~1 s and prune pooled connections on the refresh
        time.sleep(min(2.0, timeout_s / 3))
        self._srv.pause_accepting()
        remaining = timeout_s - (time.monotonic() - t0)
        drained = self._srv.drain_inflight(max(0.5, remaining))
        if not drained:
            print(
                "worker: drain timed out with requests still in flight",
                file=sys.stderr, flush=True,
            )
        return drained

    def is_set(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)


def _start_slo_engine(
    service_name: str,
    targets_spec: Optional[str],
    availability: float,
    p99_ms: Optional[float],
    interval_s: float,
    gateway: bool = False,
) -> Any:
    """Start the in-process SLO engine a fleet role exports burn-rate
    gauges from (``--slo-targets`` JSON overrides the role default)."""
    from mmlspark_tpu_torch.obs import slo

    targets = (
        slo.load_targets(targets_spec) if targets_spec
        else slo.default_targets(
            service_name, availability=availability, p99_ms=p99_ms,
            gateway=gateway,
        )
    )
    return slo.SLOEngine(targets, interval_s=interval_s).start()


def run_worker(
    registry_url: str,
    model: str = "echo",
    host: str = "0.0.0.0",
    port: int = 0,
    service_name: str = "serving",
    heartbeat_s: float = 5.0,
    advertise_host: Optional[str] = None,
    extra_models: Optional[list] = None,
    hbm_budget_bytes: Optional[int] = None,
    default_deadline_ms: Optional[float] = None,
    slo_targets: Optional[str] = None,
    slo_availability: float = 0.999,
    slo_p99_ms: Optional[float] = 250.0,
    slo_interval_s: float = 15.0,
    admission: bool = True,
    admission_initial_limit: int = 32,
    admission_min_target_ms: Optional[float] = None,
    artifact_dir: Optional[str] = None,
    reactors: int = 2,
    header_deadline_s: Optional[float] = 15.0,
    device: Optional[str] = None,
) -> tuple:
    """Start a ModelStore-backed worker, register it, and re-register on a
    heartbeat thread (a restarted registry re-learns live workers within
    one beat). The returned stopper deregisters on shutdown (clean-SIGTERM
    path).

    ``device``: where the models run (None = the card; it raises without
    one, before anything binds).

    Cold-start ordering: the default model is loaded AND warmed — placed
    on the device, its dummy bucket run (on the card: the CUDA context and
    the kernels' first-use build, a pipeline's CUDA graphs captured) —
    before the worker registers, so the gateway never routes to a worker
    whose first request would pay that; ``GET /health`` reports readiness
    for probes that want to see it. ``extra_models``: additional
    ``name=spec`` entries loaded (also pre-registration) for multi-model
    serving; all names are advertised on the roster for model-aware
    gateway routing.

    ``admission`` (default on): attach an adaptive-concurrency
    :class:`~mmlspark_tpu_torch.serving.admission.AdmissionController` — the
    AIMD in-flight limit that sheds 429 + Retry-After at ingress instead
    of queueing past every deadline (docs/robustness.md)."""
    from mmlspark_tpu_torch.serving.modelstore import (
        ModelDispatcher,
        ModelStore,
        model_name_from_spec,
    )
    from mmlspark_tpu_torch.core.device import resolve_device
    from mmlspark_tpu_torch.serving.registry import DriverRegistry
    from mmlspark_tpu_torch.serving.server import WorkerServer

    resolve_device(device)  # no card and no --device cpu: raise, bind nothing
    # multi-reactor ingress (serving/server.py): fleet workers default to
    # 2 so one slow client or a multi-MB /artifacts window can't stall
    # request intake; unit-level WorkerServer keeps the single loop
    srv = WorkerServer(
        host=host, port=port, name=service_name, num_reactors=reactors,
        # hostile-client hardening (docs/chaos.md): fleet workers face
        # real networks, so the slowloris deadline defaults tighter
        # than the unit-level WorkerServer's
        header_deadline_s=header_deadline_s,
    )
    info = srv.start()
    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.serving import artifacts as artifacts_mod

    # content-addressed artifact plane (serving/artifacts.py): every
    # worker is both a CONSUMER (``artifact:`` model specs resolve by
    # digest against the registries) and a PEER (fetched blobs re-serve
    # off this ingress and are advertised each heartbeat, so replication
    # fans out instead of hammering the producer)
    if artifact_dir:
        art_store = artifacts_mod.ArtifactStore(artifact_dir)
        artifacts_mod.configure(store=art_store, registry_urls=registry_url)
    else:
        artifacts_mod.configure(registry_urls=registry_url)
        art_store = artifacts_mod.default_store()
    artifacts_mod.attach(srv, art_store)

    # trace-tree hop attribution: spans from this process carry an
    # operator-recognizable label instead of a bare pid
    obs.set_process_label(
        f"{service_name}@{advertise_host or info.host}:{info.port}"
    )
    store = ModelStore(budget_bytes=hbm_budget_bytes, device=device)
    specs = [(model_name_from_spec(model), model)] if model else []
    for entry in extra_models or ():
        name, _, spec = entry.partition("=")
        if not spec:
            name, spec = model_name_from_spec(entry), entry
        specs.append((name, spec))
    for name, spec in specs:
        store.load(name, spec, wait=True)  # warm BEFORE registering
    ctrl = None
    if admission:
        # adaptive-concurrency shed at ingress (serving/admission.py):
        # beyond the AIMD in-flight limit, requests get a fast 429 +
        # Retry-After instead of joining a queue past every deadline
        from mmlspark_tpu_torch.serving.admission import AdmissionController

        kwargs = {}
        if admission_min_target_ms is not None:
            # queue-wait floor below which a window never reads as
            # overload: deployments on slow or noisy boxes raise it so
            # scheduler jitter alone cannot collapse the AIMD limit
            kwargs["min_target_s"] = admission_min_target_ms / 1e3
        ctrl = AdmissionController(
            server=service_name, initial_limit=admission_initial_limit,
            **kwargs,
        )
    q = ModelDispatcher(
        srv, store, default_model=specs[0][0] if specs else None,
        default_deadline_ms=default_deadline_ms, admission=ctrl,
    ).start()
    import dataclasses

    if advertise_host:
        # the registry roster must carry an address OTHER containers can
        # reach, not the 0.0.0.0 bind address
        info = dataclasses.replace(info, host=advertise_host)
    info = dataclasses.replace(info, models=tuple(n for n, _ in specs))
    stop = threading.Event()
    beat_timeout_s = beat_timeout(heartbeat_s)
    stopper = _WorkerStopper(
        stop, registry_url, info, beat_timeout_s=beat_timeout_s
    )
    stopper._srv = srv
    stopper.slo_engine = _start_slo_engine(
        service_name, slo_targets, slo_availability, slo_p99_ms,
        slo_interval_s,
    )

    registry_urls = split_registry_urls(registry_url)

    def beat() -> None:
        while not stop.is_set():
            # registry HA: every live registry learns this worker each
            # beat, so the gateway can fail roster refreshes over to any
            # of them; a dead registry is skipped, not fatal
            fresh = dataclasses.replace(
                info, models=tuple(store.model_names()),
                artifacts=tuple(art_store.refs()),
            )
            for url in registry_urls:
                try:
                    # checked INSIDE the try so a shutdown signaled between
                    # the loop test and the POST still skips the re-register
                    if not stop.is_set():
                        # re-advertise the store's CURRENT models each beat:
                        # a model loaded at runtime through the control plane
                        # becomes gateway-routable within one heartbeat
                        DriverRegistry.register(
                            url, fresh, timeout=beat_timeout_s
                        )
                except Exception as e:  # noqa: BLE001 — may be restarting
                    print(
                        f"worker: register to {url} failed: {e}",
                        file=sys.stderr, flush=True,
                    )
            stop.wait(heartbeat_s)

    stopper._beat = threading.Thread(target=beat, name="worker-heartbeat", daemon=True)
    stopper._beat.start()
    print(
        f"worker: {info.host}:{info.port} "
        f"models={','.join(info.models or ())}",
        flush=True,
    )
    return srv, q, stopper


def run_model_verb(
    action: str,
    url: str,
    name: Optional[str] = None,
    spec: Optional[str] = None,
    version: Optional[int] = None,
    pin: bool = False,
    no_wait: bool = False,
    activate: Optional[str] = None,
) -> int:
    """``fleet model <action>`` — drive a worker's (or, routed, a
    gateway's) model control plane. Returns a process exit code; prints
    the JSON response."""
    from mmlspark_tpu_torch.io.clients import send_request
    from mmlspark_tpu_torch.io.http_schema import HTTPRequestData

    base = url.rstrip("/")
    if action == "list":
        req = HTTPRequestData(f"{base}/models", "GET")
    else:
        if not name:
            print("fleet model: --name is required", file=sys.stderr)
            return 2
        body: dict = {}
        if action == "load":
            if not spec:
                print("fleet model load: --spec is required", file=sys.stderr)
                return 2
            body["spec"] = spec
            if pin:
                body["pin"] = True
            if no_wait:
                body["wait"] = False
            if activate:
                body["activate"] = activate
        if version is not None:
            body["version"] = version
        req = HTTPRequestData(
            f"{base}/models/{name}/{action}", "POST",
            {"Content-Type": "application/json"}, json.dumps(body),
        )
    resp = send_request(req, timeout=300.0)
    entity = resp["entity"]
    if isinstance(entity, bytes):
        entity = entity.decode("utf-8", "replace")
    print(entity, flush=True)
    return 0 if resp["status_code"] in (200, 202) else 1


def scrape_metrics(url: str, timeout: float = 5.0) -> Optional[dict]:
    """GET a /metrics endpoint -> parsed samples, or None when
    unreachable / non-200 (a dead worker must not kill the whole fleet
    summary). Shared by ``fleet top`` and the deploy smoke gate."""
    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.io.clients import send_request
    from mmlspark_tpu_torch.io.http_schema import HTTPRequestData

    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    resp = send_request(HTTPRequestData(url, "GET"), timeout=timeout)
    if resp["status_code"] != 200:
        return None
    body = resp["entity"]
    if isinstance(body, bytes):
        body = body.decode("utf-8", "replace")
    return obs.parse_text(body)


def roster_entries_from_registry(
    registry_url: str, service_name: str = "serving", timeout: float = 5.0
) -> list:
    """Roster -> raw entry dicts for one service (host/port plus any
    forwarded endpoint). ``registry_url`` may be comma-separated
    (registry HA): the first live registry answers. Raises when EVERY
    registry is unreachable — callers decide how to degrade."""
    from mmlspark_tpu_torch.io.clients import send_request
    from mmlspark_tpu_torch.io.http_schema import HTTPRequestData

    last_err: Optional[Exception] = None
    for url in split_registry_urls(registry_url):
        try:
            resp = send_request(
                HTTPRequestData(url.rstrip("/") + "/", "GET"),
                timeout=timeout,
            )
            if resp["status_code"] != 200:
                raise ConnectionError(
                    f"registry {url} answered {resp['status_code']}"
                )
            roster = json.loads(resp["entity"])
            return list(roster.get(service_name, []))
        except Exception as e:  # noqa: BLE001 — try the next registry
            last_err = e
    raise ConnectionError(
        f"no live registry among {registry_url!r}: {last_err}"
    )


def worker_urls_from_registry(
    registry_url: str, service_name: str = "serving", timeout: float = 5.0
) -> list:
    """Roster -> worker base URLs (preferring forwarded endpoints)."""
    return [
        f"http://{i.get('forwarded_host') or i['host']}"
        f":{i.get('forwarded_port') or i['port']}"
        for i in roster_entries_from_registry(
            registry_url, service_name, timeout
        )
    ]


def _hist_stats(parsed: dict, name: str, match: Optional[dict] = None) -> tuple:
    """(p50_estimate, mean, p99_estimate) in the histogram's native unit
    from exposition samples. Quantiles come from the SLO engine's bucket
    helpers — ONE implementation of "smallest bound reaching the rank",
    so fleet-top p99 and the SLO engine's p99 can never diverge."""
    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.obs.slo import _buckets_of, _quantile_from_buckets

    count = obs.sum_samples(parsed, f"{name}_count", match)
    total = obs.sum_samples(parsed, f"{name}_sum", match)
    if count <= 0:
        return (0.0, 0.0, 0.0)
    buckets = _buckets_of(parsed, name, match or {})
    return (
        _quantile_from_buckets(buckets, 0.5),
        total / count,
        _quantile_from_buckets(buckets, 0.99),
    )


def run_top(
    registry_url: Optional[str] = None,
    gateway_url: Optional[str] = None,
    worker_urls: Optional[list] = None,
    service_name: str = "serving",
) -> str:
    """One-screen fleet summary from /metrics scrapes (``fleet top``).

    Worker endpoints come from ``worker_urls`` and/or the registry roster;
    the gateway row needs ``gateway_url``. Everything rides the same
    Prometheus text any external scraper would consume — this is the
    zero-infrastructure view of it."""
    from mmlspark_tpu_torch import obs

    endpoints: list = [(u.rstrip("/"), None) for u in (worker_urls or ())]
    notes: list = []
    if registry_url:
        try:
            for ep in worker_urls_from_registry(registry_url, service_name):
                if ep not in [e for e, _ in endpoints]:
                    endpoints.append((ep, None))
        except Exception as e:  # noqa: BLE001 — summary must degrade, not die
            # still report the explicitly-passed workers and the gateway:
            # the registry being the one dead component is exactly when
            # the operator needs the rest of the picture
            notes.append(f"fleet top: registry scrape failed: {e}")
    from mmlspark_tpu_torch.obs import slo as slo_mod

    def slo_cell(parsed: dict) -> str:
        # each endpoint's own SLO engine exports its status gauge; a
        # pre-SLO worker simply has none — show '-', don't crash
        status = slo_mod.status_from_scrape(parsed)
        return (
            "-" if status is None
            else slo_mod.STATUS_NAMES.get(status, "?")
        )

    title = (
        f"fleet top — service {service_name!r}, {len(endpoints)} worker(s)"
    )
    if registry_url:
        # fleet supervise status (when a supervisor is registered) rides
        # the header line — the "is anything auto-healing?" glance
        sup = supervisor_status_from_registry(registry_url, service_name)
        if sup:
            title += f" — {sup}"
    lines = notes + [title]
    # the gateway scrape feeds BOTH its own summary line and the
    # per-worker BREAKER column (breaker state lives in the gateway —
    # it is the gateway's verdict about each backend)
    gw_parsed = scrape_metrics(gateway_url) if gateway_url else None
    breaker_names = {0: "closed", 1: "OPEN", 2: "half_open"}
    breakers: dict = {}
    if gw_parsed is not None:
        for (name, labels), v in gw_parsed.items():
            if name == "mmlspark_gateway_breaker_state":
                breakers[dict(labels).get("backend", "")] = (
                    breaker_names.get(int(v), "?")
                )
    hdr = (
        f"{'WORKER':<26} {'ACCEPT':>8} {'QDEPTH':>7} {'ERR':>5} "
        f"{'ERR_PCT':>7} {'QWAIT_P50_MS':>13} {'LAT_P50_MS':>11} "
        f"{'LAT_P99_MS':>11} {'BATCH_AVG':>10} {'INFL/LIM':>9} "
        f"{'BREAKER':>9} {'SLO':>6}"
    )
    lines.append(hdr)
    tot_accept = 0.0
    for ep, _ in endpoints:
        parsed = scrape_metrics(ep)
        addr = ep.split("//", 1)[-1]
        if parsed is None:
            lines.append(f"{addr:<26} {'DOWN':>8}")
            continue
        m = {"server": service_name}
        accept = obs.sum_samples(parsed, "mmlspark_serving_requests_total", m)
        qdepth = obs.sum_samples(
            parsed, "mmlspark_serving_queue_depth_requests", m
        )
        errs = obs.sum_samples(
            parsed, "mmlspark_serving_handler_errors_total", m
        )
        err_pct = (100.0 * errs / accept) if accept > 0 else 0.0
        qwait_p50, _, _ = _hist_stats(
            parsed, "mmlspark_serving_queue_wait_seconds", m
        )
        lat_p50, _, lat_p99 = _hist_stats(
            parsed, "mmlspark_serving_request_latency_seconds", m
        )
        _, batch_avg, _ = _hist_stats(
            parsed, "mmlspark_serving_batch_size_requests", m
        )
        # adaptive-concurrency cell: a worker without admission (--no-admission)
        # exports no admission gauges FOR THIS SERVICE — show '-', don't
        # invent zeros (label-matched: a co-located process may export
        # another server's admission series)
        has_adm = any(
            name == "mmlspark_admission_limit_requests"
            and ("server", service_name) in labels
            for (name, labels) in parsed
        )
        if has_adm:
            infl = obs.sum_samples(
                parsed, "mmlspark_admission_inflight_requests", m
            )
            lim = obs.sum_samples(
                parsed, "mmlspark_admission_limit_requests", m
            )
            adm_cell = f"{infl:.0f}/{lim:.0f}"
        else:
            adm_cell = "-"
        tot_accept += accept
        lines.append(
            f"{addr:<26} {accept:>8.0f} {qdepth:>7.0f} {errs:>5.0f} "
            f"{err_pct:>7.2f} {qwait_p50 * 1e3:>13.2f} "
            f"{lat_p50 * 1e3:>11.2f} {lat_p99 * 1e3:>11.2f} "
            f"{batch_avg:>10.1f} {adm_cell:>9} "
            f"{breakers.get(addr, '-'):>9} {slo_cell(parsed):>6}"
        )
    if gateway_url:
        parsed = gw_parsed
        addr = gateway_url.rstrip("/").split("//", 1)[-1]
        if parsed is None:
            lines.append(f"gateway {addr}: DOWN")
        else:
            gm = {"server": f"{service_name}-gateway"}
            accepted = obs.sum_samples(
                parsed, "mmlspark_serving_requests_total", gm
            )
            fwd = obs.sum_samples(parsed, "mmlspark_gateway_requests_total")
            retried = obs.sum_samples(parsed, "mmlspark_gateway_retries_total")
            failed = obs.sum_samples(parsed, "mmlspark_gateway_failures_total")
            backends = obs.sum_samples(
                parsed, "mmlspark_gateway_backends_count"
            )
            lat_p50, _, lat_p99 = _hist_stats(
                parsed, "mmlspark_gateway_request_latency_seconds"
            )
            containment = ""
            if breakers:
                n_open = sum(1 for s in breakers.values() if s != "closed")
                budget = obs.sum_samples(
                    parsed, "mmlspark_gateway_retry_budget_remaining_ratio"
                )
                hedges = obs.sum_samples(
                    parsed, "mmlspark_gateway_hedges_total"
                )
                containment = (
                    f", breakers {n_open}/{len(breakers)} open, "
                    f"retry budget {budget * 100:.0f}%"
                    + (f", hedges {hedges:.0f}" if hedges else "")
                )
            lines.append(
                f"gateway {addr}: accepted {accepted:.0f}, forwarded "
                f"{fwd:.0f}, retried {retried:.0f}, failed {failed:.0f}, "
                f"backends {backends:.0f}, p50 {lat_p50 * 1e3:.2f} ms, "
                f"p99 {lat_p99 * 1e3:.2f} ms{containment}, "
                f"slo {slo_cell(parsed)}"
            )
    lines.append(f"total accepted across workers: {tot_accept:.0f}")
    return "\n".join(lines)


def _trace_endpoints(
    registry_url: Optional[str],
    gateway_url: Optional[str],
    worker_urls: Optional[list],
    service_name: str = "serving",
) -> tuple:
    """(endpoints, notes): every /traces-scrapeable base URL the caller
    named plus the registry roster — and the registry's OWN endpoint,
    whose spans cover control-plane traffic."""
    endpoints: list = [u.rstrip("/") for u in (worker_urls or ())]
    notes: list = []
    if gateway_url:
        gu = gateway_url.rstrip("/")
        if gu not in endpoints:
            endpoints.append(gu)
    if registry_url:
        try:
            for ep in worker_urls_from_registry(registry_url, service_name):
                if ep not in endpoints:
                    endpoints.append(ep)
        except Exception as e:  # noqa: BLE001 — assemble what's reachable
            notes.append(f"trace: registry roster unavailable: {e}")
        ru = registry_url.rstrip("/")
        if ru not in endpoints:
            endpoints.append(ru)
    return endpoints, notes


def run_trace(
    trace_id: str,
    registry_url: Optional[str] = None,
    gateway_url: Optional[str] = None,
    worker_urls: Optional[list] = None,
    service_name: str = "serving",
) -> str:
    """``fleet trace <id>``: scrape every span buffer in the fleet, join
    the trace, render the cross-process tree. Endpoints that don't serve
    ``/traces`` (pre-trace workers: 404) are skipped."""
    from mmlspark_tpu_torch.obs import traces as traces_mod

    endpoints, notes = _trace_endpoints(
        registry_url, gateway_url, worker_urls, service_name
    )
    spans, _, scraped = traces_mod.collect(endpoints, trace_id=trace_id)
    if not scraped:
        notes.append(
            f"trace: none of {len(endpoints)} endpoint(s) served /traces"
        )
    notes.append(traces_mod.render_tree(spans, trace_id))
    return "\n".join(notes)


def run_traces_slowest(
    n: int = 5,
    registry_url: Optional[str] = None,
    gateway_url: Optional[str] = None,
    worker_urls: Optional[list] = None,
    service_name: str = "serving",
) -> str:
    """``fleet traces --slowest N``: jump from the latency histograms'
    p99-bucket exemplars to real traces and render each tree, worst
    first. Falls back to the longest buffered request spans when no
    exemplar carried a trace id yet."""
    from mmlspark_tpu_torch.obs import traces as traces_mod

    endpoints, notes = _trace_endpoints(
        registry_url, gateway_url, worker_urls, service_name
    )
    spans, exemplars, scraped = traces_mod.collect(endpoints)
    if not scraped:
        notes.append(
            f"traces: none of {len(endpoints)} endpoint(s) served /traces"
        )
        return "\n".join(notes)
    ranked = traces_mod.slowest_traces(exemplars, n=n)
    if not ranked:
        # no exemplars yet (cold fleet): rank the buffered request spans
        best: dict = {}
        for s in spans:
            if s.name in ("gateway.request", "serving.request"):
                best[s.trace_id] = max(
                    best.get(s.trace_id, 0.0), s.duration_ns / 1e9
                )
        ranked = sorted(
            ((v, t) for t, v in best.items()), reverse=True
        )[:n]
    if not ranked:
        notes.append("traces: no request traces buffered yet")
        return "\n".join(notes)
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    notes.append(
        f"slowest {len(ranked)} trace(s) across {len(scraped)} endpoint(s):"
    )
    for v, tid in ranked:
        notes.append(f"--- {v * 1e3:.2f} ms ---")
        notes.append(traces_mod.render_tree(by_trace.get(tid, []), tid))
    return "\n".join(notes)


def scrape_profile(url: str, timeout: float = 5.0) -> Optional[str]:
    """GET a /profile endpoint -> collapsed-stack text, or None when the
    endpoint is unreachable / pre-profiler (404). The scrape itself
    starts the remote sampler if it wasn't running."""
    from mmlspark_tpu_torch.io.clients import send_request
    from mmlspark_tpu_torch.io.http_schema import HTTPRequestData

    if not url.rstrip("/").endswith("/profile"):
        url = url.rstrip("/") + "/profile"
    try:
        resp = send_request(HTTPRequestData(url, "GET"), timeout=timeout)
    except Exception:  # noqa: BLE001 — a dead process is a note, not a crash
        return None
    if resp["status_code"] != 200:
        return None
    body = resp["entity"]
    if isinstance(body, bytes):
        body = body.decode("utf-8", "replace")
    return body


def run_profile(
    seconds: float = 5.0,
    registry_url: Optional[str] = None,
    gateway_url: Optional[str] = None,
    worker_urls: Optional[list] = None,
    service_name: str = "serving",
) -> str:
    """``fleet profile [--seconds N]``: scrape every /profile ingress
    twice ``seconds`` apart, diff the collapsed-stack counts so only
    samples taken *inside the window* survive, and merge the per-process
    windows into one fleet-wide flamegraph-ready view (each stack
    prefixed by its process label). The first scrape also starts any
    sampler that wasn't running, so the window is live even on a fleet
    booted without profiling."""
    from mmlspark_tpu_torch.obs import prof

    endpoints, notes = _trace_endpoints(
        registry_url, gateway_url, worker_urls, service_name
    )
    before: dict = {}
    for ep in endpoints:
        text = scrape_profile(ep)
        if text is not None:
            before[ep] = prof.parse_collapsed(text)
    if not before:
        notes.append(
            f"profile: none of {len(endpoints)} endpoint(s) served /profile"
        )
        return "\n".join(notes)
    time.sleep(max(0.0, float(seconds)))
    per_process: dict = {}
    for ep, base in before.items():
        text = scrape_profile(ep)
        if text is None:
            notes.append(f"profile: {ep} vanished mid-window; skipped")
            continue
        window: dict = {}
        for stack, n in prof.parse_collapsed(text).items():
            d = n - base.get(stack, 0)
            if d > 0:
                window[stack] = d
        label = ep
        for line in text.splitlines():  # prefer the payload's own label
            if line.startswith("# process:"):
                label = line.split(":", 1)[1].strip() or ep
                break
        if label in per_process:  # two processes, same label: keep both
            label = f"{label} {ep}"
        per_process[label] = window
    notes.append(
        f"# fleet profile: {len(per_process)} process(es), "
        f"{seconds:g}s window"
    )
    notes.append(prof.merge_collapsed(per_process).rstrip("\n"))
    return "\n".join(notes)


def run_gateway(
    registry_url: str,
    host: str = "0.0.0.0",
    port: int = 8080,
    service_name: str = "serving",
    slo_targets: Optional[str] = None,
    slo_availability: float = 0.999,
    slo_p99_ms: Optional[float] = 250.0,
    slo_interval_s: float = 15.0,
    hedge_ms: Optional[float] = None,
    retry_budget_ratio: float = 0.2,
    breaker_cooldown_s: float = 5.0,
    reactors: int = 2,
    num_dispatchers: int = 4,
    header_deadline_s: Optional[float] = 15.0,
) -> Any:
    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.serving.distributed import ServingGateway

    gw = ServingGateway(
        registry_url=registry_url, service_name=service_name,
        host=host, port=port, hedge_ms=hedge_ms,
        retry_budget_ratio=retry_budget_ratio,
        cooldown_s=breaker_cooldown_s,
        num_reactors=reactors, num_dispatchers=num_dispatchers,
        header_deadline_s=header_deadline_s,
    )
    ginfo = gw.start()
    obs.set_process_label(
        f"{service_name}-gateway@{ginfo.host}:{ginfo.port}"
    )
    gw.slo_engine = _start_slo_engine(
        service_name, slo_targets, slo_availability, slo_p99_ms,
        slo_interval_s, gateway=True,
    )
    print(f"gateway: http://{ginfo.host}:{ginfo.port}/", flush=True)
    return gw


def run_train(
    registry_url: str,
    name: str,
    data: str,
    ckpt_dir: str,
    partitions: int = 8,
    world_size: int = 1,
    service_name: str = "train",
    num_iterations: int = 100,
    num_leaves: int = 31,
    learning_rate: float = 0.1,
    min_data_in_leaf: int = 20,
    seed: int = 0,
    objective: str = "binary",
    boosting_type: str = "gbdt",
    growth_policy: str = "lossguide",
    checkpoint_every: int = 2,
    heartbeat_s: float = 0.5,
    gen_timeout_s: float = 120.0,
    advertise_host: str = "127.0.0.1",
    straggler_factor: float = 3.0,
    straggler_rounds: int = 3,
    evict_stragglers: bool = False,
    min_world: int = 1,
    resume_from: Optional[str] = None,
    status_file: Optional[str] = None,
    out_model: Optional[str] = None,
    allow_growback: bool = True,
    artifact_dir: Optional[str] = None,
    allreduce_port: int = 0,
    advertise_allreduce_port: Optional[int] = None,
    reduce_mode: str = "ring",
    tree_parallelism: str = "data",
    top_k: int = 20,
    sketch_bits: int = 16,
    device: Optional[str] = None,
) -> Any:
    """``fleet train``: one elastic training host (``parallel/elastic.py``).

    All hosts of the gang run this same role with the same ``--data`` /
    config and a shared ``--ckpt-dir`` (host-local with ``artifact_dir``);
    membership and the generation
    record ride the ``--registry`` (run it with ``--ttl-s`` a few heartbeat
    periods so a dead host's loss is detectable). A restarted trainer
    auto-resumes from its checkpoint dir and grows back into the gang at
    the next checkpoint boundary. Batch-style role: returns the booster
    when the run completes. ``device``: the member's device (None = the
    card)."""
    import hashlib

    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.models.gbdt.train import TrainConfig
    from mmlspark_tpu_torch.parallel.elastic import (
        ElasticTrainer,
        is_streaming_spec,
        load_streaming_data,
        load_training_data,
    )

    obs.set_process_label(f"{service_name}@{name}")
    if is_streaming_spec(data):
        # out-of-core: rows stream chunk by chunk (binning via
        # reducer-merged sketches); the float matrix never exists
        stream, n_rows, n_features = load_streaming_data(data)
        x = y = None
    else:
        stream, n_rows, n_features = None, None, None
        x, y = load_training_data(data)
    cfg = TrainConfig(
        objective=objective, num_iterations=num_iterations,
        num_leaves=num_leaves, learning_rate=learning_rate,
        min_data_in_leaf=min_data_in_leaf, seed=seed,
        boosting_type=boosting_type, growth_policy=growth_policy,
        parallelism=(
            "voting_parallel" if tree_parallelism == "voting"
            else "data_parallel"
        ),
        top_k=top_k,
    )
    # persist the exported model BEFORE the trainer flips its status file
    # to done: a status watcher must be able to read --out-model the
    # instant it observes done=true
    persisted: dict = {}

    def _persist_model(booster: Any) -> None:
        model = booster.to_model_string()
        if out_model:
            import os

            tmp = out_model + ".tmp"
            with open(tmp, "w") as f:
                f.write(model)
            os.replace(tmp, out_model)
        persisted["model"] = model

    trainer = ElasticTrainer(
        registry_url, name, x, y, cfg, ckpt_dir,
        n_partitions=partitions, world_size=world_size,
        service=service_name, checkpoint_every=checkpoint_every,
        heartbeat_s=heartbeat_s, gen_timeout_s=gen_timeout_s,
        resume_from=resume_from, advertise_host=advertise_host,
        straggler_factor=straggler_factor,
        straggler_rounds=straggler_rounds,
        evict_stragglers=evict_stragglers, min_world=min_world,
        status_file=status_file, allow_growback=allow_growback,
        artifact_dir=artifact_dir,
        allreduce_port=allreduce_port,
        advertise_allreduce_port=advertise_allreduce_port,
        reduce_mode=reduce_mode,
        stream=stream, n_rows=n_rows, n_features=n_features,
        sketch_bits=sketch_bits,
        on_complete=_persist_model,
        device=device,
    )
    booster = trainer.run()
    digest = hashlib.sha256(persisted["model"].encode()).hexdigest()
    print(f"train: {name} done, model sha256 {digest}", flush=True)
    return booster


def run_supervise(
    registry_url: str,
    workers: list,
    service_name: str = "serving",
    probe_s: float = 2.0,
    wedge_after: int = 3,
    backoff_s: float = 1.0,
    backoff_max_s: float = 30.0,
    host: str = "127.0.0.1",
    port: int = 0,
    autoscale: bool = False,
    min_replicas: int = 1,
    max_replicas: int = 4,
    worker_template: Optional[str] = None,
    scale_out_cooldown_s: float = 10.0,
    scale_in_cooldown_s: float = 30.0,
    idle_after_s: float = 30.0,
    util_threshold: float = 0.85,
    gateway_url: Optional[str] = None,
    trains: Optional[list] = None,
    spawn_cmd: Optional[str] = None,
    placement: Optional[str] = None,
) -> Any:
    """``fleet supervise``: spawn each ``--worker`` charge as a ``fleet
    worker`` process and keep it alive — restart on crash, kill+restart
    on a wedged ``/health``, capped exponential backoff between restarts
    (serving/supervisor.py). The supervisor registers its own status
    endpoint under ``<service-name>-supervisor`` so ``fleet top`` shows
    it in the header.

    ``--autoscale`` (docs/online-learning.md): the supervisor also
    DECIDES the replica count — the SLO-burn/admission-signal policy in
    ``mmlspark_tpu_torch/online/autoscaler.py`` scrapes the gateway and the
    rostered workers each tick, spawns a ``--worker-template`` replica
    before the breaker trips (sheds/utilization/red burn) and reaps
    autoscaled replicas on sustained idle, clamped to
    ``[--min-replicas, --max-replicas]``."""
    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.serving.supervisor import (
        FleetSupervisor,
        charge_from_train_args,
        charge_from_worker_args,
    )

    charges = [
        charge_from_worker_args(w, registry_url, i)
        for i, w in enumerate(workers)
    ]
    # training charges: a SIGKILLed elastic trainer restarts with its
    # full argv, auto-resumes from its --ckpt-dir, and grows back into
    # the gang at the next checkpoint boundary (parallel/elastic.py)
    charges += [
        charge_from_train_args(t, registry_url, i)
        for i, t in enumerate(trains or [])
    ]
    autoscaler = signals_fn = None
    template = worker_template
    if autoscale:
        from mmlspark_tpu_torch.online.autoscaler import Autoscaler, FleetSignals

        autoscaler = Autoscaler(
            min_replicas=min_replicas, max_replicas=max_replicas,
            util_threshold=util_threshold,
            scale_out_cooldown_s=scale_out_cooldown_s,
            scale_in_cooldown_s=scale_in_cooldown_s,
            idle_after_s=idle_after_s,
        )
        signals_fn = FleetSignals(
            registry_url=registry_url, gateway_url=gateway_url,
            service_name=service_name,
        )
        if template is None and workers:
            # autoscaled replicas default to the first charge's shape,
            # minus any fixed --port (replicas need ephemeral ports)
            template = _strip_port(workers[0])
    sup = FleetSupervisor(
        charges, registry_url=registry_url, service_name=service_name,
        probe_s=probe_s, wedge_after=wedge_after, backoff_s=backoff_s,
        backoff_max_s=backoff_max_s, host=host, port=port,
        autoscaler=autoscaler, worker_template=template,
        signals_fn=signals_fn, spawn_cmd=spawn_cmd, placement=placement,
    ).start()
    obs.set_process_label(
        f"{service_name}-supervisor@{sup._info.host}:{sup._info.port}"
    )
    print(
        f"supervisor: {sup.url} watching {len(charges)} worker(s)"
        + (
            f", autoscaling {min_replicas}..{max_replicas}"
            if autoscale else ""
        ),
        flush=True,
    )
    return sup


def _strip_port(worker_args: str) -> str:
    """Remove ``--port N`` / ``--port=N`` from a worker arg string
    (autoscaled replicas must bind ephemeral ports — two replicas
    cannot share the operator's fixed one)."""
    import shlex

    toks = shlex.split(worker_args)
    out = []
    i = 0
    while i < len(toks):
        if toks[i] == "--port" and i + 1 < len(toks):
            i += 2
            continue
        if toks[i].startswith("--port="):
            i += 1
            continue
        out.append(toks[i])
        i += 1
    return " ".join(out)


def run_online(
    registry_url: Optional[str] = None,
    model: str = "vw-online",
    host: str = "0.0.0.0",
    port: int = 0,
    service_name: str = "serving",
    worker_urls: Optional[list] = None,
    snapshot_dir: Optional[str] = None,
    publish_every_s: float = 2.0,
    freshness_slo_ms: float = 5000.0,
    heartbeat_s: float = 5.0,
    advertise_host: Optional[str] = None,
    num_bits: int = 18,
    loss: str = "logistic",
    lr: float = 0.5,
    batch: int = 64,
    label_col: str = "label",
    features_col: str = "features",
    text_col: Optional[str] = None,
    distributed: bool = False,
    artifact_dir: Optional[str] = None,
    publish_epoch: Optional[int] = None,
    replicas: int = 0,
    device: Optional[str] = None,
) -> tuple:
    """``fleet online``: run the continuous-learning loop as a fleet
    role. Starts the HTTP ingest ingress (``POST /ingest``; ``GET
    /metrics`` inline), trains the device-resident VW learner on every
    ingested micro-batch, and every ``publish_every_s`` publishes a
    versioned ``vw:`` snapshot through the zero-drop load -> warm ->
    swap path on every rostered worker (and/or explicit
    ``--worker-url``\\ s). Registers under ``<service>-online`` so
    ``fleet top`` and the deploy smoke's freshness gate find it; the
    freshness SLO engine runs in-process and exports burn-rate gauges.

    ``--artifact-dir`` switches publication to **artifact mode** (no
    shared filesystem): snapshots are published as
    ``artifact:vw:<name>@<sha256>`` specs, served ranged off this
    process's ingest ingress and advertised on its heartbeats — workers
    pull the bytes over HTTP, hash-verified and resumable
    (docs/artifacts.md). ``--replicas N`` adds replication-before-ack:
    each snapshot must be confirmed on N other artifact holders before
    any worker is driven to load it (docs/robustness.md).

    ``device``: where the learner's state lives and its passes run
    (None = the card; it raises without one, before anything binds).
    ``distributed``: over a ``torch.distributed`` group of two or more
    ranks, the learner averages its state over them after every pass;
    with one process it is the single-device program.

    Returns ``(stream, loop, stopper)``."""
    import dataclasses

    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.core.device import resolve_device
    from mmlspark_tpu_torch.online import (
        FeedbackStream,
        OnlineLearningLoop,
        OnlineTrainer,
        Publisher,
    )
    from mmlspark_tpu_torch.serving.registry import DriverRegistry

    if not registry_url and not worker_urls:
        raise ValueError("fleet online needs --registry and/or --worker-url")
    dev = resolve_device(device)  # no card and no --device cpu: raise, bind nothing
    stream = FeedbackStream()
    info = stream.serve(host=host, port=port, name=f"{service_name}-online")
    obs.set_process_label(
        f"{service_name}-online@{advertise_host or info.host}:{info.port}"
    )
    trainer = OnlineTrainer(
        num_bits=num_bits, loss=loss, lr=lr, batch=batch,
        label_col=label_col, features_col=features_col, text_col=text_col,
        distributed=distributed, device=dev,
    )
    art_store = None
    artifact_url = None
    if artifact_dir:
        from mmlspark_tpu_torch.serving import artifacts as artifacts_mod

        art_store = artifacts_mod.ArtifactStore(artifact_dir)
        # snapshots serve ranged off the SAME ingest ingress (the
        # /metrics contract: inline, never queued or counted)
        artifacts_mod.attach(stream._ingress, art_store)
        artifact_url = (
            f"http://{advertise_host or info.host}:{info.port}"
        )
    publisher = Publisher(
        model=model, snapshot_dir=snapshot_dir,
        worker_urls=worker_urls, registry_url=registry_url,
        service_name=service_name,
        artifact_store=art_store, artifact_url=artifact_url,
        epoch=publish_epoch, replicas=replicas,
    )
    loop = OnlineLearningLoop(
        stream, trainer, publisher, publish_every_s=publish_every_s,
        freshness_budget_ms=freshness_slo_ms or None,
    ).start()
    if advertise_host:
        info = dataclasses.replace(info, host=advertise_host)
    stop = threading.Event()
    registry_urls = split_registry_urls(registry_url)
    beat_timeout_s = beat_timeout(heartbeat_s)

    def beat() -> None:
        while not stop.is_set():
            fresh = info
            if art_store is not None:
                # advertise the snapshot artifacts each beat so workers
                # can also resolve peers from the roster (the spec's
                # embedded URL hint is merely the fast path)
                fresh = dataclasses.replace(
                    info, artifacts=tuple(art_store.refs())
                )
            for url in registry_urls:
                try:
                    if not stop.is_set():
                        # explicit short timeout: a blackholed registry
                        # must not park the heartbeat thread
                        DriverRegistry.register(
                            url, fresh, timeout=beat_timeout_s,
                        )
                except Exception as e:  # noqa: BLE001 — may be restarting
                    print(
                        f"online: register to {url} failed: {e}",
                        file=sys.stderr, flush=True,
                    )
            stop.wait(heartbeat_s)

    beat_t = threading.Thread(target=beat, name="online-heartbeat", daemon=True)
    beat_t.start()

    class _OnlineStopper:
        def stop(self) -> None:
            if stop.is_set():
                return
            stop.set()
            beat_t.join(12.0)
            loop.stop(final_publish=True)
            stream.close()
            for url in registry_urls:
                try:
                    DriverRegistry.deregister(url, info)
                except Exception:  # noqa: BLE001 — registry may be gone
                    pass

        set = stop

    print(
        f"online: ingest http://{info.host}:{info.port}/ingest -> model "
        f"{model!r}, publish every {publish_every_s}s", flush=True,
    )
    return stream, loop, _OnlineStopper()


def supervisor_status_from_registry(
    registry_url: str, service_name: str = "serving",
) -> Optional[str]:
    """One-line ``fleet supervise`` status for ``fleet top``'s header, or
    None when no supervisor is registered / reachable."""
    from mmlspark_tpu_torch import obs

    try:
        urls = worker_urls_from_registry(
            registry_url, f"{service_name}-supervisor"
        )
    except Exception:  # noqa: BLE001 — registry down: top degrades already
        return None
    for u in urls:
        parsed = scrape_metrics(u)
        if parsed is None:
            continue
        charges = obs.sum_samples(
            parsed, "mmlspark_supervisor_charges_count"
        )
        up = obs.sum_samples(
            parsed, "mmlspark_supervisor_charges_up_count"
        )
        restarts = obs.sum_samples(
            parsed, "mmlspark_supervisor_restarts_total"
        )
        return (
            f"supervise: up {up:.0f}/{charges:.0f}, "
            f"restarts {restarts:.0f}"
        )
    return None


def _install_forensics() -> None:
    """Every long-running fleet role carries the same forensics kit:
    SIGUSR1 -> flight-recorder dump, SIGUSR2 -> all-thread stall dump,
    and the always-on sampling profiler (``MMLSPARK_PROF_HZ=0`` opts
    out). Stall forensics: docs/observability.md."""
    from mmlspark_tpu_torch.obs import prof, watchdog
    from mmlspark_tpu_torch.obs.flightrec import install_sigusr1

    install_sigusr1()
    watchdog.install_sigusr2()
    prof.ensure_started()


def _serve_forever(stoppables: list, drain_s: float = 0.0) -> None:
    ev = threading.Event()

    def on_sig(signum: int, frame: Any) -> None:
        ev.set()

    signal.signal(signal.SIGTERM, on_sig)
    signal.signal(signal.SIGINT, on_sig)
    ev.wait()
    for s in stoppables:
        try:
            if drain_s > 0 and hasattr(s, "drain"):
                # gateway roll: 503 /health, finish accepted requests, stop
                s.drain(timeout_s=drain_s)
            elif hasattr(s, "stop"):
                s.stop()
            else:
                s.set()
        except Exception:  # noqa: BLE001
            pass


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(prog="mmlspark_tpu_torch.serving.fleet")
    ap.add_argument(
        "--fault-plan", default=None,
        help="JSON fault plan (inline or a file path) armed for this "
        "process — chaos-smokes a docker-compose fleet (core/faults.py)",
    )
    sub = ap.add_subparsers(dest="role", required=True)
    r = sub.add_parser("registry")
    r.add_argument("--host", default="0.0.0.0")
    r.add_argument("--port", type=int, default=9090)
    r.add_argument(
        "--ttl-s", type=float, default=None,
        help="drop roster entries not re-registered within this many "
        "seconds (a few worker heartbeat periods)",
    )
    r.add_argument(
        "--peer", action="append", default=[],
        help="peer registry base URL for anti-entropy (repeatable): "
        "rosters are periodically pulled from peers and merged by "
        "newest registration stamp, so partitioned registries reconverge",
    )
    r.add_argument(
        "--reconcile-s", type=float, default=5.0,
        help="anti-entropy pull interval against --peer registries",
    )
    w = sub.add_parser("worker")
    w.add_argument("--registry", required=True)
    w.add_argument("--model", default="echo")
    w.add_argument("--host", default="0.0.0.0")
    w.add_argument("--port", type=int, default=0)
    w.add_argument("--service-name", default="serving")
    w.add_argument("--heartbeat-s", type=float, default=5.0)
    w.add_argument(
        "--advertise-host", default=None,
        help="hostname other containers reach this worker by (compose/k8s)",
    )
    w.add_argument(
        "--load", action="append", default=[], metavar="NAME=SPEC",
        help="additional model to load+warm before registering "
        "(repeatable; bare SPEC derives the name from the spec)",
    )
    w.add_argument(
        "--hbm-budget-bytes", type=int, default=None,
        help="cap resident model-weight bytes; past it the ModelStore "
        "LRU-evicts unpinned non-serving versions (docs/modelstore.md)",
    )
    w.add_argument(
        "--default-deadline-ms", type=float, default=None,
        help="admission-control deadline applied to requests that carry "
        "no x-mmlspark-deadline-ms header (None = shed only on request)",
    )
    w.add_argument(
        "--no-admission", action="store_true",
        help="disable the adaptive in-flight limit (AIMD admission "
        "control, on by default; serving/admission.py)",
    )
    w.add_argument(
        "--admission-initial-limit", type=int, default=32,
        help="starting in-flight limit for the AIMD controller",
    )
    w.add_argument(
        "--admission-min-target-ms", type=float, default=None,
        help="queue-wait floor (ms) below which a window never counts "
        "as overload (default 2ms) — raise on slow/noisy boxes so "
        "scheduler jitter cannot collapse the AIMD limit",
    )
    w.add_argument(
        "--artifact-dir", default=None,
        help="root of this worker's content-addressed artifact cache "
        "(artifact: model specs fetch into it and re-serve off the "
        "ingress; default: a private tempdir)",
    )
    w.add_argument(
        "--reactors", type=int, default=2,
        help="ingress event loops sharing the listening socket (one slow "
        "client stalls only its own reactor; docs/serving.md)",
    )
    w.add_argument(
        "--header-deadline-s", type=float, default=15.0,
        help="slowloris shed: a request's full head (and body, floored "
        "at 256 KiB/s) must arrive within this budget of its first byte "
        "or the connection is answered 408 and closed (docs/chaos.md)",
    )
    w.add_argument(
        "--device", default="cuda",
        help="the worker's device: cuda (default; raises without a card) "
        "or cpu",
    )
    w.add_argument(
        "--drain-s", type=float, default=10.0,
        help="on SIGTERM: deregister, stop accepting, and finish every "
        "accepted request (incl. staged continuous batches) for up to "
        "this long before exiting (0 = stop immediately; docs/chaos.md)",
    )

    def add_slo_flags(p) -> None:
        p.add_argument(
            "--slo-targets", default=None,
            help="JSON list of SLO targets (inline or a file path; "
            "obs/slo.py SLOTarget fields) — overrides the role default",
        )
        p.add_argument(
            "--slo-availability", type=float, default=0.999,
            help="default target availability (good/total)",
        )
        p.add_argument(
            "--slo-p99-ms", type=float, default=250.0,
            help="default p99 latency budget; requests over it burn the "
            "error budget too (0 disables the latency SLI)",
        )

    add_slo_flags(w)
    g = sub.add_parser("gateway")
    g.add_argument("--registry", required=True)
    g.add_argument("--host", default="0.0.0.0")
    g.add_argument("--port", type=int, default=8080)
    g.add_argument("--service-name", default="serving")
    g.add_argument(
        "--drain-s", type=float, default=10.0,
        help="on SIGTERM: finish accepted requests for up to this long "
        "(0 = stop immediately)",
    )
    g.add_argument(
        "--hedge-ms", type=float, default=None,
        help="tail hedging: duplicate a request still pending after this "
        "many ms to a second backend, first answer wins (0 = derive the "
        "delay from the forward-latency p95; idempotent handlers only)",
    )
    g.add_argument(
        "--retry-budget-ratio", type=float, default=0.2,
        help="retries+hedges capped at this fraction of recent request "
        "volume (the anti-retry-storm token bucket)",
    )
    g.add_argument(
        "--breaker-cooldown-s", type=float, default=5.0,
        help="circuit-breaker open period (doubles per consecutive "
        "open, capped; half-open probe after it elapses)",
    )
    g.add_argument(
        "--reactors", type=int, default=2,
        help="gateway-ingress event loops sharing the listening socket",
    )
    g.add_argument(
        "--dispatchers", type=int, default=4,
        help="forwarding threads (each keeps its own keep-alive "
        "connection per backend)",
    )
    g.add_argument(
        "--header-deadline-s", type=float, default=15.0,
        help="slowloris shed at the gateway front door: a request's "
        "full head must arrive within this budget of its first byte "
        "(408 + close; docs/chaos.md)",
    )
    add_slo_flags(g)
    sv = sub.add_parser(
        "supervise",
        help="spawn and watch local fleet workers: restart crashed/"
        "wedged processes with capped exponential backoff",
    )
    sv.add_argument("--registry", required=True)
    sv.add_argument(
        "--worker", action="append", default=[],
        metavar="\"WORKER ARGS\"",
        help="one supervised worker's `fleet worker` arguments, quoted "
        "(repeatable); --registry is prepended automatically. A fixed "
        "--port enables /health wedge detection",
    )
    sv.add_argument(
        "--train", action="append", default=[],
        metavar="\"TRAIN ARGS\"",
        help="one supervised elastic trainer's `fleet train` arguments, "
        "quoted (repeatable); a SIGKILLed trainer restarts warm from "
        "its --ckpt-dir and rejoins the gang at the next checkpoint "
        "boundary",
    )
    sv.add_argument("--service-name", default="serving")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument(
        "--port", type=int, default=0,
        help="status endpoint port (GET /metrics; registered under "
        "<service-name>-supervisor)",
    )
    sv.add_argument("--probe-s", type=float, default=2.0,
                    help="health-probe / process-poll interval")
    sv.add_argument(
        "--wedge-after", type=int, default=3,
        help="consecutive failed /health probes before a running worker "
        "is declared wedged and killed+restarted",
    )
    sv.add_argument("--backoff-s", type=float, default=1.0,
                    help="base restart backoff (doubles per fast death)")
    sv.add_argument("--backoff-max-s", type=float, default=30.0,
                    help="restart backoff cap")
    sv.add_argument(
        "--autoscale", action="store_true",
        help="SLO-driven autoscaling: spawn a replica on admission "
        "sheds / high utilization / red SLO burn, reap on sustained "
        "idle (mmlspark_tpu_torch/online/autoscaler.py)",
    )
    sv.add_argument("--min-replicas", type=int, default=1)
    sv.add_argument("--max-replicas", type=int, default=4)
    sv.add_argument(
        "--worker-template", default=None,
        help="fleet-worker args for autoscaled replicas (default: the "
        "first --worker, with any fixed --port stripped)",
    )
    sv.add_argument("--scale-out-cooldown-s", type=float, default=10.0)
    sv.add_argument("--scale-in-cooldown-s", type=float, default=30.0)
    sv.add_argument(
        "--idle-after-s", type=float, default=30.0,
        help="sustained-idle window before an autoscaled replica is reaped",
    )
    sv.add_argument("--util-threshold", type=float, default=0.85)
    sv.add_argument(
        "--gateway", default=None,
        help="gateway base URL scraped for scale signals (backpressure, "
        "breakers, SLO status)",
    )
    sv.add_argument(
        "--spawn-cmd", default=None,
        help="pluggable placement: a command template wrapping every "
        "spawn (restart AND autoscale-out). A bare {argv} token splices "
        "the argv (local wrappers, 'kubectl run w --image=i -- {argv}'); "
        "{argv} embedded in a larger token substitutes the shell-quoted "
        "line for remote shells (\"ssh worker-7 'exec {argv}'\"). Remote "
        "charges boot from pulled artifacts — no shared filesystem",
    )
    sv.add_argument(
        "--placement", default=None,
        help="placement provider for every spawn: 'local', 'ssh:<host>' "
        "(SSH-shaped remote exec), 'k8s:<image>[@<namespace>]' "
        "(kubectl-run-shaped stub), or a raw wrapper template (the "
        "--spawn-cmd form). Remote charges pull models/checkpoints as "
        "artifacts by digest — the supervisor's filesystem is never "
        "assumed shared. Fencing (boot stamps, epoch tokens, "
        "majority-claim deferral) applies to remote placements verbatim",
    )
    on = sub.add_parser(
        "online",
        help="continuous-learning loop: HTTP feedback ingest -> online "
        "VW training -> zero-drop publication to the fleet's workers "
        "(docs/online-learning.md)",
    )
    on.add_argument("--registry", default=None)
    on.add_argument(
        "--device", default="cuda",
        help="the learner's device: cuda (default; raises without a card) "
        "or cpu",
    )
    on.add_argument(
        "--worker-url", action="append", default=[],
        help="explicit worker base URL to publish to (repeatable; "
        "adds to the registry roster)",
    )
    on.add_argument("--model", default="vw-online")
    on.add_argument("--host", default="0.0.0.0")
    on.add_argument("--port", type=int, default=0,
                    help="HTTP ingest port (POST /ingest; GET /metrics)")
    on.add_argument("--service-name", default="serving")
    on.add_argument("--snapshot-dir", default=None)
    on.add_argument("--publish-every-s", type=float, default=2.0)
    on.add_argument(
        "--freshness-slo-ms", type=float, default=5000.0,
        help="freshness budget: example-ingested -> model-servable over "
        "this burns the SLO error budget (0 disables the engine)",
    )
    on.add_argument("--heartbeat-s", type=float, default=5.0)
    on.add_argument("--advertise-host", default=None)
    on.add_argument(
        "--publish-epoch", type=int, default=None,
        help="fencing token stamped on every publication: workers "
        "reject load/swap bodies whose epoch is older than the highest "
        "seen (docs/robustness.md split brain)",
    )
    on.add_argument("--num-bits", type=int, default=18)
    on.add_argument("--loss", default="logistic")
    on.add_argument("--lr", type=float, default=0.5)
    on.add_argument("--batch", type=int, default=64)
    on.add_argument("--label-col", default="label")
    on.add_argument("--features-col", default="features")
    on.add_argument(
        "--text-col", default=None,
        help="hash this text column through the VW featurizer instead "
        "of reading pre-hashed sparse rows",
    )
    on.add_argument(
        "--distributed", action="store_true",
        help="over a torch.distributed group of two or more ranks, "
        "average the learner's state over them after every pass "
        "(multi-card training); one process runs the single-device program",
    )
    on.add_argument(
        "--artifact-dir", default=None,
        help="publish snapshots as content-addressed artifacts served "
        "off the ingest ingress (no shared filesystem): workers pull "
        "artifact:vw:<name>@<sha256> over HTTP, hash-verified + "
        "resumable (docs/artifacts.md)",
    )
    on.add_argument(
        "--replicas", type=int, default=0,
        help="replication-before-ack (artifact mode): each snapshot "
        "must be confirmed on this many OTHER artifact holders before "
        "any worker loads it — a SIGKILLed publisher host never "
        "strands the only copy (docs/robustness.md)",
    )
    tn = sub.add_parser(
        "train",
        help="one elastic training host: gang membership over the "
        "registry, TCP histogram allreduce, reshard-and-resume on host "
        "loss (parallel/elastic.py)",
    )
    tn.add_argument("--registry", required=True)
    tn.add_argument("--name", required=True,
                    help="this host's gang member name")
    tn.add_argument(
        "--data", required=True,
        help="training data spec: synth:<n>x<d>:<seed>, npz:<path>, or "
        "out-of-core stream-synth:<n>x<d>:<seed>[:<chunk>] / "
        "stream-csv:<path>:<label>[:<chunk>] (every host must see the "
        "same dataset)",
    )
    tn.add_argument("--ckpt-dir", required=True,
                    help="checkpoint dir (doubles as auto-resume): shared by "
                    "the members, or host-local with --artifact-dir")
    tn.add_argument("--partitions", type=int, default=8)
    tn.add_argument("--world-size", type=int, default=1,
                    help="members to wait for before generation 1 forms")
    tn.add_argument("--service-name", default="train")
    tn.add_argument("--num-iterations", type=int, default=100)
    tn.add_argument("--num-leaves", type=int, default=31)
    tn.add_argument("--learning-rate", type=float, default=0.1)
    tn.add_argument("--min-data-in-leaf", type=int, default=20)
    tn.add_argument("--seed", type=int, default=0)
    tn.add_argument("--objective", default="binary")
    tn.add_argument("--boosting-type", default="gbdt")
    tn.add_argument("--growth-policy", default="lossguide")
    tn.add_argument("--checkpoint-every", type=int, default=2)
    tn.add_argument("--heartbeat-s", type=float, default=0.5)
    tn.add_argument("--gen-timeout-s", type=float, default=120.0)
    tn.add_argument("--advertise-host", default="127.0.0.1")
    tn.add_argument("--straggler-factor", type=float, default=3.0)
    tn.add_argument("--straggler-rounds", type=int, default=3)
    tn.add_argument("--evict-stragglers", action="store_true")
    tn.add_argument("--min-world", type=int, default=1)
    tn.add_argument("--resume-from", default=None,
                    help="resume from this checkpoint dir/snapshot "
                    "instead of --ckpt-dir's LATEST; with --artifact-dir "
                    "also artifact:<name>@<sha256>[@peer-url,...] (pulled "
                    "over HTTP, hash-verified)")
    tn.add_argument("--status-file", default=None,
                    help="JSON progress/recovery-timing file (atomic "
                    "rewrites)")
    tn.add_argument("--out-model", default=None,
                    help="write the final model string here")
    tn.add_argument(
        "--no-growback", action="store_true",
        help="do not admit re-registered hosts at checkpoint boundaries",
    )
    tn.add_argument(
        "--artifact-dir", default=None,
        help="artifact mode: --ckpt-dir is host-local, reshard snapshots "
        "are content-addressed artifacts stored here, replicated to the "
        "new world before each commit and pulled by digest from any peer",
    )
    tn.add_argument(
        "--allreduce-port", type=int, default=0,
        help="fix the allreduce listener port (default: ephemeral)",
    )
    tn.add_argument(
        "--advertise-allreduce-port", type=int, default=None,
        help="advertise THIS port on the roster instead of the bound "
        "one — peers dial it (a proxy or NAT in front of this host)",
    )
    tn.add_argument(
        "--reduce-mode", choices=("ring", "mesh"), default="ring",
        help="gang allreduce wire pattern: chunked ring reduce-scatter "
        "+ allgather (default) or the full-mesh baseline — bit-identical "
        "results, fewer bytes on the ring",
    )
    tn.add_argument(
        "--tree-parallelism", choices=("data", "voting"), default="data",
        help="histogram exchange: the full data-parallel plane, or "
        "PV-Tree voting — only the top-2*K candidate features' columns "
        "of the two changed leaves cross the gang each split",
    )
    tn.add_argument("--top-k", type=int, default=20,
                    help="voting-parallel K: each member nominates its local "
                    "top-K features per refresh")
    tn.add_argument("--sketch-bits", type=int, default=16,
                    help="streaming-binning sketch resolution (stream-* "
                    "data specs)")
    tn.add_argument(
        "--device", default="cuda",
        help="the member's device: cuda (default; raises without a card) "
        "or cpu",
    )
    tu = sub.add_parser(
        "tune",
        help="ASHA experiment controller: schedule trials as supervisor "
        "charges, promote the top 1/eta per rung via generation-CAS "
        "records, auto-publish the winner into serving "
        "(mmlspark_tpu_torch/experiments/; docs/experiments.md)",
    )
    tu.add_argument("--registry", required=True)
    tu.add_argument("--experiment", default="exp",
                    help="experiment name (prefixes every registry record)")
    tu.add_argument("--trials", type=int, default=6)
    tu.add_argument(
        "--space", default=None,
        help="search-space JSON: {param: [choices]} or "
        '{param: {"low": .., "high": .., "log"?: true, "int"?: true}} '
        "(default: the stock GBDT space)",
    )
    tu.add_argument("--data", default="synth:512x8:1")
    tu.add_argument("--valid", default="synth:256x8:99",
                    help="held-out eval spec (same grammar as --data)")
    tu.add_argument("--min-iters", type=int, default=2)
    tu.add_argument("--max-iters", type=int, default=8)
    tu.add_argument("--eta", type=int, default=2)
    tu.add_argument("--seed", type=int, default=0)
    tu.add_argument("--lower-is-better", action="store_true")
    tu.add_argument("--workdir", default=None)
    tu.add_argument(
        "--spawn-cmd", default=None,
        help="trial placement template, supervisor semantics: bare "
        "{argv} splices, embedded {argv} substitutes the shell-quoted "
        "command (fleet supervise --spawn-cmd docs)",
    )
    tu.add_argument(
        "--placement", default=None,
        help="trial placement provider, supervisor grammar: 'local', "
        "'ssh:<host>', 'k8s:<image>[@<namespace>]', or a raw wrapper "
        "template (fleet supervise --placement docs)",
    )
    tu.add_argument("--tick-s", type=float, default=0.25)
    tu.add_argument("--heartbeat-s", type=float, default=0.5)
    tu.add_argument("--poll-s", type=float, default=0.25)
    tu.add_argument("--decision-timeout-s", type=float, default=120.0)
    tu.add_argument("--partitions", type=int, default=4)
    tu.add_argument("--max-reschedules", type=int, default=5)
    tu.add_argument(
        "--publish-model", default=None,
        help="serve the winner under this model name via the "
        "epoch-fenced Publisher path (load -> warm -> swap on every "
        "roster worker); omit to only CAS the winner record",
    )
    tu.add_argument("--publish-service", default="serving")
    tu.add_argument("--publish-epoch", type=int, default=None)
    tu.add_argument("--status-file", default=None,
                    help="atomic JSON status (the invariant checker "
                    "joins these; docs/experiments.md)")
    tu.add_argument("--deadline-s", type=float, default=600.0)
    tu.add_argument(
        "--device", default="cuda",
        help="the trials' device: cuda (default; each trial raises "
        "without a card) or cpu",
    )
    tl = sub.add_parser(
        "trial",
        help="one ASHA trial charge (spawned by fleet tune; trains "
        "through rung boundaries, CAS-reports metrics, self-reaps on "
        "demotion)",
    )
    tl.add_argument("--registry", required=True)
    tl.add_argument("--experiment", required=True)
    tl.add_argument("--trial", required=True)
    tl.add_argument("--params", required=True,
                    help="sampled hyperparameter JSON (controller-built)")
    tl.add_argument("--data", required=True)
    tl.add_argument("--valid", required=True)
    tl.add_argument("--workdir", required=True)
    tl.add_argument("--min-iters", type=int, default=2)
    tl.add_argument("--max-iters", type=int, default=8)
    tl.add_argument("--eta", type=int, default=2)
    tl.add_argument("--seed", type=int, default=0)
    tl.add_argument("--lower-is-better", action="store_true")
    tl.add_argument("--heartbeat-s", type=float, default=0.5)
    tl.add_argument("--poll-s", type=float, default=0.25)
    tl.add_argument("--decision-timeout-s", type=float, default=120.0)
    tl.add_argument("--partitions", type=int, default=4)
    tl.add_argument("--status-file", default=None)
    tl.add_argument(
        "--device", default="cuda",
        help="the trial's device: cuda (default; raises without a card) "
        "or cpu",
    )
    t = sub.add_parser(
        "top", help="scrape /metrics across the fleet, print a summary"
    )
    t.add_argument("--registry", default=None)
    t.add_argument("--gateway", default=None)
    t.add_argument("--service-name", default="serving")
    t.add_argument(
        "--worker", action="append", default=[],
        help="explicit worker base URL (repeatable; adds to the roster)",
    )
    t.add_argument(
        "--watch", type=float, default=0.0,
        help="refresh every N seconds (0 = print once and exit)",
    )
    def add_trace_endpoint_flags(p) -> None:
        p.add_argument("--registry", default=None)
        p.add_argument("--gateway", default=None)
        p.add_argument("--service-name", default="serving")
        p.add_argument(
            "--worker", action="append", default=[],
            help="explicit worker base URL (repeatable)",
        )

    tr = sub.add_parser(
        "trace",
        help="fetch one trace id across the fleet's span buffers and "
        "render the cross-process tree",
    )
    tr.add_argument("trace_id")
    add_trace_endpoint_flags(tr)
    trs = sub.add_parser(
        "traces",
        help="rank recent traces by latency (histogram-bucket exemplars) "
        "and render the slowest trees",
    )
    trs.add_argument(
        "--slowest", type=int, default=5, metavar="N",
        help="how many traces to render, worst first",
    )
    add_trace_endpoint_flags(trs)
    pf = sub.add_parser(
        "profile",
        help="scrape every /profile ingress twice, N seconds apart, and "
        "merge the sampling window into one fleet-wide collapsed-stack "
        "flame view (stall forensics: docs/observability.md)",
    )
    pf.add_argument(
        "url", nargs="?", default=None,
        help="one base URL to profile directly (any /profile ingress); "
        "omit and pass --registry/--gateway to sweep the fleet",
    )
    pf.add_argument(
        "--seconds", type=float, default=5.0,
        help="sampling window between the two scrapes",
    )
    add_trace_endpoint_flags(pf)
    ch = sub.add_parser(
        "chaos",
        help="drive a timed hostile-wire scenario against a live fleet: "
        "seeded TCP chaos proxies + process signals + the invariant "
        "checker (mmlspark_tpu_torch/chaos/; docs/chaos.md)",
    )
    ch.add_argument(
        "--scenario", required=True,
        help="scenario JSON (inline or a file path): seed + timed steps "
        "(rules / clear / signal / check / sleep / mark)",
    )
    ch.add_argument(
        "--proxy", action="append", default=[],
        metavar="NAME=LISTEN_PORT:TARGET_HOST:TARGET_PORT",
        help="one chaos proxy the scenario's rules/clear steps address "
        "by NAME (repeatable); point the fleet link at LISTEN_PORT",
    )
    ch.add_argument(
        "--pid", action="append", default=[], metavar="NAME=PID",
        help="one process the scenario's signal steps address by NAME "
        "(repeatable)",
    )
    ch.add_argument("--gateway", default=None,
                    help="gateway base URL for the check step's invariants")
    ch.add_argument("--registry", default=None,
                    help="registry base URL (resolves worker /metrics "
                    "endpoints for the invariant checker)")
    ch.add_argument("--service-name", default="serving")
    ch.add_argument("--seed", type=int, default=None,
                    help="override the scenario's seed")
    ch.add_argument(
        "--status-file", action="append", default=[], metavar="PATH",
        help="one elastic-trainer status JSON for the check step's "
        "single_writer law (repeatable; docs/chaos.md)",
    )
    ch.add_argument(
        "--online", default=None, metavar="URL",
        help="a fleet online process's base URL: the check step's "
        "online_conservation law scrapes its /metrics",
    )
    ch.add_argument(
        "--experiment-status-file", action="append", default=[],
        metavar="PATH",
        help="one fleet tune --status-file for the check step's "
        "experiment_conservation and single_promotion laws (repeatable)",
    )
    m = sub.add_parser(
        "model",
        help="model lifecycle control against a worker or gateway "
        "(GET/POST /models control plane)",
    )
    m.add_argument(
        "action", choices=["list", "load", "swap", "unload", "pin", "unpin"],
    )
    m.add_argument(
        "--url", required=True,
        help="worker base URL (or gateway: the op routes to one backend "
        "advertising the model)",
    )
    m.add_argument("--name", default=None, help="model name")
    m.add_argument("--spec", default=None, help="model spec (load)")
    m.add_argument("--version", type=int, default=None)
    m.add_argument(
        "--pin", action="store_true",
        help="load: pin the new version against eviction",
    )
    m.add_argument(
        "--no-wait", action="store_true",
        help="load: return 202 immediately, load in the background",
    )
    m.add_argument(
        "--activate", default=None, choices=["auto", "always", "never"],
        help="load: alias policy (default auto: first version serves, "
        "later versions wait for an explicit swap)",
    )
    args = ap.parse_args(argv)
    if args.fault_plan:
        from mmlspark_tpu_torch.core.faults import FaultPlan

        FaultPlan.from_spec(args.fault_plan).install()
        print(f"fleet: fault plan armed ({args.fault_plan})", flush=True)
    if args.role == "chaos":
        from mmlspark_tpu_torch.chaos.conductor import run_chaos_cli

        raise SystemExit(run_chaos_cli(
            args.scenario, args.proxy, args.pid,
            gateway_url=args.gateway, registry_url=args.registry,
            service_name=args.service_name, seed=args.seed,
            status_files=args.status_file, online_url=args.online,
            experiment_status_files=args.experiment_status_file,
        ))
    if args.role == "model":
        raise SystemExit(run_model_verb(
            args.action, args.url, name=args.name, spec=args.spec,
            version=args.version, pin=args.pin, no_wait=args.no_wait,
            activate=args.activate,
        ))
    if args.role == "trace":
        print(run_trace(
            args.trace_id, registry_url=args.registry,
            gateway_url=args.gateway, worker_urls=args.worker or None,
            service_name=args.service_name,
        ), flush=True)
        return
    if args.role == "traces":
        print(run_traces_slowest(
            args.slowest, registry_url=args.registry,
            gateway_url=args.gateway, worker_urls=args.worker or None,
            service_name=args.service_name,
        ), flush=True)
        return
    if args.role == "profile":
        urls = list(args.worker or ())
        if args.url:
            urls.append(args.url)
        print(run_profile(
            args.seconds, registry_url=args.registry,
            gateway_url=args.gateway, worker_urls=urls or None,
            service_name=args.service_name,
        ), flush=True)
        return
    if args.role == "top":
        while True:
            print(
                run_top(
                    registry_url=args.registry, gateway_url=args.gateway,
                    worker_urls=args.worker or None,
                    service_name=args.service_name,
                ),
                flush=True,
            )
            if args.watch <= 0:
                break
            time.sleep(args.watch)
    elif args.role == "train":
        _install_forensics()
        run_train(
            args.registry, args.name, args.data, args.ckpt_dir,
            partitions=args.partitions, world_size=args.world_size,
            service_name=args.service_name,
            num_iterations=args.num_iterations,
            num_leaves=args.num_leaves, learning_rate=args.learning_rate,
            min_data_in_leaf=args.min_data_in_leaf, seed=args.seed,
            objective=args.objective, boosting_type=args.boosting_type,
            growth_policy=args.growth_policy,
            checkpoint_every=args.checkpoint_every,
            heartbeat_s=args.heartbeat_s,
            gen_timeout_s=args.gen_timeout_s,
            advertise_host=args.advertise_host,
            straggler_factor=args.straggler_factor,
            straggler_rounds=args.straggler_rounds,
            evict_stragglers=args.evict_stragglers,
            min_world=args.min_world, resume_from=args.resume_from,
            status_file=args.status_file, out_model=args.out_model,
            allow_growback=not args.no_growback,
            artifact_dir=args.artifact_dir,
            allreduce_port=args.allreduce_port,
            advertise_allreduce_port=args.advertise_allreduce_port,
            reduce_mode=args.reduce_mode,
            tree_parallelism=args.tree_parallelism,
            top_k=args.top_k,
            sketch_bits=args.sketch_bits,
            device=args.device,
        )
    elif args.role == "tune":
        from mmlspark_tpu_torch.experiments.controller import (
            ExperimentController,
            space_from_json,
        )

        ctrl = ExperimentController(
            args.registry, args.experiment, n_trials=args.trials,
            space=(
                space_from_json(json.loads(args.space))
                if args.space else None
            ),
            data=args.data, valid=args.valid,
            min_iters=args.min_iters, max_iters=args.max_iters,
            eta=args.eta, seed=args.seed,
            higher_is_better=not args.lower_is_better,
            workdir=args.workdir, spawn_cmd=args.spawn_cmd,
            placement=args.placement,
            tick_s=args.tick_s, heartbeat_s=args.heartbeat_s,
            poll_s=args.poll_s,
            decision_timeout_s=args.decision_timeout_s,
            partitions=args.partitions,
            max_reschedules=args.max_reschedules,
            publish_model=args.publish_model,
            publish_service=args.publish_service,
            publish_epoch=args.publish_epoch,
            status_file=args.status_file, deadline_s=args.deadline_s,
            device=args.device,
        )
        try:
            ctrl.run()
        finally:
            ctrl.close()
    elif args.role == "trial":
        from mmlspark_tpu_torch.experiments.trial import run_trial

        _install_forensics()
        raise SystemExit(run_trial(
            args.registry, args.experiment, args.trial,
            json.loads(args.params), args.data, args.valid, args.workdir,
            min_iters=args.min_iters, max_iters=args.max_iters,
            eta=args.eta, seed=args.seed,
            higher_is_better=not args.lower_is_better,
            heartbeat_s=args.heartbeat_s, poll_s=args.poll_s,
            decision_timeout_s=args.decision_timeout_s,
            partitions=args.partitions, status_file=args.status_file,
            device=args.device,
        ))
    elif args.role == "registry":
        _install_forensics()
        reg = run_registry(
            args.host, args.port, args.ttl_s, peers=args.peer or None,
            reconcile_s=args.reconcile_s,
        )
        _serve_forever([reg])
    elif args.role == "worker":
        _install_forensics()
        srv, q, stop = run_worker(
            args.registry, args.model, args.host, args.port,
            args.service_name, args.heartbeat_s, args.advertise_host,
            extra_models=args.load,
            hbm_budget_bytes=args.hbm_budget_bytes,
            default_deadline_ms=args.default_deadline_ms,
            slo_targets=args.slo_targets,
            slo_availability=args.slo_availability,
            slo_p99_ms=args.slo_p99_ms or None,
            admission=not args.no_admission,
            admission_initial_limit=args.admission_initial_limit,
            admission_min_target_ms=args.admission_min_target_ms,
            artifact_dir=args.artifact_dir,
            reactors=args.reactors,
            header_deadline_s=args.header_deadline_s or None,
            device=args.device,
        )
        # SIGTERM with --drain-s: stop.drain() deregisters, pauses
        # accepting and waits out in-flight work; then q/srv stop as
        # usual — the graceful-drain lifecycle (docs/chaos.md)
        _serve_forever([stop, q, srv], drain_s=args.drain_s)
    elif args.role == "supervise":
        if not args.worker and not args.train:
            ap.error("supervise needs at least one --worker or --train")
        sup = run_supervise(
            args.registry, args.worker, service_name=args.service_name,
            trains=args.train,
            probe_s=args.probe_s, wedge_after=args.wedge_after,
            backoff_s=args.backoff_s, backoff_max_s=args.backoff_max_s,
            host=args.host, port=args.port,
            autoscale=args.autoscale, min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            worker_template=args.worker_template,
            scale_out_cooldown_s=args.scale_out_cooldown_s,
            scale_in_cooldown_s=args.scale_in_cooldown_s,
            idle_after_s=args.idle_after_s,
            util_threshold=args.util_threshold,
            gateway_url=args.gateway,
            spawn_cmd=args.spawn_cmd,
            placement=args.placement,
        )
        _serve_forever([sup])
    elif args.role == "online":
        _install_forensics()
        _stream, _loop, stopper = run_online(
            registry_url=args.registry, model=args.model, host=args.host,
            port=args.port, service_name=args.service_name,
            worker_urls=args.worker_url or None,
            snapshot_dir=args.snapshot_dir,
            publish_every_s=args.publish_every_s,
            freshness_slo_ms=args.freshness_slo_ms,
            heartbeat_s=args.heartbeat_s,
            advertise_host=args.advertise_host, num_bits=args.num_bits,
            loss=args.loss, lr=args.lr, batch=args.batch,
            label_col=args.label_col, features_col=args.features_col,
            text_col=args.text_col, distributed=args.distributed,
            artifact_dir=args.artifact_dir,
            publish_epoch=args.publish_epoch,
            replicas=args.replicas, device=args.device,
        )
        _serve_forever([stopper])
    else:
        _install_forensics()
        gw = run_gateway(
            args.registry, args.host, args.port, args.service_name,
            slo_targets=args.slo_targets,
            slo_availability=args.slo_availability,
            slo_p99_ms=args.slo_p99_ms or None,
            hedge_ms=args.hedge_ms,
            retry_budget_ratio=args.retry_budget_ratio,
            breaker_cooldown_s=args.breaker_cooldown_s,
            reactors=args.reactors,
            num_dispatchers=args.dispatchers,
            header_deadline_s=args.header_deadline_s or None,
        )
        _serve_forever([gw], drain_s=args.drain_s)


if __name__ == "__main__":
    main()
