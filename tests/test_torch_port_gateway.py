"""The port's gateway (``serving/distributed.py``) on the reference's cases.

The JAX package's own gateway cases run here against the port, on the CPU,
over real localhost sockets: those of ``tests/test_serving.py`` (round
robin, zero requests lost across a worker's death, registry discovery, the
static pool, the fleet roles, connection pruning, the pool's breakers),
of ``tests/test_selfheal.py`` (circuit breakers, the retry budget,
admission, deadlines, 429 backpressure, hedging, the ``boot`` stamp) and of
``tests/test_throughput.py`` (the raw-socket wire client: a bare-LF head,
the one-pass parse, the stale keep-alive retry, the hedge pool's sockets).
Cases that repeated each other are parametrised, and the deadlines that sat
close to a loaded machine's scheduling jitter are generous here.

The cross-package cases put a JAX ``ServingGateway`` in front of the
port's workers and the port's gateway in front of JAX workers, on the same
seeded ``gbdt:`` and ``vw:`` models, routed by ``x-mmlspark-model``: every
reply through the gateway is byte-equal to the same request sent to a
worker of the gateway's own package (``tests/test_torch_port_serving.py``
holds those bitwise; ``vw:`` rows here have K <= 17 slots). The port's SLO
engine, reading the JAX gateway's ``/metrics``, computes the same burn
rates, bad fraction and status as the JAX engine.
"""

from __future__ import annotations

import http.client
import json
import re
import socket
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core.faults import FaultPlan
from mmlspark_tpu_torch.serving import (
    DriverRegistry,
    ServingQuery,
    WorkerServer,
)
from mmlspark_tpu_torch.serving.admission import (
    DEADLINE_HEADER,
    RETRY_BUDGET_HEADER,
    SHED_HEADER,
    AdmissionController,
)
from mmlspark_tpu_torch.serving.distributed import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    RetryBudget,
    ServingGateway,
)

# -- helpers

def _post(port: int, path: str, obj, conn=None):
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    body = json.dumps(obj)
    c.request("POST", path, body=body, headers={"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    if conn is None:
        c.close()
    return r.status, data



def _send(port: int, obj, conn=None, path: str = "/", headers=None):
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    c.request("POST", path, body=json.dumps(obj), headers=hdrs)
    r = c.getresponse()
    data = r.read()
    if conn is None:
        c.close()
    return r.status, data


def _echo_handler(reqs):
    out = {}
    for r in reqs:
        body = json.loads(r.body) if r.body else {}
        out[r.id] = (200, json.dumps({"echo": body}).encode(), {})
    return out


def _worker(handler=_echo_handler, admission=None, **query_kw):
    from mmlspark_tpu_torch.serving.query import ServingQuery
    from mmlspark_tpu_torch.serving.server import WorkerServer

    srv = WorkerServer()
    info = srv.start()
    q = ServingQuery(srv, handler, admission=admission, **query_kw).start()
    return srv, q, info


def _req(port, path, obj, method="POST", headers=None, timeout=10):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = json.dumps(obj) if obj is not None else None
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        c.request(method, path, body=body, headers=hdrs)
        r = c.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        c.close()


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port




# -- the gateway cases of tests/test_serving.py

def _worker_with_handler(tag):
    """A backend WorkerServer+ServingQuery replying with its tag."""
    srv = WorkerServer()
    info = srv.start()

    def handler(reqs):
        out = {}
        for r in reqs:
            try:
                v = json.loads(r.body)["x"]
            except (ValueError, KeyError):
                out[r.id] = (400, b"bad body", {})
                continue
            out[r.id] = (
                200,
                json.dumps({"y": v * 2, "worker": tag}).encode(),
                {"Content-Type": "application/json"},
            )
        return out

    q = ServingQuery(srv, handler, max_wait_ms=0).start()
    return srv, q, info


def test_gateway_round_robins_over_workers():
    from mmlspark_tpu_torch.serving import ServingGateway

    backends = [_worker_with_handler(f"w{i}") for i in range(3)]
    gw = ServingGateway(workers=[b[2] for b in backends])
    ginfo = gw.start()
    try:
        seen = set()
        for i in range(30):
            status, data = _post(ginfo.port, "/", {"x": i})
            assert status == 200
            d = json.loads(data)
            assert d["y"] == i * 2
            seen.add(d["worker"])
        assert seen == {"w0", "w1", "w2"}  # all workers share the load
    finally:
        gw.stop()
        for srv, q, _ in backends:
            q.stop()
            srv.stop()


def test_gateway_survives_worker_death_zero_lost():
    """Kill one worker mid-stream: every accepted request still gets a
    correct reply from a DIFFERENT worker (the cross-worker replay of the
    reference's uncommitted-epoch recovery, DistributedHTTPSource)."""
    from mmlspark_tpu_torch.serving import ServingGateway

    backends = [_worker_with_handler(f"w{i}") for i in range(3)]
    gw = ServingGateway(workers=[b[2] for b in backends], request_timeout_s=3.0)
    ginfo = gw.start()
    errs = []
    answers = {}
    lock = threading.Lock()

    def client(k):
        try:
            for i in range(40):
                x = k * 1000 + i
                status, data = _post(ginfo.port, "/", {"x": x})
                assert status == 200, (status, data)
                d = json.loads(data)
                assert d["y"] == x * 2
                with lock:
                    answers[x] = d["worker"]
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    # kill worker 0 while traffic is in flight
    time.sleep(0.05)
    backends[0][1].stop()
    backends[0][0].stop()
    for t in threads:
        t.join()
    gw.stop()
    for srv, q, _ in backends[1:]:
        q.stop()
        srv.stop()
    assert not errs, errs[:3]
    assert len(answers) == 160  # zero lost requests
    survivors = {w for w in answers.values()}
    assert {"w1", "w2"} <= survivors  # the load moved to live workers


def test_gateway_discovers_workers_from_registry():
    from mmlspark_tpu_torch.serving import DriverRegistry, ServingGateway

    reg = DriverRegistry()
    backends = [_worker_with_handler(f"r{i}") for i in range(2)]
    try:
        for _, _, info in backends:
            assert DriverRegistry.register(reg.url, info)
        gw = ServingGateway(registry_url=reg.url, refresh_s=0.2)
        ginfo = gw.start()
        try:
            assert gw.pool.size() == 2
            status, data = _post(ginfo.port, "/", {"x": 21})
            assert status == 200 and json.loads(data)["y"] == 42
            # a THIRD worker registering later joins without a restart
            late = _worker_with_handler("late")
            backends.append(late)
            assert DriverRegistry.register(reg.url, late[2])
            deadline = time.monotonic() + 5.0
            while gw.pool.size() < 3 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert gw.pool.size() == 3
            seen = set()
            for i in range(30):
                _, data = _post(ginfo.port, "/", {"x": i})
                seen.add(json.loads(data)["worker"])
            assert "late" in seen
        finally:
            gw.stop()
    finally:
        reg.stop()
        for srv, q, _ in backends:
            q.stop()
            srv.stop()


def test_gateway_all_workers_down_503():
    from mmlspark_tpu_torch.serving import ServingGateway

    srv, q, info = _worker_with_handler("only")
    gw = ServingGateway(workers=[info], request_timeout_s=1.0, max_attempts=2)
    ginfo = gw.start()
    try:
        status, _ = _post(ginfo.port, "/", {"x": 1})
        assert status == 200
        q.stop()
        srv.stop()
        status, data = _post(ginfo.port, "/", {"x": 2})
        assert status == 503
        assert b"no live" in data
    finally:
        gw.stop()


def test_static_pool_worker_recovers_after_cooldown():
    """A static (no-registry) pool must let a briefly-down worker rejoin:
    eviction is disabled there, cooldown alone rate-limits attempts."""
    from mmlspark_tpu_torch.serving import ServingGateway

    srv, q, info = _worker_with_handler("w")
    gw = ServingGateway(
        workers=[info], request_timeout_s=1.0, cooldown_s=0.3, max_attempts=2
    )
    ginfo = gw.start()
    try:
        assert _post(ginfo.port, "/", {"x": 1})[0] == 200
        port = info.port
        q.stop()
        srv.stop()
        # many failures while down — would trip any eviction threshold
        for _ in range(5):
            assert _post(ginfo.port, "/", {"x": 2})[0] == 503
        # worker comes back on the SAME port (static deployments pin ports)
        srv2 = WorkerServer(port=port)
        srv2.start()
        q2 = ServingQuery(srv2, lambda reqs: {
            r.id: (200, b'{"y": 42}', {}) for r in reqs
        }, max_wait_ms=0).start()
        time.sleep(0.4)  # let the cooldown lapse
        try:
            status, data = _post(ginfo.port, "/", {"x": 3})
            assert status == 200 and json.loads(data)["y"] == 42
        finally:
            q2.stop()
            srv2.stop()
    finally:
        gw.stop()


def test_registry_roster_is_bounded():
    from mmlspark_tpu_torch.serving import DriverRegistry, ServiceInfo

    reg = DriverRegistry(max_entries_per_service=5)
    try:
        for p in range(20):  # crash-looping worker on ephemeral ports
            DriverRegistry.register(
                reg.url, ServiceInfo("serving", "127.0.0.1", 40000 + p)
            )
        roster = reg.services("serving")
        assert len(roster) == 5
        # newest registrations survive
        assert {e["port"] for e in roster} == set(range(40015, 40020))
    finally:
        reg.stop()


def test_fleet_roles_bring_up_and_smoke():
    """The deployment recipe's code path (tools/deploy): fleet.py roles
    bring up registry + 2 workers + gateway; the smoke client round-trips
    through the gateway and both workers serve."""
    from mmlspark_tpu_torch.serving import fleet

    reg = fleet.run_registry(host="127.0.0.1", port=0)
    workers = [
        fleet.run_worker(reg.url, model="echo", host="127.0.0.1",
                         heartbeat_s=0.5, device="cpu")
        for _ in range(2)
    ]
    gw = fleet.run_gateway(reg.url, host="127.0.0.1", port=0)
    try:
        deadline = time.monotonic() + 5.0
        while gw.pool.size() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert gw.pool.size() == 2
        for i in range(20):
            status, data = _post(
                int(gw.url.rsplit(":", 1)[1].rstrip("/")), "/", {"x": i}
            )
            assert status == 200
            assert json.loads(data)["echo"]["x"] == i
    finally:
        gw.stop()
        for srv, q, stop in workers:
            stop.set()
            q.stop()
            srv.stop()
        reg.stop()


def test_fleet_worker_heartbeat_survives_registry_restart():
    """A restarted registry re-learns live workers from heartbeats — the
    operational property the deployment doc promises."""
    from mmlspark_tpu_torch.serving import fleet
    from mmlspark_tpu_torch.serving.registry import DriverRegistry

    reg = fleet.run_registry(host="127.0.0.1", port=0)
    port = int(reg.url.rsplit(":", 1)[1].rstrip("/"))
    srv, q, stop = fleet.run_worker(
        reg.url, model="echo", host="127.0.0.1", heartbeat_s=0.2,
        device="cpu",
    )
    try:
        time.sleep(0.4)
        assert reg.services("serving")
        reg.stop()
        reg2 = None
        for _ in range(50):  # the freed port may linger in TIME_WAIT
            try:
                reg2 = DriverRegistry(host="127.0.0.1", port=port)
                break
            except OSError:
                time.sleep(0.1)
        assert reg2 is not None, "could not rebind registry port"
        try:
            deadline = time.monotonic() + 5.0
            while not reg2.services("serving") and time.monotonic() < deadline:
                time.sleep(0.05)
            assert reg2.services("serving"), "heartbeat did not re-register"
        finally:
            reg2.stop()
    finally:
        stop.set()
        q.stop()
        srv.stop()


def test_gateway_conn_cache_prunes_departed_backends():
    """Registry churn must not leak pooled connections: when a backend
    leaves the pool, the next dispatch closes and forgets its cached
    keep-alive connection (per dispatcher thread)."""
    from mmlspark_tpu_torch.serving import ServingGateway

    from mmlspark_tpu_torch.serving.distributed import BackendPool

    s1, q1, i1 = _worker_with_handler("p1")
    s2, q2, i2 = _worker_with_handler("p2")
    gw = ServingGateway(workers=[i1, i2], request_timeout_s=2.0)
    try:
        b1, b2 = gw.pool.members()
        # registry-style pool: no static members, so refresh() can drop
        # a departed backend (static pools never shrink by design)
        gw._pool = BackendPool()
        gw.pool.refresh([b1, b2])
        # populate this thread's cache with live connections to both
        c1, cached1 = gw._conn_for(b1)
        c2, _ = gw._conn_for(b2)
        assert not cached1
        c1.send(
            b"POST / HTTP/1.1\r\nContent-Length: 8\r\n\r\n" + b'{"x": 1}'
        )
        assert c1.read_response().body
        assert set(gw._conns.by_backend) == {
            (b1.host, b1.port), (b2.host, b2.port)
        }
        # b2 leaves the roster; next dispatch to b1 prunes b2's conn
        gw.pool.refresh([b1])
        c1b, cached = gw._conn_for(b1)
        assert cached and c1b is c1  # live entry survives, still pooled
        assert set(gw._conns.by_backend) == {(b1.host, b1.port)}
        assert c2._closed  # pruned connection was closed
    finally:
        for s, q in ((s1, q1), (s2, q2)):
            q.stop()
            s.stop()


# -- BackendPool eviction/revival edge cases ---------------------------------


def _pool_backend(port):
    from mmlspark_tpu_torch.serving.distributed import Backend

    return Backend(host="10.0.0.1", port=port)


def test_pool_breaker_opens_and_closes_on_reregistration():
    """A dead worker's roster entry keeps its registration timestamp; a
    refresh carrying the SAME stamp must not close its open breaker —
    only an actual re-registration (newer stamp, i.e. a new process)
    resets it immediately."""
    from mmlspark_tpu_torch.serving.distributed import BackendPool

    b = _pool_backend(9001)
    pool = BackendPool(cooldown_s=60.0, evict_after=3)
    pool.refresh([b], stamps={b: 100.0})
    for _ in range(3):
        pool.report_failure(b)
    # breaker OPEN: skipped entirely, not even as a cooled-down fallback
    assert pool.breaker_states() == {"10.0.0.1:9001": "open"}
    assert pool.size() == 0 and pool.next() is None
    pool.refresh([b], stamps={b: 100.0})  # stale roster echo: same stamp
    assert pool.size() == 0 and pool.next() is None
    pool.refresh([b], stamps={b: 101.0})  # real re-registration: new stamp
    assert pool.breaker_states() == {"10.0.0.1:9001": "closed"}
    assert pool.size() == 1 and pool.next() == b


def test_pool_static_backend_never_evicted():
    """Static backends (constructor list) only cool down: with no registry
    to revive them, eviction would lose a briefly-down worker forever —
    both at evict_after=0 (eviction off) and above any threshold."""
    from mmlspark_tpu_torch.serving.distributed import BackendPool

    for evict_after in (0, 3):
        b = _pool_backend(9002)
        pool = BackendPool([b], cooldown_s=10.0, evict_after=evict_after)
        for _ in range(10):  # far past any eviction threshold
            pool.report_failure(b)
        assert pool.size() == 1
        # cooled down, but still reachable via the fallback (it may have
        # recovered — better one retry than a refused request)
        assert pool.next() == b
        pool.refresh([], stamps={})  # roster refresh cannot drop it either
        assert pool.size() == 1


def test_pool_cooldown_fallback_when_all_backends_cooling():
    """With every backend cooling down, next() must still hand out one of
    them (round-robin would otherwise refuse all traffic during a blip),
    and exclusions are honored before the fallback."""
    from mmlspark_tpu_torch.serving.distributed import BackendPool

    b1, b2 = _pool_backend(9003), _pool_backend(9004)
    pool = BackendPool([b1, b2], cooldown_s=60.0, evict_after=0)
    pool.report_failure(b1)
    pool.report_failure(b2)
    got = pool.next()
    assert got in (b1, b2)
    other = b2 if got == b1 else b1
    assert pool.next(exclude={got}) == other
    assert pool.next(exclude={b1, b2}) is None
    # recovery clears the cooldown entirely
    pool.report_ok(b1)
    assert pool.next(exclude={b2}) == b1


# -- the gateway cases of tests/test_selfheal.py
# -- circuit breaker (unit) ---------------------------------------------------


def test_breaker_opens_on_consecutive_failures_and_probes_closed():
    br = CircuitBreaker(open_after=3, cooldown_s=0.05)
    t = 100.0
    assert br.record_failure(t) is None
    assert br.record_failure(t) is None
    assert br.record_failure(t) == BREAKER_OPEN
    assert not br.allow(t + 0.01)          # open: no traffic at all
    assert br.allow(t + 0.06)              # open period elapsed: ONE probe
    assert br.state == BREAKER_HALF_OPEN
    assert not br.allow(t + 0.06)          # second request: probe in flight
    assert br.record_ok(t + 0.07) == BREAKER_CLOSED
    assert br.allow(t + 0.08) and br.fails == 0


def test_breaker_failed_probe_reopens_with_doubled_period():
    br = CircuitBreaker(open_after=2, cooldown_s=0.05, max_open_s=0.15)
    t = 10.0
    br.record_failure(t)
    assert br.record_failure(t) == BREAKER_OPEN
    assert br.open_for_s() == pytest.approx(0.05)
    assert br.allow(t + 0.06)              # half-open probe
    assert br.record_failure(t + 0.07) == BREAKER_OPEN  # probe failed
    assert br.open_for_s() == pytest.approx(0.10)       # doubled
    assert not br.allow(t + 0.12)          # 0.05 after reopen: still open
    assert br.allow(t + 0.18)
    br.record_failure(t + 0.19)
    assert br.open_for_s() == pytest.approx(0.15)       # capped at max

    br.reset()                              # a re-registered backend
    assert br.state == BREAKER_CLOSED and br.opens_in_a_row == 0


def test_breaker_error_rate_trip_requires_min_volume():
    br = CircuitBreaker(
        open_after=100,  # consecutive trip effectively off
        rate_threshold=0.5, rate_window_s=10.0, rate_min_volume=10,
    )
    t = 50.0
    # alternate ok/fail: never 100 consecutive, but 50% error rate
    for i in range(9):
        (br.record_failure if i % 2 else br.record_ok)(t + i * 0.01)
    assert br.state == BREAKER_CLOSED       # below min volume: no trip
    for i in range(9, 14):
        transition = (br.record_failure if i % 2 else br.record_ok)(
            t + i * 0.01
        )
        if transition == BREAKER_OPEN:
            break
    assert br.state == BREAKER_OPEN


def test_breaker_open_after_zero_never_opens():
    br = CircuitBreaker(open_after=0)
    t = 0.0
    for i in range(20):
        br.record_failure(t + i)
    assert br.state == BREAKER_CLOSED       # static-pool setting


# -- retry budget (unit) ------------------------------------------------------


def test_retry_budget_caps_retries_at_ratio_of_volume():
    rb = RetryBudget(ratio=0.2, window_s=10.0, min_reserve=0)
    for _ in range(50):
        rb.note_request()
    spent = sum(1 for _ in range(50) if rb.try_spend())
    assert spent == 10                      # 20% of 50, not one more
    assert rb.exhausted == 40
    assert rb.remaining_ratio() == 0.0


def test_retry_budget_min_reserve_lets_a_cold_gateway_retry():
    rb = RetryBudget(ratio=0.2, window_s=10.0, min_reserve=3)
    assert [rb.try_spend() for _ in range(4)] == [True] * 3 + [False]


def test_retry_budget_window_prunes_old_volume():
    rb = RetryBudget(ratio=1.0, window_s=0.05, min_reserve=0)
    rb.note_request()
    assert rb.try_spend()
    time.sleep(0.08)                        # request AND retry age out
    assert not rb.try_spend()               # no recent volume -> no budget


# -- admission controller (unit) ----------------------------------------------


def test_admission_acquire_release_and_shed():
    a = AdmissionController(
        server="selfheal-unit", initial_limit=2, min_limit=1
    )
    assert a.try_acquire() and a.try_acquire()
    assert not a.try_acquire()              # over the limit: shed
    assert a.shed == 1 and a.inflight == 2
    a.release()
    assert a.try_acquire()
    a.release(), a.release()
    assert a.inflight == 0


def test_admission_aimd_decreases_on_queue_wait_and_recovers():
    a = AdmissionController(
        server="selfheal-aimd",
        initial_limit=32, window_samples=1, window_s=0.0,
        wait_factor=1.5, min_target_s=0.002, decrease=0.5,
    )
    # queue wait far above 1.5x the 10 ms service EWMA: halve the limit
    a.observe(queue_wait_s=0.5, service_s=0.01)
    assert a.limit == 16
    a.observe(queue_wait_s=0.5, service_s=0.01)
    assert a.limit == 8
    # healthy windows: additive increase, +1 each
    for _ in range(3):
        a.observe(queue_wait_s=0.001, service_s=0.01)
    assert a.limit == 11
    # floor: the limit can never shed everything
    for _ in range(20):
        a.observe(queue_wait_s=5.0, service_s=0.01)
    assert a.limit >= a.min_limit


@pytest.mark.xdist_group("latency")
def test_admission_sheds_429_at_ingress_with_retry_after():
    ctrl = AdmissionController(
        server="selfheal-adm", initial_limit=1, min_limit=1, max_limit=1,
        retry_after_s=2.0,
    )
    gate = threading.Event()

    def slow(reqs):
        gate.wait(5.0)
        return _echo_handler(reqs)

    srv, q, info = _worker(slow, admission=ctrl)
    try:
        results = []

        def client():
            results.append(_req(info.port, "/", {"i": 1}))

        t = threading.Thread(target=client)
        t.start()
        deadline = time.monotonic() + 5.0
        while ctrl.inflight < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert ctrl.inflight == 1
        # second request while the slot is held: fast 429, never queued
        status, body, headers = _req(info.port, "/", {"i": 2})
        assert status == 429
        assert headers.get("Retry-After") == "2"
        assert headers.get(SHED_HEADER) == "admission"
        assert ctrl.shed == 1
        gate.set()
        t.join(5.0)
        assert results and results[0][0] == 200
        # the slot was released on reply: a new request is admitted
        assert _req(info.port, "/", {"i": 3})[0] == 200
        assert ctrl.inflight == 0
    finally:
        gate.set()
        q.stop()
        srv.stop()


def test_admission_shed_fault_point_forces_429():
    ctrl = AdmissionController(server="selfheal-forced", initial_limit=64)
    srv, q, info = _worker(admission=ctrl)
    plan = FaultPlan().on("admission.shed", payload=True, at=(0,))
    try:
        with plan.armed():
            status, _, headers = _req(info.port, "/", {"i": 0})
            assert status == 429 and headers.get(SHED_HEADER) == "admission"
            assert _req(info.port, "/", {"i": 1})[0] == 200
        assert plan.fires() == [("admission.shed", 0)]
    finally:
        q.stop()
        srv.stop()


# -- deadline propagation -----------------------------------------------------


def _headers_handler(reqs):
    """Echoes back the request headers the worker actually saw."""
    out = {}
    for r in reqs:
        out[r.id] = (
            200,
            json.dumps({"deadline": r.headers.get(DEADLINE_HEADER)}).encode(),
            {},
        )
    return out


@pytest.mark.xdist_group("latency")
def test_gateway_decrements_deadline_across_retries():
    """Satellite fix: a retry must forward what is LEFT of the client's
    deadline, not the original budget."""
    s1, q1, i1 = _worker(_headers_handler)
    dead = {"host": "127.0.0.1", "port": _closed_port()}
    gw = ServingGateway(workers=[dead, i1], request_timeout_s=5.0)
    ginfo = gw.start()
    try:
        t0 = time.perf_counter()
        status, body, _ = _req(
            ginfo.port, "/", {"i": 0},
            headers={DEADLINE_HEADER: "5000"},
        )
        burned_ms = (time.perf_counter() - t0) * 1e3
        assert status == 200
        fwd = float(json.loads(body)["deadline"])
        # decremented by the dead-backend attempt, but by no more than
        # the request's actual wall time at the gateway
        assert fwd < 5000.0
        assert 5000.0 - fwd <= burned_ms + 1.0
        assert gw.retried == 1
    finally:
        gw.stop()
        q1.stop()
        s1.stop()


def test_gateway_expired_deadline_fails_504_without_forwarding():
    s1, q1, i1 = _worker()
    gw = ServingGateway(workers=[i1], request_timeout_s=5.0)
    ginfo = gw.start()
    try:
        time.sleep(0.02)  # any queue wait at all blows a 0.01 ms budget
        status, body, _ = _req(
            ginfo.port, "/", {"i": 0}, headers={DEADLINE_HEADER: "0.01"},
        )
        assert status == 504 and b"deadline" in body
        assert gw.forwarded == 0            # never reached a worker
    finally:
        gw.stop()
        q1.stop()
        s1.stop()


def test_gateway_skips_retry_when_ewma_exceeds_remaining():
    """Satellite fix, part 2: don't bother retrying on a backend whose
    typical service time can't fit in the leftover budget."""
    s1, q1, i1 = _worker()
    dead = {"host": "127.0.0.1", "port": _closed_port()}
    gw = ServingGateway(workers=[dead, i1], request_timeout_s=5.0)
    ginfo = gw.start()
    try:
        live = [b for b in gw.pool.members() if b.port == i1.port][0]
        gw.pool.report_ok(live, elapsed_s=10.0)  # EWMA: 10 s service time
        status, body, _ = _req(
            ginfo.port, "/", {"i": 0}, headers={DEADLINE_HEADER: "2000"},
        )
        # first attempt (dead) burned ~nothing, 2 s remain — but the only
        # retry candidate needs ~10 s: fail fast instead of a doomed send
        assert status == 504 and b"service time" in body
        assert gw.forwarded == 0
    finally:
        gw.stop()
        q1.stop()
        s1.stop()


@pytest.mark.xdist_group("latency")
def test_worker_sheds_requests_whose_deadline_expired_in_queue():
    from mmlspark_tpu_torch.serving.query import ServingQuery
    from mmlspark_tpu_torch.serving.server import WorkerServer

    srv = WorkerServer()
    info = srv.start()
    results = []

    def client():
        results.append(
            _req(info.port, "/", {"i": 0}, headers={DEADLINE_HEADER: "20"})
        )

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.15)  # queued with NO dispatcher running: deadline burns
    q = ServingQuery(srv, _echo_handler).start()
    try:
        t.join(5.0)
        status, body, headers = results[0]
        assert status == 504 and b"deadline" in body
        assert headers.get(SHED_HEADER) == "deadline"
        assert q.deadline_expired == 1
        # a fresh request with budget to spare is served normally
        assert _req(info.port, "/", {"i": 1})[0] == 200
    finally:
        q.stop()
        srv.stop()


# -- 429 backpressure classification ------------------------------------------


def test_shedding_replica_is_backpressure_not_failure():
    """Satellite fix: a 429-shedding replica is alive and correct —
    re-dispatch elsewhere, never cool it down or open its breaker."""
    ctrl = AdmissionController(
        server="selfheal-bp", initial_limit=1, min_limit=1, max_limit=1
    )
    ctrl.try_acquire()                      # wedge the only slot: all shed
    s1, q1, i1 = _worker(admission=ctrl)
    s2, q2, i2 = _worker()
    gw = ServingGateway(workers=[i1, i2], request_timeout_s=5.0)
    ginfo = gw.start()
    try:
        for i in range(4):
            status, body, _ = _req(ginfo.port, "/", {"i": i})
            assert status == 200            # re-dispatched to the healthy one
        states = gw.pool.breaker_states()
        assert all(v == "closed" for v in states.values())
        assert gw.pool.size() == 2          # the shedder was NOT evicted
        assert gw.failed == 0
    finally:
        gw.stop()
        for s, q in ((s1, q1), (s2, q2)):
            q.stop()
            s.stop()


# -- retry budget at the gateway ----------------------------------------------


def test_exhausted_retry_budget_fails_fast_with_header():
    s1, q1, i1 = _worker()
    dead = {"host": "127.0.0.1", "port": _closed_port()}
    gw = ServingGateway(
        workers=[dead, i1], request_timeout_s=5.0,
        retry_budget_ratio=0.0, retry_budget_min=0,  # zero tokens, ever
    )
    ginfo = gw.start()
    try:
        # round-robin starts at the dead backend: the failure wants a
        # retry, the empty bucket refuses it
        status, body, headers = _req(ginfo.port, "/", {"i": 0})
        assert status == 503
        assert headers.get(RETRY_BUDGET_HEADER) == "exhausted"
        assert gw.retried == 0
        # the healthy backend still serves the NEXT request (round robin)
        assert _req(ginfo.port, "/", {"i": 1})[0] == 200
    finally:
        gw.stop()
        q1.stop()
        s1.stop()


# -- circuit breaker through the gateway --------------------------------------


@pytest.mark.xdist_group("latency")
def test_breaker_cycles_open_half_open_closed_through_gateway():
    """A registry-discovered backend that fails repeatedly trips its
    breaker OPEN (skipped entirely), then recovers through a half-open
    probe once the open period elapses."""
    from mmlspark_tpu_torch.serving.registry import DriverRegistry

    reg = DriverRegistry(host="127.0.0.1", port=0)
    s1, q1, i1 = _worker()
    gw = ServingGateway(
        registry_url=reg.url, request_timeout_s=5.0, refresh_s=0.1,
        cooldown_s=0.3, evict_after=3,
    )
    try:
        DriverRegistry.register(reg.url, i1)
        ginfo = gw.start()
        deadline = time.monotonic() + 5.0
        while gw.pool.size() < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        b = gw.pool.members()[0]
        for _ in range(3):
            gw.pool.report_failure(b)
        assert gw.pool.breaker_states() == {
            f"{b.host}:{b.port}": "open"
        }
        assert gw.pool.size() == 0 and gw.pool.next() is None
        time.sleep(0.35)                    # the open period elapses
        nxt = gw.pool.next()
        assert nxt == b                     # the half-open probe
        assert gw.pool.breaker_states()[f"{b.host}:{b.port}"] == "half_open"
        assert gw.pool.next() is None       # one probe at a time
        gw.pool.report_failure(b)           # probe failed: reopen, doubled
        assert gw.pool.breaker_states()[f"{b.host}:{b.port}"] == "open"
        assert gw.pool.next() is None
        time.sleep(0.7)                     # the doubled open period
        # a REAL request through the gateway is the next probe — its
        # success closes the breaker
        status, _, _ = _req(ginfo.port, "/", {"i": 0})
        assert status == 200
        assert gw.pool.breaker_states()[f"{b.host}:{b.port}"] == "closed"
        assert gw.pool.size() == 1
    finally:
        gw.stop()
        q1.stop()
        s1.stop()
        reg.stop()


# -- tail hedging -------------------------------------------------------------


def _slow_then_echo(delay_s):
    def handler(reqs):
        time.sleep(delay_s)
        return _echo_handler(reqs)

    return handler


@pytest.mark.xdist_group("latency")
def test_hedge_duplicates_to_second_backend_and_first_answer_wins():
    s1, q1, i1 = _worker(_slow_then_echo(3.0))   # round-robin primary
    s2, q2, i2 = _worker()
    gw = ServingGateway(
        workers=[i1, i2], request_timeout_s=5.0, hedge_ms=60.0,
    )
    ginfo = gw.start()
    try:
        t0 = time.perf_counter()
        status, body, _ = _req(ginfo.port, "/", {"i": 7})
        elapsed = time.perf_counter() - t0
        assert status == 200 and json.loads(body)["echo"]["i"] == 7
        assert gw.hedged == 1 and gw.hedge_wins == 1
        assert elapsed < 2.5                 # did NOT wait out the primary
        # the slow loser was cancelled, not failed: breaker stays closed
        assert all(
            v == "closed" for v in gw.pool.breaker_states().values()
        )
        assert gw.failed == 0
    finally:
        gw.stop()
        for s, q in ((s1, q1), (s2, q2)):
            q.stop()
            s.stop()


@pytest.mark.xdist_group("latency")
def test_hedge_fault_point_suppresses_the_duplicate():
    s1, q1, i1 = _worker(_slow_then_echo(0.3))
    s2, q2, i2 = _worker()
    gw = ServingGateway(
        workers=[i1, i2], request_timeout_s=5.0, hedge_ms=40.0,
    )
    ginfo = gw.start()
    plan = FaultPlan().on("gateway.hedge", error=RuntimeError, at=(0,))
    try:
        with plan.armed():
            status, body, _ = _req(ginfo.port, "/", {"i": 1})
        assert status == 200                 # primary answered eventually
        assert json.loads(body)["echo"]["i"] == 1
        assert gw.hedged == 0                # the duplicate never launched
        assert plan.fires() == [("gateway.hedge", 0)]
    finally:
        gw.stop()
        for s, q in ((s1, q1), (s2, q2)):
            q.stop()
            s.stop()


@pytest.mark.xdist_group("latency")
def test_hedge_failed_primary_falls_back_to_retry_loop():
    """Both hedged attempts dying must not lose the request: the normal
    retry loop picks it up against the retry budget."""
    s2, q2, i2 = _worker()
    dead1 = {"host": "127.0.0.1", "port": _closed_port()}
    dead2 = {"host": "127.0.0.1", "port": _closed_port()}
    gw = ServingGateway(
        workers=[dead1, dead2, i2], request_timeout_s=5.0, hedge_ms=20.0,
    )
    ginfo = gw.start()
    try:
        status, body, _ = _req(ginfo.port, "/", {"i": 3})
        assert status == 200 and json.loads(body)["echo"]["i"] == 3
    finally:
        gw.stop()
        q2.stop()
        s2.stop()



# -- breaker reset keyed on boot, not heartbeat ts ----------------------------


def test_roster_refresh_resets_breaker_only_on_new_boot():
    """The registry bumps ``ts`` on every heartbeat — the breaker reset
    must key on the per-process ``boot`` stamp instead, or a wedged-but-
    heartbeating worker's open breaker flaps closed every refresh."""
    from mmlspark_tpu_torch.serving.distributed import Backend, BackendPool

    pool = BackendPool(cooldown_s=60.0, evict_after=2)
    b = Backend("127.0.0.1", 19999)
    pool.refresh([b], stamps={b: 100.0})
    pool.report_failure(b)
    pool.report_failure(b)
    key = f"{b.host}:{b.port}"
    assert pool.breaker_states()[key] == "open"
    # heartbeat: same process delivers the same boot stamp — stays open
    pool.refresh([b], stamps={b: 100.0})
    assert pool.breaker_states()[key] == "open"
    assert pool.next() is None
    # restart: a NEW boot stamp closes the breaker immediately
    pool.refresh([b], stamps={b: 200.0})
    assert pool.breaker_states()[key] == "closed"
    assert pool.next() == b


def test_worker_boot_stamp_constant_across_heartbeats():
    from mmlspark_tpu_torch.serving.registry import DriverRegistry
    from mmlspark_tpu_torch.serving.server import WorkerServer

    srv = WorkerServer(name="selfheal-boot")
    reg = DriverRegistry(host="127.0.0.1", port=0)
    try:
        info = srv.start()
        assert info.boot is not None
        DriverRegistry.register(reg.url, info)
        first = reg.services("selfheal-boot")[0]
        time.sleep(0.02)
        DriverRegistry.register(reg.url, info)  # the heartbeat re-register
        second = reg.services("selfheal-boot")[0]
        assert second["ts"] > first["ts"]       # ts bumps every beat...
        assert second["boot"] == first["boot"] == info.boot  # ...boot doesn't
    finally:
        reg.stop()
        srv.stop()


# -- half-open probe slot return ----------------------------------------------


def test_report_abandoned_returns_half_open_probe_slot():
    """``next()`` hands out the single half-open probe; a caller that
    never contacts the backend must return the slot or the breaker waits
    forever for an outcome and the backend stays unroutable."""
    from mmlspark_tpu_torch.serving.distributed import Backend, BackendPool

    pool = BackendPool(cooldown_s=0.05, evict_after=1)
    b = Backend("127.0.0.1", 19998)
    pool.refresh([b], stamps={b: 1.0})
    pool.report_failure(b)                  # opens the breaker
    key = f"{b.host}:{b.port}"
    assert pool.breaker_states()[key] == "open"
    time.sleep(0.06)                        # the open period elapses
    assert pool.next() == b                 # the half-open probe
    assert pool.next() is None              # slot held by the probe
    pool.report_abandoned(b)                # probe never sent
    assert pool.breaker_states()[key] == "half_open"
    assert pool.next() == b                 # the slot came back
    pool.report_ok(b)
    assert pool.breaker_states()[key] == "closed"


def test_report_abandoned_is_noop_for_closed_breaker():
    from mmlspark_tpu_torch.serving.distributed import Backend, BackendPool

    pool = BackendPool(cooldown_s=0.05, evict_after=3)
    b = Backend("127.0.0.1", 19997)
    pool.refresh([b], stamps={b: 1.0})
    pool.report_abandoned(b)                # no breaker minted, no crash
    pool.report_failure(b)
    pool.report_abandoned(b)                # closed breaker: untouched
    assert pool.breaker_states()[f"{b.host}:{b.port}"] == "closed"
    assert pool.next() == b


# -- forced-shed accounting ---------------------------------------------------


def test_force_shed_counts_like_a_real_shed():
    a = AdmissionController(server="selfheal-forceshed", initial_limit=4)
    a.force_shed()
    a.force_shed()
    assert a.shed == 2
    assert a.inflight == 0                  # never touches admission state
    assert a.try_acquire()                  # and never blocks admission


# -- hedged shed / model-state classification ---------------------------------


@pytest.mark.parametrize("hedge_ms", [None, 60.0], ids=["plain", "hedged"])
def test_gateway_relays_429_when_every_backend_sheds(hedge_ms):
    """With every backend shedding, the gateway relays the 429 and its
    Retry-After — a shed, not a 5xx. With hedging on, the 429 must not
    'win' a hedged race as a forwarded answer either: it is stashed,
    classified backpressure, and relayed when nothing better arrives."""
    ctrl = AdmissionController(
        server=f"selfheal-bp2-{hedge_ms}", initial_limit=1, min_limit=1,
        max_limit=1, retry_after_s=3.0,
    )
    ctrl.try_acquire()                      # wedge the only slot: all shed
    s1, q1, i1 = _worker(admission=ctrl)
    gw = ServingGateway(workers=[i1], request_timeout_s=5.0, hedge_ms=hedge_ms)
    ginfo = gw.start()
    try:
        status, _, headers = _req(ginfo.port, "/", {"i": 0})
        assert status == 429                # the shed, relayed — not a 5xx
        assert headers.get(SHED_HEADER) == "admission"
        assert headers.get("Retry-After") == "3"
        assert gw.pool.size() == 1
        assert gw.forwarded == 0            # a shed is not a forward
        assert gw.failed == 1
        # and the shedding replica was never blamed for it
        assert all(
            v == "closed" for v in gw.pool.breaker_states().values()
        )
    finally:
        gw.stop()
        q1.stop()
        s1.stop()


def _loading(reqs):
    return {
        r.id: (
            503, b'{"error": "model loading"}',
            {"x-mmlspark-model-state": "loading"},
        )
        for r in reqs
    }


@pytest.mark.xdist_group("latency")
@pytest.mark.parametrize("primary", ["shed", "not_ready"])
def test_hedged_fast_refusal_retries_on_second_replica_before_relaying(primary):
    """With hedging on, a replica that refuses FASTER than the hedge delay
    — a 429 shed, or a model-state 503 from a mid-swap/loading replica —
    must not short-circuit the cross-replica retry: the standard loop gets
    the request and the replica with headroom (which already serves the
    model) serves it. A shedding replica is backpressure, never blamed."""
    if primary == "shed":
        ctrl = AdmissionController(
            server="selfheal-hedgeshed", initial_limit=1, min_limit=1,
            max_limit=1,
        )
        ctrl.try_acquire()                  # wedge the only slot: A sheds
        s1, q1, i1 = _worker(admission=ctrl)    # round-robin primary
    else:
        s1, q1, i1 = _worker(_loading)          # round-robin primary
    s2, q2, i2 = _worker()
    gw = ServingGateway(
        workers=[i1, i2], request_timeout_s=5.0, hedge_ms=60.0,
    )
    ginfo = gw.start()
    try:
        status, body, _ = _req(ginfo.port, "/", {"i": 5})
        assert status == 200 and json.loads(body)["echo"]["i"] == 5
        assert gw.forwarded == 1
        if primary == "shed":
            assert all(
                v == "closed" for v in gw.pool.breaker_states().values()
            )
    finally:
        gw.stop()
        for s, q in ((s1, q1), (s2, q2)):
            q.stop()
            s.stop()


# -- breaker bookkeeping bounds -----------------------------------------------


def test_breaker_outcome_window_bounded_on_success_path():
    """The happy path must not grow the outcome window forever: record_ok
    prunes by time (and the deque is hard-capped regardless of rate)."""
    br = CircuitBreaker(rate_window_s=1.0)
    for i in range(10_000):
        br.record_ok(i * 0.01)              # 100 ok/s for 100 simulated s
    assert len(br._window) <= 110           # ~one window's worth, not 10k
    assert br._window.maxlen is not None    # hard cap at any rate


def test_half_open_probe_readmission_counts_one_transition():
    """report_abandoned returning the probe slot re-admits a probe while
    the breaker is ALREADY half-open — that is not a new transition and
    must not inflate the cycle-evidence counter."""
    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.serving.distributed import Backend, BackendPool

    pool = BackendPool(cooldown_s=0.05, evict_after=1)
    b = Backend("127.0.0.1", 19996)
    pool.refresh([b], stamps={b: 1.0})

    def half_open_count():
        parsed = obs.parse_text(obs.render())
        return obs.sum_samples(
            parsed, "mmlspark_gateway_breaker_transitions_total",
            {"backend": f"{b.host}:{b.port}", "state": "half_open"},
        )

    base = half_open_count()
    pool.report_failure(b)                  # opens the breaker
    time.sleep(0.06)                        # the open period elapses
    assert pool.next() == b                 # open -> half-open: the probe
    pool.report_abandoned(b)                # probe never sent, slot back
    assert pool.next() == b                 # re-admitted, SAME half-open
    assert half_open_count() - base == 1


# -- probe overflow bound at ingress ------------------------------------------


def _fire_raw(port: int, data: bytes) -> socket.socket:
    """Send a raw request and keep the socket open (the request stays
    pending — no dispatcher is draining the queue)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    s.sendall(data)
    return s


@pytest.mark.xdist_group("latency")
def test_probe_overflow_closes_unanswered_past_bound():
    """Probes may queue past max_queue (never bounced inline — a 429/503
    would read as 'alive' and defeat wedge detection) but only up to the
    overflow allowance; beyond it the connection closes unanswered,
    which reads as a failed probe."""
    from mmlspark_tpu_torch.serving.server import WorkerServer

    srv = WorkerServer(name="selfheal-probeflood", max_queue=1)
    srv._PROBE_OVERFLOW = 2
    info = srv.start()
    opened = []
    probe = b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n"
    post = (b"POST / HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 2\r\n\r\n{}")
    try:
        def wait_pending(n):
            deadline = time.monotonic() + 5.0
            while srv.pending() < n and time.monotonic() < deadline:
                time.sleep(0.005)
            assert srv.pending() == n

        opened.append(_fire_raw(info.port, post))     # fills max_queue
        wait_pending(1)
        # a normal request past max_queue bounces 503 inline
        assert _req(info.port, "/", {"i": 1})[0] == 503
        # probes still ride the queue, up to the overflow allowance
        opened.append(_fire_raw(info.port, probe))
        wait_pending(2)
        opened.append(_fire_raw(info.port, probe))
        wait_pending(3)
        # past max_queue + overflow: closed unanswered (a failed probe)
        with pytest.raises((http.client.BadStatusLine, ConnectionError)):
            _req(info.port, "/health", None, method="GET", timeout=5)
        assert srv.pending() == 3            # the flood never grew the queue
    finally:
        for s in opened:
            s.close()
        srv.stop()



# -- tests/test_throughput.py: the wire
        srv.stop()


def test_bare_lf_request_head_still_parses():
    """The ingress has always tolerated LF-only request heads; the
    parse-path rewrite must not turn them into indefinite hangs."""
    def handler(reqs):
        return {r.id: (200, b"ok", {}) for r in reqs}

    srv = WorkerServer(num_reactors=2)
    info = srv.start()
    q = ServingQuery(srv, handler).start()
    try:
        s = socket.create_connection(("127.0.0.1", info.port), timeout=5)
        s.sendall(b"POST / HTTP/1.1\nContent-Length: 2\n\n{}")
        data = s.recv(65536)
        assert data.startswith(b"HTTP/1.1 200")
        s.close()
    finally:
        q.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# pooled zero-re-parse forwarding
# ---------------------------------------------------------------------------


def _echo_worker(name: str):
    def handler(reqs):
        return {
            r.id: (200, json.dumps({"who": name}).encode(),
                   {"Content-Type": "application/json"})
            for r in reqs
        }

    srv = WorkerServer(name=name)
    info = srv.start()
    q = ServingQuery(srv, handler).start()
    return srv, q, info


def test_wireconn_single_pass_parse_roundtrip():
    from mmlspark_tpu_torch.serving.distributed import WireConn, _head_bytes

    srv, q, info = _echo_worker("wire")
    try:
        conn = WireConn("127.0.0.1", info.port, timeout=5.0)
        body = b'{"x": 1}'
        head = _head_bytes(
            "POST", "/", b"Host: t\r\n",
            b"x-custom: yes\r\n", {"x-extra": "1"}, len(body),
        )
        conn.send(head + body)
        resp = conn.read_response()
        assert resp.status == 200
        assert json.loads(resp.body) == {"who": "wire"}
        assert resp.getheader("Content-Type") == "application/json"
        assert not resp.will_close
        # keep-alive: a second request rides the same socket
        conn.send(head + body)
        assert conn.read_response().status == 200
        conn.close()
        conn.close()  # idempotent: the open-count must not go negative
        assert WireConn.open_count() >= 0
    finally:
        q.stop()
        srv.stop()


class _StaleKeepAliveBackend:
    """A worker that promises keep-alive but closes the connection after
    every response — the stale-pooled-connection scenario."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.served = 0
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            try:
                buf = b""
                while b"\r\n\r\n" not in buf:
                    d = c.recv(65536)
                    if not d:
                        raise ConnectionError
                    buf += d
                head, _, rest = buf.partition(b"\r\n\r\n")
                m = re.search(rb"content-length:\s*(\d+)", head.lower())
                n = int(m.group(1)) if m else 0
                while len(rest) < n:
                    rest += c.recv(65536)
                # counted before the reply goes out, so a client that has
                # read its reply always finds its request counted
                self.served += 1
                c.sendall(
                    b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n"
                    b"Connection: keep-alive\r\n\r\nok"
                )
            except Exception:
                pass
            finally:
                c.close()  # stale: keep-alive promised, not kept

    def stop(self):
        try:
            self.sock.close()
        except OSError:
            pass


def test_stale_keepalive_transparent_retry_no_breaker_count(monkeypatch):
    """Reusing a pooled connection the worker closed must cost ONE
    transparent retry on a fresh connection — never a breaker outcome,
    never a cross-worker re-dispatch. alive() normally catches the FIN;
    patching it True simulates the close-racing-the-send window."""
    from mmlspark_tpu_torch.serving.distributed import ServingGateway, WireConn

    be = _StaleKeepAliveBackend()
    gw = ServingGateway(
        workers=[{"host": "127.0.0.1", "port": be.port}],
        request_timeout_s=3.0,
    )
    gw.start()
    monkeypatch.setattr(WireConn, "alive", lambda self: not self._closed)
    try:
        for i in range(4):
            s, d = _send(gw._ingress.port, {"i": i})
            assert (s, d) == (200, b"ok")
        assert be.served == 4
        # transparent means invisible to failure containment: no retry
        # counted, no backend failure, no breaker movement
        assert gw.retried == 0
        assert gw.failed == 0
        for br in gw.pool._breakers.values():
            assert br.fails == 0
    finally:
        gw.stop()
        be.stop()


def test_hedge_burst_does_not_leak_sockets():
    """Hedged attempts ride the shared side pool: a burst of hedges must
    not grow the process's open wire-connection count without bound, and
    losers' sockets are closed, never pooled."""
    from mmlspark_tpu_torch.serving.distributed import ServingGateway, WireConn

    def slow_handler(reqs):
        time.sleep(0.15)
        return {r.id: (200, b'{"who": "slow"}', {}) for r in reqs}

    def fast_handler(reqs):
        return {r.id: (200, b'{"who": "fast"}', {}) for r in reqs}

    s1 = WorkerServer(name="hedge-slow")
    i1 = s1.start()
    q1 = ServingQuery(s1, slow_handler, max_batch_size=1).start()
    s2 = WorkerServer(name="hedge-fast")
    i2 = s2.start()
    q2 = ServingQuery(s2, fast_handler, max_batch_size=1).start()
    # one dispatcher: each dispatcher thread opens its keep-alive connection
    # to a backend lazily, so with several the warm burst may not have
    # reached them all and a later one opens a pooled (not leaked) socket
    gw = ServingGateway(
        workers=[i1, i2], hedge_ms=30.0, request_timeout_s=5.0,
        retry_budget_ratio=1.0, retry_budget_min=100, num_dispatchers=1,
    )
    gw.start()
    try:
        def burst(n):
            for i in range(n):
                s, _ = _send(gw._ingress.port, {"i": i})
                assert s == 200

        def settled_count():
            # a loser's socket closes when its late reply lands: count after
            # the slow backend's replies are in
            time.sleep(0.5)
            return WireConn.open_count()

        burst(8)
        assert gw.hedged > 0  # the slow primary genuinely forced hedges
        count_after_warm = settled_count()
        burst(12)
        # steady state: more hedge traffic, zero net socket growth
        assert settled_count() <= count_after_warm
        assert gw._hedge_pool.idle_count() <= 2 * 4  # cap per backend
    finally:
        gw.stop()
        for s, q in ((s1, q1), (s2, q2)):
            q.stop()
            s.stop()
        assert gw._hedge_pool.idle_count() == 0  # close_all drained it


# ---------------------------------------------------------------------------
# pipeline: columnar array fast path
# ---------------------------------------------------------------------------



# -- at most once after send (tests/test_chaos.py, tests/test_chaos_wire.py) --


@pytest.mark.parametrize("retry_after_send", [False, True],
                         ids=["at_most_once_504", "idempotent_redispatch"])
def test_gateway_post_send_hang(retry_after_send):
    """A worker hanging after the body was delivered fails the request 504
    (re-dispatching would run a non-idempotent POST twice) and is not held
    against the pool; with ``retry_after_send`` the request goes to the
    other backend instead."""
    s1, q1, i1 = _worker()
    s2, q2, i2 = _worker()
    gw = ServingGateway(workers=[i1, i2], request_timeout_s=5.0,
                        retry_after_send=retry_after_send)
    ginfo = gw.start()
    plan = FaultPlan().on("gateway.response", error=TimeoutError, at=(0,))
    try:
        with plan.armed():
            status, data = _post(ginfo.port, "/", {"i": 0})
            if retry_after_send:
                assert status == 200 and json.loads(data)["echo"]["i"] == 0
                assert gw.retried == 1 and gw.failed == 0
            else:
                assert status == 504 and b"timed out" in data
                status, data = _post(ginfo.port, "/", {"i": 1})
                assert status == 200  # the hang was not held against the pool
                assert gw.failed == 1
    finally:
        gw.stop()
        for s, q in ((s1, q1), (s2, q2)):
            q.stop()
            s.stop()


def test_gateway_truncated_response_no_double_dispatch():
    """A worker reply RST mid-frame proves the worker executed: the gateway
    answers 502 instead of re-dispatching the POST to another backend."""
    from mmlspark_tpu_torch.chaos import ChaosProxy, WireRule
    from mmlspark_tpu_torch.serving.server import ServiceInfo

    handled: list = []
    srv = WorkerServer()
    info = srv.start()

    def handler(reqs):
        handled.extend(r.id for r in reqs)
        return {r.id: (200, r.body or b"ok", {}) for r in reqs}

    q = ServingQuery(srv, handler).start()
    body = b"0123456789"
    s = socket.create_connection(("127.0.0.1", info.port), timeout=5)
    s.sendall(b"POST / HTTP/1.1\r\nContent-Length: 10\r\n\r\n" + body)
    s.settimeout(5)
    resp1 = b""
    while body not in resp1:
        resp1 += s.recv(4096)
    s.close()
    handled.clear()
    proxy_a = ChaosProxy(
        "127.0.0.1", info.port, seed=0, name="gw-a",
        rules=[WireRule("truncate_rst", direction="s2c",
                        at_offset=len(resp1) + 5)],
    ).start()
    proxy_b = ChaosProxy("127.0.0.1", info.port, seed=0, name="gw-b").start()
    gw = ServingGateway(
        workers=[
            ServiceInfo(name="serving", host="127.0.0.1", port=proxy_a.port),
            ServiceInfo(name="serving", host="127.0.0.1", port=proxy_b.port),
        ],
        num_dispatchers=1, request_timeout_s=5.0,
    )
    ginfo = gw.start()

    def raw_post():
        c = http.client.HTTPConnection("127.0.0.1", ginfo.port, timeout=10)
        try:
            c.request("POST", "/", body, {})
            r = c.getresponse()
            return r.status, r.read()
        finally:
            c.close()

    try:
        # round robin: r1 -> A (ok), r2 -> B (ok), r3 -> A (truncated)
        assert raw_post()[0] == 200
        assert raw_post()[0] == 200
        status, out = raw_post()
        assert status == 502 and b"truncated" in out
        assert len(handled) == 3              # executed once: no re-dispatch
        assert gw.failed == 1 and gw.retried == 0
    finally:
        gw.stop()
        proxy_a.stop()
        proxy_b.stop()
        q.stop()
        srv.stop()


def test_worker_role_raises_without_a_card(monkeypatch):
    """``fleet worker`` runs on the card by default: without one it raises
    before it binds or registers anything (no quiet CPU fallback)."""
    import torch

    from mmlspark_tpu_torch.serving import fleet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = fleet.run_registry(host="127.0.0.1", port=0)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.run_worker(reg.url, model="echo", host="127.0.0.1")
        assert reg.services("serving") == []
    finally:
        reg.stop()


# -- the gateway of one package in front of the workers of the other ---------


@pytest.fixture(scope="module")
def seeded_models(tmp_path_factory):
    """A ``gbdt:`` booster trained by the port from a seed, a ``vw:``
    snapshot made from a seed, and requests for both (vw rows: K <= 17)."""
    from mmlspark_tpu_torch.models.gbdt import TrainConfig, train

    d = tmp_path_factory.mktemp("xpkg")
    rng = np.random.default_rng(16)
    x = rng.standard_normal((600, 6)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64)
    booster = train(x, y, TrainConfig(objective="binary", num_iterations=6,
                                      num_leaves=7), device="cpu")
    gbdt = d / "churn.gbdt.json"
    gbdt.write_text(booster.to_model_string())
    bits = 12
    meta = json.dumps({"num_bits": bits, "loss": "logistic"}).encode()
    vw = d / "clicks.npz"
    np.savez(vw, weights=rng.standard_normal(1 << bits).astype(np.float32),
             meta=np.frombuffer(meta, np.uint8))
    reqs = []
    for i in range(24):
        if i % 2:
            reqs.append(("churn", {"features": rng.standard_normal(6).tolist()}))
        else:
            k = int(rng.integers(1, 17))
            reqs.append(("clicks", {
                "i": rng.integers(0, 1 << bits, k).tolist(),
                "v": rng.standard_normal(k).astype(np.float32).tolist()}))
    return {"specs": {"churn": f"gbdt:{gbdt}", "clicks": f"vw:{vw}"}, "reqs": reqs}


def _package(name: str):
    import importlib

    root = "mmlspark_tpu" if name == "jax" else "mmlspark_tpu_torch"
    return (importlib.import_module(f"{root}.serving.fleet"),
            importlib.import_module(f"{root}.serving.distributed"))


def _fleet_worker(pkg: str, reg_url: str, specs: dict):
    fleet, _ = _package(pkg)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    (first, spec0), *rest = specs.items()
    return fleet.run_worker(
        reg_url, model=spec0, host="127.0.0.1", heartbeat_s=0.5,
        extra_models=[f"{n}={s}" for n, s in rest], **kw,
    )


def _model_post(port: int, model: str, obj) -> tuple:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("POST", "/", body=json.dumps(obj),
                  headers={"Content-Type": "application/json",
                           "x-mmlspark-model": model})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


@pytest.mark.parametrize("front", ["jax", "torch"])
def test_cross_package_gateway_replies_bitwise(seeded_models, front):
    """The gateway of package ``front`` over two workers of the other
    package: each reply equals byte for byte the same request sent straight
    to a worker of ``front``'s own package, for both models."""
    back = "torch" if front == "jax" else "jax"
    specs, reqs = seeded_models["specs"], seeded_models["reqs"]
    ffleet, fdist = _package(front)
    reg = ffleet.run_registry(host="127.0.0.1", port=0)
    workers = [_fleet_worker(back, reg.url, specs) for _ in range(2)]
    own = _fleet_worker(front, reg.url, specs)
    own[2].set()                      # off the roster: direct requests only
    gw = fdist.ServingGateway(registry_url=reg.url, refresh_s=0.2,
                              host="127.0.0.1", port=0)
    ginfo = gw.start()
    try:
        deadline = time.monotonic() + 30.0
        while gw.pool.size() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert gw.pool.size() == 2
        own_port = own[0].port
        for model, obj in reqs:
            via = _model_post(ginfo.port, model, obj)
            direct = _model_post(own_port, model, obj)
            assert via[0] == direct[0] == 200, (via, direct)
            assert via[1] == direct[1]
        assert gw.forwarded == len(reqs) and gw.failed == 0
    finally:
        gw.stop()
        for srv, q, stop in workers + [own]:
            stop.set()
            q.stop()
            srv.stop()
        reg.stop()


def test_port_slo_engine_reads_the_jax_gateways_burn_rates():
    """The port's SLO engine on the JAX gateway's ``/metrics`` text: the
    same burn rates, bad fraction and status as the JAX engine's on the
    same scrapes (the families keep the JAX names byte for byte)."""
    from mmlspark_tpu import obs as jobs
    from mmlspark_tpu.obs import slo as jslo
    from mmlspark_tpu.serving.distributed import ServingGateway as JGateway
    from mmlspark_tpu.serving.query import ServingQuery as JQuery
    from mmlspark_tpu.serving.server import WorkerServer as JWorker
    from mmlspark_tpu_torch.obs import slo as pslo

    srv = JWorker()
    info = srv.start()
    q = JQuery(srv, _echo_handler).start()
    gw = JGateway(workers=[info], request_timeout_s=2.0, max_attempts=1,
                  service_name="xslo")
    ginfo = gw.start()

    def scrape() -> str:
        c = http.client.HTTPConnection("127.0.0.1", ginfo.port, timeout=10)
        c.request("GET", "/metrics")
        text = c.getresponse().read().decode()
        c.close()
        return text

    engines = {
        "jax": (jobs, jslo, jslo.SLOEngine(jslo.default_targets(
            "xslo", availability=0.99, p99_ms=250.0, gateway=True),
            source=lambda: {}, time_fn=lambda: 0.0)),
        "torch": (obs, pslo, pslo.SLOEngine(pslo.default_targets(
            "xslo", availability=0.99, p99_ms=250.0, gateway=True),
            source=lambda: {}, time_fn=lambda: 0.0)),
    }
    try:
        first = scrape()
        for i in range(30):
            assert _post(ginfo.port, "/", {"i": i})[0] == 200
        q.stop()
        srv.stop()
        for i in range(10):                # no live worker: 503s burn budget
            assert _post(ginfo.port, "/", {"i": i})[0] == 503
        second = scrape()
    finally:
        gw.stop()
        q.stop()
        srv.stop()
    reps = {}
    for pkg, (o, _, eng) in engines.items():
        eng.tick(parsed=o.parse_text(first), now=0.0)
        reps[pkg] = eng.tick(parsed=o.parse_text(second), now=60.0)
    assert reps["torch"] == reps["jax"]
    (rep,) = reps["torch"].values()
    assert rep["bad_fraction"] > 0 and rep["burn"]["5m"] > pslo.RED_BURN
    assert rep["status"] == "red"
