"""The port's fleet supervisor (``serving/supervisor.py``), its autoscaler
(``online/autoscaler.py``) and the fleet CLI's ``supervise`` role.

The JAX package's own cases run here against the port, on the CPU: the
supervisor cases of ``tests/test_selfheal.py`` (restart on exit, crash-loop
back-off, wedge detection, the ``supervisor.restart`` fault point, charges
from worker arguments; ``fleet top``'s degraded columns and the registries'
anti-entropy), of ``tests/test_artifacts.py`` (placement templates) and of
``tests/test_online.py`` (the autoscaling policy and its supervisor
drills). Cases that repeated each other are parametrised; the wall-clock
deadlines that sat close to a loaded machine's scheduling (the reference's
5-15 s waits for a respawn, a 0.4 s registry TTL) are generous here, and
every wait ends as soon as its condition holds.

The fleet cases spawn the port's own roles as processes
(``python -m mmlspark_tpu_torch.serving.fleet worker --device cpu``) under
a ``FleetSupervisor``, with ``OMP_NUM_THREADS=1`` and ``MKL_NUM_THREADS=1``
so their PyTorch thread pools do not starve the rest of the suite: a
SIGKILLed worker comes back with a new ``boot`` stamp and the gateway
routes to it again with no request lost, and ``rolling_restart`` under load
answers every request 200.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import socket
import sys
import threading
import time

import pytest

from mmlspark_tpu_torch.core.faults import FaultPlan
from mmlspark_tpu_torch.serving.distributed import ServingGateway
from mmlspark_tpu_torch.serving.registry import DriverRegistry


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    """Spawned fleet roles import torch: one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")


def _echo_handler(reqs):
    out = {}
    for r in reqs:
        body = json.loads(r.body) if r.body else {}
        out[r.id] = (200, json.dumps({"echo": body}).encode(), {})
    return out


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _free_port() -> int:
    s = socket.create_server(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


# -- fleet supervisor (tests/test_selfheal.py) ----------------------------------
# -- fleet supervisor ---------------------------------------------------------


def _sleeper_charge(name="sleeper", health_url=None):
    from mmlspark_tpu_torch.serving.supervisor import WorkerCharge

    return WorkerCharge(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        name=name, health_url=health_url,
    )


@pytest.mark.xdist_group("latency")
@pytest.mark.parametrize("faulted", [False, True], ids=["plain", "restart_fault"])
def test_supervisor_restarts_exited_charge(faulted):
    """A charge whose process exits is respawned (a new pid); ``stop()``
    reaps it. With the ``supervisor.restart`` fault point armed, the first
    respawn attempt is refused (chaos) and the next tick lands it."""
    from mmlspark_tpu_torch.serving.supervisor import FleetSupervisor

    c = _sleeper_charge(name="faulted" if faulted else "sleeper")
    sup = FleetSupervisor(
        [c], probe_s=0.05, backoff_s=0.05, stable_s=10.0
    ).start()
    plan = FaultPlan().on("supervisor.restart", error=RuntimeError, at=(0,))
    try:
        deadline = time.monotonic() + 30.0
        while not c.alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert c.alive()
        first_pid = c.proc.pid
        with plan.armed() if faulted else contextlib.nullcontext():
            c.proc.kill()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if c.restarts >= 1 and c.alive():
                    break
                time.sleep(0.02)
        assert c.restarts == 1 and c.alive()
        assert c.proc.pid != first_pid
        assert sup.status()["up"] == 1
        assert plan.fires() == ([("supervisor.restart", 0)] if faulted else [])
    finally:
        sup.stop()
    assert not c.alive()                     # stop() reaps the charge


@pytest.mark.xdist_group("latency")
def test_supervisor_crash_loop_backs_off_exponentially():
    from mmlspark_tpu_torch.serving.supervisor import FleetSupervisor, WorkerCharge

    # exits immediately: a crash loop
    c = WorkerCharge([sys.executable, "-c", "pass"], name="crashy")
    sup = FleetSupervisor(
        [c], probe_s=0.02, backoff_s=0.05, backoff_max_s=0.2, stable_s=30.0
    ).start()
    try:
        deadline = time.monotonic() + 30.0
        while c.restarts < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert c.restarts >= 3
        assert c.streak >= 3                 # fast deaths kept the streak
        # the streak implies the NEXT delay would be capped
        assert min(
            sup.backoff_max_s, sup.backoff_s * (2 ** (c.streak - 1))
        ) <= sup.backoff_max_s
    finally:
        sup.stop()


@pytest.mark.xdist_group("latency")
def test_supervisor_kills_and_restarts_wedged_charge():
    from mmlspark_tpu_torch.serving.supervisor import FleetSupervisor

    # alive process, but /health points at nothing: wedged
    c = _sleeper_charge(
        name="wedged", health_url=f"http://127.0.0.1:{_closed_port()}/health"
    )
    sup = FleetSupervisor(
        [c], probe_s=0.05, probe_timeout_s=0.2, wedge_after=2,
        backoff_s=0.05, stable_s=30.0, startup_grace_s=0.0,
    ).start()
    try:
        deadline = time.monotonic() + 30.0
        while c.restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert c.restarts >= 1
        assert c.last_reason == "wedged" or c.restarts >= 1
    finally:
        sup.stop()


def test_charge_from_worker_args_derives_health_url():
    from mmlspark_tpu_torch.serving.supervisor import charge_from_worker_args

    c = charge_from_worker_args(
        "--model echo --port 9101 --host 0.0.0.0", "http://r:9090/", 0
    )
    assert c.health_url == "http://127.0.0.1:9101/health"
    assert "--registry" in c.argv and "http://r:9090/" in c.argv
    assert c.argv.count("--port") == 1

    c2 = charge_from_worker_args(
        "--model echo --port 9102 --advertise-host worker-a",
        "http://r:9090/", 1,
    )
    assert c2.health_url == "http://worker-a:9102/health"

    c3 = charge_from_worker_args("--model echo", "http://r:9090/", 2)
    assert c3.health_url is None             # ephemeral port: liveness only




# -- fleet top degradation ----------------------------------------------------


def test_fleet_top_admission_and_breaker_columns_degrade():
    from mmlspark_tpu_torch.serving import fleet
    from mmlspark_tpu_torch.serving.query import ServingQuery
    from mmlspark_tpu_torch.serving.server import WorkerServer

    # a worker WITHOUT admission control and no gateway: both new
    # columns must show '-' (a fleet without them), not crash or invent
    # zeros. A unique service label: the process-global registry may
    # hold admission series for "serving" from other tests' workers
    srv = WorkerServer(name="selfheal-top")
    info = srv.start()
    q = ServingQuery(srv, _echo_handler).start()
    try:
        out = fleet.run_top(
            worker_urls=[f"http://127.0.0.1:{info.port}"],
            service_name="selfheal-top",
        )
        assert "INFL/LIM" in out and "BREAKER" in out
        row = [
            ln for ln in out.splitlines()
            if ln.startswith(f"127.0.0.1:{info.port}")
        ][0]
        cells = row.split()
        assert cells[-2] == "-" and cells[-3] == "-"
    finally:
        q.stop()
        srv.stop()


def test_registry_anti_entropy_reconciles_partitioned_rosters():
    """Peered registries re-converge after a partition. A
    worker that could only reach registry A becomes visible on B within
    one reconcile pass; merges go by NEWEST registration stamp, so a
    stale peer copy never overwrites a fresher local one; and TTL still
    governs liveness — an adopted entry expires normally."""
    import time as _t

    from mmlspark_tpu_torch.serving.registry import DriverRegistry
    from mmlspark_tpu_torch.serving.server import ServiceInfo

    reg_a = DriverRegistry(host="127.0.0.1", port=0, ttl_s=30.0)
    reg_b = DriverRegistry(
        host="127.0.0.1", port=0, ttl_s=30.0, peers=[reg_a.url],
        reconcile_s=0.15,
    )
    try:
        # partition: the worker reaches only A
        info = ServiceInfo("svc", "w1", 1234, models=("m1",))
        assert DriverRegistry.register(reg_a.url, info)
        assert reg_b.services("svc") == []
        deadline = _t.monotonic() + 10.0
        while not reg_b.services("svc") and _t.monotonic() < deadline:
            _t.sleep(0.05)
        got = reg_b.services("svc")
        assert [e["host"] for e in got] == ["w1"], "B never learned w1"
        assert got[0]["models"] == ["m1"]
        # heal + update: a NEWER registration on A (new model set)
        # propagates; ts is the merge key
        _t.sleep(0.05)
        DriverRegistry.register(
            reg_a.url, ServiceInfo("svc", "w1", 1234, models=("m1", "m2"))
        )
        deadline = _t.monotonic() + 10.0
        while _t.monotonic() < deadline:
            got = reg_b.services("svc")
            if got and got[0].get("models") == ["m1", "m2"]:
                break
            _t.sleep(0.05)
        assert got[0]["models"] == ["m1", "m2"]
        # a STALE peer copy never clobbers a fresher local one: B now
        # holds the freshest w1; pulling A again must keep it
        b_ts = reg_b.services("svc")[0]["ts"]
        assert reg_b.reconcile_now() == 0
        assert reg_b.services("svc")[0]["ts"] == b_ts
        # reverse direction via explicit peers: A pulls an entry only B
        # has (registered during the partition, B-side)
        DriverRegistry.register(
            reg_b.url, ServiceInfo("svc", "w2", 5678)
        )
        reg_a.peers = [reg_b.url]
        assert reg_a.reconcile_now() >= 1
        assert sorted(
            e["host"] for e in reg_a.services("svc")
        ) == ["w1", "w2"]
        # tombstones: a clean DELETE on A must not be resurrected by the
        # next reconcile pull from B (which still holds the entry)...
        DriverRegistry.deregister(reg_a.url, ServiceInfo("svc", "w2", 5678))
        assert sorted(e["host"] for e in reg_a.services("svc")) == ["w1"]
        reg_a.reconcile_now()
        assert sorted(e["host"] for e in reg_a.services("svc")) == ["w1"]
        # ...but a RE-registration after the delete (newer stamp) wins
        _t.sleep(0.05)
        DriverRegistry.register(reg_b.url, ServiceInfo("svc", "w2", 5678))
        assert reg_a.reconcile_now() >= 1
        assert sorted(
            e["host"] for e in reg_a.services("svc")
        ) == ["w1", "w2"]
    finally:
        reg_a.stop()
        reg_b.stop()


def test_registry_anti_entropy_adopted_entries_still_expire():
    """An entry adopted from a peer is not immortal: the local TTL
    applies from its ORIGINAL registration stamp, and an entry already
    older than the TTL is never adopted at all."""
    import time as _t

    from mmlspark_tpu_torch.serving.registry import DriverRegistry
    from mmlspark_tpu_torch.serving.server import ServiceInfo

    reg_a = DriverRegistry(host="127.0.0.1", port=0, ttl_s=2.0)
    reg_b = DriverRegistry(host="127.0.0.1", port=0, ttl_s=2.0)
    try:
        DriverRegistry.register(reg_a.url, ServiceInfo("svc", "w1", 1))
        reg_b.peers = [reg_a.url]
        assert reg_b.reconcile_now() == 1
        assert [e["host"] for e in reg_b.services("svc")] == ["w1"]
        _t.sleep(2.6)  # no heartbeats: the adopted copy expires too
        assert reg_b.services("svc") == []
        # and an expired-at-the-source entry is never adopted: A still
        # HOLDS the stale record internally, but B's floor rejects it
        assert reg_b.reconcile_now() == 0
        assert reg_b.services("svc") == []
    finally:
        reg_a.stop()
        reg_b.stop()


# -- tests/test_artifacts.py: placement

def test_spawn_from_template_shapes():
    from mmlspark_tpu_torch.serving.supervisor import spawn_from_template

    captured: dict = {}

    class FakePopen:
        def __init__(self, argv):
            captured["argv"] = argv

        def poll(self):
            return None

    import subprocess

    orig = subprocess.Popen
    subprocess.Popen = FakePopen
    try:
        # token splice: argv lands as separate arguments
        spawn_from_template("ssh worker-7 {argv}")(["python", "-m", "x"])
        assert captured["argv"] == ["ssh", "worker-7", "python", "-m", "x"]
        # embedded substitution: the shell-quoted command line
        spawn_from_template("sh -c 'exec {argv}'")(["python", "a b"])
        assert captured["argv"] == ["sh", "-c", "exec python 'a b'"]
        # no placeholder: argv appended
        spawn_from_template("nice -n 10")(["python"])
        assert captured["argv"] == ["nice", "-n", "10", "python"]
    finally:
        subprocess.Popen = orig


def test_supervisor_spawn_cmd_wraps_restarts_and_scaleout(tmp_path):
    """The pluggable placement hook: with ``spawn_cmd`` set, EVERY spawn
    (initial, crash restart, autoscale-out) goes through the template —
    the SSH/k8s-shaped seam remote placement plugs into."""
    from mmlspark_tpu_torch.serving.supervisor import FleetSupervisor, WorkerCharge

    marker = str(tmp_path / "spawn.log")
    # the template wraps the real command in a shell that first records
    # the spawn — observable proof the hook ran, locally
    sleeper = str(tmp_path / "sleep.py")
    with open(sleeper, "w") as f:
        f.write("import time\ntime.sleep(60)\n")
    import sys as _sys

    tpl = f"sh -c 'echo spawned >> {marker}; exec {{argv}}'"
    c = WorkerCharge([_sys.executable, sleeper], name="w0")
    sup = FleetSupervisor(
        [c], probe_s=0.1, backoff_s=0.1, stable_s=60.0, spawn_cmd=tpl,
    ).start()
    try:
        deadline = time.monotonic() + 60.0
        def spawn_count() -> int:
            try:
                with open(marker) as f:
                    return f.read().count("spawned")
            except OSError:
                return 0

        while time.monotonic() < deadline and spawn_count() < 1:
            time.sleep(0.05)
        assert c.alive() and spawn_count() == 1
        c.proc.kill()
        deadline = time.monotonic() + 60.0
        # the respawned shell writes its marker before the supervisor's
        # thread counts the restart: wait for both
        while time.monotonic() < deadline and (spawn_count() < 2 or c.restarts < 1):
            time.sleep(0.05)
        assert c.restarts >= 1
        assert spawn_count() == 2  # the restart rode the template too
    finally:
        sup.stop()


# -- tests/test_online.py: the autoscaler


def _scaler(**kw):
    from mmlspark_tpu_torch.online import Autoscaler

    clock = {"t": 0.0}
    defaults = dict(
        min_replicas=1, max_replicas=3, scale_out_cooldown_s=10.0,
        scale_in_cooldown_s=20.0, idle_after_s=30.0,
        time_fn=lambda: clock["t"],
    )
    defaults.update(kw)
    return Autoscaler(**defaults), clock


def test_autoscaler_scale_out_hysteresis_and_cap():
    from mmlspark_tpu_torch.online import ScaleSignals

    asc, clock = _scaler()
    overload = ScaleSignals(shed_delta=3.0)
    n, why = asc.decide(1, overload)
    assert n == 2 and "shed" in why
    # inside the cooldown: overload persists, but no flap
    clock["t"] = 5.0
    assert asc.decide(2, overload)[0] == 2
    clock["t"] = 15.0
    assert asc.decide(2, overload)[0] == 3
    # at the cap: overload can't push past max_replicas
    clock["t"] = 30.0
    assert asc.decide(3, overload)[0] == 3


def test_autoscaler_scale_in_requires_sustained_idle():
    from mmlspark_tpu_torch.online import ScaleSignals

    asc, clock = _scaler(scale_in_cooldown_s=0.0)
    idle = ScaleSignals()
    # idle but not SUSTAINED: the window hasn't elapsed
    clock["t"] = 10.0
    assert asc.decide(3, idle)[0] == 3
    clock["t"] = 31.0
    n, why = asc.decide(3, idle)
    assert n == 2 and why == "sustained idle"
    # one reap per idle window — the clock reset on the scale event
    clock["t"] = 40.0
    assert asc.decide(2, idle)[0] == 2
    clock["t"] = 62.0
    assert asc.decide(2, idle)[0] == 1
    # floor: never below min_replicas
    clock["t"] = 120.0
    assert asc.decide(1, idle)[0] == 1


def test_autoscaler_activity_and_utilization_signals():
    from mmlspark_tpu_torch.obs import slo
    from mmlspark_tpu_torch.online import ScaleSignals

    asc, clock = _scaler()
    # busy traffic resets the idle clock even without overload
    clock["t"] = 31.0
    assert asc.decide(2, ScaleSignals(accepted_delta=50.0))[0] == 2
    clock["t"] = 45.0  # only 14 s idle since the busy tick
    assert asc.decide(2, ScaleSignals())[0] == 2
    # utilization >= threshold scales out; red SLO burn does too
    n, why = asc.decide(2, ScaleSignals(inflight=17, limit=20))
    assert n == 3 and "utilization" in why
    asc2, clock2 = _scaler()
    n, why = asc2.decide(1, ScaleSignals(slo_status=slo.RED))
    assert n == 2 and why == "slo red"
    # yellow alone does not (burn < page-now keeps the fleet steady)
    asc3, _ = _scaler()
    assert asc3.decide(1, ScaleSignals(slo_status=slo.YELLOW))[0] == 1


@pytest.mark.xdist_group("latency")
def test_supervisor_autoscale_spawns_and_reaps_only_its_own():
    import sys as _sys

    from mmlspark_tpu_torch.online import Autoscaler, ScaleSignals
    from mmlspark_tpu_torch.serving.supervisor import FleetSupervisor, WorkerCharge

    clock = {"t": 0.0}
    signals = {"cur": ScaleSignals(shed_delta=1.0)}
    asc = Autoscaler(
        min_replicas=1, max_replicas=2, scale_out_cooldown_s=0.0,
        scale_in_cooldown_s=0.0, idle_after_s=0.5,
        time_fn=lambda: clock["t"],
    )
    operator_charge = WorkerCharge(
        [_sys.executable, "-c", "import time; time.sleep(60)"], name="op-0"
    )
    sup = FleetSupervisor(
        [operator_charge], probe_s=0.05, autoscaler=asc,
        worker_template="--model echo",
        signals_fn=lambda: signals["cur"],
        spawn=lambda argv: __import__("subprocess").Popen(
            [_sys.executable, "-c", "import time; time.sleep(60)"]
        ),
    ).start()
    try:
        deadline = time.monotonic() + 30.0
        while len(sup.charges) < 2 and time.monotonic() < deadline:
            clock["t"] += 1.0
            time.sleep(0.05)
        assert len(sup.charges) == 2, "overload never spawned a replica"
        assert sup.charges[1].name.startswith("autoscaled-")
        # sustained idle reaps the autoscaled replica, not the operator's
        signals["cur"] = ScaleSignals()
        deadline = time.monotonic() + 30.0
        while len(sup.charges) > 1 and time.monotonic() < deadline:
            clock["t"] += 1.0
            time.sleep(0.05)
        assert [c.name for c in sup.charges] == ["op-0"]
        # at the floor, idle forever never reaps the operator charge
        clock["t"] += 100.0
        time.sleep(0.2)
        assert len(sup.charges) == 1
    finally:
        sup.stop()


@pytest.mark.xdist_group("latency")
def test_supervisor_autoscale_fault_point_suppresses_event():
    import sys as _sys

    from mmlspark_tpu_torch.online import Autoscaler, ScaleSignals
    from mmlspark_tpu_torch.serving.supervisor import FleetSupervisor, WorkerCharge

    asc = Autoscaler(
        min_replicas=1, max_replicas=2, scale_out_cooldown_s=0.0,
    )
    c = WorkerCharge(
        [_sys.executable, "-c", "import time; time.sleep(60)"], name="op-0"
    )
    sup = FleetSupervisor(
        [c], probe_s=0.05, autoscaler=asc, worker_template="--model echo",
        signals_fn=lambda: ScaleSignals(shed_delta=1.0),
        spawn=lambda argv: __import__("subprocess").Popen(
            [_sys.executable, "-c", "import time; time.sleep(60)"]
        ),
    )
    plan = FaultPlan().on("autoscaler.scale", error=RuntimeError, at=(0,))
    with plan.armed():
        sup.start()
        deadline = time.monotonic() + 30.0
        while len(sup.charges) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
    try:
        # the first scale-out was refused (chaos), a later tick landed it
        assert len(sup.charges) == 2
        assert ("autoscaler.scale", 0) in plan.fires()
    finally:
        sup.stop()


# -- the port's fleet under the supervisor --------------------------------------


def test_charges_spawn_the_port_fleet_and_pass_device_through():
    """A charge's argv re-enters the PORT's fleet CLI (a copied JAX string
    would start JAX workers), with the caller's ``--device`` as given."""
    from mmlspark_tpu_torch.serving.supervisor import (
        charge_from_train_args,
        charge_from_worker_args,
    )

    w = charge_from_worker_args("--model echo --device cpu --port 9101",
                                "http://r:9090/", 0)
    t = charge_from_train_args("--name host-a --data synth:64x4:1 --ckpt-dir /c "
                               "--device cpu", "http://r:9090/", 0)
    for c, role in ((w, "worker"), (t, "train")):
        assert c.argv[:4] == [sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet", role]
        assert "mmlspark_tpu.serving.fleet" not in c.argv
        assert c.argv[c.argv.index("--device") + 1] == "cpu"
    assert t.gang_member == "host-a" and w.health_url == "http://127.0.0.1:9101/health"


@pytest.fixture(scope="module")
def supervised_fleet():
    """``fleet supervise``'s function over two port workers (echo, CPU, fixed
    ports so ``/health`` is probed), a registry and a gateway in front."""
    import pytest as _pytest

    from mmlspark_tpu_torch.serving import fleet

    mp = _pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    mp.setenv("MKL_NUM_THREADS", "1")
    reg = DriverRegistry(host="127.0.0.1", port=0, ttl_s=10.0)
    ports = [_free_port(), _free_port()]
    sup = fleet.run_supervise(
        reg.url,
        [f"--model echo --device cpu --host 127.0.0.1 --port {p} "
         f"--heartbeat-s 0.3 --drain-s 8 --slo-p99-ms 0 "
         f"--admission-min-target-ms 50" for p in ports],
        probe_s=0.3, backoff_s=0.2, wedge_after=20,
    )
    gw = ServingGateway(registry_url=reg.url, refresh_s=0.3, request_timeout_s=10.0,
                        host="127.0.0.1", port=0)
    ginfo = gw.start()
    try:
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if len(reg.services("serving")) >= 2 and gw.pool.size() >= 2:
                break
            time.sleep(0.25)
        assert gw.pool.size() >= 2, "workers never became routable"
        yield {"reg": reg, "sup": sup, "gw": gw, "port": ginfo.port, "ports": ports}
    finally:
        gw.stop()
        sup.stop()
        reg.stop()
        mp.undo()


class _Load:
    """Four keep-alive-less clients posting through the gateway until
    stopped; every reply is checked against its request."""

    def __init__(self, port: int, clients: int = 4):
        self.port, self.ok, self.failures = port, 0, []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(i,), daemon=True)
                         for i in range(clients)]
        for t in self._threads:
            t.start()

    def _run(self, k: int) -> None:
        i = 0
        while not self._stop.is_set():
            i += 1
            try:
                c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
                c.request("POST", "/", body=json.dumps({"k": k, "i": i}),
                          headers={"Content-Type": "application/json"})
                r = c.getresponse()
                body = r.read()
                c.close()
                good = r.status == 200 and json.loads(body)["echo"] == {"k": k, "i": i}
                with self._lock:
                    if good:
                        self.ok += 1
                    else:
                        self.failures.append((r.status, body[:80]))
            except OSError as e:
                with self._lock:
                    self.failures.append(("conn", str(e)))
            time.sleep(0.005)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(30)


def _boot_of(reg, port: int):
    return {e["port"]: e.get("boot") for e in reg.services("serving")}.get(port)


def _accepted(port: int) -> float:
    from mmlspark_tpu_torch.serving.fleet import scrape_metrics
    from mmlspark_tpu_torch import obs

    parsed = scrape_metrics(f"http://127.0.0.1:{port}")
    return 0.0 if parsed is None else obs.sum_samples(
        parsed, "mmlspark_serving_requests_total")


@pytest.mark.xdist_group("latency")
def test_supervised_worker_sigkilled_under_load_comes_back_routable(supervised_fleet):
    """SIGKILL one supervised worker mid-load: no accepted request is lost
    (the gateway re-dispatches), the supervisor respawns it with a new
    ``boot`` stamp, and the gateway routes to the new process."""
    f = supervised_fleet
    reg, sup = f["reg"], f["sup"]
    victim = sup.charges[0]
    vport = f["ports"][0]
    old_boot = _boot_of(reg, vport)
    assert old_boot is not None
    load = _Load(f["port"])
    try:
        time.sleep(1.0)
        restarts = victim.restarts
        victim.proc.kill()
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            boot = _boot_of(reg, vport)
            if victim.restarts > restarts and boot not in (None, old_boot):
                break
            time.sleep(0.1)
        assert victim.restarts == restarts + 1
        assert _boot_of(reg, vport) not in (None, old_boot)
        deadline = time.monotonic() + 60.0
        while _accepted(vport) == 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _accepted(vport) > 0, "the gateway never routed to the new process"
    finally:
        load.stop()
    assert load.ok > 50
    assert load.failures == [], load.failures[:5]


@pytest.mark.xdist_group("latency")
def test_supervised_rolling_restart_under_load_zero_errors(supervised_fleet):
    """``rolling_restart`` under load: each worker drains, is respawned and
    is routable again before the next one rolls; every reply is a 200."""
    f = supervised_fleet
    sup = f["sup"]
    before = sum(c.restarts for c in sup.charges)
    load = _Load(f["port"])
    try:
        time.sleep(1.0)
        assert sup.rolling_restart(wait_up_s=120.0) is True
        time.sleep(1.0)
    finally:
        load.stop()
    assert load.ok > 50
    assert load.failures == [], load.failures[:5]
    assert sum(c.restarts for c in sup.charges) == before + 2
