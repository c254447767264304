"""The port's chaos conductor and invariant checker
(``mmlspark_tpu_torch/chaos/{conductor,invariants}.py`` and ``fleet chaos``)
against the JAX package's, on the CPU.

Both are host code and must agree exactly:

- the port's ``InvariantChecker`` gives the JAX checker's verdicts, the
  violations' text included, on the same ``/metrics`` texts (each package
  parsing them with its own ``obs.parse_text``) and the same status files,
  for every law a scrape can decide, green and red, during a soak and
  final, across checker passes where a worker's counter restarts;
- a scenario loads to the same steps and is refused with the same errors;
  its run journals the same entries (wall times, trace ids and pids
  aside), and the proxies' schedule digests are equal for the same seed;
- ``fleet chaos`` (a process) on a small CPU fleet — a registry, a
  ``fleet worker --device cpu`` behind a proxied link and ``fleet online
  --device cpu`` — keeps every law green, ``online_conservation`` and
  ``experiment_conservation`` included, through latency with jitter and a
  SIGSTOP/SIGCONT of the worker, and prints the same schedule digest
  when run again with the same seed and traffic.

Processes spawned here get one intra-op thread each.
"""

from __future__ import annotations

import copy
import dataclasses
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu import obs as jobs
from mmlspark_tpu.chaos.conductor import ChaosConductor as JConductor
from mmlspark_tpu.chaos.conductor import Scenario as JScenario
from mmlspark_tpu.chaos.invariants import InvariantChecker as JChecker
from mmlspark_tpu.chaos.wire import ChaosProxy as JProxy

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.chaos import ChaosConductor, ChaosProxy, InvariantChecker, Scenario

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _children_env(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    pp = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", ROOT + (os.pathsep + pp if pp else ""))


# -- the invariant checker ----------------------------------------------------------


GW, W1, W2, ON = ("http://gw", "http://w1", "http://w2", "http://online")


def _fleet(over: dict) -> dict:
    """A green fleet's samples {url: {name or (name, labels): value}}, with
    ``over``'s {(url, key): value} set (None: the url does not answer)."""
    m = {
        GW: {("mmlspark_serving_requests_total", 'server="serving-gateway"'): 10,
             "mmlspark_gateway_requests_total": 8, "mmlspark_gateway_failures_total": 2,
             ("mmlspark_serving_inflight_requests", 'server="serving-gateway"'): 0,
             ("mmlspark_gateway_breaker_state", 'backend="w1"'): 0,
             ("mmlspark_gateway_breaker_state", 'backend="w2"'): 2,
             "mmlspark_gateway_retry_budget_remaining_ratio": 0.5},
        **{w: {("mmlspark_serving_requests_total", 'server="serving"'): 5,
               ("mmlspark_serving_inflight_requests", 'server="serving"'): 0,
               ("mmlspark_modelstore_version_refs_count", 'model="m",version="1"'): 0,
               ("mmlspark_admission_inflight_requests", 'server="serving"'): 0,
               "mmlspark_artifact_verify_failures_total": 1,
               "mmlspark_artifact_quarantines_total": 1} for w in (W1, W2)},
        ON: {"mmlspark_online_ingested_total": 100, "mmlspark_online_spill_replayed_total": 4,
             "mmlspark_online_examples_total": 90, "mmlspark_online_buffered_examples_count": 6,
             "mmlspark_online_shed_examples_total": 5,
             "mmlspark_online_poisoned_examples_total": 3},
    }
    for (url, key), v in over.items():
        if v is None:
            m[url] = None
        else:
            m[url][key] = v
    return m


def _text(samples: "dict | None") -> "str | None":
    if samples is None:
        return None
    lines = []
    for key, v in samples.items():
        name, labels = key if isinstance(key, tuple) else (key, "")
        lines.append(f"{name}{{{labels}}} {v}" if labels else f"{name} {v}")
    return "# a scrape\n" + "\n".join(lines) + "\n"


GATE_IN = ("mmlspark_serving_requests_total", 'server="serving-gateway"')
W_IN = ("mmlspark_serving_requests_total", 'server="serving"')

# name -> (per-pass overrides, final)
CASES = {
    "green_final": ([{}], True),
    "green_mid_soak": ([{(GW, GATE_IN): 13}], False),
    "gateway_conservation_final": ([{(GW, GATE_IN): 11}], True),
    "gateway_answered_more_than_accepted": ([{(GW, GATE_IN): 9}], False),
    "gateway_inflight": ([{(GW, ("mmlspark_serving_inflight_requests",
                                 'server="serving-gateway"')): 2}], True),
    "fleet_conservation": ([{(W1, W_IN): 3, (W2, W_IN): 4}], True),
    "fleet_law_off_after_a_counter_restart": ([{}, {(W1, W_IN): 1}], True),
    "fleet_law_skipped_with_a_worker_down": ([{(W1, W_IN): 3, (W2, "x"): None}], True),
    "worker_inflight_refs_admission": ([{
        (W1, ("mmlspark_serving_inflight_requests", 'server="serving"')): 1,
        (W2, ("mmlspark_modelstore_version_refs_count", 'model="m",version="1"')): 2,
        (W2, ("mmlspark_admission_inflight_requests", 'server="serving"')): 1}], True),
    "inflight_allowed_mid_soak": ([{
        (W1, ("mmlspark_serving_inflight_requests", 'server="serving"')): 1}], False),
    "online_conservation_final": ([{(ON, "mmlspark_online_examples_total"): 89}], True),
    "online_accounted_above_ingested": ([{(ON, "mmlspark_online_buffered_examples_count"): 9}],
                                        False),
    "online_unreachable": ([{(ON, "x"): None}], True),
    "gateway_unreachable": ([{(GW, "x"): None}], True),
    "breaker_and_retry_budget": ([{
        (GW, ("mmlspark_gateway_breaker_state", 'backend="w1"')): 3,
        (GW, "mmlspark_gateway_retry_budget_remaining_ratio"): 1.5}], False),
    "artifact_quarantine": ([{(W2, "mmlspark_artifact_verify_failures_total"): 3}], True),
    "artifact_gap_mid_soak": ([{(W2, "mmlspark_artifact_verify_failures_total"): 2}], False),
}


def _status_files(tmp_path, bad: bool) -> tuple:
    """Trainer and controller status files; ``bad`` adds a double
    generation claim, a lost trial and a rival promotion."""
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"name": "a", "committed_gens": [1, 2]}))
    b.write_text(json.dumps({"name": "b", "committed_gens": [3] + ([2] if bad else [])}))
    e1, e2 = tmp_path / "e1.json", tmp_path / "e2.json"
    e1.write_text(json.dumps({"experiment": "e", "trials_spawned": 4, "completed": 1,
                              "demoted": 2, "rescheduled": 0, "running": 0 if bad else 1,
                              "rungs": {"0": ["t001", "t000"]}}))
    e2.write_text(json.dumps({"experiment": "e", "trials_spawned": 2, "completed": 0,
                              "demoted": 0, "rescheduled": 1, "running": 1,
                              "rungs": {"0": ["t000", "t002" if bad else "t001"]}}))
    (tmp_path / "torn.json").write_text("{")
    return ([str(a), str(b), str(tmp_path / "missing.json")],
            [str(e1), str(e2), str(tmp_path / "torn.json")])


def _verdicts(pkg: str, passes: list, final: bool, status: tuple) -> list:
    parse = (jobs if pkg == "jax" else obs).parse_text
    texts = {"i": 0}

    def scrape(url):
        t = _text(passes[texts["i"]][url])
        return None if t is None else parse(t)

    cls = JChecker if pkg == "jax" else InvariantChecker
    checker = cls(gateway_url=GW, worker_urls=[W1, W2], online_url=ON, scrape=scrape,
                  status_files=status[0], experiment_status_files=status[1])
    out = []
    for i in range(len(passes)):
        texts["i"] = i
        out.append([str(v) for v in checker.check(final=final)])
    return out


@pytest.mark.parametrize("bad_status", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_invariant_verdicts_match_jax(case, bad_status, tmp_path):
    overrides, final = CASES[case]
    passes = [_fleet(o) for o in overrides]
    status = _status_files(tmp_path, bad_status)
    want = _verdicts("jax", copy.deepcopy(passes), final, status)
    got = _verdicts("torch", passes, final, status)
    assert got == want
    names = {v.split("@")[0] for v in got[-1]}
    if bad_status:
        assert {"single_writer", "experiment_conservation", "single_promotion"} <= names
    if case.startswith("green") or case.startswith("fleet_law") or case.endswith("mid_soak"):
        assert names - {"single_writer", "experiment_conservation", "single_promotion"} == set()
    else:
        assert names - {"single_writer", "experiment_conservation", "single_promotion"}


def test_quarantined_store_caught_as_the_jax_checker_does():
    class LeakyStore:
        root = "leaky"
        _quarantined = {"ab" * 32}

        def refs(self):
            return [f"a.bin@{'ab' * 32}"]

        def handle_http(self, path, headers):
            return 200, b"poison", {}

    got = InvariantChecker(scrape=lambda u: None, stores=[LeakyStore()]).check(final=True)
    want = JChecker(scrape=lambda u: None, stores=[LeakyStore()]).check(final=True)
    assert [str(v) for v in got] == [str(v) for v in want]
    assert len(got) == 2
    assert InvariantChecker().report(got) == JChecker().report(want)


# -- scenarios and the conductor ------------------------------------------------------


SPEC = {"seed": 7, "steps": [
    {"at_s": 0.0, "action": "rules", "link": "lnk",
     "rules": [{"kind": "latency", "delay_ms": 1, "jitter_ms": 2, "direction": "c2s"}]},
    {"at_s": 0.9, "action": "mark", "note": "traffic done"},
    {"at_s": 0.95, "action": "signal", "target": "victim", "signal": "SIGSTOP"},
    {"at_s": 1.05, "action": "signal", "target": "victim", "signal": "SIGCONT"},
    {"at_s": 1.1, "action": "partition", "link": "lnk"},
    {"at_s": 1.15, "action": "heal", "links": ["lnk"]},
    {"at_s": 1.2, "action": "clear", "link": "lnk"},
    {"at_s": 1.25, "action": "sleep"},
    {"at_s": 1.3, "action": "check", "final": True},
]}


def _steps(sc) -> list:
    return [{k: ([dataclasses.asdict(r) for r in v] if k == "rules" else v)
             for k, v in s.items()} for s in sc.steps]


def test_scenario_loads_as_the_jax_one():
    shuffled = dict(SPEC, steps=list(reversed(SPEC["steps"])))
    assert _steps(Scenario.from_spec(shuffled)) == _steps(JScenario.from_spec(shuffled))
    assert Scenario.from_spec(json.dumps(SPEC)).seed == 7
    for bad in ({"steps": [{"action": "nap"}]},
                {"steps": [{"action": "signal", "target": "v", "signal": "SIGFOO"}]},
                {"steps": [{"action": "rules", "link": "l", "rules": [{"kind": "fliip"}]}]},
                {"steps": [{"action": "partition"}]}):
        with pytest.raises(ValueError) as jerr:
            JScenario.from_spec(bad)
        with pytest.raises(ValueError) as perr:
            Scenario.from_spec(bad)
        assert str(perr.value) == str(jerr.value)


def _echo_server():
    srv = socket.create_server(("127.0.0.1", 0))
    stop = threading.Event()

    def serve():
        srv.settimeout(0.2)
        while not stop.is_set():
            try:
                c, _ = srv.accept()
            except OSError:
                continue
            with c:
                buf = b""
                while len(buf) < 50_000:
                    b = c.recv(65536)
                    if not b:
                        break
                    buf += b
                c.sendall(buf)

    threading.Thread(target=serve, daemon=True).start()
    return srv.getsockname()[1], lambda: (stop.set(), srv.close())


def _conduct(pkg: str, echo_port: int) -> tuple:
    """One run of SPEC against an echo server through one proxy, with
    the same traffic (five 50,000-byte round trips) while the rules hold."""
    proxy = (JProxy if pkg == "jax" else ChaosProxy)("127.0.0.1", echo_port, seed=SPEC["seed"],
                                                     name="lnk").start()
    victim = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])

    class Green:
        def check(self, final=False):
            return []

    conductor = (JConductor if pkg == "jax" else ChaosConductor)(
        (JScenario if pkg == "jax" else Scenario).from_spec(SPEC), proxies={"lnk": proxy},
        pids={"victim": victim.pid}, checker=Green())

    def traffic():
        time.sleep(0.2)
        for k in range(5):
            c = socket.create_connection(("127.0.0.1", proxy.port))
            c.sendall(bytes([k]) * 50_000)
            got = b""
            while len(got) < 50_000:
                b = c.recv(65536)
                if not b:
                    break
                got += b
            c.close()

    t = threading.Thread(target=traffic)
    try:
        t.start()
        journal = conductor.run()
        t.join(10)
        return journal, proxy.schedule_digest(), conductor.violations
    finally:
        proxy.stop()
        victim.kill()
        victim.wait(5)


def test_conductor_journal_and_schedule_digest_match_jax():
    port, close = _echo_server()
    try:
        runs = {pkg: _conduct(pkg, port) for pkg in ("jax", "torch", "torch2")}
    finally:
        close()
    volatile = ("t_wall", "t_rel_s", "trace_id", "pid")
    strip = lambda j: [{k: v for k, v in e.items() if k not in volatile} for e in j]  # noqa: E731
    assert strip(runs["torch"][0]) == strip(runs["jax"][0])
    assert [e["action"] for e in runs["torch"][0]] == [s["action"] for s in SPEC["steps"]]
    assert runs["torch"][0][-1]["violations"] == 0 and runs["torch"][2] == []
    assert runs["torch"][1] == runs["jax"][1] == runs["torch2"][1]


# -- fleet chaos --------------------------------------------------------------------


def _free_port() -> int:
    s = socket.create_server(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _wait(cond, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


def _role(args: list, log) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet", *args],
                            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)


def _post(port: int, path: str, body: dict, timeout: float = 60.0) -> int:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path, body=json.dumps(body),
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        r.read()
        return r.status
    finally:
        c.close()


PROXIED = 30   # requests through the proxied link a run


def _chaos_run(reg_url: str, proxy_port: int, worker_port: int, worker_pid: int,
               online_port: int, exp_status: str, seed: int, tmp_path, tag: str) -> tuple:
    """``fleet chaos`` with latency + jitter on the worker link and a
    SIGSTOP/SIGCONT of the worker, under scoring and ingest traffic;
    returns (rc, printed JSON, statuses, seconds the proxied requests took)."""
    scenario = {"seed": seed, "steps": [
        {"at_s": 0.0, "action": "rules", "link": "w",
         "rules": [{"kind": "latency", "delay_ms": 2, "jitter_ms": 3, "direction": "c2s"}]},
        {"at_s": 1.0, "action": "signal", "target": "worker", "signal": "SIGSTOP"},
        {"at_s": 2.0, "action": "signal", "target": "worker", "signal": "SIGCONT"},
        {"at_s": 5.5, "action": "check"},
        {"at_s": 6.0, "action": "clear", "link": "w"},
        {"at_s": 7.5, "action": "check", "final": True},
    ]}
    out = open(tmp_path / f"chaos-{tag}.out", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet", "chaos",
         "--scenario", json.dumps(scenario),
         "--proxy", f"w={proxy_port}:127.0.0.1:{worker_port}",
         "--pid", f"worker={worker_pid}", "--registry", reg_url,
         "--online", f"http://127.0.0.1:{online_port}",
         "--experiment-status-file", exp_status],
        cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    rng = np.random.default_rng(seed)
    rows = [{"i": rng.integers(0, 1024, size=3).tolist(), "v": [1.0, -0.5, 0.25],
             "label": int(k % 2)} for k in range(64)]

    def up():
        try:
            socket.create_connection(("127.0.0.1", proxy_port), timeout=1).close()
            return True
        except OSError:
            return False

    _wait(up, 60.0, "the chaos proxy did not come up")
    time.sleep(0.5)
    statuses = []
    t0 = time.monotonic()
    for k in range(PROXIED):   # the same bytes through the proxied link every run
        statuses.append(_post(proxy_port, "/", {"k": k}))
        if k % 5 == 0:
            statuses.append(_post(online_port, "/ingest", {"rows": rows}))
    sent_s = time.monotonic() - t0
    proc.wait(60)
    out.close()
    text = open(tmp_path / f"chaos-{tag}.out").read()
    return proc.returncode, json.loads(text[text.index("{"):]), statuses, sent_s


def test_fleet_chaos_on_a_cpu_fleet_is_green_and_replays(tmp_path):
    from mmlspark_tpu_torch.serving import fleet

    reg = fleet.run_registry(host="127.0.0.1", port=0, ttl_s=10.0)
    wport, oport = _free_port(), _free_port()
    logs = open(tmp_path / "roles.log", "w")
    worker = _role(["worker", "--registry", reg.url, "--model", "echo", "--device", "cpu",
                    "--host", "127.0.0.1", "--port", str(wport), "--heartbeat-s", "0.5"], logs)
    online = _role(["online", "--registry", reg.url, "--device", "cpu", "--host", "127.0.0.1",
                    "--port", str(oport), "--snapshot-dir", str(tmp_path / "snaps"),
                    "--publish-every-s", "0.5", "--num-bits", "10", "--heartbeat-s", "0.5"],
                   logs)
    exp_status = tmp_path / "tune.json"
    exp_status.write_text(json.dumps({"experiment": "e", "trials_spawned": 4, "completed": 1,
                                      "demoted": 3, "rescheduled": 0, "running": 0,
                                      "rungs": {"0": ["t003", "t001"], "1": ["t003"]}}))
    try:
        _wait(lambda: reg.services("serving") and reg.services("serving-online"), 120.0,
              "the worker and the online loop did not register")
        proxy_port = _free_port()   # both runs listen here: the Host header is the same
        runs = [_chaos_run(reg.url, proxy_port, wport, worker.pid, oport, str(exp_status), 5,
                           tmp_path, tag) for tag in ("a", "b")]
        for rc, out, statuses, _ in runs:
            assert rc == 0 and out["violations"] == [], out
            assert statuses == [200] * len(statuses)
            acts = [e["action"] for e in out["journal"]]
            assert acts == ["rules", "signal", "signal", "check", "clear", "check"]
            assert [e.get("violations") for e in out["journal"] if e["action"] == "check"] \
                == [0, 0]
        # every proxied request went out while the rules held (cleared at 6 s)
        assert max(r[3] for r in runs) < 5.0
        assert runs[0][1]["schedules"] == runs[1][1]["schedules"]
        assert len(runs[0][1]["schedules"]["w"]) == 64
        # the laws really looked at the online loop and the experiment
        parsed = fleet.scrape_metrics(f"http://127.0.0.1:{oport}")
        assert obs.sum_samples(parsed, "mmlspark_online_ingested_total") > 0
        bad = json.loads(exp_status.read_text())
        bad["running"] = 1
        exp_status.write_text(json.dumps(bad))
        checker = InvariantChecker(registry_url=reg.url,
                                   online_url=f"http://127.0.0.1:{oport}",
                                   experiment_status_files=[str(exp_status)])
        assert [v.name for v in checker.check(final=True)] == ["experiment_conservation"]
    finally:
        for p in (online, worker):
            p.terminate()
        for p in (online, worker):
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        logs.close()
        reg.stop()
