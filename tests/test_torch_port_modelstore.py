"""The port's single-worker serving contracts on the CPU.

The port's counterparts of the JAX package's single-worker contract tests
(``tests/test_serving.py``'s WorkerServer + ServingQuery cases and
``tests/test_modelstore.py``'s store, dispatcher and bucket cases), run
against ``mmlspark_tpu_torch.serving`` over real HTTP on ephemeral ports,
then the port's own contracts: the budget counts what a version measures
after its warm-up, only input the handler cannot read is a 400 (an error
of the model call is the batch's 500, and counted), a failed warm-up leaves
the version ``failed``, and release drops the tensors a version placed.
The cases that need a card (a compiled pipeline hot-swapped while serving,
card memory freed at unload) are in ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core.faults import FaultPlan
from mmlspark_tpu_torch.serving import (
    ServingQuery,
    WorkerServer,
    make_reply,
    request_to_json,
    serve_transformer,
)
from mmlspark_tpu_torch.serving.modelstore import (
    EVICTED,
    FAILED,
    HBMBudgetExceeded,
    LOADING,
    LoadedModel,
    ModelDispatcher,
    ModelStore,
    ModelStoreError,
    READY,
    STATE_HEADER,
    build_loaded_model,
    model_name_from_spec,
    tensor_nbytes,
)


# -- WorkerServer + ServingQuery (tests/test_serving.py) ----------------------


def _post_raw(port: int, path: str, obj, conn=None):
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    body = json.dumps(obj)
    c.request("POST", path, body=body, headers={"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    if conn is None:
        c.close()
    return r.status, data


def _echo_handler(reqs):
    out = {}
    for r in reqs:
        obj = request_to_json(r)
        code, body, headers = make_reply({"echo": obj})
        out[r.id] = (code, body, headers)
    return out


def test_worker_server_roundtrip():
    srv = WorkerServer()
    info = srv.start()
    q = ServingQuery(srv, _echo_handler).start()
    try:
        status, data = _post_raw(info.port, "/", {"a": 1})
        assert status == 200
        assert json.loads(data) == {"echo": {"a": 1}}
        assert srv.requests_seen == 1
    finally:
        q.stop()
        srv.stop()


def test_keep_alive_and_batching():
    srv = WorkerServer()
    info = srv.start()
    q = ServingQuery(srv, _echo_handler, max_batch_size=8).start()
    conn = http.client.HTTPConnection("127.0.0.1", info.port, timeout=10)
    try:
        for i in range(20):
            status, data = _post_raw(info.port, "/", i, conn=conn)
            assert status == 200
            assert json.loads(data) == {"echo": i}
    finally:
        conn.close()
        q.stop()
        srv.stop()


def test_handler_error_becomes_500():
    srv = WorkerServer()
    info = srv.start()

    def bad_handler(reqs):
        raise RuntimeError("boom")

    q = ServingQuery(srv, bad_handler).start()
    status, data = _post_raw(info.port, "/", {"x": 1})
    assert status == 500 and b"boom" in data
    assert q.errors == 1
    q.stop()
    srv.stop()


def test_404_off_path():
    srv = WorkerServer(api_path="/api")
    info = srv.start()
    q = ServingQuery(srv, _echo_handler).start()
    status, _ = _post_raw(info.port, "/other", {})
    assert status == 404
    status, _ = _post_raw(info.port, "/apifoo", {})  # shared prefix != on path
    assert status == 404
    status, _ = _post_raw(info.port, "/api", {"ok": 1})
    assert status == 200
    status, _ = _post_raw(info.port, "/api/sub?x=1", {"ok": 1})
    assert status == 200
    q.stop()
    srv.stop()


def test_bad_request_does_not_poison_batch():
    """One malformed concurrent request must 400 alone; well-formed
    requests in the same batch still succeed."""
    w = np.eye(3, dtype=np.float32)
    q = serve_transformer(lambda x: x @ w, "f", "s", max_wait_ms=20.0, input_shape=(3,))
    results = {}

    def client(key, payload):
        results[key] = _post_raw(q.server.port, "/", payload)

    threads = [
        threading.Thread(target=client, args=("good", [1.0, 2.0, 3.0])),
        threading.Thread(target=client, args=("short", [1.0])),
        threading.Thread(target=client, args=("text", "zzz")),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results["good"][0] == 200
    assert json.loads(results["good"][1]) == [1.0, 2.0, 3.0]
    assert results["short"][0] == 400
    q.stop()
    q.server.stop()


def test_microbatch_epochs_and_commit():
    srv = WorkerServer()
    info = srv.start()
    q = ServingQuery(srv, _echo_handler, mode="microbatch", epoch_interval_ms=30).start()
    try:
        res = []
        for i in range(5):
            res.append(_post_raw(info.port, "/", i))
        assert all(s == 200 for s, _ in res)
        time.sleep(0.1)
        assert srv.epoch >= 1
        assert not srv._history  # committed epochs pruned
    finally:
        q.stop()
        srv.stop()


def test_replay_recovery():
    """Crash-before-reply: requests are unanswered; replay() rehydrates the
    epoch's queue and a recovered dispatcher answers them."""
    srv = WorkerServer()
    info = srv.start()
    results = []

    def client(i):
        results.append(_post_raw(info.port, "/", i))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    # crashing dispatcher: pops the batch, dies before replying
    time.sleep(0.2)
    doomed = srv.get_next_batch(10, timeout_s=1.0)
    assert len(doomed) == 3
    epoch = srv.epoch
    assert srv.replay(epoch) == 3  # unanswered -> rehydrated
    q = ServingQuery(srv, _echo_handler).start()  # recovered dispatcher
    for t in threads:
        t.join(10.0)
    assert sorted(json.loads(d)["echo"] for s, d in results) == [0, 1, 2]
    assert all(s == 200 for s, _ in results)
    replayed = [r for r in doomed]
    assert all(r.attempt == 1 for r in replayed)
    q.stop()
    srv.stop()


def test_reply_idempotent():
    srv = WorkerServer()
    info = srv.start()
    got = {}

    def handler(reqs):
        got["ids"] = [r.id for r in reqs]
        return {r.id: (200, b"first", {}) for r in reqs}

    q = ServingQuery(srv, handler).start()
    status, data = _post_raw(info.port, "/", 1)
    assert (status, data) == (200, b"first")
    assert srv.reply_to(got["ids"][0], b"second") is False  # routing removed
    q.stop()
    srv.stop()




def test_serve_dataframe_transformer():
    from mmlspark_tpu_torch.stages.basic import UDFTransformer

    t = UDFTransformer(input_col="x", output_col="y").set(
        vector_udf=lambda col: np.asarray(col) * 10
    )
    q = serve_transformer(t, "x", "y")
    try:
        status, data = _post_raw(q.server.port, "/", 4.0)
        assert status == 200
        assert json.loads(data) == 40.0
    finally:
        q.stop()
        q.server.stop()


def test_worker_server_forwarding_option(monkeypatch):
    """forwarding= opens an ssh -R tunnel for the bound port and reports
    the public endpoint (HTTPSourceV2.scala:657-665 parity). The ssh spawn
    is faked: the command/port plumbing is what's under test."""
    import mmlspark_tpu_torch.io.port_forwarding as pf

    started = {}

    class FakeProc:
        def poll(self):
            return None

        def terminate(self):
            started["stopped"] = True

        def wait(self, timeout=None):
            return 0

        import io as _io

        stderr = _io.BytesIO()

    def fake_popen(cmd, **kw):
        started["cmd"] = cmd
        return FakeProc()

    monkeypatch.setattr(pf.subprocess, "Popen", fake_popen)
    srv = WorkerServer(
        forwarding={"remote_host": "gateway.example", "remote_port": 9000}
    )
    info = srv.start()
    try:
        assert info.forwarded_host == "gateway.example"
        assert info.forwarded_port == 9000
        assert f"9000:127.0.0.1:{info.port}" in " ".join(started["cmd"])
    finally:
        srv.stop()
    assert started.get("stopped")


def test_serve_transformer_torch_model():
    """End-to-end: a torch model served over HTTP with fixed-bucket
    batching (the JAX package's case serves a ``jax.jit`` function)."""
    w = torch.tensor([[1.0, 2.0], [3.0, 4.0], [0.5, -0.5]])

    def model(x):
        return torch.from_numpy(x) @ w

    q = serve_transformer(model, "features", "scores", max_wait_ms=1.0)
    try:
        port = q.server.port
        status, data = _post_raw(port, "/", [1.0, 0.0, 2.0])
        assert status == 200
        np.testing.assert_allclose(json.loads(data), [2.0, 1.0], atol=1e-5)
        # a second, different batch size hits another bucket fine
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        for i in range(5):
            status, data = _post_raw(port, "/", [float(i), 1.0, 0.0], conn=conn)
            np.testing.assert_allclose(
                json.loads(data), [i + 3.0, 2 * i + 4.0], atol=1e-4
            )
        conn.close()
        status, data = _post_raw(port, "/", "not-a-vector-json{{{")
        assert status == 400  # the body is not a vector: the request's fault
    finally:
        q.stop()
        q.server.stop()


def test_serve_transformer_device_error_is_500_input_error_is_400():
    """Whatever the model raises fails the batch with 500 and is counted:
    the RuntimeError a CUDA failure raises, and a ValueError of the model
    too. Input is a 400 only where validation finds it before the model
    runs: a non-numeric body, a body not of ``input_shape``."""
    def model(x):
        if x[0, 0] == 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        if x[0, 0] == 1:
            raise ValueError("a stage broke")
        return x

    q = serve_transformer(model, "f", "s", input_shape=(3,))
    try:
        assert _post_raw(q.server.port, "/", [0.0, 2.0, 3.0])[0] == 200
        status, data = _post_raw(q.server.port, "/", [0.0])
        assert status == 400 and b"the model takes (3,)" in data
        assert _post_raw(q.server.port, "/", "zzz")[0] == 400
        assert q.errors == 0
        status, data = _post_raw(q.server.port, "/", [2.0, 2.0, 3.0])
        assert status == 500 and b"CUDA error" in data
        status, data = _post_raw(q.server.port, "/", [1.0, 2.0, 3.0])
        assert status == 500 and b"a stage broke" in data
        assert q.errors == 2
    finally:
        q.stop()
        q.server.stop()


# -- ModelStore + ModelDispatcher (tests/test_modelstore.py) -------------------


def _sum(name: str, match=None) -> float:
    return obs.sum_samples(obs.parse_text(obs.render()), name, match)


def _tagged_loaded(tag: str, nbytes: int = 0, sleep_s: float = 0.0,
                   released=None) -> LoadedModel:
    """A LoadedModel whose handler replies with its tag (who served me?)."""

    def handler(reqs):
        if sleep_s:
            time.sleep(sleep_s)
        out = {}
        for r in reqs:
            body = json.loads(r.body) if r.body else {}
            out[r.id] = (
                200,
                json.dumps({"tag": tag, "echo": body}).encode(),
                {"Content-Type": "application/json"},
            )
        return out

    def release():
        if released is not None:
            released.append(tag)

    return LoadedModel(handler=handler, nbytes=nbytes, release=release)


def _post(port, path, obj, method="POST", headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        body = json.dumps(obj) if obj is not None else None
        h = {"Content-Type": "application/json"}
        h.update(headers or {})
        c.request(method, path, body=body, headers=h)
        r = c.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        c.close()


# -- store lifecycle ----------------------------------------------------------


def test_first_load_serves_later_loads_wait_for_swap():
    store = ModelStore()
    assert store.load("m", _tagged_loaded("v1")) == 1
    assert store.serving_version("m") == 1
    assert store.load("m", _tagged_loaded("v2")) == 2
    assert store.serving_version("m") == 1  # activate=auto: no self-promotion
    assert store.swap("m") == 2  # default: newest ready non-serving
    assert store.serving_version("m") == 2
    # idempotent swap-to-current is a no-op
    assert store.swap("m", 2) == 2


def test_swap_drains_inflight_then_evicts_old():
    released: list = []
    store = ModelStore()
    store.load("m", _tagged_loaded("v1", nbytes=100, released=released))
    store.load("m", _tagged_loaded("v2", nbytes=100, released=released))
    mv1 = store.acquire("m")  # an in-flight batch on v1
    assert mv1.version == 1
    store.swap("m", 2)
    # old version must stay resident until its batch releases it
    listing = store.models()["m"]
    v1 = [v for v in listing["versions"] if v["version"] == 1][0]
    assert v1["state"] == READY and v1["inflight"] == 1
    assert store.resident_bytes() == 200
    store.release(mv1)
    v1 = [v for v in store.models()["m"]["versions"] if v["version"] == 1][0]
    assert v1["state"] == EVICTED
    assert released == ["v1"]
    assert store.resident_bytes() == 100
    # new batches resolve v2
    mv = store.acquire("m")
    assert mv.version == 2
    store.release(mv)


def test_budget_lru_eviction_and_exhaustion():
    store = ModelStore(budget_bytes=130)
    store.load("a", _tagged_loaded("a1", nbytes=60))
    # a second resident version (not serving) fits: 120 <= 130
    store.load("a", _tagged_loaded("a2", nbytes=60))
    assert store.resident_bytes() == 120
    # the third evicts the LRU eligible version (a2: non-serving, drained)
    store.load("a", _tagged_loaded("a3", nbytes=60))
    states = {
        v["version"]: v["state"] for v in store.models()["a"]["versions"]
    }
    assert states == {1: READY, 2: EVICTED, 3: READY}
    assert store.resident_bytes() == 120
    # serving + pinned versions are not evictable: nothing can make room
    store.pin("a", 3)
    with pytest.raises(HBMBudgetExceeded):
        store.load("a", _tagged_loaded("a4", nbytes=60))
    assert [
        v["state"] for v in store.models()["a"]["versions"]
        if v["version"] == 4
    ] == ["failed"]
    assert _sum("mmlspark_modelstore_resident_bytes") == 120


def _gated_warmup_loader(entered, gate, nbytes=60):
    """Loader whose warmup blocks on ``gate`` (signalling ``entered``) —
    pins a version in WARMING so races against it are deterministic."""

    def loader(spec):
        lm = _tagged_loaded(str(spec), nbytes=nbytes)
        if spec == "slow":
            def warmup():
                entered.set()
                gate.wait(10.0)

            lm.warmup = warmup
        return lm

    return loader


def test_injected_load_fault_fails_version_serving_survives():
    """Fault point ``modelstore.load``: an injected error is a corrupt
    model artifact — the version lands FAILED (recorded error), the
    serving version keeps serving, and a retried load succeeds; an
    injected delay is a slow deserialize the background load absorbs
    while traffic continues."""
    from mmlspark_tpu_torch.serving.modelstore.store import FAILED

    store = ModelStore()
    store.load("m", _tagged_loaded("v1"))
    plan = FaultPlan().on("modelstore.load", error=OSError, at=(0,))
    with plan.armed():
        with pytest.raises(OSError):
            store.load("m", _tagged_loaded("v2"), wait=True)
        # the fault consumed: the store is not poisoned — retry lands
        v3 = store.load("m", _tagged_loaded("v3"), wait=True)
    assert len(plan.fires("modelstore.load")) == 1
    listing = {v["version"]: v for v in store.models()["m"]["versions"]}
    assert listing[2]["state"] == FAILED
    assert listing[v3]["state"] == READY
    assert store.serving_version("m") == 1  # v1 never stopped serving
    mv = store.acquire("m")
    assert mv.version == 1
    store.release(mv)
    # injected LATENCY on a background load: serving continues through it
    plan2 = FaultPlan().on("modelstore.load", delay_s=0.3, at=(0,))
    with plan2.armed():
        v4 = store.load("m", _tagged_loaded("v4"), wait=False)
        for _ in range(5):
            mv = store.acquire("m")
            assert mv.version == 1
            store.release(mv)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            st = {v["version"]: v for v in store.models()["m"]["versions"]}
            if st[v4]["state"] == READY:
                break
            time.sleep(0.02)
    assert st[v4]["state"] == READY


def test_budget_never_evicts_a_warming_version():
    """A WARMING version's load thread is still running warmup on its
    weights: budget pressure must fail the competing load rather than
    evict mid-warmup (which would resurrect as a ready-but-empty brick)."""
    entered, gate = threading.Event(), threading.Event()
    store = ModelStore(
        budget_bytes=100, loader=_gated_warmup_loader(entered, gate)
    )
    try:
        store.load("a", "slow", wait=False)  # 60 bytes, stuck in warmup
        assert entered.wait(5.0)
        with pytest.raises(HBMBudgetExceeded):
            store.load("b", "other")  # +60 > 100 and nothing evictable
    finally:
        gate.set()
    deadline = time.monotonic() + 5.0
    while store.serving_state("a") != READY and time.monotonic() < deadline:
        time.sleep(0.02)
    assert store.serving_state("a") == READY  # warmup finished unharmed
    mv = store.acquire("a")
    assert mv is not None and mv.loaded is not None
    store.release(mv)


def test_unload_during_warmup_does_not_resurrect():
    entered, gate = threading.Event(), threading.Event()
    store = ModelStore(loader=_gated_warmup_loader(entered, gate))
    store.load("m", "slow", wait=False)
    assert entered.wait(5.0)
    assert store.unload("m") == 1
    gate.set()
    time.sleep(0.2)  # give the load thread its chance to misbehave
    assert store.serving_state("m") is None  # stays unloaded, no alias
    assert store.resident_bytes() == 0
    assert store.acquire("m") is None


def test_unload_during_load_phase_leaks_nothing():
    """unload() racing a background load still in its loader: the orphan
    must not turn resident (leaking budget bytes nothing can evict) nor
    resurrect the deleted model's serving alias."""
    entered, gate = threading.Event(), threading.Event()

    def blocking_loader(spec):
        entered.set()
        gate.wait(10.0)
        return _tagged_loaded("late", nbytes=70)

    store = ModelStore(budget_bytes=100, loader=blocking_loader)
    store.load("m", "slow", wait=False)
    assert entered.wait(5.0)
    assert store.unload("m") == 1
    gate.set()
    deadline = time.monotonic() + 5.0
    while store.resident_bytes() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert store.resident_bytes() == 0  # orphan bytes released
    assert store.serving_state("m") is None  # no alias resurrection
    # the whole budget is available again
    store._loader = lambda spec: _tagged_loaded("fresh", nbytes=90)
    store.load("m", "fresh")
    assert store.serving_state("m") == READY


def test_pinned_old_version_survives_swap_for_rollback():
    store = ModelStore()
    store.load("m", _tagged_loaded("v1", nbytes=10))
    store.pin("m")  # pin the serving version
    store.load("m", _tagged_loaded("v2", nbytes=10))
    store.swap("m", 2)
    v1 = [v for v in store.models()["m"]["versions"] if v["version"] == 1][0]
    assert v1["state"] == READY and v1["pinned"]  # instant-rollback copy
    assert store.swap("m", 1) == 1  # the rollback itself
    v2 = [v for v in store.models()["m"]["versions"] if v["version"] == 2][0]
    assert v2["state"] == EVICTED  # the unpinned loser drained out
    # a pinned version displaced again is released by unpin alone
    store.load("m", _tagged_loaded("v3", nbytes=10))
    store.swap("m", 3)
    v1 = [v for v in store.models()["m"]["versions"] if v["version"] == 1][0]
    assert v1["state"] == READY  # still pinned: survives its retirement
    store.pin("m", 1, pinned=False)
    v1 = [v for v in store.models()["m"]["versions"] if v["version"] == 1][0]
    assert v1["state"] == EVICTED


def test_failed_load_is_visible_and_reloadable():
    def bad_loader(spec):
        raise RuntimeError("corrupt artifact")

    store = ModelStore(loader=bad_loader)
    with pytest.raises(RuntimeError):
        store.load("m", "whatever")
    v = store.models()["m"]["versions"][0]
    assert v["state"] == "failed" and "corrupt artifact" in v["error"]
    assert store.serving_version("m") is None
    # the slot can be reloaded (failed versions are replaceable)
    store2 = ModelStore()
    store2.load("m", _tagged_loaded("ok"))
    assert store2.serving_state("m") == READY


def test_unload_model_and_version():
    store = ModelStore()
    store.load("m", _tagged_loaded("v1", nbytes=5))
    store.load("m", _tagged_loaded("v2", nbytes=5))
    assert store.unload("m", 2) == 1
    assert [v["version"] for v in store.models()["m"]["versions"]] == [1]
    assert store.unload("m") == 1
    assert store.serving_state("m") is None
    assert store.resident_bytes() == 0
    with pytest.raises(KeyError):
        store.unload("m")


def test_dead_version_history_is_bounded():
    """Months of hourly hot-swaps must not grow the listing without
    bound: old evicted/failed tombstones are pruned at the next load."""
    store = ModelStore()
    store.load("m", _tagged_loaded("v1", nbytes=1))
    for i in range(14):
        v = store.load("m", _tagged_loaded(f"v{i + 2}", nbytes=1))
        store.swap("m", v)
    versions = store.models()["m"]["versions"]
    dead = [v for v in versions if v["state"] == EVICTED]
    # pruning runs at load time, so at most KEEP + the last swap's corpse
    assert len(dead) <= ModelStore.KEEP_DEAD_VERSIONS + 1
    assert store.serving_state("m") == READY  # the live version survives


def test_swap_requires_ready_version():
    store = ModelStore()
    store.load("m", _tagged_loaded("v1"))
    with pytest.raises(ModelStoreError):
        store.swap("m")  # nothing to swap to
    with pytest.raises(KeyError):
        store.swap("nope")


# -- dispatcher: routing, control plane, admission ----------------------------


def _dispatcher(store, **kw):
    srv = WorkerServer()
    info = srv.start()
    disp = ModelDispatcher(srv, store, **kw).start()
    return srv, disp, info


def test_dispatch_routes_by_path_header_and_default():
    store = ModelStore()
    store.load("a", _tagged_loaded("A"))
    store.load("b", _tagged_loaded("B"))
    srv, disp, info = _dispatcher(store, default_model="a")
    try:
        s, d, _ = _post(info.port, "/", {"x": 1})
        assert s == 200 and json.loads(d)["tag"] == "A"
        s, d, _ = _post(info.port, "/models/b", {"x": 2})
        assert s == 200 and json.loads(d)["tag"] == "B"
        s, d, _ = _post(
            info.port, "/", {"x": 3}, headers={"x-mmlspark-model": "b"}
        )
        assert s == 200 and json.loads(d)["tag"] == "B"
        s, d, _ = _post(info.port, "/models/nope", {"x": 4})
        assert s == 404
    finally:
        disp.stop()
        srv.stop()


def test_control_plane_over_http():
    store = ModelStore(loader=lambda spec: _tagged_loaded(spec))
    store.load("m", "m-v1")
    srv, disp, info = _dispatcher(store, default_model="m")
    try:
        s, d, _ = _post(info.port, "/models", None, "GET")
        assert s == 200 and json.loads(d)["m"]["serving"] == 1
        s, d, _ = _post(info.port, "/models/m/load", {"spec": "m-v2"})
        assert s == 200 and json.loads(d)["version"] == 2
        s, d, _ = _post(info.port, "/models/m/swap", {})
        assert s == 200 and json.loads(d)["serving"] == 2
        s, d, _ = _post(info.port, "/", {"q": 1})
        assert json.loads(d)["tag"] == "m-v2"  # traffic moved to v2
        s, d, _ = _post(info.port, "/models/m/pin", {"version": 2})
        assert s == 200 and json.loads(d)["pinned"] is True
        s, d, _ = _post(info.port, "/models/m/load", {"spec": None})
        assert s == 400  # spec required
        s, d, _ = _post(info.port, "/models/ghost/swap", {})
        assert s == 404
        s, d, _ = _post(info.port, "/models/m/unload", {})
        assert s == 200 and json.loads(d)["unloaded"] == 2
        s, d, _ = _post(info.port, "/", {"q": 2})
        assert s == 404  # model gone
    finally:
        disp.stop()
        srv.stop()


def test_health_reports_loading_until_warm():
    gate = threading.Event()

    def slow_loader(spec):
        gate.wait(10.0)
        return _tagged_loaded(spec)

    store = ModelStore(loader=slow_loader)
    store.load("m", "m1", wait=False)
    srv, disp, info = _dispatcher(store, default_model="m")
    try:
        s, d, _ = _post(info.port, "/health", None, "GET")
        assert s == 503 and json.loads(d)["status"] == "loading"
        # data-path requests during load: worker-local 503 with the
        # state header a routing layer keys its retry on
        s, d, h = _post(info.port, "/", {"x": 1})
        assert s == 503
        assert {k.lower(): v for k, v in h.items()}[STATE_HEADER] == LOADING
        gate.set()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            s, d, _ = _post(info.port, "/health", None, "GET")
            if s == 200:
                break
            time.sleep(0.02)
        assert s == 200 and json.loads(d)["status"] == "ok"
        assert _post(info.port, "/", {"x": 2})[0] == 200
    finally:
        disp.stop()
        srv.stop()


def test_admission_sheds_unmeetable_deadlines_429():
    store = ModelStore()
    store.load("m", _tagged_loaded("slow", sleep_s=0.15))
    srv, disp, info = _dispatcher(store, default_model="m", max_batch_size=1)
    try:
        # prime the service-time EWMA (no estimate -> everything admits)
        assert _post(info.port, "/", {"i": 0})[0] == 200
        assert disp._queues["m"].svc_s > 0.05
        # saturate the single-slot batcher, then ask for the impossible
        results = {}

        def client(i):
            results[i] = _post(info.port, "/", {"i": i})

        threads = [
            threading.Thread(target=client, args=(i,)) for i in range(3)
        ]
        for t in threads:
            t.start()
        time.sleep(0.05)  # queue now holds work worth ~2+ service times
        s, d, _ = _post(
            info.port, "/", {"i": 99},
            headers={"x-mmlspark-deadline-ms": "1"},
        )
        assert s == 429
        body = json.loads(d)
        assert body["deadline_ms"] == 1.0 and body["estimate_ms"] > 1.0
        assert disp.shed == 1
        # a generous deadline still admits
        s, _, _ = _post(
            info.port, "/", {"i": 100},
            headers={"x-mmlspark-deadline-ms": "60000"},
        )
        assert s == 200
        for t in threads:
            t.join()
        assert all(r[0] == 200 for r in results.values())
        assert _sum("mmlspark_modelstore_shed_total", {"model": "m"}) >= 1
    finally:
        disp.stop()
        srv.stop()


def test_unload_reaps_the_model_queue():
    """Multi-tenant churn must not leak a batcher thread + metric series
    per model name ever served: unload reaps the queue, reload recreates
    it lazily."""
    store = ModelStore()
    store.load("m", _tagged_loaded("x"))
    srv, disp, info = _dispatcher(store, default_model="m")
    try:
        assert _post(info.port, "/", {"i": 1})[0] == 200
        assert "m" in disp._queues
        store.unload("m")
        deadline = time.monotonic() + 3.0
        while "m" in disp._queues and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "m" not in disp._queues  # batcher exited, series removed
        store.load("m", _tagged_loaded("y"))
        s, d, _ = _post(info.port, "/", {"i": 2})
        assert s == 200 and json.loads(d)["tag"] == "y"  # lazily recreated
    finally:
        disp.stop()
        srv.stop()


# -- satellites ---------------------------------------------------------------


def test_bucket_is_capped_at_max_batch_pow2():
    from mmlspark_tpu_torch.serving.query import _bucket

    assert _bucket(5) == 8
    assert _bucket(1) == 1
    assert _bucket(5, cap=64) == 8
    assert _bucket(65, cap=64) == 64  # capped: bounded compile set
    assert _bucket(100, cap=100) == 128
    assert _bucket(3, cap=2) == 2


def test_serve_transformer_records_bucket_sizes():
    import numpy as np

    from mmlspark_tpu_torch.serving import serve_transformer

    w = np.eye(3, dtype=np.float32)
    q = serve_transformer(
        lambda x: x @ w, "f", "s", max_batch_size=16, name="bkt"
    )
    try:
        s, d, _ = _post(q.server.port, "/", [1.0, 2.0, 3.0])
        assert s == 200
        # chosen bucket (1 request -> bucket 1) landed in the batch-size
        # histogram under the "<name>/buckets" series
        n = _sum(
            "mmlspark_serving_batch_size_requests_count",
            {"server": "bkt/buckets"},
        )
        assert n >= 1
    finally:
        q.stop()
        q.server.stop()



# -- the port's own contracts --------------------------------------------------


def _vw_snapshot(path, bits: int = 10, loss: str = "logistic", seed: int = 0) -> str:
    """A ``vw:`` snapshot as the loader documents it: ``weights`` (2^bits
    f32) and ``meta``, JSON bytes."""
    w = np.random.default_rng(seed).standard_normal(1 << bits).astype(np.float32)
    meta = json.dumps({"num_bits": bits, "loss": loss}).encode()
    np.savez(path, weights=w, meta=np.frombuffer(meta, np.uint8))
    return str(path)


def test_input_error_is_400_device_error_is_500_and_counted(tmp_path, monkeypatch):
    from mmlspark_tpu_torch.ops import sgd

    spec = "vw:" + _vw_snapshot(tmp_path / "m.npz")
    store = ModelStore(device="cpu")
    store.load("m", spec)
    srv, disp, info = _dispatcher(store, default_model="m")
    try:
        assert _post(info.port, "/", {"i": [1, 2], "v": [1.0, 0.5]})[0] == 200
        s, d, _ = _post(info.port, "/", {"i": [1 << 10], "v": [1.0]})
        assert s == 400 and b"out of range" in d  # outside the weights
        assert _post(info.port, "/", {"i": [1, 2], "v": [1.0]})[0] == 400
        assert _post(info.port, "/", {"x": 1})[0] == 400
        assert disp.errors == 0

        def broken(idx, val, w):
            raise RuntimeError("CUDA error: unspecified launch failure")

        monkeypatch.setattr(sgd, "margins", broken)
        before = _sum("mmlspark_modelstore_handler_errors_total", {"model": "m"})
        s, d, _ = _post(info.port, "/", {"i": [1], "v": [1.0]})
        assert s == 500 and b"CUDA error" in d
        assert disp.errors == 1
        assert _sum("mmlspark_modelstore_handler_errors_total", {"model": "m"}) == before + 1
    finally:
        disp.stop()
        srv.stop()


def test_failed_warmup_leaves_the_version_failed():
    def loader(spec):
        lm = _tagged_loaded(spec, nbytes=10)
        if spec == "bad":
            def warmup():
                raise RuntimeError("CUDA error: out of memory")

            lm.warmup = warmup
        return lm

    store = ModelStore(budget_bytes=100, loader=loader)
    store.load("m", "good")
    with pytest.raises(RuntimeError, match="out of memory"):
        store.load("m", "bad")
    versions = {v["version"]: v for v in store.models()["m"]["versions"]}
    assert versions[2]["state"] == FAILED and "out of memory" in versions[2]["error"]
    assert store.resident_bytes() == 10 and store.serving_version("m") == 1


def test_budget_counts_what_the_warmup_measured():
    """``nbytes`` is checked before the version is placed; what it holds
    after its warm-up (``measure``) replaces it, and growth must fit the
    budget like a load: LRU eviction, else HBMBudgetExceeded."""
    def loader(spec):
        lm = _tagged_loaded(spec, nbytes=10)
        lm.measure = lambda: int(spec)
        return lm

    store = ModelStore(budget_bytes=100, loader=loader)
    store.load("a", "40")
    assert store.resident_bytes() == 40
    assert store.models()["a"]["versions"][0]["nbytes"] == 40
    store.load("a", "50")
    assert store.resident_bytes() == 90
    store.load("a", "30")  # 10 fits; measured 30 evicts v2 (LRU, not serving)
    states = {v["version"]: v["state"] for v in store.models()["a"]["versions"]}
    assert states == {1: READY, 2: EVICTED, 3: READY}
    assert store.resident_bytes() == 70
    store.pin("a", 3)
    with pytest.raises(HBMBudgetExceeded):
        store.load("a", "45")  # measured 45 > 30 free, nothing evictable
    states = {v["version"]: v["state"] for v in store.models()["a"]["versions"]}
    assert states[4] == FAILED and store.resident_bytes() == 70
    assert _sum("mmlspark_modelstore_resident_bytes") == 70


def test_tensor_nbytes_counts_each_storage_once():
    w = torch.zeros(1000)
    b = torch.ones(3, dtype=torch.float64)

    class Holder:
        __slots__ = ("t",)

    h = Holder()
    h.t = w[10:20]  # a view: its storage is w's
    assert tensor_nbytes([lambda: (w, b), {"v": w[:5]}, h]) == 4000 + 24
    assert tensor_nbytes(torch.nn.Linear(4, 2)) == (8 + 2) * 4
    assert tensor_nbytes({"a": w}, device="cpu") == 4000
    assert tensor_nbytes({"a": w}, device="cuda:0") == 0
    assert tensor_nbytes({"host": np.zeros(100)}) == 0


@pytest.mark.parametrize("fn", [build_loaded_model, model_name_from_spec])
def test_artifact_specs_are_not_ported_yet(fn):
    with pytest.raises(NotImplementedError, match="artifacts.py"):
        fn("artifact:vw:m.npz@" + "0" * 64)


@pytest.mark.parametrize("spec, name", [
    ("echo", "echo"), ("zoo:ResNet8_Digits", "ResNet8_Digits"), ("module:pkg.make", "make"),
    ("pipeline:/m/churn/", "churn"), ("vw:/s/vw-online-v000007.npz", "vw-online"),
    ("vw:/s/fraud-v2.npz", "fraud-v2"), ("gbdt:/g/trial-r3.gbdt.json", "trial"),
])
def test_model_name_from_spec(spec, name):
    assert model_name_from_spec(spec) == name


def test_vw_loader_places_its_weights_once_and_release_drops_them(tmp_path):
    lm = build_loaded_model("vw:" + _vw_snapshot(tmp_path / "w.npz"), device="cpu")
    assert lm.nbytes == 4 << 10 and lm.meta["device"] == "cpu"
    lm.warmup()
    assert lm.measure() == 4 << 10
    lm.release()
    assert lm.measure() == 0


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    store = ModelStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.load("m", "vw:" + _vw_snapshot(tmp_path / "w.npz"))
    assert store.models()["m"]["versions"][0]["state"] == FAILED
    store.load("e", "echo")  # a weightless handler needs no device
    assert store.serving_state("e") == READY


def _saved_pipeline(path, rows: int = 5):
    """A small fitted Featurize -> LogisticRegression pipeline saved with a
    ``warmup.json`` of its first ``rows`` rows."""
    from mmlspark_tpu_torch import DataFrame, Pipeline
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.models.linear import LogisticRegression

    rng = np.random.default_rng(3)
    cols = {"a": rng.standard_normal(64), "b": rng.standard_normal(64),
            "label": rng.integers(0, 2, 64)}
    model = Pipeline([
        Featurize(input_cols=["a", "b"], output_col="features"),
        LogisticRegression(features_col="features", label_col="label", max_iter=5,
                           device="cpu"),
    ]).fit(DataFrame.from_dict(cols))
    model.save(str(path))
    with open(os.path.join(str(path), "warmup.json"), "w") as f:
        json.dump({"a": cols["a"][:rows].tolist(), "b": cols["b"][:rows].tolist()}, f)
    return cols


def test_pipeline_warmup_runs_every_bucket_and_release_drops_the_graphs(tmp_path, monkeypatch):
    from mmlspark_tpu_torch.core.pipeline import PipelineModel

    cols = _saved_pipeline(tmp_path / "p", rows=5)
    compiled, compile_ = [], PipelineModel.compile
    monkeypatch.setattr(PipelineModel, "compile",
                        lambda self, *a, **kw: compiled.append(compile_(self, *a, **kw))
                        or compiled[-1])
    lm = build_loaded_model(f"pipeline:{tmp_path / 'p'}", device="cpu")
    assert lm.meta["fused_stages"] == 2 and lm.meta["device"] == "cpu"
    lm.warmup()
    (comp,) = compiled
    buckets = sorted(k[0] for s in comp.fused_segments for k in s._graphs)
    assert buckets == [1, 2, 4, 8]  # warmup.json's 5 rows: buckets 1, 2, 4 and 8
    assert lm.measure() > 0  # the placed weights
    req = type("R", (), {"id": "r", "body": json.dumps(
        {"a": float(cols["a"][0]), "b": float(cols["b"][0])}).encode()})()
    code, body, _ = lm.handler([req])["r"]
    assert code == 200 and set(json.loads(body)) == {
        "features", "raw_prediction", "probability", "prediction"}
    lm.release()
    assert all(not s._graphs and s._pool is None for s in comp.fused_segments)


def test_pipeline_validates_before_the_model_and_a_stage_error_is_500(tmp_path, monkeypatch):
    """A request the pipeline cannot read — a column the plan reads is
    missing, a column's rows are not of ``warmup.json``'s shape — 400s
    alone, before the model runs; whatever the compiled transform raises,
    a stage's ValueError too, is the batch's 500 and counted."""
    from mmlspark_tpu_torch.compiler import CompiledPipeline

    cols = _saved_pipeline(tmp_path / "p")
    store = ModelStore(device="cpu")
    store.load("p", f"pipeline:{tmp_path / 'p'}")
    srv, disp, info = _dispatcher(store, default_model="p")
    row = {"a": float(cols["a"][0]), "b": float(cols["b"][0])}
    try:
        assert _post(info.port, "/", row)[0] == 200
        assert _post(info.port, "/", {"rows": [row, row]})[0] == 200
        s, d, _ = _post(info.port, "/", {"a": 1.0})
        assert s == 400 and b"missing column" in d
        s, d, _ = _post(info.port, "/", {"a": [1.0, 2.0], "b": 0.5})
        assert s == 400 and b"the model takes ()" in d
        s, d, _ = _post(info.port, "/", {"cols": {"a": ["x"], "b": [0.5]}})
        assert s == 400 and b"non-numeric" in d
        assert disp.errors == 0

        def broken(self, df):
            raise ValueError("a stage broke")

        monkeypatch.setattr(CompiledPipeline, "transform", broken)
        before = _sum("mmlspark_modelstore_handler_errors_total", {"model": "p"})
        s, d, _ = _post(info.port, "/", row)
        assert s == 500 and b"a stage broke" in d
        assert disp.errors == 1
        assert _sum("mmlspark_modelstore_handler_errors_total", {"model": "p"}) == before + 1
    finally:
        disp.stop()
        srv.stop()


def test_a_custom_loader_refuses_the_default_loaders_options():
    with pytest.raises(ValueError, match="custom loader"):
        ModelStore(loader=_tagged_loaded, device="cpu")
    with pytest.raises(ValueError, match="custom loader"):
        ModelStore(loader=_tagged_loaded, zoo_dir="/zoo")
