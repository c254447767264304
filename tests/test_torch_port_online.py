"""The port's continuous-learning slice (``mmlspark_tpu_torch/online/`` and
``fleet online``) against the JAX package's, on the CPU.

The same rows, made from a seed with numpy, go through both packages'
``OnlineTrainer``, ``FeedbackStream`` and ``Publisher``. The JAX trainer runs
its single-device program (``distributed=False``, its default). Tolerances:

- the warm-start identity within the port: chunks of whole minibatches
  (64 rows) give ``w``, ``g2`` and ``t`` bitwise equal to one
  ``train_sparse_sgd_state`` call over the same rows, for every loss;
- against the JAX trainer: weights bitwise for the squared, hinge and
  quantile losses; within ``EXP_TOL`` * max |w| for logistic (XLA's
  ``exp`` and PyTorch's round differently: ROADMAP.md's standing
  differences);
- snapshots: the ``.npz`` one package writes loads in the other's worker,
  and the replies of both workers to the same rows are bitwise equal (at
  most 17 slots a row: ``tests/test_torch_port_serving.py``);
- spills: the records one package writes replay in the other with the
  same sequence numbers, stamps and rows;
- ``fleet online --device cpu`` (a process of its own): the last
  snapshot's weights bitwise equal to one ``train_sparse_sgd`` over the
  rows in ingest order, and the worker's replies bitwise the in-process
  scoring of that snapshot, in shared-file and artifact mode.

Processes spawned here get one intra-op thread each.
"""

from __future__ import annotations

import glob
import http.client
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mmlspark_tpu.core.dataframe import DataFrame as JDataFrame
from mmlspark_tpu.online import FeedbackStream as JFeedbackStream
from mmlspark_tpu.online import OnlineTrainer as JOnlineTrainer
from mmlspark_tpu.online import Publisher as JPublisher
from mmlspark_tpu.serving.modelstore import ModelDispatcher as JModelDispatcher
from mmlspark_tpu.serving.modelstore import ModelStore as JModelStore
from mmlspark_tpu.serving.server import WorkerServer as JWorkerServer

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.faults import FaultPlan
from mmlspark_tpu_torch.online import (
    FeedbackStream,
    OnlineLearningLoop,
    OnlineTrainer,
    PublishError,
    Publisher,
)
from mmlspark_tpu_torch.serving.modelstore import ModelDispatcher, ModelStore
from mmlspark_tpu_torch.serving.server import WorkerServer
from mmlspark_tpu_torch.vw import learner as PL
from mmlspark_tpu_torch.vw.estimators import _append_constant
from mmlspark_tpu_torch.vw.sparse import pad_sparse_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP_TOL = 1e-5
BITS = 10
LOSSES = ("logistic", "squared", "hinge", "quantile")


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    """Spawned fleet roles import torch: one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")


def _rows(n: int, seed: int, loss: str = "logistic", bits: int = BITS) -> tuple:
    """n sparse rows of 2-6 slots (JSON-shaped lists) and their labels:
    0/1 for logistic and hinge, real values otherwise."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = int(rng.integers(2, 7))
        rows.append({"i": rng.integers(0, 1 << bits, size=k).tolist(),
                     "v": rng.normal(size=k).astype(np.float32).tolist()})
    if loss in ("logistic", "hinge"):
        y = rng.integers(0, 2, size=n).astype(np.float64)
    else:
        y = rng.normal(size=n)
    return rows, y


def _frame(cls, rows: list, y, lo: int = 0, hi: "int | None" = None):
    hi = len(rows) if hi is None else hi
    cells = np.empty(hi - lo, dtype=object)
    for r in range(lo, hi):
        cells[r - lo] = {"i": np.asarray(rows[r]["i"], np.int64),
                         "v": np.asarray(rows[r]["v"], np.float32)}
    return cls.from_dict({"features": cells, "label": np.asarray(y[lo:hi])})


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _arrays(rows: list, y, loss: str) -> tuple:
    """The trainer's featurization of all rows at once: padded (idx, val)
    with the Constant, labels mapped to +-1 for logistic and hinge."""
    cells = np.empty(len(rows), dtype=object)
    for r, row in enumerate(rows):
        cells[r] = {"i": np.asarray(row["i"], np.int64), "v": np.asarray(row["v"], np.float32)}
    idx, val = _append_constant(*pad_sparse_batch(cells), BITS)
    yy = np.asarray(y, np.float64).astype(np.float32)
    if loss in ("logistic", "hinge"):
        yy = np.where(yy > 0, 1.0, -1.0).astype(np.float32)
    return idx, val, yy


# -- the trainer ------------------------------------------------------------------


@pytest.mark.parametrize("loss", LOSSES)
def test_trainer_chunks_equal_one_call_bitwise(loss):
    """Chunks of whole 64-row minibatches == one train_sparse_sgd_state call
    over the concatenation: w, g2 and t bitwise."""
    rows, y = _rows(384, seed=7, loss=loss)
    online = OnlineTrainer(num_bits=BITS, loss=loss, device="cpu")
    for lo in (0, 64, 192):
        online.step(_frame(DataFrame, rows, y, lo, {0: 64, 64: 192, 192: 384}[lo]))
    idx, val, yy = _arrays(rows, y, loss)
    want = PL.train_sparse_sgd_state(idx, val, yy, None, BITS, None, loss=loss, batch=64,
                                     distributed=False, device="cpu")
    assert online.examples == 384 and online.batches == 3
    assert _bits_equal(online.weights_host(), want.w.numpy())
    assert _bits_equal(online.state.g2.numpy(), want.g2.numpy())
    assert float(online.state.t) == float(want.t) == 6.0
    one = PL.train_sparse_sgd(idx, val, yy, None, BITS, loss=loss, batch=64,
                              distributed=False, device="cpu")
    assert _bits_equal(online.weights_host(), one)


@pytest.mark.parametrize("loss", LOSSES)
def test_trainer_matches_jax_online_trainer(loss):
    """The same chunks through the JAX OnlineTrainer and the port's: bitwise
    for squared, hinge and quantile; logistic within EXP_TOL * max|w|."""
    rows, y = _rows(320, seed=11, loss=loss)
    port = OnlineTrainer(num_bits=BITS, loss=loss, quantile_tau=0.3, device="cpu")
    ref = JOnlineTrainer(num_bits=BITS, loss=loss, quantile_tau=0.3)
    for lo in range(0, 320, 128):
        hi = min(lo + 128, 320)
        port.step(_frame(DataFrame, rows, y, lo, hi))
        ref.step(_frame(JDataFrame, rows, y, lo, hi))
    got, want = port.weights_host(), ref.weights_host()
    assert np.count_nonzero(want) > 100
    if loss == "logistic":
        assert np.abs(got - want).max() <= EXP_TOL * np.abs(want).max()
    else:
        assert _bits_equal(got, want)
        assert _bits_equal(port.state.g2.numpy(), np.asarray(ref.state.g2))
    assert float(port.state.t) == float(ref.state.t)
    assert port.snapshot_meta() == ref.snapshot_meta()


def test_trainer_initial_weights_cross_packages():
    """Weights leave the JAX trainer as numpy and seed the port's (and the
    other way round); both then train on bitwise alike."""
    rows, y = _rows(256, seed=3, loss="squared")
    j0 = JOnlineTrainer(num_bits=BITS, loss="squared")
    j0.step(_frame(JDataFrame, rows, y, 0, 128))
    w0 = j0.weights_host()
    port = OnlineTrainer(num_bits=BITS, loss="squared", initial_weights=w0, device="cpu")
    ref = JOnlineTrainer(num_bits=BITS, loss="squared", initial_weights=w0)
    port.step(_frame(DataFrame, rows, y, 128, 256))
    ref.step(_frame(JDataFrame, rows, y, 128, 256))
    assert _bits_equal(port.weights_host(), ref.weights_host())
    back = JOnlineTrainer(num_bits=BITS, loss="squared", initial_weights=port.weights_host())
    assert _bits_equal(back.weights_host(), port.weights_host())


def test_trainer_text_column_matches_jax():
    """A text column hashed through each package's featurizer trains to the
    same weights (squared loss: bitwise)."""
    rng = np.random.default_rng(3)
    texts = np.array([" ".join(rng.choice(["spam", "ham", "eggs", "nau", "x1"], size=5))
                      for _ in range(128)], dtype=object)
    labels = np.array([1.0 if "spam" in t else 0.0 for t in texts])
    port = OnlineTrainer(num_bits=BITS, loss="squared", text_col="text", device="cpu")
    ref = JOnlineTrainer(num_bits=BITS, loss="squared", text_col="text")
    assert port.step(DataFrame.from_dict({"text": texts, "label": labels})) == 128
    ref.step(JDataFrame.from_dict({"text": texts, "label": labels}))
    assert np.count_nonzero(port.weights_host()) > 3
    assert _bits_equal(port.weights_host(), ref.weights_host())
    model = port.to_model()
    assert model.get("device") == "cpu"
    scored = model.transform(port._featurizer.transform(DataFrame.from_dict({"text": texts})))
    assert len(scored["prediction"]) == 128


def test_weights_host_is_a_copy_that_later_steps_leave_alone():
    rows, y = _rows(256, seed=5, loss="squared")
    t = OnlineTrainer(num_bits=BITS, loss="squared", device="cpu")
    t.step(_frame(DataFrame, rows, y, 0, 128))
    snap = t.weights_host()
    kept = snap.copy()
    snap[:] = 7.0                       # writing the copy leaves the state alone
    assert _bits_equal(t.weights_host(), kept)
    state0 = t.state
    t.step(_frame(DataFrame, rows, y, 128, 256))
    assert t.state is not state0        # the step replaced the state whole
    assert _bits_equal(state0.w.numpy(), kept)
    assert not _bits_equal(t.weights_host(), kept)


def test_trainer_without_a_card_raises():
    """Entry points run on the card unless told the CPU: here there is none."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnlineTrainer(num_bits=BITS)


# -- snapshots across packages ------------------------------------------------------


def _published(pkg: str, tmp_path, rows, y) -> str:
    """Train and publish one snapshot with ``pkg``'s trainer and Publisher
    into an in-process store of the same package; returns its path."""
    if pkg == "jax":
        trainer, store = JOnlineTrainer(num_bits=BITS, loss="squared"), JModelStore()
        pub = JPublisher(model="vw-online", snapshot_dir=str(tmp_path / pkg), store=store)
        trainer.step(_frame(JDataFrame, rows, y))
    else:
        trainer = OnlineTrainer(num_bits=BITS, loss="squared", device="cpu")
        store = ModelStore(device="cpu")
        pub = Publisher(model="vw-online", snapshot_dir=str(tmp_path / pkg), store=store)
        trainer.step(_frame(DataFrame, rows, y))
    res = pub.publish(trainer, oldest_ts=time.monotonic())
    assert res["targets"] == 1 and res["version"] == 1
    assert os.path.basename(res["path"]) == "vw-online-v000001.npz"
    return res["path"]


def _worker_replies(pkg: str, spec: str, bodies: list) -> list:
    if pkg == "jax":
        store, srv = JModelStore(), JWorkerServer()
    else:
        store, srv = ModelStore(device="cpu"), WorkerServer()
    store.load("vw-online", spec)
    info = srv.start()
    disp = (JModelDispatcher if pkg == "jax" else ModelDispatcher)(srv, store).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", info.port, timeout=60)
        out = []
        for b in bodies:
            conn.request("POST", "/models/vw-online", body=b,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            out.append((r.status, json.loads(r.read())))
        conn.close()
        return out
    finally:
        disp.stop()
        srv.stop()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_loads_and_scores_in_both_workers_bitwise(writer, tmp_path):
    rows, y = _rows(192, seed=21, loss="squared")
    path = _published(writer, tmp_path, rows, y)
    other = _published("torch" if writer == "jax" else "jax", tmp_path, rows, y)
    with np.load(path) as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files) == ["meta", "weights"]
        assert bytes(a["meta"]) == bytes(b["meta"])
        assert _bits_equal(a["weights"], b["weights"])
    held, _ = _rows(24, seed=22)
    bodies = [json.dumps(r).encode() for r in held]
    bodies.append(json.dumps({"rows": held[:5]}).encode())
    got = {pkg: _worker_replies(pkg, f"vw:{path}", bodies) for pkg in ("jax", "torch")}
    assert [s for s, _ in got["torch"]] == [s for s, _ in got["jax"]] == [200] * len(bodies)
    assert [r for _, r in got["torch"]] == [r for _, r in got["jax"]]
    w = np.load(path)["weights"]
    assert got["torch"][0][1]["margin"] == float(PL.predict_margin(
        *_append_constant(*pad_sparse_batch([{"i": np.asarray(held[0]["i"]),
                                              "v": np.asarray(held[0]["v"], np.float32)}]),
                          BITS), w, device="cpu")[0])


# -- the feedback stream ------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spill_written_by_one_package_replays_in_the_other(writer, tmp_path):
    spill = str(tmp_path / "spill")
    W, R = (JFeedbackStream, FeedbackStream) if writer == "jax" else (FeedbackStream,
                                                                      JFeedbackStream)
    wdf = JDataFrame if writer == "jax" else DataFrame
    rows, y = _rows(30, seed=4)
    stream = W(spill_dir=spill, spill_segment_chunks=2)
    sizes = [3, 4, 5, 6, 7]
    lo = 0
    for i, n in enumerate(sizes):
        stream.push(_frame(wdf, rows, y, lo, lo + n), ts=100.0 + i)
        lo += n
    ts, _ = stream.poll(0.0)
    assert ts == 100.0
    stream.ack_trained()                  # chunk 0 trained
    stream.poll(0.0)                      # chunk 1 handed out, never acked: a crash
    replay = R(spill_dir=spill)
    assert replay.replayed == sum(sizes[1:])
    got, lo = [], sizes[0]
    while (item := replay.poll(0.0)) is not None:
        got.append((item[0], len(item[1])))
        for r in range(len(item[1])):
            cell = item[1]["features"][r]
            assert list(cell["i"]) == rows[lo + r]["i"]
            assert np.float32(cell["v"]).tolist() == rows[lo + r]["v"]
            assert float(item[1]["label"][r]) == float(y[lo + r])
        lo += len(item[1])
        replay.ack_trained()
    assert got == [(100.0 + i, n) for i, n in enumerate(sizes) if i > 0]
    assert replay.spill_pending() == 0
    assert W(spill_dir=spill).replayed == 0   # the reader's acks hold for the writer


def test_feedback_http_ingest_and_fault_refusal():
    stream = FeedbackStream()
    info = stream.serve(host="127.0.0.1", port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", info.port, timeout=5)
        body = json.dumps({"rows": [{"i": [1, 2], "v": [1.0, 0.5], "label": 1},
                                    {"i": [3], "v": [2.0], "label": 0}]})
        conn.request("POST", "/ingest", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["accepted"] == 2
        conn.request("GET", "/health")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["buffered_chunks"] == 1
        plan = FaultPlan().on("online.ingest", error=ConnectionError, at=(0,))
        with plan.armed():
            conn.request("POST", "/ingest", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
        assert resp.status == 503 and stream.depth() == 1
        assert plan.fires() == [("online.ingest", 0)]
        conn.request("POST", "/ingest", body=b'{"rows": []}',
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 503
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
        assert resp.status == 200 and "mmlspark_online_ingested_total" in text
        conn.close()
        _, chunk = stream.poll(0.0)
        assert len(chunk) == 2 and chunk["label"][1] == 0
    finally:
        stream.close()


def test_feedback_bound_sheds_oldest_and_pull_fault_keeps_the_chunk():
    stream = FeedbackStream(max_chunks=2)
    for tag in ("a", "b", "c"):
        stream.push(DataFrame.from_dict({"tag": np.array([tag], object)}))
    assert stream.depth() == 2 and stream.dropped == 1
    assert stream.poll(0.0)[1]["tag"][0] == "b"
    chunks = [DataFrame.from_dict({"x": np.array([i])}) for i in range(2)]
    pull = FeedbackStream.from_generator(lambda i: chunks[i] if i < 2 else None)
    plan = FaultPlan().on("online.ingest", error=ConnectionError, at=(0,))
    with plan.armed():
        with pytest.raises(ConnectionError):
            pull.poll(0.0)
        assert pull.poll(0.0)[1]["x"][0] == 0
    assert pull.ingested == 1


# -- the publisher and the loop -----------------------------------------------------


def test_publisher_zero_drop_rollback_and_pruning(tmp_path):
    rows, y = _rows(320, seed=1, loss="squared")
    trainer = OnlineTrainer(num_bits=BITS, loss="squared", device="cpu")
    store = ModelStore(device="cpu")
    pub = Publisher(model="vw-online", snapshot_dir=str(tmp_path), store=store,
                    keep_snapshots=2)
    trainer.step(_frame(DataFrame, rows, y, 0, 64))
    pub.publish(trainer, oldest_ts=time.monotonic() - 0.1)
    srv = WorkerServer()
    info = srv.start()
    disp = ModelDispatcher(srv, store, default_model="vw-online").start()
    statuses = []
    try:
        conn = http.client.HTTPConnection("127.0.0.1", info.port, timeout=5)
        payload = json.dumps({"i": [1, 2], "v": [0.5, -0.5]})

        def hit(n):
            for _ in range(n):
                conn.request("POST", "/", body=payload,
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                r.read()
                statuses.append(r.status)

        for lo in (64, 128, 192):
            hit(20)
            trainer.step(_frame(DataFrame, rows, y, lo, lo + 64))
            pub.publish(trainer, oldest_ts=time.monotonic() - 0.05)
        v = store.serving_version("vw-online")
        plan = FaultPlan().on("online.publish", error=OSError, at=(0,))
        with plan.armed():
            trainer.step(_frame(DataFrame, rows, y, 256, 320))
            with pytest.raises(PublishError):
                pub.publish(trainer)
            assert store.serving_version("vw-online") == v   # rolled back
            hit(20)
            pub.publish(trainer)
        hit(20)
        conn.close()
    finally:
        disp.stop()
        srv.stop()
    assert statuses == [200] * 100
    assert pub.publishes == 5 and pub.failures == 1
    assert store.serving_version("vw-online") != v
    assert len(glob.glob(str(tmp_path / "*.npz"))) <= 2


def test_loop_keeps_watermark_through_failed_publish(tmp_path):
    clock = {"t": 100.0}
    stream = FeedbackStream(time_fn=lambda: clock["t"])
    trainer = OnlineTrainer(num_bits=BITS, device="cpu")
    pub = Publisher(model="m", snapshot_dir=str(tmp_path), store=ModelStore(device="cpu"),
                    time_fn=lambda: clock["t"])
    loop = OnlineLearningLoop(stream, trainer, pub, publish_every_s=0.0, poll_s=0.0,
                              time_fn=lambda: clock["t"])
    rows, y = _rows(32, seed=4)
    stream.push(_frame(DataFrame, rows, y))
    plan = FaultPlan().on("online.publish", error=OSError, at=(0,))
    with plan.armed():
        clock["t"] = 101.0
        loop._tick()
    assert pub.failures == 1 and pub.publishes == 0
    clock["t"] = 105.0
    loop._tick()
    assert pub.publishes == 1
    assert pub.freshness_history[-1] == pytest.approx(5.0)
    assert loop.stats()["examples"] == 32


def test_publication_epoch_fence_rejects_a_stale_publisher(tmp_path):
    from mmlspark_tpu_torch.serving import fleet

    reg = fleet.run_registry(host="127.0.0.1", port=0)
    srv, q, wstop = fleet.run_worker(reg.url, model="echo", host="127.0.0.1",
                                     heartbeat_s=0.2, device="cpu")
    try:
        url = f"http://127.0.0.1:{srv.port}"
        rows, y = _rows(128, seed=7)
        winner_t = OnlineTrainer(num_bits=BITS, device="cpu")
        winner_t.step(_frame(DataFrame, rows, y, 0, 64))
        winner = Publisher(model="vw-online", snapshot_dir=str(tmp_path / "w"),
                           worker_urls=[url], epoch=2)
        assert winner.publish(winner_t)["targets"] == 1
        zombie_t = OnlineTrainer(num_bits=BITS, device="cpu")
        zombie_t.step(_frame(DataFrame, rows, y, 64, 128))
        zombie = Publisher(model="vw-online", snapshot_dir=str(tmp_path / "z"),
                           worker_urls=[url], epoch=1)
        with pytest.raises(PublishError):
            zombie.publish(zombie_t)
        assert zombie.publishes == 0 and zombie.failures == 1
        winner.set_epoch(1)
        assert winner.epoch == 2
    finally:
        wstop.stop()
        q.stop()
        srv.stop()
        reg.stop()


# -- fleet online -------------------------------------------------------------------


def _post(port: int, path: str, body: dict, timeout: float = 30.0) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _free_port() -> int:
    import socket

    s = socket.create_server(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _wait(cond, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


@pytest.mark.parametrize("mode", ["shared_file", "artifact_replicas_1"])
def test_fleet_online_role_end_to_end_on_the_cpu(mode, tmp_path):
    """``fleet online --device cpu`` as a process: ordered chunks POSTed to
    /ingest, the rostered worker serves each publication; the last
    snapshot equals one train_sparse_sgd over the rows in ingest order,
    bitwise, and the worker's replies the in-process scoring of it."""
    from mmlspark_tpu_torch import obs
    from mmlspark_tpu_torch.serving import fleet

    n, chunk = 640, 128
    rows, y = _rows(n, seed=9)
    held, _ = _rows(16, seed=10)
    reg = fleet.run_registry(host="127.0.0.1", port=0)
    srv, q, wstop = fleet.run_worker(reg.url, model="echo", host="127.0.0.1",
                                     heartbeat_s=0.2, device="cpu",
                                     artifact_dir=str(tmp_path / "worker_art"))
    port = _free_port()
    snaps = tmp_path / "snaps"
    argv = [sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet", "online",
            "--device", "cpu", "--registry", reg.url, "--host", "127.0.0.1",
            "--port", str(port), "--snapshot-dir", str(snaps), "--publish-every-s", "0.3",
            "--num-bits", str(BITS), "--heartbeat-s", "0.2", "--freshness-slo-ms", "10000"]
    if mode != "shared_file":
        argv += ["--artifact-dir", str(tmp_path / "online_art"), "--replicas", "1"]
    log = open(tmp_path / "online.log", "w")
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=ROOT))
    statuses = []
    try:
        _wait(lambda: reg.services("serving-online"), 60.0, "fleet online did not register")
        if mode != "shared_file":
            # the worker's artifact plane must be on the roster to replicate onto
            _wait(lambda: any(e.get("artifacts") is not None for e in reg.services("serving")),
                  30.0, "the worker's artifact plane is not rostered")
        for lo in range(0, n, chunk):
            body = {"rows": [{**rows[r], "label": int(y[r])} for r in range(lo, lo + chunk)]}
            status, _ = _post(port, "/ingest", body)
            assert status == 200
            for r in held[:4]:
                s, b = _post(srv.port, "/models/vw-online", r)
                statuses.append(s)

        def newest_meta():
            files = sorted(glob.glob(str(snaps / "vw-online-v*.npz")))
            if not files:
                return None, {}
            try:
                with np.load(files[-1]) as z:
                    return files[-1], json.loads(bytes(z["meta"]))
            except (OSError, ValueError, KeyError):
                return None, {}

        _wait(lambda: newest_meta()[1].get("examples") == n, 60.0,
              "no snapshot covers every ingested row")
        path, meta = newest_meta()
        version = int(path[-10:-4])
        on_metrics = f"http://127.0.0.1:{port}"
        _wait(lambda: obs.sum_samples(fleet.scrape_metrics(on_metrics) or {},
                                      "mmlspark_online_published_version_count") >= version,
              30.0, "the newest snapshot was not published")
        with np.load(path) as z:
            w = np.asarray(z["weights"], np.float32)
        idx, val, yy = _arrays(rows, y, "logistic")
        want = PL.train_sparse_sgd(idx, val, yy, None, BITS, batch=64, distributed=False,
                                   device="cpu")
        assert _bits_equal(w, want)
        replies = []
        for r in held:
            s, b = _post(srv.port, "/models/vw-online", r)
            statuses.append(s)
            replies.append(json.loads(b)["margin"])
        cells = [{"i": np.asarray(r["i"]), "v": np.asarray(r["v"], np.float32)} for r in held]
        hidx, hval = _append_constant(*pad_sparse_batch(cells), BITS)
        local = PL.predict_margin(hidx, hval, w, device="cpu")
        assert replies == [float(m) for m in local]
        parsed = fleet.scrape_metrics(on_metrics)
        assert obs.sum_samples(parsed, "mmlspark_online_examples_total") == n
        assert obs.sum_samples(parsed, "mmlspark_online_publish_failures_total") == 0
        assert meta["num_bits"] == BITS and meta["loss"] == "logistic"
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        wstop.stop()
        q.stop()
        srv.stop()
        reg.stop()
    # a request before the first publication may 404 (no vw-online yet);
    # after it, every reply across the publications is 200
    first = next((i for i, s in enumerate(statuses) if s == 200), len(statuses))
    assert statuses[first:] == [200] * (len(statuses) - first), open(tmp_path / "online.log").read()
    assert statuses[-len(held):] == [200] * len(held)


def test_fleet_online_without_a_card_fails_before_it_binds(tmp_path):
    port = _free_port()
    r = subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch.serving.fleet", "online",
                        "--worker-url", "http://127.0.0.1:9", "--host", "127.0.0.1",
                        "--port", str(port), "--snapshot-dir", str(tmp_path)],
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "online: ingest" not in r.stdout
