"""The port's serving worker against the JAX package's, on the CPU.

The same seeded requests go over HTTP to a JAX ``WorkerServer`` +
``ModelDispatcher`` over the JAX package's ``ModelStore`` and to the
port's (``device="cpu"``), each on an ephemeral port, every model loaded
from one spec by both packages' loaders; the replies are compared field by
field. Tolerances:

- ``echo``: the reply bodies byte for byte;
- ``gbdt:`` (one model string, written by the port and loaded by both):
  margins, predictions and probabilities bitwise (the trees replay in the
  JAX package's order, as ``tests/test_torch_port_boosting.py`` holds);
- ``vw:`` (one npz snapshot): bitwise at K <= 17 slots a row (16 indices
  and the Constant: XLA:CPU's margin sum then runs in the port's order;
  ``tests/test_torch_port_vw.py``'s ``WIDE_TOL`` covers wider rows);
- ``pipeline:`` (Featurize -> UDFTransformer(tanh 0.5 x) ->
  LogisticRegression, fitted by the JAX package, carried into the port):
  ``features`` bitwise; the UDF's output within 4 ulp (XLA's f32 ``tanh``
  and PyTorch's round differently); logits within 1e-5 * max |logit|
  (the 4 ulp, and the JAX package's ``x @ W + b``, which rounds by the row
  count of the batch, against the port's fixed-order head), probabilities
  within 1e-5, predictions equal except on rows whose top two logits lie
  within twice that tolerance;
- ``zoo:ResNet8_Digits``: the packaged checkpoint's pooled features within
  relative L2 2e-2 a request (the bf16 backbone: one rounded value that
  flips by a bf16 ulp spreads, as ``tests/test_torch_port_zoo.py`` allows).
"""

from __future__ import annotations

import contextlib
import http.client
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu as J
import mmlspark_tpu.models as JM
from mmlspark_tpu.featurize.featurize import Featurize as JFeaturize
from mmlspark_tpu.models.linear import LogisticRegression as JLogisticRegression
from mmlspark_tpu.serving import WorkerServer as JWorkerServer
from mmlspark_tpu.serving.modelstore import ModelDispatcher as JModelDispatcher
from mmlspark_tpu.serving.modelstore import ModelStore as JModelStore
from mmlspark_tpu.stages.basic import UDFTransformer as JUDFTransformer

from mmlspark_tpu_torch import PipelineModel
from mmlspark_tpu_torch.featurize import FeaturizeModel
from mmlspark_tpu_torch.models.gbdt import TrainConfig, train
from mmlspark_tpu_torch.models.linear import LogisticRegressionModel
from mmlspark_tpu_torch.serving import WorkerServer
from mmlspark_tpu_torch.serving.modelstore import ModelDispatcher, ModelStore
from mmlspark_tpu_torch.stages import UDFTransformer

TANH_ULP = 4
LOGIT_RTOL = 1e-5
PROB_ATOL = 1e-5
ZOO_L2 = 2e-2


@contextlib.contextmanager
def _worker(pkg: str, specs: dict, **port_loader_kw):
    """One worker of ``pkg`` serving ``specs`` ({name: spec}) on an
    ephemeral port; yields the port."""
    if pkg == "jax":
        store = JModelStore()
        srv = JWorkerServer()
    else:
        store = ModelStore(device="cpu", **port_loader_kw)
        srv = WorkerServer()
    for name, spec in specs.items():
        store.load(name, spec)
    info = srv.start()
    disp = (JModelDispatcher if pkg == "jax" else ModelDispatcher)(srv, store).start()
    try:
        yield info.port
    finally:
        disp.stop()
        srv.stop()


def _replies(specs: dict, name: str, bodies: list, **port_loader_kw) -> dict:
    """{pkg: [(status, body bytes)]} for ``bodies`` POSTed in order to
    ``/models/<name>`` of each package's worker."""
    out = {}
    for pkg in ("jax", "torch"):
        with _worker(pkg, specs, **port_loader_kw) as port:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            got = []
            for b in bodies:
                conn.request("POST", f"/models/{name}", body=b,
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                got.append((r.status, r.read()))
            conn.close()
        out[pkg] = got
    return out


def _all_200(replies: dict) -> tuple:
    for pkg, got in replies.items():
        assert [s for s, _ in got] == [200] * len(got), (pkg, got[:3])
    return ([json.loads(b) for _, b in replies["jax"]],
            [json.loads(b) for _, b in replies["torch"]])


def test_echo_replies_byte_equal():
    rng = np.random.default_rng(0)
    bodies = [json.dumps({"i": i, "x": rng.standard_normal(3).tolist(), "s": "é"}).encode()
              for i in range(8)] + [b"", b"[1, 2]"]
    got = _replies({"echo": "echo"}, "echo", bodies)
    assert got["torch"] == got["jax"]
    bad = _replies({"echo": "echo"}, "echo", [b"{not json"])
    assert [s for s, _ in bad["torch"]] == [s for s, _ in bad["jax"]] == [400]


@pytest.mark.parametrize("objective, num_class", [("binary", 1), ("multiclass", 3)])
def test_gbdt_margins_bitwise(tmp_path, objective, num_class):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((600, 6)).astype(np.float32)
    y = ((x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float64) if num_class == 1
         else (np.digitize(x[:, 0], [-0.4, 0.4])).astype(np.float64))
    booster = train(x, y, TrainConfig(objective=objective, num_class=num_class,
                                      num_iterations=6, num_leaves=7),
                    device="cpu")
    path = tmp_path / "m.gbdt.json"
    path.write_text(booster.to_model_string())
    q = rng.standard_normal((12, 6)).astype(np.float32)
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in q]
    bodies.append(json.dumps({"rows": q[:5].tolist()}).encode())
    jax_out, port_out = _all_200(_replies({"m": f"gbdt:{path}"}, "m", bodies))
    assert port_out == jax_out  # every float equal: the f32 margins bitwise
    assert "margin" in port_out[0] and len(port_out[-1]["rows"]) == 5


def _vw_rows(rng, n: int, bits: int) -> list:
    rows = []
    for _ in range(n):
        k = int(rng.integers(1, 17))  # 16 slots at most: K = 17 with the Constant
        rows.append({"i": rng.integers(0, 1 << bits, k).tolist(),
                     "v": rng.standard_normal(k).astype(np.float32).tolist()})
    return rows


@pytest.mark.parametrize("loss", ["logistic", "squared"])
def test_vw_margins_bitwise(tmp_path, loss):
    bits = 12
    rng = np.random.default_rng(2)
    w = rng.standard_normal(1 << bits).astype(np.float32)
    meta = json.dumps({"num_bits": bits, "loss": loss}).encode()
    path = tmp_path / "vw-online-v000003.npz"
    np.savez(path, weights=w, meta=np.frombuffer(meta, np.uint8))
    rows = _vw_rows(rng, 20, bits)
    bodies = [json.dumps(r).encode() for r in rows[:12]]
    bodies.append(json.dumps({"rows": rows[12:]}).encode())
    jax_out, port_out = _all_200(_replies({"vw-online": f"vw:{path}"}, "vw-online", bodies))
    assert port_out == jax_out
    assert len(port_out[-1]["rows"]) == 8


def jax_tanh_half(x):
    return jnp.tanh(x * jnp.float32(0.5))


def torch_tanh_half(x):
    return torch.tanh(x * 0.5)


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_pipeline_replies_within_tolerance(tmp_path):
    rng = np.random.default_rng(7)
    n = 512
    cols = {f"x{i}": rng.standard_normal(n) for i in range(4)}
    cols["vec"] = rng.standard_normal((n, 4)).astype(np.float32)
    cols["label"] = rng.integers(0, 3, n)
    inputs = [f"x{i}" for i in range(4)] + ["vec"]
    jmodel = J.Pipeline([
        JFeaturize(input_cols=inputs, output_col="features"),
        JUDFTransformer(input_col="features", output_col="fs", jit_compatible=True,
                        vector_udf=jax_tanh_half),
        JLogisticRegression(features_col="fs", label_col="label", max_iter=10),
    ]).fit(J.DataFrame.from_dict(cols))
    jfeat, _, jlr = jmodel.get("stages")
    params = {s: {k: v for k, _, v in st.iter_set_params()} for s, st in
              (("feat", jfeat), ("lr", jlr))}
    pmodel = PipelineModel(stages=[
        FeaturizeModel.from_jax_params(params["feat"]),
        UDFTransformer(input_col="features", output_col="fs", jit_compatible=True,
                       vector_udf=torch_tanh_half, device="cpu"),
        LogisticRegressionModel.from_jax_params(params["lr"], device="cpu"),
    ])
    warm = {c: (v[:4].tolist()) for c, v in cols.items() if c != "label"}
    for pkg, model in (("jax", jmodel), ("torch", pmodel)):
        model.save(str(tmp_path / pkg))
        (tmp_path / pkg / "warmup.json").write_text(json.dumps(warm))

    def row(i):
        return {**{f"x{k}": float(cols[f"x{k}"][i]) for k in range(4)},
                "vec": cols["vec"][i].tolist()}

    bodies = [json.dumps(row(i)).encode() for i in range(10)]
    bodies.append(json.dumps({"rows": [row(i) for i in range(10, 16)]}).encode())
    bodies.append(json.dumps({"cols": {c: [row(i)[c] for i in range(16, 19)]
                                       for c in row(0)}}).encode())
    replies = {}
    for pkg in ("jax", "torch"):
        with _worker(pkg, {"p": f"pipeline:{tmp_path / pkg}"}) as port:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            got = []
            for b in bodies:
                conn.request("POST", "/models/p", body=b)
                r = conn.getresponse()
                got.append((r.status, r.read()))
            replies[pkg] = got
    jax_out, port_out = _all_200(replies)

    def flat(out):
        rows = []
        for o in out:
            rows.extend(o["rows"] if "rows" in o else [o])
        return {c: np.asarray([r[c] for r in rows]) for c in rows[0]}

    want, got = flat(jax_out), flat(port_out)
    assert sorted(got) == sorted(want) == [
        "features", "fs", "prediction", "probability", "raw_prediction"]
    assert len(got["prediction"]) == 19
    np.testing.assert_array_equal(got["features"], want["features"])
    assert int(_ulp(got["fs"], want["fs"]).max()) <= TANH_ULP
    tol = LOGIT_RTOL * float(np.abs(want["raw_prediction"]).max())
    assert float(np.abs(got["raw_prediction"] - want["raw_prediction"]).max()) <= tol
    assert float(np.abs(got["probability"] - want["probability"]).max()) <= PROB_ATOL
    top2 = np.sort(want["raw_prediction"], axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * tol
    assert not ((got["prediction"] != want["prediction"]) & ~near_tie).any()


def test_zoo_features_within_tolerance(tmp_path, monkeypatch):
    class TmpZooFeaturizer(JM.ImageFeaturizer):
        """The JAX package's featurizer with its zoo under the test's
        directory (its loader names no zoo; the default one is under
        ``$HOME``)."""

        def __init__(self, **kw):
            super().__init__(repo_dir=str(tmp_path / "jax_zoo"), **kw)

    monkeypatch.setattr(JM, "ImageFeaturizer", TmpZooFeaturizer)
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    bodies = [json.dumps({"image": im.tolist()}).encode() for im in imgs]
    bodies.append(json.dumps({"image": [[1, 2, 3]]}).encode())  # 2-D: not an image
    replies = _replies({"ResNet8_Digits": "zoo:ResNet8_Digits"}, "ResNet8_Digits", bodies,
                       zoo_dir=str(tmp_path / "port_zoo"))
    assert replies["torch"][-1][0] == 400  # the port validates the image's shape
    replies = {pkg: got[:-1] for pkg, got in replies.items()}
    jax_out, port_out = _all_200(replies)
    for j, p in zip(jax_out, port_out):
        want, got = np.asarray(j["features"]), np.asarray(p["features"])
        assert got.shape == want.shape == (64,)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= ZOO_L2
