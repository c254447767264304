"""The port's HTTP on DataFrames (``io/{http_transformer,parsers,powerbi,
shared}.py``) against the JAX package's, on the CPU.

Both packages talk to the JAX package's own mock server
(``tests/test_io.py``'s ``_Handler`` and ``server`` fixture, imported
read-only). Outputs must equal row for row: requests exactly, responses
but for their ``Date`` header (each reply stamps its own second).
"""

from __future__ import annotations

import json
import pickle
import threading
import time

import numpy as np
import pytest

import mmlspark_tpu as J
import mmlspark_tpu.io as JIO
from mmlspark_tpu.io import parsers as JP
from mmlspark_tpu.stages.batching import FixedMiniBatchTransformer as JBatcher

import mmlspark_tpu_torch as P
import mmlspark_tpu_torch.io as PIO
from mmlspark_tpu_torch.io import parsers as PP
from mmlspark_tpu_torch.io.shared import SharedSingleton, SharedVariable
from mmlspark_tpu_torch.stages.batching import FixedMiniBatchTransformer

from test_io import _Handler, server  # noqa: F401  the reference's mock and fixture


def _resp(r):
    """A response row without its ``Date`` header."""
    if r is None:
        return None
    return {**r, "headers": {k: v for k, v in r["headers"].items() if k != "Date"}}


def _rows(col) -> list:
    return [_resp(r) if isinstance(r, dict) and "status_code" in r else r for r in col]


def _both(cols: dict, parts: int = 2) -> tuple:
    return (J.DataFrame.from_dict(cols, num_partitions=parts),
            P.DataFrame.from_dict(cols, num_partitions=parts))


def _requests(mod, url: str, n: int = 6) -> np.ndarray:
    reqs = np.empty(n, dtype=object)
    for i in range(n):
        reqs[i] = mod.HTTPRequestData(url, "POST", {"Content-Type": "application/json"},
                                      json.dumps({"x": i}))
    return reqs


def test_http_transformer_equals_jax(server):  # noqa: F811
    jdf = J.DataFrame.from_dict({"req": _requests(JIO, server + "/double"), "i": np.arange(6)},
                                num_partitions=2)
    pdf = P.DataFrame.from_dict({"req": _requests(PIO, server + "/double"), "i": np.arange(6)},
                                num_partitions=2)
    want = JIO.HTTPTransformer(input_col="req", output_col="resp").transform(jdf)
    got = PIO.HTTPTransformer(input_col="req", output_col="resp").transform(pdf)
    assert got.columns == want.columns
    assert _rows(got["resp"]) == _rows(want["resp"])
    assert [json.loads(r["entity"])["value"] for r in got["resp"]] == [0, 2, 4, 6, 8, 10]
    kw = dict(input_col="req", output_col="resp")
    assert PIO.HTTPTransformer(**kw).pipeline_io() == JIO.HTTPTransformer(**kw).pipeline_io()


@pytest.mark.parametrize("concurrency", [1, 3, 8])
def test_http_transformer_keeps_its_concurrency_bound(concurrency):
    """At most ``concurrency`` requests of a partition are in flight, as
    in the JAX package (its thread pool of ``concurrency`` workers)."""
    def run(mod, frame):
        state = {"live": 0, "most": 0}
        lock = threading.Lock()

        def handler(req):
            with lock:
                state["live"] += 1
                state["most"] = max(state["most"], state["live"])
            time.sleep(0.02)
            with lock:
                state["live"] -= 1
            return mod.HTTPResponseData(200, req["entity"])

        reqs = np.empty(24, dtype=object)
        for i in range(24):
            reqs[i] = mod.HTTPRequestData("http://unused/", "POST", entity=str(i))
        t = mod.HTTPTransformer(input_col="req", output_col="resp", concurrency=concurrency)
        out = t.set(custom_handler=handler).transform(frame.from_dict({"req": reqs}))
        return state["most"], [r["entity"] for r in out["resp"]]

    (jmost, jout), (pmost, pout) = run(JIO, J.DataFrame), run(PIO, P.DataFrame)
    assert pout == jout == [str(i).encode() for i in range(24)]
    assert 1 <= pmost <= concurrency and 1 <= jmost <= concurrency
    if concurrency == 1:
        assert pmost == jmost == 1


def test_simple_http_transformer_equals_jax(server):  # noqa: F811
    jdf, pdf = _both({"x": np.arange(5, dtype=np.int64)})
    kw = dict(input_col="x", output_col="out", url=server + "/echo", concurrency=4)
    want = JIO.SimpleHTTPTransformer(**kw).transform(jdf)
    got = PIO.SimpleHTTPTransformer(**kw).transform(pdf)
    assert got.columns == want.columns
    assert list(got["out"]) == list(want["out"])
    assert [o["echo"] for o in got["out"]] == list(range(5))
    assert all(e is None for e in got["out_error"])
    assert PIO.SimpleHTTPTransformer(**kw).pipeline_io() == \
        JIO.SimpleHTTPTransformer(**kw).pipeline_io()


def test_simple_http_transformer_error_split_equals_jax(server):  # noqa: F811
    jdf, pdf = _both({"x": [1, 2]})
    kw = dict(input_col="x", output_col="out", url=server + "/fail",
              use_advanced_handler=False, error_col="errs")
    want = JIO.SimpleHTTPTransformer(**kw).transform(jdf)
    got = PIO.SimpleHTTPTransformer(**kw).transform(pdf)
    assert got.columns == want.columns
    assert list(got["out"]) == list(want["out"]) == [None, None]
    assert _rows(got["errs"]) == _rows(want["errs"])
    assert all(e["status_code"] == 400 for e in got["errs"])


def test_simple_http_transformer_flatten_equals_jax(server):  # noqa: F811
    jdf, pdf = _both({"x": np.arange(7, dtype=np.int64)}, parts=1)
    kw = dict(input_col="x", output_col="out", url=server + "/echo", flatten_output=True)
    want = JIO.SimpleHTTPTransformer(**kw).set(
        mini_batcher=JBatcher(batch_size=3)).transform(jdf)
    got = PIO.SimpleHTTPTransformer(**kw).set(
        mini_batcher=FixedMiniBatchTransformer(batch_size=3)).transform(pdf)
    assert got.count() == want.count() == 7
    assert got.columns == want.columns
    for c in got.columns:
        assert [np.asarray(v).tolist() if isinstance(v, np.ndarray) else v for v in got[c]] == \
            [np.asarray(v).tolist() if isinstance(v, np.ndarray) else v for v in want[c]], c
    assert PIO.SimpleHTTPTransformer(**kw).set(
        mini_batcher=FixedMiniBatchTransformer(batch_size=3)).pipeline_io() is None


def test_parsers_equal_jax(server):  # noqa: F811
    vals = [{"a": 1, "v": np.arange(2)}, {"a": np.int64(2), "b": b"raw", "t": (1.5, "s")}]
    jdf, pdf = _both({"x": vals}, parts=1)
    kw = dict(input_col="x", output_col="req", url=server + "/echo", headers={"X-K": "1"})
    jreq = JIO.JSONInputParser(**kw).transform(jdf)
    preq = PIO.JSONInputParser(**kw).transform(pdf)
    assert list(preq["req"]) == list(jreq["req"])
    jout = JIO.HTTPTransformer(input_col="req", output_col="resp").transform(jreq)
    pout = PIO.HTTPTransformer(input_col="req", output_col="resp").transform(preq)
    for jp, pp in [
        (JIO.StringOutputParser(), PIO.StringOutputParser()),
        (JIO.JSONOutputParser(), PIO.JSONOutputParser()),
        (JIO.JSONOutputParser(data_type=["echo", "nope"]),
         PIO.JSONOutputParser(data_type=["echo", "nope"])),
        (JIO.CustomOutputParser().set_udf(lambda r: r["status_code"]),
         PIO.CustomOutputParser().set_udf(lambda r: r["status_code"])),
    ]:
        kw = {"input_col": "resp", "output_col": "o"}
        want = jp.copy(kw).transform(jout)["o"]
        got = pp.copy(kw).transform(pout)["o"]
        assert list(got) == list(want), type(pp).__name__
    want = JIO.CustomInputParser(input_col="x", output_col="r").set_udf(
        lambda v: {"url": str(v["a"])}).transform(jdf)["r"]
    got = PIO.CustomInputParser(input_col="x", output_col="r").set_udf(
        lambda v: {"url": str(v["a"])}).transform(pdf)["r"]
    assert list(got) == list(want) == [{"url": "1"}, {"url": "2"}]


@pytest.mark.parametrize("v", [
    np.float32(1.5), np.arange(3), {"k": np.bool_(True)}, [np.int8(3), (b"\xff", "x")],
    None, "s", 7,
])
def test_to_jsonable_equals_jax(v):
    assert PP._to_jsonable(v) == JP._to_jsonable(v)


def test_powerbi_writer_equals_jax(server):  # noqa: F811
    cols = {"a": np.arange(7), "b": np.arange(7) * 1.5, "s": np.array(list("abcdefg"), object)}
    jdf, pdf = _both(cols)
    sent = []
    for mod, df in ((JIO, jdf), (PIO, pdf)):
        _Handler.seen.clear()
        resps = mod.PowerBIWriter.write(df, server + "/rows", minibatch_size=3, concurrency=1)
        assert len(resps) == 3
        sent.append([json.loads(b) for b in _Handler.seen])
        assert all(_resp(r) == _resp(resps[0]) and r["status_code"] == 200 for r in resps)
    assert sent[1] == sent[0]
    assert [r["a"] for batch in sent[1] for r in batch] == list(range(7))
    errs = []
    for mod, df in ((JIO, jdf), (PIO, pdf)):
        with pytest.raises(RuntimeError) as e:
            mod.PowerBIWriter.write(df, server + "/fail", minibatch_size=10)
        errs.append(str(e.value))
    assert errs[1] == errs[0]


def _const() -> dict:
    return {}


def test_shared_variable_and_singleton():
    calls = []
    sv = SharedVariable(lambda: calls.append(1) or "value")
    assert sv.get() == "value" and sv.get() == "value" and len(calls) == 1
    assert pickle.loads(pickle.dumps(SharedVariable(_const))).get() == {}
    SharedSingleton.invalidate("port-k")
    assert SharedSingleton("port-k", list).get() is SharedSingleton("port-k", list).get()
    SharedSingleton.invalidate("port-k")
    # the port's singletons are its own: a JAX-package key is another table
    from mmlspark_tpu.io.shared import SharedSingleton as JSingleton

    assert JSingleton("port-k", list).get() is not SharedSingleton("port-k", list).get()
