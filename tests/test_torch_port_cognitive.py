"""The port's ``cognitive/`` against the JAX package's, on the CPU.

Every cognitive stage runs in both packages against the JAX package's own
mock services, imported read-only: ``tests/test_cognitive.py``'s
``_Mock`` and ``svc`` fixture, ``tests/test_audio.py``'s ``make_wav``,
``_SpeechHandler`` and ``_OffsetHandler``. Outputs must equal row for row
(typed records compared by type name and fields), so must the column
metadata and every request the services saw (path, body, headers; in any
order, as a partition's requests run concurrently).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import HTTPServer

import numpy as np
import pytest

import mmlspark_tpu as J
import mmlspark_tpu.cognitive as JC
from mmlspark_tpu.cognitive import audio as JA

import mmlspark_tpu_torch as P
import mmlspark_tpu_torch.cognitive as PC
from mmlspark_tpu_torch.cognitive import audio as PA
from mmlspark_tpu_torch.cognitive import schemas as PS

from test_audio import _OffsetHandler, _SpeechHandler, make_wav
from test_cognitive import _Mock, svc  # noqa: F401  the reference's mock service and fixture


def plain(v):
    """A record, list or array as plain values, records tagged by type."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)})
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, plain(v.tolist()))
    return v


def _obj(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


TEXTS = {"text": _obj(["good day", "awful day"])}
URLS = {"url": _obj(["http://img/1.jpg"])}
IDS = {"ids": _obj([["f-1", "f-2"]]), "fid": _obj(["f-1"])}
SERIES = {"series": _obj([[{"timestamp": f"2026-01-0{i + 1}T00:00:00Z", "value": float(i)}
                           for i in range(4)]])}

# (case id, stage builder over a package's ``cognitive`` module, input columns, partitions)
CASES = [
    ("sentiment", lambda m, u: m.TextSentiment(url=u, output_col="sentiment")
     .set_col("text", "text"), TEXTS, 2),
    ("sentiment_literal_key", lambda m, u: m.TextSentiment(
        url=u, output_col="s", subscription_key="k-123").set(text="good stuff"),
     {"i": np.array([1, 2, 3])}, 1),
    ("sentiment_bad_key", lambda m, u: m.TextSentiment(
        url=u, output_col="s", subscription_key="bad-key", use_advanced_handler=False)
     .set_col("text", "text"), TEXTS, 2),
    ("sentiment_none_rows", lambda m, u: m.TextSentiment(url=u, output_col="s")
     .set_col("text", "text"), {"text": _obj(["good", None])}, 1),
    ("sentiment_minibatched", lambda m, u: m.TextSentiment(
        url=u, subscription_key="k", batch_size=4).set_col("text", "text")
     .set(output_col="sent"),
     {"text": _obj(["good a", "bad b", "good c", None, "bad d", "good e"])}, 1),
    ("sentiment_document_error", lambda m, u: m.TextSentiment(
        url=u, subscription_key="k", batch_size=8).set_col("text", "text")
     .set(output_col="sent"), {"text": _obj(["good a", "BOOM", "bad c"])}, 1),
    ("language", lambda m, u: m.LanguageDetector(url=u, output_col="lang")
     .set_col("text", "text"), TEXTS, 2),
    ("key_phrases", lambda m, u: m.KeyPhraseExtractor(url=u, output_col="kp")
     .set_col("text", "text"), TEXTS, 2),
    ("entities", lambda m, u: m.EntityDetector(url=u, output_col="e")
     .set_col("text", "text"), TEXTS, 2),
    ("ner", lambda m, u: m.NER(url=u, subscription_key="k", output_col="ents")
     .set_col("text", "text"), TEXTS, 2),
    ("analyze_url", lambda m, u: m.AnalyzeImage(url=u, output_col="a")
     .set_col("image_url", "url"), URLS, 1),
    ("analyze_bytes", lambda m, u: m.AnalyzeImage(url=u, output_col="a")
     .set_col("image_bytes", "img"), {"img": _obj([b"rawjpegbytes"])}, 1),
    ("ocr", lambda m, u: m.OCR(url=u, output_col="o").set_col("image_url", "url"), URLS, 1),
    ("thumbnail", lambda m, u: m.GenerateThumbnails(url=u, output_col="t", width=32, height=32)
     .set_col("image_url", "url"), URLS, 1),
    ("tag", lambda m, u: m.TagImage(url=u, output_col="t").set_col("image_url", "url"), URLS, 1),
    ("describe", lambda m, u: m.DescribeImage(url=u, output_col="d")
     .set_col("image_url", "url"), URLS, 1),
    ("domain", lambda m, u: m.RecognizeDomainSpecificContent(url=u, output_col="c")
     .set_col("image_url", "url"), URLS, 1),
    ("recognize_text", lambda m, u: m.RecognizeText(
        url=u, subscription_key="k", output_col="rt", polling_delay_ms=10)
     .set_col("image_url", "img"), {"img": _obj(["http://x/a.png", "http://x/b.png"])}, 1),
    ("detect_face", lambda m, u: m.DetectFace(url=u, output_col="faces")
     .set_col("image_url", "url"), URLS, 1),
    ("verify", lambda m, u: m.VerifyFaces(url=u, output_col="v").set_col("face_id1", "a")
     .set_col("face_id2", "b"), {"a": _obj(["f-1", "f-1"]), "b": _obj(["f-1", "f-2"])}, 1),
    ("identify", lambda m, u: m.IdentifyFaces(url=u, output_col="p", person_group_id="g")
     .set_col("face_ids", "ids"), IDS, 1),
    ("group", lambda m, u: m.GroupFaces(url=u, output_col="g").set_col("face_ids", "ids"),
     IDS, 1),
    ("find_similar", lambda m, u: m.FindSimilarFace(url=u, output_col="s")
     .set_col("face_id", "fid").set_col("face_ids", "ids"), IDS, 1),
    ("last_anomaly", lambda m, u: m.DetectLastAnomaly(url=u, output_col="la")
     .set_col("series", "series"), SERIES, 1),
    ("anomalies", lambda m, u: m.DetectAnomalies(url=u, output_col="ea")
     .set_col("series", "series"), SERIES, 1),
    ("speech", lambda m, u: m.SpeechToText(url=u, output_col="txt")
     .set_col("audio_data", "audio"), {"audio": _obj([b"RIFFfakewav"])}, 1),
    ("bing", lambda m, u: m.BingImageSearch(url=u, output_col="imgs").set_col("query", "q"),
     {"q": _obj(["tpu chip"])}, 1),
]


def _requests(log: list) -> list:
    return [(p, {k: v for k, v in h.items() if k != "Host"}, raw) for p, h, raw in log]


def _run_both(build, cols: dict, parts: int, url: str) -> tuple:
    outs = []
    for mod, frame in ((JC, J.DataFrame), (PC, P.DataFrame)):
        _Mock.log.clear()
        _Mock.poll_counts.clear()
        out = build(mod, url).transform(frame.from_dict(cols, num_partitions=parts))
        outs.append((out, _requests(_Mock.log), dict(_Mock.poll_counts)))
    return outs


@pytest.mark.parametrize("case,build,cols,parts", CASES, ids=[c[0] for c in CASES])
def test_service_equals_jax(svc, case, build, cols, parts):  # noqa: F811
    (want, jreq, jpolls), (got, preq, ppolls) = _run_both(build, cols, parts, svc)
    assert got.columns == want.columns
    for c in got.columns:
        assert [plain(v) for v in got[c]] == [plain(v) for v in want[c]], c
        assert got.column_metadata(c) == want.column_metadata(c), c
    # a partition's requests run concurrently: the services saw the same
    # requests, in any order, and polled each operation as often
    assert sorted(map(repr, preq)) == sorted(map(repr, jreq))
    assert sorted(ppolls.values()) == sorted(jpolls.values())


def test_every_registered_cognitive_stage_is_exercised():
    from mmlspark_tpu_torch.core.pipeline import STAGE_REGISTRY

    names = {n for n, c in STAGE_REGISTRY.items()
             if c.__module__.startswith("mmlspark_tpu_torch.cognitive.")}
    built = {type(b(PC, "http://x")).__name__ for _, b, _, _ in CASES}
    assert names - built == {"CognitiveServiceBase", "SpeechToTextSDK"}  # both below
    base = PC.CognitiveServiceBase(url="http://x", output_col="o")
    jbase = JC.CognitiveServiceBase(url="http://x", output_col="o")
    assert base.explain_params() == jbase.explain_params()


def test_typed_records_and_metadata(svc):  # noqa: F811
    out = PC.TextSentiment(url=svc, subscription_key="k").set_col("text", "text").set(
        output_col="sent").transform(P.DataFrame.from_dict(TEXTS))
    rec = list(out["sent"])[0]
    assert isinstance(rec, PS.SentimentDocument)
    assert rec.sentiment == rec["sentiment"] == "positive"
    assert rec.confidenceScores.positive == 0.9
    assert out.column_metadata("sent")["response_schema"] == "SentimentDocument"


def test_azure_search_writer_equals_jax(svc):  # noqa: F811
    cols = {"id": ["1", "2"], "score": [0.5, 0.9]}
    sent = []
    for mod, frame in ((JC, J.DataFrame), (PC, P.DataFrame)):
        _Mock.log.clear()
        resps = mod.AzureSearchWriter.write(frame.from_dict(cols), svc, "myindex", key="k",
                                            batch_size=10)
        assert len(resps) == 1
        sent.append(_requests(_Mock.log))
    assert sent[1] == sent[0]
    assert json.loads(sent[1][-1][2])["value"][0]["@search.action"] == "upload"


def test_search_index_lifecycle_equals_jax(svc):  # noqa: F811
    idx = {"name": "docs-1", "fields": [
        {"name": "id", "type": "Edm.String", "key": True},
        {"name": "body", "type": "Edm.String", "searchable": True},
        {"name": "rank", "type": "Edm.Int32"}]}
    for mod in (JC, PC):
        _Mock.created_indexes.clear()
        assert mod.SearchIndex.create_if_none_exists(svc, idx, key="k") is True
        assert mod.SearchIndex.get_existing(svc, key="k") == ["docs-1"]
        assert mod.SearchIndex.create_if_none_exists(svc, idx, key="k") is False
        assert _Mock.created_indexes == ["docs-1"]


@pytest.mark.parametrize("index", [
    {"name": "i", "fields": [{"name": "a", "type": "Edm.String"}]},
    {"name": "i", "fields": [{"name": "id", "type": "Edm.String", "key": True},
                             {"name": "x", "type": "Edm.Float"}]},
    {"name": "i", "fields": [{"name": "id", "type": "Edm.String", "key": True},
                             {"name": "n", "type": "Edm.Int32", "searchable": True}]},
])
def test_search_index_validation_equals_jax(index):
    msgs = []
    for mod in (JC, PC):
        with pytest.raises(ValueError) as e:
            mod.SearchIndex.validate_index(dict(index))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def _serve(handler) -> HTTPServer:
    srv = HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.parametrize("handler,kw,seconds", [
    (_SpeechHandler, dict(window_seconds=1.0, concurrency=1), 2.5),
    (_SpeechHandler, dict(stream_format="compressed"), None),
    (_OffsetHandler, dict(window_seconds=1.0, concurrency=1), 2.5),
    (None, {}, 0.5),  # a dead endpoint: the error column
])
def test_speech_sdk_equals_jax(handler, kw, seconds):
    blob = _obj([make_wav(seconds) if seconds else b"\x00opaque-compressed"])
    outs, bodies = [], []
    for mod, frame in ((JC, J.DataFrame), (PC, P.DataFrame)):
        srv = _serve(handler) if handler else None
        _SpeechHandler.calls = []
        url = f"http://127.0.0.1:{srv.server_port}" if srv else "http://127.0.0.1:9"
        try:
            out = mod.SpeechToTextSDK(url=url, output_col="text", use_advanced_handler=False,
                                      **kw).set_col("audio_data", "audio").transform(
                frame.from_dict({"audio": blob}))
        finally:
            if srv:
                srv.shutdown()
        outs.append(out)
        bodies.append(list(_SpeechHandler.calls))
    want, got = outs
    assert got.columns == want.columns
    for c in got.columns:
        assert [plain(v) for v in got[c]] == [plain(v) for v in want[c]], c
    assert bodies[1] == bodies[0]


def _tone_silence_tone(mod, rate=16000) -> bytes:
    t1 = np.sin(2 * np.pi * 440 * np.arange(rate) / rate)
    t2 = np.sin(2 * np.pi * 220 * np.arange(rate) / rate)
    pcm = (np.concatenate([t1, np.zeros(rate // 2), t2]) * 20000).astype(np.int16)
    return mod.wrap_wav(pcm.tobytes(), mod.WavFormat(channels=1, sample_rate=rate,
                                                     bits_per_sample=16))


def test_audio_streams_equal_jax():
    for blob in (make_wav(3.5), make_wav(1.0, channels=2), _tone_silence_tone(JA)):
        js, ps = JA.WavStream(blob), PA.WavStream(blob)
        assert dataclasses.asdict(ps.format) == dataclasses.asdict(js.format)
        assert ps.pcm == js.pcm and ps.duration_seconds == js.duration_seconds
        for w in (1.0, 0.25):
            assert list(ps.windows(w)) == list(js.windows(w))
        assert list(ps.pull(3200)) == list(js.pull(3200))
        for cap in (15.0, 0.6):
            assert ps.segments(max_seconds=cap, min_silence_s=0.3) == \
                js.segments(max_seconds=cap, min_silence_s=0.3)
    assert _tone_silence_tone(PA) == _tone_silence_tone(JA)
    data = b"\xff\xfbOGGOPUS"
    assert list(PA.CompressedStream(data).windows(1.0)) == \
        list(JA.CompressedStream(data).windows(1.0)) == [data]
    for mod in (JA, PA):
        with pytest.raises(ValueError):
            mod.WavStream(b"not audio at all")
