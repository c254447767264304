"""Speech-to-text transformers (cognitive/SpeechToText.scala +
SpeechToTextSDK.scala analogues).

``SpeechToText``: one-shot REST v1 — POST raw audio bytes (wav) with
language in the query; response JSON carries
``DisplayText``/``RecognitionStatus``.

``SpeechToTextSDK``: continuous recognition over audio streams. The
reference runs a Speech-SDK session fed by ``WavStream``/
``CompressedStream`` pull streams (SpeechToTextSDK.scala:204-249,367);
here the stream is windowed host-side (cognitive/audio.py), each
sample-aligned window is recognized via the same REST wire format, and
the per-row output is the ordered list of segment results.

The PyTorch port's copy of ``mmlspark_tpu.cognitive.speech``: host code
over the port's ``io``, no device.
"""

from __future__ import annotations

from typing import Any, Optional

from mmlspark_tpu_torch.cognitive import schemas as S
from mmlspark_tpu_torch.cognitive.audio import CompressedStream, WavStream
from mmlspark_tpu_torch.cognitive.base import CognitiveServiceBase, ServiceParam
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.io.http_schema import HTTPRequestData, response_to_json


class SpeechToText(CognitiveServiceBase):
    _response_schema = S.SpeechResponse

    audio_data = ServiceParam("raw audio bytes (value or column)")
    language = ServiceParam("recognition language", default={"value": "en-US"})
    format = ServiceParam("'simple' or 'detailed'", default={"value": "simple"})
    profanity = ServiceParam("masked|removed|raw", default={"value": "masked"})

    def _build_request(self, vals: dict) -> Optional[dict]:
        audio = vals.get("audio_data")
        if audio is None:
            return None
        query = (
            f"language={vals.get('language') or 'en-US'}"
            f"&format={vals.get('format') or 'simple'}"
            f"&profanity={vals.get('profanity') or 'masked'}"
        )
        url = (
            self.get_or_fail("url").rstrip("/")
            + "/speech/recognition/conversation/cognitiveservices/v1?" + query
        )
        headers = self._headers(vals, content_type="audio/wav; codecs=audio/pcm")
        return HTTPRequestData(url, "POST", headers, bytes(audio))


class SpeechToTextSDK(SpeechToText):
    """Continuous recognition over pull streams: segment the audio at
    phrase boundaries (energy VAD — what the reference SDK's session does
    between utterances, SpeechToTextSDK.scala:204-249), recognize each
    segment, and emit the ordered result list with every record's
    ``Offset``/``Duration`` REBASED to stream time (100-ns ticks from the
    start of the audio). Failed segments keep their position as ``None``
    placeholders so transcripts never look complete when audio was lost;
    every segment's error is kept with its offset.
    """

    window_seconds = Param(
        "max recognition segment length", default=15.0, type_=float,
        validator=lambda v: v > 0,
    )
    stream_format = Param(
        "'wav' (parsed + sample-aligned windows) or 'compressed' (opaque)",
        default="wav",
        validator=lambda v: v in ("wav", "compressed"),
    )
    segmentation = Param(
        "'vad' (phrase boundaries at energy dips, the SDK behavior) or "
        "'fixed' (plain fixed-length windows)",
        default="vad",
        validator=lambda v: v in ("vad", "fixed"),
    )
    min_silence_s = Param(
        "silence run length that ends a phrase (vad mode)",
        default=0.3, type_=float,
    )

    def _segments(self, audio: Any) -> list:
        """-> list of (wav_blob, offset_ticks, duration_ticks)."""
        if audio is None:
            return []
        data = bytes(audio)
        if self.get("stream_format") == "wav":
            try:
                stream: Any = WavStream(data)
            except ValueError:
                stream = CompressedStream(data)  # not RIFF: pass through
        else:
            stream = CompressedStream(data)
        win = self.get("window_seconds")
        if isinstance(stream, WavStream):
            if self.get("segmentation") == "vad":
                return stream.segments(
                    max_seconds=win, min_silence_s=self.get("min_silence_s")
                )
            return stream.fixed_segments(win)
        return [(w, 0, 0) for w in stream.windows(win)]

    def _build_requests(self, vals: dict) -> list:
        reqs = []
        for blob, off, dur in self._segments(vals.get("audio_data")):
            r = self._build_request({**vals, "audio_data": blob})
            if r is not None:
                # per-segment stream position rides on the request dict
                # (the HTTP sender only reads url/method/headers/entity);
                # _row_output_ctx rebases the service's window-relative
                # Offset with it
                r["_segment"] = {"offset_ticks": off, "duration_ticks": dur}
                reqs.append(r)
        return reqs

    # the output column holds the ordered per-segment record list, not a
    # single record — metadata must say so
    from typing import List as _List

    _response_schema = _List[S.SpeechResponse]

    def _row_output_ctx(self, resps: list, reqs: list) -> tuple:
        segs: list = []
        errors: list = []
        for w, resp in enumerate(resps):
            meta = (reqs[w] if w < len(reqs) else {}).get("_segment") or {}
            off = int(meta.get("offset_ticks") or 0)
            if resp is None:
                segs.append(None)
                continue
            if resp["status_code"] // 100 == 2:
                try:
                    rec = S.from_json(S.SpeechResponse, response_to_json(resp))
                    # the service reports Offset relative to the POSTED
                    # window; stream time = segment start + window offset
                    rec.Offset = off + int(rec.Offset or 0)
                    if rec.Duration is None and meta.get("duration_ticks"):
                        rec.Duration = int(meta["duration_ticks"])
                    segs.append(rec)
                    continue
                except (ValueError, KeyError, TypeError) as e:
                    errors.append({"window": w, "offset_ticks": off,
                                   "status_code": resp["status_code"],
                                   "reason": f"parse error: {e}"})
            else:
                errors.append({"window": w, "offset_ticks": off,
                               "status_code": resp["status_code"],
                               "reason": resp["reason"], "entity": resp["entity"]})
            segs.append(None)  # placeholder keeps segment positions aligned
        return segs, (errors or None)
