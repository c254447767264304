"""Computer-vision transformers (cognitive/ComputerVision.scala analogue).

Wire format: Computer Vision v2 — POST an image by URL (JSON ``{"url"}``)
or raw bytes (``application/octet-stream``), feature selection via query
string.

The PyTorch port's copy of ``mmlspark_tpu.cognitive.vision``: host code
over the port's ``io``, no device.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from mmlspark_tpu_torch.cognitive import schemas as S
from mmlspark_tpu_torch.cognitive.base import CognitiveServiceBase, ServiceParam
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.io.http_schema import HTTPRequestData


class _VisionBase(CognitiveServiceBase):
    image_url = ServiceParam("image URL (value or column)")
    image_bytes = ServiceParam("raw image bytes (value or column)")

    _path = ""

    def _query(self, vals: dict) -> str:
        return ""

    def _image_request(self, vals: dict, path: Optional[str] = None) -> Optional[dict]:
        query = self._query(vals)
        url = self.get_or_fail("url").rstrip("/") + (
            self._path if path is None else path
        ) + (f"?{query}" if query else "")
        data = vals.get("image_bytes")
        if data is not None:
            return HTTPRequestData(
                url, "POST",
                self._headers(vals, content_type="application/octet-stream"),
                bytes(data),
            )
        img_url = vals.get("image_url")
        if img_url is None:
            return None
        return HTTPRequestData(
            url, "POST", self._headers(vals), json.dumps({"url": str(img_url)})
        )

    def _build_request(self, vals: dict) -> Optional[dict]:
        return self._image_request(vals)


class AnalyzeImage(_VisionBase):
    """Tags/categories/description/faces for an image (AnalyzeImage;
    /vision/v2.0/analyze)."""

    _path = "/vision/v2.0/analyze"
    _response_schema = S.AnalyzeImageResponse
    visual_features = ServiceParam(
        "features to compute", default={"value": ["Categories", "Tags", "Description"]}
    )
    details = ServiceParam("detail domains (Celebrities/Landmarks)")
    language = ServiceParam("response language", default={"value": "en"})

    def _query(self, vals: dict) -> str:
        parts = []
        if vals.get("visual_features"):
            parts.append("visualFeatures=" + ",".join(vals["visual_features"]))
        if vals.get("details"):
            parts.append("details=" + ",".join(vals["details"]))
        parts.append("language=" + (vals.get("language") or "en"))
        return "&".join(parts)


class OCR(_VisionBase):
    """Printed-text OCR (OCR.scala; /vision/v2.0/ocr)."""

    _path = "/vision/v2.0/ocr"
    _response_schema = S.OCRResponse
    detect_orientation = ServiceParam("detect text orientation", default={"value": True})
    language = ServiceParam("BCP-47 language", default={"value": "unk"})

    def _query(self, vals: dict) -> str:
        return (
            f"language={vals.get('language') or 'unk'}"
            f"&detectOrientation={str(bool(vals.get('detect_orientation'))).lower()}"
        )


class RecognizeText(_VisionBase):
    """Async printed/handwritten text recognition
    (RecognizeText, ComputerVision.scala:215-262; /vision/v2.0/recognizeText).

    The service's wire contract is ASYNC: the POST answers 202 with an
    ``Operation-Location`` header, and the result is GET-polled from that
    URL until ``status`` leaves running/notStarted (the reference's
    ``maxPollingRetries``/``pollingDelay`` handler loop). The whole
    POST-then-poll sequence runs inside the per-request handler (the
    ``_wrap_handler`` hook), so rows poll CONCURRENTLY on the base's
    thread pool and reuse the stage's configured retry handler and the
    request's own resolved auth headers."""

    _path = "/vision/v2.0/recognizeText"
    _response_schema = S.RecognizeTextResponse
    mode = ServiceParam(
        "'Printed' or 'Handwritten'", default={"value": "Printed"}
    )
    # plain ints, as in the reference (IntParam maxPollingRetries /
    # pollingDelay) — they configure the stage, not a per-row value
    max_polling_retries = Param("poll attempts", default=1000, type_=int)
    polling_delay_ms = Param("delay between polls (ms)", default=300, type_=int)

    def _query(self, vals: dict) -> str:
        return f"mode={vals.get('mode') or 'Printed'}"

    def _wrap_handler(self, handler_fn: Any) -> Any:
        import time as _time

        from mmlspark_tpu_torch.io.http_schema import (
            HTTPRequestData,
            HTTPResponseData,
            response_to_json,
        )

        retries = max(int(self.get("max_polling_retries")), 1)
        delay_s = int(self.get("polling_delay_ms")) / 1000.0

        def wrapped(req: dict) -> dict:
            resp = handler_fn(req)
            if resp is None or resp["status_code"] not in (200, 202):
                return resp
            op_url = next(
                (v for k, v in (resp.get("headers") or {}).items()
                 if k.lower() == "operation-location"),
                None,
            )
            if not op_url:
                return HTTPResponseData(
                    0,
                    reason=(
                        f"{resp['status_code']} without "
                        "Operation-Location header"
                    ),
                )
            # the ORIGINAL request's resolved headers carry this row's
            # auth (column-bound subscription keys included)
            headers = {
                k: v for k, v in (req.get("headers") or {}).items()
                if k.lower() != "content-type"
            }
            last_status = ""
            for _ in range(retries):
                pr = handler_fn(HTTPRequestData(op_url, "GET", headers))
                if pr["status_code"] // 100 != 2:
                    return pr
                try:
                    body = response_to_json(pr) or {}
                except (ValueError, KeyError, TypeError) as e:
                    return HTTPResponseData(0, reason=f"poll parse error: {e}")
                last_status = str(body.get("status", "")).lower()
                if last_status not in ("running", "notstarted", "not started", ""):
                    if last_status != "succeeded":
                        return HTTPResponseData(
                            0,
                            reason=f"recognition did not succeed: {body.get('status')}",
                        )
                    return pr  # the final response body IS the result
                _time.sleep(delay_s)
            return HTTPResponseData(
                0, reason=f"polling exhausted (last status: {last_status!r})"
            )

        return wrapped


class RecognizeDomainSpecificContent(_VisionBase):
    """Domain model analysis (celebrities/landmarks)
    (RecognizeDomainSpecificContent; /vision/v2.0/models/{model}/analyze)."""

    model = ServiceParam("domain model name", default={"value": "celebrities"})
    _response_schema = S.DomainModelResponse

    def _build_request(self, vals: dict) -> Optional[dict]:
        return self._image_request(
            vals, path=f"/vision/v2.0/models/{vals.get('model')}/analyze"
        )


class GenerateThumbnails(_VisionBase):
    """Smart-cropped thumbnail bytes (GenerateThumbnails;
    /vision/v2.0/generateThumbnail)."""

    _path = "/vision/v2.0/generateThumbnail"
    _binary_response = True
    width = ServiceParam("thumbnail width", default={"value": 64})
    height = ServiceParam("thumbnail height", default={"value": 64})
    smart_cropping = ServiceParam("smart cropping", default={"value": True})

    def _query(self, vals: dict) -> str:
        return (
            f"width={int(vals.get('width') or 64)}&height={int(vals.get('height') or 64)}"
            f"&smartCropping={str(bool(vals.get('smart_cropping'))).lower()}"
        )


class TagImage(_VisionBase):
    """Image tags (TagImage; /vision/v2.0/tag)."""

    _path = "/vision/v2.0/tag"
    _response_schema = S.TagImagesResponse


class DescribeImage(_VisionBase):
    """Natural-language captions (DescribeImage; /vision/v2.0/describe)."""

    _path = "/vision/v2.0/describe"
    _response_schema = S.DescribeImageResponse
    max_candidates = ServiceParam("number of caption candidates", default={"value": 1})

    def _query(self, vals: dict) -> str:
        return f"maxCandidates={int(vals.get('max_candidates') or 1)}"
