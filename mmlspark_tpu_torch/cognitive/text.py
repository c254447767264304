"""Text-analytics transformers (cognitive/TextAnalytics.scala analogue).

Wire format: Text Analytics v3 — POST ``{"documents": [{"id", "language",
"text"}]}``; response ``{"documents": [...], "errors": [...]}`` keyed by
document id. Rows are MINIBATCHED: up to ``batch_size`` (default 10)
documents travel per HTTP request and are flattened back to rows by id —
the reference's minibatch -> JSON -> flatten pipeline
(io/http/SimpleHTTPTransformer.scala:111-154; TextAnalytics.scala posts
document seqs the same way). Outputs are typed records from
cognitive/schemas.py (TextAnalyticsSchemas.scala's SparkBindings
analogue), with the schema reflected into output-column metadata.

The PyTorch port's copy of ``mmlspark_tpu.cognitive.text``: host code
over the port's ``io``, no device.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from mmlspark_tpu_torch.cognitive import schemas as S
from mmlspark_tpu_torch.cognitive.base import CognitiveServiceBase, ServiceParam
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.io.http_schema import response_to_json


class _TextAnalyticsBase(CognitiveServiceBase):
    text = ServiceParam("input text (value or column)")
    language = ServiceParam("ISO language hint", default={"value": "en"})
    batch_size = Param(
        "documents per HTTP request (TextAnalytics minibatching)",
        default=10, type_=int,
    )

    _path = ""
    _batchable = True

    # -- document assembly ----------------------------------------------------

    def _doc(self, vals: dict, doc_id: int) -> dict:
        return {
            "id": str(doc_id),
            "language": vals.get("language") or "en",
            "text": str(vals.get("text")),
        }

    def _build_request(self, vals: dict) -> Optional[dict]:
        if vals.get("text") is None:
            return None
        return self._post_json(
            vals, {"documents": [self._doc(vals, 0)]}, path=self._path
        )

    def _project_response(self, obj: Any) -> Any:
        docs = (obj or {}).get("documents") or []
        return S.from_json(self._response_schema, docs[0]) if docs else None

    # -- minibatching ---------------------------------------------------------

    def _batch_key(self, vals: dict) -> Optional[Any]:
        if vals.get("text") is None:
            return None  # skip row (the reference's shouldSkip)
        # rows sharing credentials share a request; url is stage-constant.
        # Wrapped in a tuple: a None credential is still a VALID group key,
        # distinct from the skip sentinel above
        return ("key", vals.get("subscription_key"))

    def _build_batch_request(self, vals_list: list) -> dict:
        docs = [self._doc(v, j) for j, v in enumerate(vals_list)]
        return self._post_json(vals_list[0], {"documents": docs}, path=self._path)

    def _split_batch_response(self, resp: Optional[dict], k: int) -> list:
        if resp is None:
            return [(None, None)] * k
        if resp["status_code"] // 100 != 2:
            err = {
                "status_code": resp["status_code"],
                "reason": resp["reason"],
                "entity": resp["entity"],
            }
            return [(None, err)] * k
        try:
            obj = response_to_json(resp) or {}
        except (ValueError, KeyError, TypeError) as e:
            err = {"status_code": resp["status_code"], "reason": f"parse error: {e}"}
            return [(None, err)] * k
        docs = {str(d.get("id")): d for d in obj.get("documents") or []}
        doc_errs = {str(e.get("id")): e for e in obj.get("errors") or []}
        out = []
        for j in range(k):
            d = docs.get(str(j))
            if d is not None:
                out.append((S.from_json(self._response_schema, d), None))
            elif str(j) in doc_errs:
                out.append(
                    (None, {"status_code": 200, "reason": json.dumps(doc_errs[str(j)])})
                )
            else:
                out.append((None, None))
        return out


class TextSentiment(_TextAnalyticsBase):
    """Sentiment per document (TextSentiment.scala; /sentiment)."""

    _path = "/text/analytics/v3.0/sentiment"
    _response_schema = S.SentimentDocument


class LanguageDetector(_TextAnalyticsBase):
    """Detected language (LanguageDetector; /languages). The v3 wire format
    nests text only, no language hint."""

    _path = "/text/analytics/v3.0/languages"
    _response_schema = S.LanguageDocument

    def _doc(self, vals: dict, doc_id: int) -> dict:
        return {"id": str(doc_id), "text": str(vals.get("text"))}


class EntityDetector(_TextAnalyticsBase):
    """Named-entity recognition (EntityDetector; /entities/recognition/general)."""

    _path = "/text/analytics/v3.0/entities/recognition/general"
    _response_schema = S.EntitiesDocument


class NER(EntityDetector):
    """Named-entity recognition (NERV2/NER in TextAnalytics.scala:217-227;
    the v3 wire format unifies it with EntityDetector's endpoint — this is
    the same stage under the reference's other registry name)."""


class KeyPhraseExtractor(_TextAnalyticsBase):
    """Key-phrase extraction (KeyPhraseExtractor; /keyPhrases)."""

    _path = "/text/analytics/v3.0/keyPhrases"
    _response_schema = S.KeyPhraseDocument
