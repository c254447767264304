"""Typed response schemas for the cognitive services — the SparkBindings
layer (core/schema/SparkBindings.scala:13-46 turns case classes into Spark
struct codecs; cognitive/TextAnalyticsSchemas.scala, Face.scala and
AnomalyDetectorSchemas.scala declare one response case class per service).

Here each service's response is a ``@schema`` dataclass; :func:`from_json`
is the recursive JSON -> record codec (Optional/List/nested records from
type hints, tolerant of missing and extra keys the way spray-json's
``Option`` fields are). Records are dataclasses that ALSO support mapping
access (``rec["sentiment"]`` == ``rec.sentiment``) so downstream code that
handled raw dicts keeps working, and :func:`schema_fields` reflects a
record type into column metadata (the StructType the reference attaches).

The PyTorch port's copy of ``mmlspark_tpu.cognitive.schemas``: host
code, no device.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, List, Optional


class Record:
    """Mixin: dataclass with dict-style read access + dict round-trip."""

    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def keys(self):
        return [f.name for f in dataclasses.fields(self)]

    def to_dict(self) -> dict:
        """Record -> plain JSON-style dict (drops None optionals)."""

        def conv(v: Any) -> Any:
            if isinstance(v, Record):
                return v.to_dict()
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return {
            f.name: conv(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }


def schema(cls):
    """Class decorator: a cognitive response record (dataclass + Record)."""
    return dataclass(cls)


def _strip_optional(tp: Any) -> Any:
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_json(cls: Any, obj: Any) -> Any:
    """Parse a JSON value into ``cls`` (a Record dataclass, List[...] of
    them, or a primitive). Missing fields become their defaults (None for
    optionals); unknown response keys are ignored — service API additions
    must not break parsing (the reference's spray-json Option tolerance)."""
    cls = _strip_optional(cls)
    if obj is None:
        return None
    origin = typing.get_origin(cls)
    if origin in (list, List):
        (item_t,) = typing.get_args(cls) or (Any,)
        if not isinstance(obj, list):
            return []
        return [from_json(item_t, x) for x in obj]
    if dataclasses.is_dataclass(cls):
        if not isinstance(obj, dict):
            return None
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in obj:
                kwargs[f.name] = from_json(hints.get(f.name, Any), obj[f.name])
        return cls(**kwargs)
    return obj  # primitive / Any: pass through


def schema_fields(cls: Any) -> list:
    """Record type -> column-metadata field list: [{"name", "type"}]."""
    if not dataclasses.is_dataclass(cls):
        return []
    hints = typing.get_type_hints(cls)
    out = []
    for f in dataclasses.fields(cls):
        tp = _strip_optional(hints.get(f.name, Any))
        origin = typing.get_origin(tp)
        if origin in (list, List):
            (item_t,) = typing.get_args(tp) or (Any,)
            item_t = _strip_optional(item_t)
            name = getattr(item_t, "__name__", str(item_t))
            out.append({"name": f.name, "type": f"array<{name}>"})
        else:
            out.append({"name": f.name, "type": getattr(tp, "__name__", str(tp))})
    return out


def column_metadata(cls: Any) -> dict:
    """Output-column metadata for a schema'd service column."""
    origin = typing.get_origin(cls)
    if origin in (list, List):
        (item_t,) = typing.get_args(cls) or (Any,)
        item_t = _strip_optional(item_t)
        return {
            "response_schema": f"array<{getattr(item_t, '__name__', str(item_t))}>",
            "response_fields": schema_fields(item_t),
        }
    return {
        "response_schema": getattr(cls, "__name__", str(cls)),
        "response_fields": schema_fields(cls),
    }


# -- Text Analytics v3 (TextAnalyticsSchemas.scala) --------------------------


@schema
class TAWarning(Record):
    code: Optional[str] = None
    message: Optional[str] = None


@schema
class TAError(Record):
    id: Optional[str] = None
    error: Optional[Any] = None
    message: Optional[str] = None


@schema
class DocumentStatistics(Record):
    charactersCount: Optional[int] = None
    transactionsCount: Optional[int] = None


@schema
class SentimentConfidence(Record):
    positive: Optional[float] = None
    neutral: Optional[float] = None
    negative: Optional[float] = None


@schema
class SentenceSentiment(Record):
    text: Optional[str] = None
    sentiment: Optional[str] = None
    confidenceScores: Optional[SentimentConfidence] = None
    offset: Optional[int] = None
    length: Optional[int] = None


@schema
class SentimentDocument(Record):
    """SentimentScoredDocumentV3 (TextAnalyticsSchemas.scala:45-55)."""

    id: Optional[str] = None
    sentiment: Optional[str] = None
    confidenceScores: Optional[SentimentConfidence] = None
    sentences: List[SentenceSentiment] = field(default_factory=list)
    warnings: List[TAWarning] = field(default_factory=list)
    statistics: Optional[DocumentStatistics] = None


@schema
class DetectedLanguage(Record):
    name: Optional[str] = None
    iso6391Name: Optional[str] = None
    confidenceScore: Optional[float] = None


@schema
class LanguageDocument(Record):
    """DocumentLanguageV3 (TextAnalyticsSchemas.scala:67-72)."""

    id: Optional[str] = None
    detectedLanguage: Optional[DetectedLanguage] = None
    warnings: List[TAWarning] = field(default_factory=list)
    statistics: Optional[DocumentStatistics] = None


@schema
class Entity(Record):
    text: Optional[str] = None
    category: Optional[str] = None
    subcategory: Optional[str] = None
    offset: Optional[int] = None
    length: Optional[int] = None
    confidenceScore: Optional[float] = None


@schema
class EntitiesDocument(Record):
    """DetectEntitiesScoreV3 (TextAnalyticsSchemas.scala:77-83)."""

    id: Optional[str] = None
    entities: List[Entity] = field(default_factory=list)
    warnings: List[TAWarning] = field(default_factory=list)
    statistics: Optional[DocumentStatistics] = None


@schema
class KeyPhraseDocument(Record):
    """KeyPhraseScoreV3 analogue."""

    id: Optional[str] = None
    keyPhrases: List[str] = field(default_factory=list)
    warnings: List[TAWarning] = field(default_factory=list)
    statistics: Optional[DocumentStatistics] = None


# -- Computer Vision v2 (ComputerVisionSchemas in ComputerVision.scala) ------


@schema
class ImageTag(Record):
    name: Optional[str] = None
    confidence: Optional[float] = None
    hint: Optional[str] = None


@schema
class ImageCaption(Record):
    text: Optional[str] = None
    confidence: Optional[float] = None


@schema
class ImageDescription(Record):
    tags: List[str] = field(default_factory=list)
    captions: List[ImageCaption] = field(default_factory=list)


@schema
class ImageCategory(Record):
    name: Optional[str] = None
    score: Optional[float] = None
    detail: Optional[Any] = None


@schema
class ImageMetadata(Record):
    width: Optional[int] = None
    height: Optional[int] = None
    format: Optional[str] = None


@schema
class AnalyzeImageResponse(Record):
    """AIResponse (ComputerVision.scala AnalyzeImage)."""

    categories: List[ImageCategory] = field(default_factory=list)
    tags: List[ImageTag] = field(default_factory=list)
    description: Optional[ImageDescription] = None
    faces: List[Any] = field(default_factory=list)
    color: Optional[Any] = None
    adult: Optional[Any] = None
    requestId: Optional[str] = None
    metadata: Optional[ImageMetadata] = None


@schema
class OCRWord(Record):
    boundingBox: Optional[str] = None
    text: Optional[str] = None


@schema
class OCRLine(Record):
    boundingBox: Optional[str] = None
    words: List[OCRWord] = field(default_factory=list)


@schema
class OCRRegion(Record):
    boundingBox: Optional[str] = None
    lines: List[OCRLine] = field(default_factory=list)


@schema
class OCRResponse(Record):
    """OCRResponse (ComputerVision.scala OCR)."""

    language: Optional[str] = None
    textAngle: Optional[float] = None
    orientation: Optional[str] = None
    regions: List[OCRRegion] = field(default_factory=list)


@schema
class RTWord(Record):
    boundingBox: List[int] = field(default_factory=list)
    text: Optional[str] = None


@schema
class RTLine(Record):
    boundingBox: List[int] = field(default_factory=list)
    text: Optional[str] = None
    words: List[RTWord] = field(default_factory=list)


@schema
class RecognitionResult(Record):
    lines: List[RTLine] = field(default_factory=list)


@schema
class RecognizeTextResponse(Record):
    """RTResponse (ComputerVisionSchemas.scala RecognizeText)."""

    status: Optional[str] = None
    recognitionResult: Optional[RecognitionResult] = None


@schema
class TagImagesResponse(Record):
    tags: List[ImageTag] = field(default_factory=list)
    requestId: Optional[str] = None
    metadata: Optional[ImageMetadata] = None


@schema
class DescribeImageResponse(Record):
    description: Optional[ImageDescription] = None
    requestId: Optional[str] = None
    metadata: Optional[ImageMetadata] = None


@schema
class DomainModelResponse(Record):
    """DSIRResponse (RecognizeDomainSpecificContent)."""

    requestId: Optional[str] = None
    metadata: Optional[ImageMetadata] = None
    result: Optional[Any] = None


# -- Face v1.0 (Face.scala schemas) ------------------------------------------


@schema
class FaceRectangle(Record):
    top: Optional[int] = None
    left: Optional[int] = None
    width: Optional[int] = None
    height: Optional[int] = None


@schema
class DetectedFace(Record):
    """Face (Face.scala detect response element)."""

    faceId: Optional[str] = None
    faceRectangle: Optional[FaceRectangle] = None
    faceLandmarks: Optional[Any] = None
    faceAttributes: Optional[Any] = None


@schema
class VerifyResponse(Record):
    isIdentical: Optional[bool] = None
    confidence: Optional[float] = None


@schema
class IdentifyCandidate(Record):
    personId: Optional[str] = None
    confidence: Optional[float] = None


@schema
class IdentifiedFace(Record):
    faceId: Optional[str] = None
    candidates: List[IdentifyCandidate] = field(default_factory=list)


@schema
class SimilarFace(Record):
    faceId: Optional[str] = None
    persistedFaceId: Optional[str] = None
    confidence: Optional[float] = None


@schema
class GroupResponse(Record):
    groups: List[Any] = field(default_factory=list)
    messyGroup: List[str] = field(default_factory=list)


# -- Anomaly Detector (AnomalyDetectorSchemas.scala) -------------------------


@schema
class AnomalyDetectResponse(Record):
    """ADEntireResponse (AnomalyDetectorSchemas.scala)."""

    expectedValues: List[float] = field(default_factory=list)
    isAnomaly: List[bool] = field(default_factory=list)
    isNegativeAnomaly: List[bool] = field(default_factory=list)
    isPositiveAnomaly: List[bool] = field(default_factory=list)
    lowerMargins: List[float] = field(default_factory=list)
    upperMargins: List[float] = field(default_factory=list)
    period: Optional[int] = None


@schema
class LastAnomalyResponse(Record):
    """ADLastResponse (AnomalyDetectorSchemas.scala)."""

    isAnomaly: Optional[bool] = None
    isNegativeAnomaly: Optional[bool] = None
    isPositiveAnomaly: Optional[bool] = None
    expectedValue: Optional[float] = None
    lowerMargin: Optional[float] = None
    upperMargin: Optional[float] = None
    period: Optional[int] = None
    suggestedWindow: Optional[int] = None


# -- Speech (SpeechAPISchemas in SpeechToTextSDK.scala / SpeechToText.scala) --


@schema
class SpeechNBest(Record):
    Confidence: Optional[float] = None
    Lexical: Optional[str] = None
    ITN: Optional[str] = None
    MaskedITN: Optional[str] = None
    Display: Optional[str] = None


@schema
class SpeechResponse(Record):
    """SpeechResponse (SpeechToText.scala)."""

    RecognitionStatus: Optional[str] = None
    DisplayText: Optional[str] = None
    Offset: Optional[int] = None
    Duration: Optional[int] = None
    NBest: List[SpeechNBest] = field(default_factory=list)


# -- Bing search / Azure search (BingImageSearch.scala, AzureSearch.scala) ---


@schema
class BingImage(Record):
    name: Optional[str] = None
    contentUrl: Optional[str] = None
    thumbnailUrl: Optional[str] = None
    contentSize: Optional[str] = None
    encodingFormat: Optional[str] = None
    width: Optional[int] = None
    height: Optional[int] = None


@schema
class BingImagesResponse(Record):
    value: List[BingImage] = field(default_factory=list)
    totalEstimatedMatches: Optional[int] = None


@schema
class IndexResult(Record):
    key: Optional[str] = None
    status: Optional[bool] = None
    errorMessage: Optional[str] = None
    statusCode: Optional[int] = None


@schema
class IndexResponse(Record):
    value: List[IndexResult] = field(default_factory=list)
