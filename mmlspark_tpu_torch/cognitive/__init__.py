"""Cognitive-service-style REST enrichment transformers (SURVEY.md §2.8).

The reference ships ~20 transformers that call Azure Cognitive Services
REST APIs from DataFrame columns (cognitive/, CognitiveServiceBase.scala:
258-330). The service *catalog* — text analytics, vision, face, anomaly
detection, speech, search — is the capability; Azure specifics are not.
Each transformer here speaks the same wire format against any base URL
(self-hosted, proxy, or Azure), with:

- :class:`ServiceParam` value-or-column duality (HasServiceParams,
  CognitiveServiceBase.scala:29-150)
- bounded-concurrency async sends with retry/backoff (RESTHelpers analogue
  via the io layer's AdvancedHandler)
- typed response projection into an output column + error column

The PyTorch port's copy of ``mmlspark_tpu.cognitive``: host code over
the port's ``io``, no device.
"""

from mmlspark_tpu_torch.cognitive.base import CognitiveServiceBase, ServiceParam
from mmlspark_tpu_torch.cognitive.text import (
    NER,
    EntityDetector,
    KeyPhraseExtractor,
    LanguageDetector,
    TextSentiment,
)
from mmlspark_tpu_torch.cognitive.vision import (
    OCR,
    AnalyzeImage,
    DescribeImage,
    GenerateThumbnails,
    RecognizeDomainSpecificContent,
    RecognizeText,
    TagImage,
)
from mmlspark_tpu_torch.cognitive.face import (
    DetectFace,
    FindSimilarFace,
    GroupFaces,
    IdentifyFaces,
    VerifyFaces,
)
from mmlspark_tpu_torch.cognitive.anomaly import DetectAnomalies, DetectLastAnomaly
from mmlspark_tpu_torch.cognitive.speech import SpeechToText, SpeechToTextSDK
from mmlspark_tpu_torch.cognitive.search import SearchIndex, AzureSearchWriter, BingImageSearch

__all__ = [
    "CognitiveServiceBase",
    "ServiceParam",
    "TextSentiment",
    "LanguageDetector",
    "EntityDetector",
    "KeyPhraseExtractor",
    "NER",
    "AnalyzeImage",
    "OCR",
    "RecognizeText",
    "RecognizeDomainSpecificContent",
    "GenerateThumbnails",
    "TagImage",
    "DescribeImage",
    "DetectFace",
    "VerifyFaces",
    "IdentifyFaces",
    "GroupFaces",
    "FindSimilarFace",
    "DetectAnomalies",
    "DetectLastAnomaly",
    "SpeechToText",
    "SpeechToTextSDK",
    "BingImageSearch",
    "AzureSearchWriter",
    "SearchIndex",
]
