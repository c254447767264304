"""Featurization: the port of ``mmlspark_tpu.featurize``, with every name of
its ``__all__``."""

from mmlspark_tpu_torch.featurize.clean import CleanMissingData, CleanMissingDataModel, DataConversion
from mmlspark_tpu_torch.featurize.featurize import Featurize, FeaturizeModel
from mmlspark_tpu_torch.featurize.indexers import (
    IndexToValue,
    ValueIndexer,
    ValueIndexerModel,
)
from mmlspark_tpu_torch.featurize.text import (
    MultiNGram,
    PageSplitter,
    TextFeaturizer,
    TextFeaturizerModel,
)

__all__ = [
    "CleanMissingData",
    "CleanMissingDataModel",
    "DataConversion",
    "Featurize",
    "FeaturizeModel",
    "ValueIndexer",
    "ValueIndexerModel",
    "IndexToValue",
    "TextFeaturizer",
    "TextFeaturizerModel",
    "MultiNGram",
    "PageSplitter",
]
