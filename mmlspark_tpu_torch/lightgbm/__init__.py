"""Drop-in import location matching the reference package layout
(``com.microsoft.ml.spark.lightgbm`` -> ``mmlspark_tpu_torch.lightgbm``):
the port of ``mmlspark_tpu.lightgbm``, over the port's ``models.gbdt``."""

from mmlspark_tpu_torch.models.gbdt import (
    Booster as LightGBMBooster,
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
)

__all__ = [
    "LightGBMBooster",
    "LightGBMClassifier",
    "LightGBMClassificationModel",
    "LightGBMRegressor",
    "LightGBMRegressionModel",
    "LightGBMRanker",
    "LightGBMRankerModel",
]
