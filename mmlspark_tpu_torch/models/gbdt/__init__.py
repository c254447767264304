from mmlspark_tpu_torch.models.gbdt.binning import BinMapper
from mmlspark_tpu_torch.models.gbdt.booster import Booster, Tree
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_reference
from mmlspark_tpu_torch.models.gbdt.train import TrainConfig, train
from mmlspark_tpu_torch.models.gbdt.estimators import (
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
)

__all__ = [
    "BinMapper",
    "Booster",
    "Tree",
    "booster_from_reference",
    "TrainConfig",
    "train",
    "LightGBMClassifier",
    "LightGBMClassificationModel",
    "LightGBMRanker",
    "LightGBMRankerModel",
    "LightGBMRegressor",
    "LightGBMRegressionModel",
]
