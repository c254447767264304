from mmlspark_tpu_torch.models.gbdt.binning import BinMapper, BinnedDataset
from mmlspark_tpu_torch.models.gbdt.sketch import QuantileSketch
from mmlspark_tpu_torch.models.gbdt.booster import Booster, Tree
from mmlspark_tpu_torch.models.gbdt.checkpoint import (
    TrainCheckpoint,
    load_checkpoint,
    save_checkpoint,
)
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_reference
from mmlspark_tpu_torch.models.gbdt.delegate import LightGBMDelegate
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
    "BinnedDataset",
    "QuantileSketch",
    "Booster",
    "Tree",
    "booster_from_reference",
    "LightGBMDelegate",
    "TrainConfig",
    "train",
    "TrainCheckpoint",
    "save_checkpoint",
    "load_checkpoint",
    "LightGBMClassifier",
    "LightGBMClassificationModel",
    "LightGBMRanker",
    "LightGBMRankerModel",
    "LightGBMRegressor",
    "LightGBMRegressionModel",
]
