"""Auto-featurized training and model statistics: the port of
``mmlspark_tpu.train``, with every name of its ``__all__``."""

from mmlspark_tpu_torch.train.train import (
    OneVsRest,
    OneVsRestModel,
    TrainClassifier,
    TrainRegressor,
    TrainedClassifierModel,
    TrainedRegressorModel,
)
from mmlspark_tpu_torch.train.statistics import (
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
)

__all__ = [
    "OneVsRest",
    "OneVsRestModel",
    "TrainClassifier",
    "TrainRegressor",
    "TrainedClassifierModel",
    "TrainedRegressorModel",
    "ComputeModelStatistics",
    "ComputePerInstanceStatistics",
]
