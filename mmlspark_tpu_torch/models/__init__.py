"""Models of the port: GBDT (``models.gbdt``), the ResNet backbones, the
batched model stage ``TorchModel`` and ``ImageFeaturizer``."""

from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models import resnet

__all__ = ["TorchModel", "ImageFeaturizer", "resnet"]
