"""Models of the port: GBDT (``models.gbdt``), the ResNet and ViT
backbones, the BiLSTM tagger (``sequence``), the batched model stage
``TorchModel`` and ``ImageFeaturizer``."""

from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models import resnet
from mmlspark_tpu_torch.models import sequence
from mmlspark_tpu_torch.models import vit

__all__ = ["TorchModel", "ImageFeaturizer", "resnet", "sequence", "vit"]
