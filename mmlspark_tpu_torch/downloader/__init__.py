from mmlspark_tpu_torch.downloader.zoo import ModelDownloader, ModelSchema, RemoteRepository
from mmlspark_tpu_torch.downloader.torch_import import (
    import_torch_resnet,
    import_torch_vit,
    install_torch_checkpoint,
)

__all__ = [
    "ModelDownloader",
    "ModelSchema",
    "RemoteRepository",
    "import_torch_resnet",
    "import_torch_vit",
    "install_torch_checkpoint",
]
