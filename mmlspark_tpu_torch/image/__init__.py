"""Image pipeline stages (reference: opencv/ + image/): every pixel op is a
batched PyTorch op from ``mmlspark_tpu_torch.ops.image`` on the stage's
device; images of one shape in a partition run as one (N, H, W, C) batch.
"""

from mmlspark_tpu_torch.image.transformer import (
    ImageSetAugmenter,
    ImageTransformer,
    ResizeImageTransformer,
    UnrollBinaryImage,
    UnrollImage,
)

__all__ = [
    "ImageTransformer",
    "UnrollImage",
    "UnrollBinaryImage",
    "ResizeImageTransformer",
    "ImageSetAugmenter",
]
