"""Import torchvision-format ResNet checkpoints into the model zoo.

The port of ``mmlspark_tpu.downloader.torch_import``. A torchvision ResNet
``state_dict`` (a ``.pth`` file) becomes the zoo's flax-layout tree, the
same tree the JAX package's importer returns, so either package can serve
it: convs transpose OIHW -> HWIO, batch norms map (weight, bias,
running_mean, running_var) -> (scale, bias, mean, var), the classifier
transposes, and the schema sets ``torch_padding=True`` so strided convs
and the pool pad symmetrically, as torch does::

    from mmlspark_tpu_torch.downloader import install_torch_checkpoint
    schema = install_torch_checkpoint("resnet50-imagenet.pth", name="ResNet50")
    ImageFeaturizer(model_name="ResNet50", ...)   # real semantic features

ViT checkpoints wait for the port's ViT (ROADMAP Queue A item 9).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np

log = logging.getLogger("mmlspark_tpu_torch.downloader")

# stage sizes per variant (must match models/resnet.py factories)
_STAGES = {
    "ResNet18": ([2, 2, 2, 2], "BasicBlock"),
    "ResNet34": ([3, 4, 6, 3], "BasicBlock"),
    "ResNet50": ([3, 4, 6, 3], "BottleneckBlock"),
    "ResNet101": ([3, 4, 23, 3], "BottleneckBlock"),
}

VIT_TODO = ("ViT checkpoints are not ported yet: models/vit.py waits for "
            "ROADMAP Queue A item 9")


def _np(t: Any) -> np.ndarray:
    """torch tensor or array-like -> float32 numpy (host)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _take(sd: dict, key: str) -> Any:
    try:
        return sd.pop(key)
    except KeyError:
        raise ValueError(
            f"state_dict is missing {key!r} — architecture mismatch with "
            "the requested variant"
        ) from None


def _conv(sd: dict, key: str) -> np.ndarray:
    """torch conv weight (O, I, kh, kw) -> flax kernel (kh, kw, I, O)."""
    return _np(_take(sd, key)).transpose(2, 3, 1, 0)


def _bn(sd: dict, prefix: str) -> tuple:
    """-> (params {scale, bias}, stats {mean, var})."""
    sd.pop(f"{prefix}.num_batches_tracked", None)
    return (
        {
            "scale": _np(_take(sd, f"{prefix}.weight")),
            "bias": _np(_take(sd, f"{prefix}.bias")),
        },
        {
            "mean": _np(_take(sd, f"{prefix}.running_mean")),
            "var": _np(_take(sd, f"{prefix}.running_var")),
        },
    )


def import_torch_resnet(state_dict: dict, variant: str = "ResNet50") -> dict:
    """torchvision ResNet ``state_dict`` -> flax variables
    ``{"params": ..., "batch_stats": ...}`` for ``RESNETS[variant]`` built
    with ``torch_padding=True``. Strict: every weight must be consumed and
    every expected key present, so silent architecture drift is impossible.
    """
    if variant.startswith("ViT"):
        raise NotImplementedError(VIT_TODO)
    if variant not in _STAGES:
        raise ValueError(f"unsupported variant {variant!r}; known: {list(_STAGES)}")
    stages, block_kind = _STAGES[variant]
    sd = dict(state_dict)
    params: dict = {}
    stats: dict = {}

    params["conv_init"] = {"kernel": _conv(sd, "conv1.weight")}
    params["bn_init"], stats["bn_init"] = _bn(sd, "bn1")

    flat = 0
    for li, blocks in enumerate(stages):
        for bj in range(blocks):
            t = f"layer{li + 1}.{bj}"
            name = f"{block_kind}_{flat}"
            flat += 1
            p: dict = {}
            s: dict = {}
            n_convs = 3 if block_kind == "BottleneckBlock" else 2
            for ci in range(n_convs):
                p[f"Conv_{ci}"] = {"kernel": _conv(sd, f"{t}.conv{ci + 1}.weight")}
                p[f"BatchNorm_{ci}"], s[f"BatchNorm_{ci}"] = _bn(
                    sd, f"{t}.bn{ci + 1}"
                )
            if f"{t}.downsample.0.weight" in sd:
                p["proj"] = {"kernel": _conv(sd, f"{t}.downsample.0.weight")}
                p["proj_bn"], s["proj_bn"] = _bn(sd, f"{t}.downsample.1")
            params[name] = p
            stats[name] = s

    if "fc.weight" in sd:
        params["head"] = {
            "kernel": _np(sd.pop("fc.weight")).T,
            "bias": _np(_take(sd, "fc.bias")),
        }
    else:
        raise ValueError(
            "state_dict has no fc.weight — import the full torchvision "
            "checkpoint (the featurizer cuts the head at runtime instead)"
        )
    leftovers = [k for k in sd if not k.endswith("num_batches_tracked")]
    if leftovers:
        raise ValueError(
            f"unconsumed keys in state_dict (architecture mismatch with "
            f"{variant}): {leftovers[:8]}{'...' if len(leftovers) > 8 else ''}"
        )
    return {"params": params, "batch_stats": stats}


def install_torch_checkpoint(
    src: Any,
    name: str,
    variant: Optional[str] = None,
    num_classes: Optional[int] = None,
    image_size: int = 224,
    downloader: Any = None,
) -> Any:
    """Load a torch ``.pth``/state_dict and register it in the local zoo.

    ``src``: a path to a torch-serialized file or an in-memory state_dict.
    Returns the installed :class:`ModelSchema`; afterwards
    ``ImageFeaturizer(model_name=name)`` serves REAL features from it.
    """
    from mmlspark_tpu_torch.downloader.zoo import ModelDownloader, ModelSchema

    variant = variant or name.split("_", 1)[0]
    if variant.startswith("ViT"):
        raise NotImplementedError(VIT_TODO)
    if isinstance(src, (str, bytes, os.PathLike)):
        import torch

        state_dict = torch.load(src, map_location="cpu", weights_only=True)
        if hasattr(state_dict, "state_dict"):  # a full module was saved
            state_dict = state_dict.state_dict()
    else:
        state_dict = src
    variables = import_torch_resnet(state_dict, variant=variant)
    if num_classes is None:
        num_classes = int(variables["params"]["head"]["bias"].shape[0])
    dl = downloader or ModelDownloader()
    schema = ModelSchema(
        name=name,
        variant=variant,
        num_classes=num_classes,
        image_size=image_size,
        torch_padding=True,
    )
    dl.register(schema, variables)
    log.info("installed torch checkpoint %r as zoo model %r", variant, name)
    return schema
