"""Import torchvision-format ResNet and ViT checkpoints into the model zoo.

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

A torchvision ``vit_b_16`` ``state_dict`` (:func:`import_torch_vit`)
becomes the zoo's ViT tree: ``in_proj_weight`` (3C, C) is the
``DenseGeneral((3, h, d))`` kernel after a transpose and reshape, linears
transpose, LayerNorms map (weight, bias) -> (scale, bias). Its schema
keeps ``torch_padding=False``: the patch conv pads nothing.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np
import torch

log = logging.getLogger("mmlspark_tpu_torch.downloader")

# stage sizes per variant (must match models/resnet.py factories)
_STAGES = {
    "ResNet18": ([2, 2, 2, 2], "BasicBlock"),
    "ResNet34": ([3, 4, 6, 3], "BasicBlock"),
    "ResNet50": ([3, 4, 6, 3], "BottleneckBlock"),
    "ResNet101": ([3, 4, 23, 3], "BottleneckBlock"),
}

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


def import_torch_vit(state_dict: dict, num_heads: Optional[int] = None,
                     variant: str = "ViTB16") -> dict:
    """torchvision ViT ``state_dict`` (``vit_b_16`` layout) -> flax
    variables ``{"params": ...}`` for ``VITS[variant]``. Strict like the
    ResNet importer: every weight consumed, every expected key present,
    and the checkpoint's geometry (patch size, hidden dim, depth, mlp
    width) checked against the variant.

    Layout: torch packs q/k/v as ``in_proj_weight`` (3C, C) with heads
    contiguous inside each of q/k/v, which is the (C, 3, H, D)
    DenseGeneral kernel after a transpose and reshape; linears transpose;
    LayerNorm weight/bias -> scale/bias."""
    from mmlspark_tpu_torch.models.vit import VITS

    if variant not in VITS:
        raise ValueError(f"unsupported variant {variant!r}; known: {list(VITS)}")
    with torch.device("meta"):  # the variant's geometry, no weights
        ref = VITS[variant]()
    if num_heads is None:
        num_heads = ref.num_heads
    sd = dict(state_dict)
    params: dict = {}

    params["conv_proj"] = {
        "kernel": _conv(sd, "conv_proj.weight"),
        "bias": _np(_take(sd, "conv_proj.bias")),
    }
    kh, kw_ = params["conv_proj"]["kernel"].shape[:2]
    if (kh, kw_) != (ref.patch_size, ref.patch_size):
        raise ValueError(
            f"checkpoint patch size {kh}x{kw_} != {variant}'s {ref.patch_size}")
    params["cls_token"] = _np(_take(sd, "class_token"))
    params["pos_embedding"] = _np(_take(sd, "encoder.pos_embedding"))
    c = params["pos_embedding"].shape[-1]
    if c != ref.hidden_dim:
        raise ValueError(f"checkpoint hidden dim {c} != {variant}'s {ref.hidden_dim}")
    if c % num_heads:
        raise ValueError(f"hidden dim {c} not divisible by heads {num_heads}")
    d = c // num_heads

    def _ln(prefix: str) -> dict:
        return {"scale": _np(_take(sd, f"{prefix}.weight")),
                "bias": _np(_take(sd, f"{prefix}.bias"))}

    def _linear(prefix: str) -> dict:
        return {"kernel": _np(_take(sd, f"{prefix}.weight")).T,
                "bias": _np(_take(sd, f"{prefix}.bias"))}

    i = 0
    while f"encoder.layers.encoder_layer_{i}.ln_1.weight" in sd:
        t = f"encoder.layers.encoder_layer_{i}"
        w_in = _np(_take(sd, f"{t}.self_attention.in_proj_weight"))
        b_in = _np(_take(sd, f"{t}.self_attention.in_proj_bias"))
        params[f"block_{i}"] = {
            "ln_1": _ln(f"{t}.ln_1"),
            "qkv": {"kernel": w_in.T.reshape(c, 3, num_heads, d),
                    "bias": b_in.reshape(3, num_heads, d)},
            "out": _linear(f"{t}.self_attention.out_proj"),
            "ln_2": _ln(f"{t}.ln_2"),
            "mlp_1": _linear(f"{t}.mlp.0"),
            "mlp_2": _linear(f"{t}.mlp.3"),
        }
        i += 1
    if i == 0:
        raise ValueError("state_dict has no encoder.layers.encoder_layer_0 — not a "
                         "torchvision ViT checkpoint")
    if i != ref.depth:
        raise ValueError(f"checkpoint has {i} encoder layers != {variant}'s {ref.depth}")
    width = params["block_0"]["mlp_1"]["kernel"].shape[1]
    if width != ref.mlp_dim:
        raise ValueError(f"checkpoint mlp width {width} != {variant}'s {ref.mlp_dim}")
    params["ln"] = _ln("encoder.ln")
    params["head"] = _linear("heads.head")
    leftovers = list(sd)
    if leftovers:
        raise ValueError(
            f"unconsumed keys in state_dict (architecture mismatch with "
            f"{variant}): {leftovers[:8]}{'...' if len(leftovers) > 8 else ''}")
    return {"params": params}


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

    if isinstance(src, (str, bytes, os.PathLike)):
        state_dict = torch.load(src, map_location="cpu", weights_only=True)
        if hasattr(state_dict, "state_dict"):  # a full module was saved
            state_dict = state_dict.state_dict()
    else:
        state_dict = src
    variant = variant or name.split("_", 1)[0]
    is_vit = variant.startswith("ViT")
    extra: dict = {}
    if is_vit:
        from mmlspark_tpu_torch.models.vit import LAYER_NAMES, VITS

        variables = import_torch_vit(state_dict, variant=variant)
        # the pos-embedding length depends on the input size: serving at
        # another size than the checkpoint's would fail only at transform
        # time, so it is pinned here
        n_ck = variables["params"]["pos_embedding"].shape[1]
        with torch.device("meta"):
            n_want = (image_size // VITS[variant]().patch_size) ** 2 + 1
        if n_ck != n_want:
            raise ValueError(
                f"checkpoint pos_embedding has {n_ck} tokens but image_size={image_size} "
                f"needs {n_want} — pass the image_size the checkpoint was trained at")
        extra["layer_names"] = list(LAYER_NAMES)
    else:
        variables = import_torch_resnet(state_dict, variant=variant)
    if num_classes is None:
        num_classes = int(variables["params"]["head"]["bias"].shape[0])
    dl = downloader or ModelDownloader()
    schema = ModelSchema(
        name=name,
        variant=variant,
        num_classes=num_classes,
        image_size=image_size,
        # the ViT's patch conv pads nothing; torch_padding concerns ResNets
        torch_padding=not is_vit,
        **extra,
    )
    dl.register(schema, variables)
    log.info("installed torch checkpoint %r as zoo model %r", variant, name)
    return schema
