"""Batched image ops in PyTorch: the port of ``mmlspark_tpu.ops.image``.

Every op takes and returns an ``(N, H, W, C)`` tensor, the JAX package's
layout, and runs on whatever device the tensor lies on; each is the same
arithmetic as its JAX counterpart, in float32 where that one casts:

- ``resize`` is ``jax.image.resize(..., "linear")``: half-pixel bilinear
  that antialiases when it shrinks (a triangle filter stretched by the
  scale), which ``F.interpolate(mode="bilinear", antialias=True)`` computes;
  a same-size resize only casts to float32, as there;
- ``gaussian_blur`` is two zero-padded separable passes, "SAME" as XLA pads
  them (the odd tap below, for an even kernel);
- ``unroll``/``roll`` keep the reference's CHW plane order and BGR channel
  order.

The convolutions and resize are cuDNN/ATen calls on the card, as they were
XLA ops in the JAX package: this module has no hand-written kernel.
``decode_image`` is host code: PIL where installed, else the PPM (P6)
fallback.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def resize(images: torch.Tensor, height: int, width: int, method: str = "linear") -> torch.Tensor:
    """Batched resize (ResizeImage stage analogue). images: (N,H,W,C)."""
    if method != "linear":
        raise ValueError(f"unsupported resize method {method!r}: only 'linear'")
    _, h, w, _ = images.shape
    x = images.float()
    if (h, w) == (height, width):
        return x
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def center_crop(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """CropImage stage analogue (centered)."""
    _, h, w, _ = images.shape
    top = max(0, (h - height) // 2)
    left = max(0, (w - width) // 2)
    return images[:, top: top + height, left: left + width, :]


def crop(images: torch.Tensor, x: int, y: int, height: int, width: int) -> torch.Tensor:
    return images[:, y: y + height, x: x + width, :]


def flip(images: torch.Tensor, horizontal: bool = True) -> torch.Tensor:
    """Flip stage analogue (flipCode >=0 => horizontal in OpenCV terms)."""
    return torch.flip(images, dims=(2 if horizontal else 1,))


def bgr_to_rgb(images: torch.Tensor) -> torch.Tensor:
    return torch.flip(images, dims=(-1,))


rgb_to_bgr = bgr_to_rgb


def to_grayscale(images: torch.Tensor, bgr: bool = True) -> torch.Tensor:
    """ColorFormat(GRAY) analogue; ITU-R BT.601 weights like OpenCV."""
    w = torch.tensor([0.114, 0.587, 0.299] if bgr else [0.299, 0.587, 0.114],
                     dtype=torch.float32, device=images.device)
    return torch.tensordot(images.float(), w, dims=([-1], [0]))[..., None]


def gaussian_kernel(ksize: int, sigma: float, device: "torch.device | str | None" = None) -> torch.Tensor:
    """1-D gaussian taps (GaussianKernel stage analogue)."""
    x = torch.arange(ksize, dtype=torch.float32, device=device) - (ksize - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(images: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Blur stage analogue as a separable depthwise conv (two small convs)."""
    k = gaussian_kernel(ksize, sigma, images.device)
    x = images.float()
    n, h, w, c = x.shape
    x = x.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    lo, hi = (ksize - 1) // 2, ksize // 2  # XLA's "SAME" at stride 1
    x = F.conv2d(F.pad(x, (0, 0, lo, hi)), k.reshape(1, 1, ksize, 1))
    x = F.conv2d(F.pad(x, (lo, hi, 0, 0)), k.reshape(1, 1, 1, ksize))
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1)


def threshold(images: torch.Tensor, thresh: float, max_val: float = 255.0) -> torch.Tensor:
    """Threshold stage analogue (THRESH_BINARY)."""
    return torch.where(images > thresh, max_val, 0.0).float()


def unroll(images: torch.Tensor, bgr: bool = True) -> torch.Tensor:
    """Image batch -> flat vectors in the reference's layout: CHW plane
    order, BGR channel order (UnrollImage.scala:40-51). images: (N,H,W,C)
    assumed RGB unless ``bgr=False`` means already BGR."""
    x = torch.flip(images, dims=(-1,)) if bgr else images
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def roll(vectors: torch.Tensor, height: int, width: int, channels: int = 3, bgr: bool = True) -> torch.Tensor:
    """Inverse of unroll (UnrollImage.roll analogue)."""
    x = vectors.reshape(-1, channels, height, width).permute(0, 2, 3, 1)
    return torch.flip(x, dims=(-1,)) if bgr else x


def normalize(
    images: torch.Tensor,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
    scale: float = 1.0 / 255.0,
) -> torch.Tensor:
    """Standard model-input normalization (scale then per-channel z-score)."""
    x = images.float() * scale
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (x - m) / s


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """Host-side image decode (bytes -> HWC uint8 RGB array): PIL if present,
    else a minimal PPM (P6) fallback; None when the bytes do not decode."""
    try:
        import io as _io

        from PIL import Image  # type: ignore

        img = Image.open(_io.BytesIO(data)).convert("RGB")
        return np.asarray(img, dtype=np.uint8)
    except ImportError:
        return _decode_fallback(data)
    except Exception:
        return None


def _decode_fallback(data: bytes) -> Optional[np.ndarray]:
    # raw PPM (P6) decode: keeps decoding hermetic where PIL is absent
    if data[:2] == b"P6":
        try:
            parts = data.split(maxsplit=4)
            w, h = int(parts[1]), int(parts[2])
            raw = parts[4][-w * h * 3:] if len(parts[4]) > w * h * 3 else parts[4]
            return np.frombuffer(raw, dtype=np.uint8, count=w * h * 3).reshape(h, w, 3)
        except Exception:
            return None
    return None
