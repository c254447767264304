"""Image transformer stages: the port of ``mmlspark_tpu.image.transformer``.

``ImageTransformer`` mirrors the reference's stage-list design
(opencv/ImageTransformer.scala:41-110): the transform is configured as an
ordered list of op descriptors (dicts), built fluently::

    ImageTransformer(input_col="image").resize(224, 224).flip().blur(5, 1.5)

Execution is batched: each partition groups images by shape, stacks each
group into one (N, H, W, C) float32 tensor on the stage's ``device`` (the
card unless ``device="cpu"``), runs the whole op list there with
``mmlspark_tpu_torch.ops.image``, and returns host float32 arrays.

``UnrollImage`` flattens to the reference's CHW/BGR vector layout
(image/UnrollImage.scala:40-51), ``ResizeImageTransformer`` is the
OpenCV-free resize (image/ResizeImageTransformer.scala), and
``ImageSetAugmenter`` emits flip-augmented copies
(image/ImageSetAugmenter.scala).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.ops import image as ops


def _as_image(v: Any) -> np.ndarray:
    img = np.asarray(v, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    return img


def _apply_grouped(images: np.ndarray, fn: Callable, dev: torch.device) -> np.ndarray:
    """Group an object array of (H,W,C) images by shape, run ``fn`` on each
    stacked group as one batch on ``dev``, scatter results back row-aligned."""

    def run(batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return fn(torch.as_tensor(batch, dtype=torch.float32, device=dev)).cpu().numpy()

    if isinstance(images, np.ndarray) and images.dtype != object:
        return run(images)
    groups: dict[tuple, list[int]] = {}
    imgs = [_as_image(v) for v in images]
    for i, img in enumerate(imgs):
        groups.setdefault(img.shape, []).append(i)
    out = np.empty(len(imgs), dtype=object)
    for idxs in groups.values():
        res = run(np.stack([imgs[i] for i in idxs]))
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out


class ImageTransformer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Ordered list of image ops applied on device (see module docstring)."""

    stages = Param("ordered op descriptors", default=[])

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "input_col" not in self._paramMap:
            self.set(input_col="image")
        if "output_col" not in self._paramMap:
            self.set(output_col=self.get("input_col"))

    # -- fluent builders (reference python wrapper style) --------------------

    def _add(self, **stage: Any) -> "ImageTransformer":
        self.set(stages=self.get("stages") + [stage])
        return self

    def resize(self, height: int, width: int) -> "ImageTransformer":
        return self._add(op="resize", height=height, width=width)

    def crop(self, x: int, y: int, height: int, width: int) -> "ImageTransformer":
        return self._add(op="crop", x=x, y=y, height=height, width=width)

    def color_format(self, format: str) -> "ImageTransformer":
        return self._add(op="color_format", format=format)

    def flip(self, flip_code: int = 1) -> "ImageTransformer":
        return self._add(op="flip", flip_code=flip_code)

    def blur(self, ksize: int, sigma: float) -> "ImageTransformer":
        return self._add(op="blur", ksize=ksize, sigma=sigma)

    def threshold(self, threshold: float, max_val: float = 255.0) -> "ImageTransformer":
        return self._add(op="threshold", threshold=threshold, max_val=max_val)

    def gaussian_kernel(self, aperture_size: int, sigma: float) -> "ImageTransformer":
        return self._add(op="blur", ksize=aperture_size, sigma=sigma)

    def normalize(
        self,
        mean: tuple = (0.485, 0.456, 0.406),
        std: tuple = (0.229, 0.224, 0.225),
        scale: float = 1.0 / 255.0,
    ) -> "ImageTransformer":
        return self._add(op="normalize", mean=list(mean), std=list(std), scale=scale)

    # -- execution -----------------------------------------------------------

    @staticmethod
    def _stage_fn(stage: dict) -> Callable:
        op = stage["op"]
        if op == "resize":
            return lambda b: ops.resize(b, stage["height"], stage["width"])
        if op == "crop":
            return lambda b: ops.crop(
                b, stage["x"], stage["y"], stage["height"], stage["width"]
            )
        if op == "color_format":
            fmt = stage["format"].lower()
            if fmt in ("gray", "grey", "grayscale"):
                return lambda b: ops.to_grayscale(b)
            if fmt in ("bgr2rgb", "rgb2bgr"):
                return lambda b: ops.bgr_to_rgb(b)
            raise ValueError(f"unknown color format {fmt!r}")
        if op == "flip":
            return lambda b: ops.flip(b, horizontal=stage.get("flip_code", 1) >= 1)
        if op == "blur":
            return lambda b: ops.gaussian_blur(b, stage["ksize"], stage["sigma"])
        if op == "threshold":
            return lambda b: ops.threshold(b, stage["threshold"], stage.get("max_val", 255.0))
        if op == "normalize":
            return lambda b: ops.normalize(
                b, tuple(stage["mean"]), tuple(stage["std"]), stage["scale"]
            )
        raise ValueError(f"unknown image op {op!r}")

    def transform(self, df: DataFrame) -> DataFrame:
        fns = [self._stage_fn(s) for s in self.get("stages")]
        dev = resolve_device(self.get("device"))

        def pipeline(batch: torch.Tensor) -> torch.Tensor:
            for f in fns:
                batch = f(batch)
            return batch

        ic, oc = self.get("input_col"), self.get("output_col")

        def fn(p: dict) -> dict:
            q = dict(p)
            q[oc] = _apply_grouped(p[ic], pipeline, dev)
            return q

        return df.map_partitions(fn, parallel=False)


class ResizeImageTransformer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Standalone resize (image/ResizeImageTransformer.scala:105 analogue)."""

    height = Param("target height", type_=int)
    width = Param("target width", type_=int)

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "input_col" not in self._paramMap:
            self.set(input_col="image")
        if "output_col" not in self._paramMap:
            self.set(output_col=self.get("input_col"))

    def transform(self, df: DataFrame) -> DataFrame:
        h, w = self.get_or_fail("height"), self.get_or_fail("width")
        dev = resolve_device(self.get("device"))

        def fn(p: dict) -> dict:
            q = dict(p)
            out = _apply_grouped(p[self.get("input_col")], lambda b: ops.resize(b, h, w), dev)
            if isinstance(out, np.ndarray) and out.dtype == object:
                # uniform output shapes: stack into a dense tensor column
                out = np.stack(list(out))
            q[self.get("output_col")] = out
            return q

        return df.map_partitions(fn, parallel=False)


class UnrollImage(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Image -> flat CHW/BGR vector (image/UnrollImage.scala:40-51)."""

    bgr = Param("convert RGB input to BGR plane order like the reference", default=True, type_=bool)

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "input_col" not in self._paramMap:
            self.set(input_col="image")
        if "output_col" not in self._paramMap:
            self.set(output_col="unrolled")

    def transform(self, df: DataFrame) -> DataFrame:
        dev = resolve_device(self.get("device"))

        def fn(p: dict) -> dict:
            q = dict(p)
            out = _apply_grouped(
                p[self.get("input_col")], lambda b: ops.unroll(b, self.get("bgr")), dev
            )
            if isinstance(out, np.ndarray) and out.dtype == object:
                lens = {v.shape for v in out}
                if len(lens) == 1:
                    out = np.stack(list(out))
            q[self.get("output_col")] = out
            return q

        return df.map_partitions(fn, parallel=False)


class UnrollBinaryImage(UnrollImage):
    """Encoded image bytes -> decode -> unroll (UnrollBinaryImage analogue)."""

    def transform(self, df: DataFrame) -> DataFrame:
        ic = self.get("input_col")

        def decode(p: dict) -> dict:
            data = p[ic]
            out = np.empty(len(data), dtype=object)
            for i, blob in enumerate(data):
                img = ops.decode_image(bytes(blob)) if blob is not None else None
                out[i] = np.zeros((1, 1, 3), np.float32) if img is None else np.asarray(img, np.float32)
            q = dict(p)
            q[ic] = out
            return q

        return super().transform(df.map_partitions(decode, parallel=False))


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Emit augmented copies of every image (image/ImageSetAugmenter.scala:73):
    original + optional horizontal/vertical flips, multiplying row count."""

    flip_left_right = Param("add horizontal flips", default=True, type_=bool)
    flip_up_down = Param("add vertical flips", default=False, type_=bool)

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "input_col" not in self._paramMap:
            self.set(input_col="image")
        if "output_col" not in self._paramMap:
            self.set(output_col=self.get("input_col"))

    def transform(self, df: DataFrame) -> DataFrame:
        ic, oc = self.get("input_col"), self.get("output_col")
        dev = resolve_device(self.get("device"))

        def fn(p: dict) -> dict:
            variants: list[np.ndarray] = [p[ic]]
            if self.get("flip_left_right"):
                variants.append(_apply_grouped(p[ic], lambda b: ops.flip(b, True), dev))
            if self.get("flip_up_down"):
                variants.append(_apply_grouped(p[ic], lambda b: ops.flip(b, False), dev))
            q: dict = {}
            for c, v in p.items():
                if c == ic:
                    continue
                q[c] = np.concatenate([v] * len(variants))
            merged = np.empty(sum(len(v) for v in variants), dtype=object)
            pos = 0
            for v in variants:
                for x in v:
                    merged[pos] = x
                    pos += 1
            q[oc] = merged
            return q

        return df.map_partitions(fn, parallel=False)
