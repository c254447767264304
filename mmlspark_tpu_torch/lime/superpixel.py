"""SLIC superpixel clustering and its transformer stage: the port of
``mmlspark_tpu.lime.superpixel``.

Fixed-iteration SLIC as tensor code on the image's device: grid-seeded
centers, a joint (position, colour) distance, segment-mean updates summed
in pixel order. The label map equals the JAX package's exactly: the
distance ``|f|^2 + |c|^2 - 2 f.c`` takes each inner product as one fused
multiply-add chain over the feature's components, as XLA's CPU dot computes
it (each step a f64 ``a * b + c`` rounded once to f32), so the arithmetic is
the same on the card and on the CPU.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Transformer


def _dot_rows(f: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(P, F) @ (K, F).T as an f32 fused multiply-add chain over F."""
    acc = (f[:, :1] * c[None, :, 0]).double()
    for j in range(1, f.shape[1]):
        acc = (f[:, j:j + 1].double() * c[None, :, j].double() + acc).float().double()
    return acc.float()


def _sum_sq(f: torch.Tensor) -> torch.Tensor:
    """Row sums of squares over F, added in order."""
    sq = f * f
    acc = sq[..., 0]
    for j in range(1, f.shape[-1]):
        acc = acc + sq[..., j]
    return acc


def segment_sum(x: torch.Tensor, seg: torch.Tensor, k: int,
                out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Rows of ``x`` summed by segment in row order, as XLA's CPU
    scatter-add sums: ``index_add_`` on the CPU (a loop in order); on the
    card the accumulating ``index_put_``, which sorts the indices stably and
    adds each segment's rows in turn (``index_add_`` there adds with
    atomics, in no fixed order). With ``out`` ((k, ...)), the rows are
    added into it in place, each onto the running sum."""
    if out is None:
        out = torch.zeros((k,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return out.index_add_(0, seg, x)
    return out.index_put_((seg,), x, accumulate=True)


def slic(image: Any, n_segments: int = 64, compactness: float = 10.0, iters: int = 10,
         device: "str | torch.device | None" = None) -> torch.Tensor:
    """SLIC over one (H, W, C) image -> (H, W) int32 label map, on the
    image's device (a tensor) or on ``device`` (numpy; None = the card).

    Joint feature = [compactness / S * (y, x), channels]; centers seeded on
    a sqrt(n_segments) grid; ``iters`` rounds of assign + segment-mean
    update; an empty cluster keeps its center."""
    if isinstance(image, torch.Tensor):
        img = image.float()
    else:
        img = torch.as_tensor(np.asarray(image, np.float32), device=resolve_device(device))
    dev = img.device
    h, w, c = img.shape
    gy = int(np.sqrt(n_segments))
    gx = int(np.ceil(n_segments / gy))
    k = gy * gx
    s = float(np.sqrt(h * w / k))  # nominal superpixel spacing
    scale = torch.tensor(compactness / s, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    feats = torch.cat([(yy * scale)[..., None], (xx * scale)[..., None], img],
                      dim=-1).reshape(h * w, c + 2)
    cy = (torch.arange(gy, dtype=torch.float32, device=dev) + 0.5) * np.float32(h / gy)
    cx = (torch.arange(gx, dtype=torch.float32, device=dev) + 0.5) * np.float32(w / gx)
    cyy, cxx = torch.meshgrid(cy, cx, indexing="ij")
    ci = torch.clamp(cyy.reshape(-1).to(torch.int64), 0, h - 1)
    cj = torch.clamp(cxx.reshape(-1).to(torch.int64), 0, w - 1)
    centers = feats.reshape(h, w, c + 2)[ci, cj]
    f2 = _sum_sq(feats)[:, None]
    ones = torch.ones(h * w, dtype=torch.float32, device=dev)
    assign = None
    for _ in range(iters):
        d2 = f2 + _sum_sq(centers)[None, :] - 2.0 * _dot_rows(feats, centers)
        assign = torch.argmin(d2, dim=1)
        sums = segment_sum(feats, assign, k)
        counts = segment_sum(ones, assign, k)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, centers)
    return assign.reshape(h, w).to(torch.int32)


class Superpixel:
    """Host-facing helper mirroring the reference's Superpixel object:
    cluster one image and mask it by per-cluster on/off states."""

    @staticmethod
    def cluster(image: np.ndarray, n_segments: int = 64, compactness: float = 10.0,
                iters: int = 10, device: "str | torch.device | None" = None) -> np.ndarray:
        return slic(np.asarray(image), n_segments, compactness, iters, device).cpu().numpy()

    @staticmethod
    def mask_image(image: np.ndarray, labels: np.ndarray, states: np.ndarray) -> np.ndarray:
        """Keep pixels whose superpixel state is on; censor the rest to 0
        (the reference blacks out off clusters)."""
        on = np.asarray(states, bool)[np.asarray(labels)]
        return np.where(on[..., None], image, 0).astype(image.dtype)


class SuperpixelTransformer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Attach an (H, W) superpixel label map for each image row
    (lime/SuperpixelTransformer in the reference), clustered on ``device``."""

    cell_size = Param("approximate superpixel diameter in pixels", default=16.0, type_=float)
    compactness = Param("SLIC compactness (spatial vs color weight)", default=10.0, type_=float)
    iters = Param("SLIC iterations", default=10, type_=int)

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        if "output_col" not in self._paramMap:
            self.set(output_col="superpixels")

    def transform(self, df: DataFrame) -> DataFrame:
        ic, oc = self.get_or_fail("input_col"), self.get("output_col")
        cell = self.get("cell_size")
        dev = resolve_device(self.get("device"))

        def fn(p: dict) -> dict:
            images = p[ic]
            out = np.empty(len(images), dtype=object)
            for i, img in enumerate(images):
                img = np.asarray(img)
                n_seg = max(1, int((img.shape[0] * img.shape[1]) / (cell * cell)))
                out[i] = Superpixel.cluster(img, n_seg, self.get("compactness"),
                                            self.get("iters"), dev)
            q = dict(p)
            q[oc] = out
            return q

        return df.map_partitions(fn, parallel=False)
