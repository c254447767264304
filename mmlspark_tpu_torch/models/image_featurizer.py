"""ImageFeaturizer — images to feature vectors through a zoo backbone.

The port of ``mmlspark_tpu.models.image_featurizer``. Reference:
image/ImageFeaturizer.scala:133-178 composes Resize -> UnrollImage ->
CNTKModel with ``cutOutputLayers`` truncating the head so the net becomes
a featurizer (:96-104); layer names come from the model schema (:121-129).

Here the preprocess (BGR flip, antialiased resize, normalisation) and the
backbone form one ``nn.Module`` evaluated on the card by ``TorchModel`` in
fixed batches, with uint8 pixels on the wire and the cast on the card.
``cut_output_layers=k`` selects the k-th entry of the schema's
``layer_names`` (0 = logits, 1 = pooled features), and the backbone stops
at that output (``forward(until=...)`` of the zoo's ResNet and ViT), so
the head past it never runs. The backbone computes in bf16, as the JAX
package's does. The
pipeline compiler fuses the stage only with ``compile(exact=False)``
(``fusable_kernel``).

Over the ranks of a process group the featurizer shards as ``TorchModel``
does (every rank calls ``transform`` with the same rows and gets every
row's features back); in a sharded fused segment its kernel runs on the
rank's block of the bucket, and the segment, not ``TorchModel``, gathers.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import (
    ComplexParam,
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
)
from mmlspark_tpu_torch.core.pipeline import Model
from mmlspark_tpu_torch.core.schema import image_row_to_array
from mmlspark_tpu_torch.downloader.zoo import ModelDownloader
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.ops import image as image_ops

class FeaturizerNet(nn.Module):
    """Raw pixels (N, H, W, C), 0..255, any dtype -> the named output of
    ``backbone``: BGR flip (``bgr``), resize to ``size``, normalise, then
    ``backbone(x, until=node)`` (a zoo ResNet or ViT stops there)."""

    def __init__(self, backbone: nn.Module, size: int, node: str, bgr: bool):
        super().__init__()
        self.backbone, self.size, self.node, self.bgr = backbone, size, node, bgr

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(_preprocess(x, self.size, self.bgr), until=self.node)[self.node]


def _preprocess(x: torch.Tensor, size: int, bgr: bool) -> torch.Tensor:
    x = x.float()
    if bgr:
        x = image_ops.bgr_to_rgb(x)
    return image_ops.normalize(image_ops.resize(x, size, size))


class ImageFeaturizer(Model, HasInputCol, HasOutputCol, HasBatchSize):
    # default = the zoo entry with COMMITTED TRAINED weights
    # (mmlspark_tpu_torch/downloader/builtin/); the large ResNet variants
    # stay selectable for scale benchmarking
    model_name = Param("zoo model name", default="ResNet8_Digits", type_=str)
    cut_output_layers = Param(
        "how many output layers to drop (0=logits, 1=pooled features)",
        default=1,
        type_=int,
    )
    repo_dir = Param("model repository directory", type_=str)
    drop_na = Param("drop rows whose image failed to decode", default=True, type_=bool)
    apply_fn = ComplexParam(
        "override: (variables, normalised (N, H, W, C) f32 images) -> dict of outputs"
    )
    variables = ComplexParam("override: backbone variables")
    module = ComplexParam("override: backbone nn.Module, called as module(x, until=name)")
    image_size = Param("input resolution override", type_=int)
    bgr_input = Param(
        "treat incoming channel order as BGR (reference image format)",
        default=False,
        type_=bool,
    )
    device = Param(
        "torch device: 'cuda' (default; raises without a card) or 'cpu'", type_=str
    )

    def __init__(self, **kw: Any):
        super().__init__(**kw)
        self._inner: Optional[TorchModel] = None
        self._schema: Any = None

    # -- model assembly ------------------------------------------------------

    def _build(self) -> TorchModel:
        if self._inner is not None:
            return self._inner
        backbone, apply_fn, variables = None, None, None
        if self.is_set("apply_fn") and self.is_set("variables"):
            apply_fn, variables = self.get("apply_fn"), self.get("variables")
            layer_names = ["logits", "pool"]
            size = self.get("image_size") or 224
        elif self.is_set("module"):
            backbone = self.get("module")
            layer_names = list(getattr(backbone, "LAYER_NAMES", ("logits", "pool")))
            size = self.get("image_size") or 224
        else:
            repo = ModelDownloader(self.get("repo_dir")) if self.get("repo_dir") else ModelDownloader()
            backbone, _, schema = repo.load(self.get("model_name"), device=self.get("device"))
            self._schema = schema
            layer_names = schema.layer_names
            size = self.get("image_size") or schema.image_size

        cut = self.get("cut_output_layers")
        if not 0 <= cut < len(layer_names):
            raise ValueError(
                f"cut_output_layers={cut} out of range for layers {layer_names}"
            )
        node, bgr = layer_names[cut], self.get("bgr_input")
        self._inner = TorchModel(
            input_col="__pixels__",
            output_col=self.get_or_fail("output_col"),
            batch_size=self.get("batch_size"),
            # keep host dtype: uint8 pixel batches transfer 4x less and the
            # net casts to f32 on the device
            input_dtype=None,
        )
        if backbone is not None:
            self._inner.set(module=FeaturizerNet(backbone, size, node, bgr))
        else:
            def full_fn(vs: Any, x: torch.Tensor) -> Any:
                out = apply_fn(vs, _preprocess(x, size, bgr))
                return out[node] if isinstance(out, dict) else out

            self._inner.set(apply_fn=full_fn, variables=variables)
        if self.get("device") is not None:
            self._inner.set(device=self.get("device"))
        return self._inner

    # -- host-side image coercion -------------------------------------------

    def _coerce_images(self, col: np.ndarray) -> tuple:
        """image structs / bytes / dense tensors -> ((N,H,W,C) array, keep mask)."""
        if col.dtype != object:
            # uint8 pixel tensors stay uint8 (device-side cast; cheaper copy)
            x = col if col.dtype == np.uint8 else col.astype(np.float32)
            if x.ndim == 2:  # unrolled vectors: roll back using model size
                size = self.get("image_size") or (
                    self._schema.image_size if self._schema else 224
                )
                # unrolled layout is always reference CHW/BGR. With
                # bgr_input=False, convert to RGB here (roll bgr=True);
                # with bgr_input=True keep BGR planes (roll bgr=False) so
                # the net's single bgr_to_rgb flip lands on RGB — never two.
                x = image_ops.roll(
                    torch.from_numpy(np.ascontiguousarray(x)), size, size,
                    bgr=not self.get("bgr_input"),
                ).contiguous().numpy()
            return x, np.ones(len(x), bool)
        rows = []
        for r in col:
            if isinstance(r, (bytes, bytearray)):
                arr = image_ops.decode_image(bytes(r))
            elif r is None:
                arr = None
            else:
                arr = image_row_to_array(r)
            rows.append(arr)
        keep = np.array([a is not None for a in rows], dtype=bool)
        if not keep.all() and not self.get("drop_na"):
            raise ValueError("undecodable image rows present and drop_na=False")
        good = [np.asarray(a) for a in rows if a is not None]
        if not good:
            return np.zeros((0, 1, 1, 3), np.float32), keep
        # decoded JPEG/PNG arrive uint8 — keep them uint8 so the batch ships
        # to the device at 1 byte/px (the net casts on the device)
        if all(a.dtype == np.uint8 for a in good):
            return np.stack(good), keep
        return np.stack([a.astype(np.float32) for a in good]), keep

    def pipeline_io(self) -> tuple:
        """Column deps for the pipeline compiler."""
        return (self.get_or_fail("input_col"),), (self.get_or_fail("output_col"),)

    @property
    def pipeline_row_preserving(self) -> bool:
        # drop_na may remove undecodable rows at runtime (object inputs
        # only) — the scheduler must not reorder branches around that
        return not self.get("drop_na")

    def fusable_kernel(self) -> Any:
        """Fusable for dense (N,H,W,C) pixel batches: the whole
        preprocess+backbone module (the staged path's ``TorchModel``
        runner) runs in the fused segment, captured into its CUDA graph,
        with bf16 outputs widened to f32 as the staged path widens them.
        Object columns (bytes/structs needing host decode) and unrolled
        2-D layouts guard-fall back to the staged path.

        ``exact_capable=False``: convolution algorithms are picked by batch
        shape, so exact-mode compilation (the default) keeps this stage
        host-bound; ``compile(exact=False)`` fuses the backbone into the
        segment at allclose-level equality. Row-wise: in a segment sharded
        over ranks ``fn`` gets the rank's block and runs the module on it
        directly (no ``apply_batch``, so no second gather)."""
        from mmlspark_tpu_torch.compiler.kernels import StageKernel

        ic = self.get_or_fail("input_col")
        oc = self.get_or_fail("output_col")
        inner = self._build()

        def fn(cols: dict) -> dict:
            x = cols[ic]
            y = inner._select(inner._runner(x.device)(x))
            return {oc: y.float() if y.dtype == torch.bfloat16 else y}

        def guard(cols: dict) -> Any:
            a = np.asarray(cols.get(ic))
            if a.dtype == object:
                return "object image column (host decode path)"
            if a.ndim != 4:
                return f"image column ndim={a.ndim} (unrolled host path)"
            return None

        return StageKernel(reads=(ic,), writes=(oc,), fn=fn, guard=guard,
                           cost_hint=20.0, exact_capable=False,
                           device=self.get("device"))

    def transform(self, df: DataFrame) -> DataFrame:
        ic = self.get_or_fail("input_col")
        inner = self._build()

        def fn(p: Partition) -> Partition:
            x, keep = self._coerce_images(p[ic])
            feats = inner.apply_batch(x) if len(x) else np.zeros((0, 1), np.float32)
            q = dict(p)
            if not keep.all():  # undecodable rows dropped from every column
                q = {k: v[keep] for k, v in p.items()}
            q[self.get_or_fail("output_col")] = feats
            return q

        return df.map_partitions(fn, parallel=False)
