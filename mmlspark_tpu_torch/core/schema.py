"""Column schema utilities.

Plays the role of the reference's schema layer: ``SparkBindings`` row<->struct
codecs (core/schema/SparkBindings.scala:13-46), image-schema checks
(``ImageSchemaUtils``), categorical metadata (core/schema/Categoricals.scala),
and ``DatasetExtensions.findUnusedColumnName``.

Here a DataFrame column is a numpy array per partition:
- scalar column: 1-D array (float/int/bool/str-object)
- vector column: 2-D array (rows x dim) — TPU-friendly dense layout
- tensor column: N-D array (rows x ...) e.g. images as (n, H, W, C)
- object column: 1-D object array (ragged payloads, structs, bytes)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass(frozen=True)
class ColumnInfo:
    """Shape/dtype summary of one column."""

    dtype: str          # numpy dtype name, or "object"
    shape: tuple        # per-row element shape, () for scalars
    metadata: dict = field(default_factory=dict, compare=False)

    @property
    def kind(self) -> str:
        if self.dtype == "object":
            return "object"
        if len(self.shape) == 0:
            return "scalar"
        if len(self.shape) == 1:
            return "vector"
        return "tensor"

    @staticmethod
    def of(arr: np.ndarray, metadata: Optional[dict] = None) -> "ColumnInfo":
        return ColumnInfo(
            dtype=str(arr.dtype) if arr.dtype != np.dtype("O") else "object",
            shape=tuple(arr.shape[1:]),
            metadata=metadata or {},
        )


class Schema(dict):
    """Mapping column name -> :class:`ColumnInfo` preserving insertion order."""

    def column_names(self) -> list:
        return list(self.keys())

    def __repr__(self) -> str:
        parts = ", ".join(
            f"{k}: {v.dtype}{list(v.shape) if v.shape else ''}" for k, v in self.items()
        )
        return f"Schema({parts})"


def infer_schema(partition: dict) -> Schema:
    s = Schema()
    for name, arr in partition.items():
        s[name] = ColumnInfo.of(np.asarray(arr))
    return s


def find_unused_column(base: str, existing) -> str:
    """``DatasetExtensions.findUnusedColumnName`` analogue."""
    name = base
    i = 0
    existing = set(existing)
    while name in existing:
        i += 1
        name = f"{base}_{i}"
    return name


# --------------------------------------------------------------------------
# Image schema — analogue of Spark's ImageSchema struct
# (io/image/ImageUtils.scala, core ImageSchemaUtils). An image column is a
# 1-D object array of dicts with these keys, OR a dense (n,H,W,C) uint8
# tensor column when shapes are uniform (the TPU-friendly form).
# --------------------------------------------------------------------------

IMAGE_FIELDS = ("origin", "height", "width", "nChannels", "mode", "data")


def make_image_row(
    data: np.ndarray, origin: str = "", mode: int = 16
) -> dict:
    """Build an image struct from an (H, W, C) uint8 array.

    mode 16 == CV_8UC3 (BGR), matching the reference's default
    (io/image/ImageUtils.scala)."""
    h, w = data.shape[:2]
    c = 1 if data.ndim == 2 else data.shape[2]
    return {
        "origin": origin,
        "height": int(h),
        "width": int(w),
        "nChannels": int(c),
        "mode": mode,
        "data": np.ascontiguousarray(data, dtype=np.uint8),
    }


def is_image_column(info: ColumnInfo) -> bool:
    if info.kind == "object":
        return info.metadata.get("logical_type") == "image"
    return len(info.shape) == 3 and info.dtype == "uint8"


def image_row_to_array(row: Any) -> np.ndarray:
    """Image struct (or raw array) -> (H, W, C) uint8 array."""
    if isinstance(row, dict):
        data = np.asarray(row["data"], dtype=np.uint8)
        return data.reshape(row["height"], row["width"], row["nChannels"])
    arr = np.asarray(row, dtype=np.uint8)
    return arr


# --------------------------------------------------------------------------
# Categorical metadata — CategoricalMap analogue
# (core/schema/Categoricals.scala). Levels ride in ColumnInfo.metadata so
# ValueIndexer / IndexToValue / TrainClassifier can round-trip labels.
# --------------------------------------------------------------------------

CATEGORICAL_KEY = "categorical_levels"


def with_categorical_levels(info: ColumnInfo, levels: list) -> ColumnInfo:
    md = dict(info.metadata)
    md[CATEGORICAL_KEY] = list(levels)
    return ColumnInfo(info.dtype, info.shape, md)


def get_categorical_levels(info: ColumnInfo):
    return info.metadata.get(CATEGORICAL_KEY)
