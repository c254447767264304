"""Sparse hashed-feature representation shared by the VW-style stages.

The PyTorch port's copy of ``mmlspark_tpu.vw.sparse`` (host numpy in both).

A sparse feature row is a dict ``{"i": int64[nnz], "v": float32[nnz]}``
(indices into a 2^num_bits weight space, values). Column metadata carries
``{"sparse": True, "num_bits": b}``.

Batches are *padded* to a static max-nnz — ``(B, K)`` index and value
matrices — so the training/scoring kernels are fixed-shape gathers and
scatter-adds (padding values are 0.0 so they are exact no-ops in dot
products and gradients; the card's SGD kernels skip them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

SPARSE_META = "sparse"
NUM_BITS_META = "num_bits"


def make_sparse(indices: np.ndarray, values: np.ndarray, dedupe: bool = True) -> dict:
    """Build one sparse row, summing duplicate indices (VW sum-collisions)."""
    idx = np.asarray(indices, np.int64).ravel()
    val = np.asarray(values, np.float32).ravel()
    if dedupe and len(idx):
        uniq, inv = np.unique(idx, return_inverse=True)
        if len(uniq) != len(idx):
            summed = np.zeros(len(uniq), np.float32)
            np.add.at(summed, inv, val)
            idx, val = uniq, summed
    return {"i": idx, "v": val}


def empty_sparse() -> dict:
    return {"i": np.zeros(0, np.int64), "v": np.zeros(0, np.float32)}


def concat_sparse(rows: Sequence[dict]) -> dict:
    """Concatenate several namespaces of one example into one sparse row."""
    if not rows:
        return empty_sparse()
    return make_sparse(
        np.concatenate([r["i"] for r in rows]),
        np.concatenate([r["v"] for r in rows]),
        dedupe=False,
    )


def pad_sparse_batch(
    col: Sequence[dict], max_nnz: Optional[int] = None, multiple: int = 8
) -> tuple:
    """Object column of sparse rows -> padded ``(idx, val)`` dense batch.

    Pads nnz up to a multiple (fewer distinct compiled shapes) and rows with
    value 0.0 / index 0 (no-ops in every kernel)."""
    n = len(col)
    if max_nnz is None:
        max_nnz = max((len(r["i"]) for r in col), default=1)
    max_nnz = max(1, int(np.ceil(max(1, max_nnz) / multiple)) * multiple)
    idx = np.zeros((n, max_nnz), np.int64)
    val = np.zeros((n, max_nnz), np.float32)
    for r, row in enumerate(col):
        k = min(len(row["i"]), max_nnz)
        idx[r, :k] = row["i"][:k]
        val[r, :k] = row["v"][:k]
    return idx, val
