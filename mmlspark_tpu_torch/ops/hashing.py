"""Feature hashing — vectorized MurmurHash3 (x86_32).

The PyTorch port's copy of ``mmlspark_tpu.ops.hashing``. Hashing runs on the
host in both packages: ``hash_strings`` calls the native C++ murmur3
(``ops/native_loader.py``, the port's own build) and falls back to the numpy
path where no ``g++`` is at hand, as the JAX package does; both give the
same bits.

The reference reimplements VW's murmur hash in-JVM for speed
(vw/VowpalWabbitMurmurWithPrefix.scala:77) and hashes text n-grams via
Spark's HashingTF. Here the hash is vectorized over numpy uint32 lanes (the
whole token batch is hashed at once).

``murmur3_bytes`` matches the canonical MurmurHash3_x86_32 for arbitrary
byte strings, seed-parameterized, so hashed feature indices are stable
across runs/hosts (a persistence requirement for saved featurizers).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix(h: np.ndarray) -> np.ndarray:
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def murmur3_bytes(data: bytes, seed: int = 0) -> int:
    """Canonical MurmurHash3_x86_32 of one byte string."""
    with np.errstate(over="ignore"):
        h = np.uint32(seed)
        nblocks = len(data) // 4
        if nblocks:
            blocks = np.frombuffer(data[: nblocks * 4], dtype="<u4").copy()
            for k in blocks:
                k = np.uint32(k) * _C1
                k = _rotl32(k, 15) * _C2
                h ^= k
                h = _rotl32(h, 13)
                h = h * np.uint32(5) + np.uint32(0xE6546B64)
        tail = data[nblocks * 4:]
        k = np.uint32(0)
        if len(tail) >= 3:
            k ^= np.uint32(tail[2]) << np.uint32(16)
        if len(tail) >= 2:
            k ^= np.uint32(tail[1]) << np.uint32(8)
        if len(tail) >= 1:
            k ^= np.uint32(tail[0])
            k *= _C1
            k = _rotl32(k, 15) * _C2
            h ^= k
        h ^= np.uint32(len(data))
        return int(_fmix(h))


def hash_strings(tokens: Iterable[str], seed: int = 0) -> np.ndarray:
    """Hash a batch of strings -> uint32 array (tries the native kernel,
    falls back to the numpy path)."""
    from mmlspark_tpu_torch.ops import native_loader

    toks = [str(t).encode("utf-8") for t in tokens]
    native = native_loader.try_load()
    if native is not None:
        return native.murmur3_batch(toks, seed)
    return np.array([murmur3_bytes(t, seed) for t in toks], dtype=np.uint32)


def hashing_tf(
    docs: Sequence[Sequence[str]], num_features: int, seed: int = 0, binary: bool = False
) -> np.ndarray:
    """Batch of token lists -> dense (n, num_features) term-frequency matrix.

    Dense output feeds a matrix product directly; for very
    large num_features use the sparse segment-sum path in the VW module."""
    n = len(docs)
    out = np.zeros((n, num_features), dtype=np.float32)
    flat: list = []
    doc_idx: list = []
    for i, d in enumerate(docs):
        flat.extend(d)
        doc_idx.extend([i] * len(d))
    if not flat:
        return out
    idx = hash_strings(flat, seed) % np.uint32(num_features)
    np.add.at(out, (np.array(doc_idx), idx.astype(np.int64)), 1.0)
    if binary:
        out = (out > 0).astype(np.float32)
    return out


def hash_feature_index(name: str, num_bits: int, seed: int = 0) -> int:
    """Single feature-name -> index in 2^num_bits space (VW-style)."""
    return murmur3_bytes(name.encode("utf-8"), seed) & ((1 << num_bits) - 1)
