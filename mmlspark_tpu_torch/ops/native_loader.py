"""Native host kernels — the NativeLoader analogue (core/env/NativeLoader.java:28-62).

The PyTorch port of ``mmlspark_tpu.ops.native_loader``, with its own copy of
the C++ source (``ops/native/mmltpu.cc``: murmur3 hashing, feature binning,
CSV parsing). It compiles with ``g++`` at first use into the port's build
directory (``build/mmlspark_tpu_torch/`` at the repository root, or
``MMLSPARK_TPU_TORCH_BUILD_DIR``), under a file name keyed by the source's
hash as ``ops/cuda_build.py`` keys the CUDA kernels, and is bound with
ctypes. It never builds inside the JAX package. Without a toolchain
``try_load`` returns None and callers take their numpy paths, which give
the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional["_NativeLib"] = None
_failed = False

SOURCE = Path(__file__).resolve().parent / "native" / "mmltpu.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    from mmlspark_tpu_torch.ops.cuda_build import build_dir

    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return build_dir() / f"libmmltpu-{h.hexdigest()[:16]}.so"


class _NativeLib:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.mml_murmur3_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.mml_murmur3_batch.restype = None
        lib.mml_bin_features.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.mml_bin_features.restype = None
        lib.mml_parse_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.mml_parse_csv.restype = ctypes.c_int64
        lib.mml_csv_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mml_csv_dims.restype = None

    def murmur3_batch(self, toks: list, seed: int) -> np.ndarray:
        """MurmurHash3_x86_32 of each byte string -> uint32 array."""
        n = len(toks)
        arr = (ctypes.c_char_p * n)(*toks)
        lens = np.array([len(t) for t in toks], dtype=np.int32)
        out = np.empty(n, dtype=np.uint32)
        self._lib.mml_murmur3_batch(
            ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            seed,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return out

    def bin_features(self, x: np.ndarray, uppers: list) -> np.ndarray:
        """(n, d) float32 -> uint8 bins via per-feature edge search (threaded)."""
        x = np.ascontiguousarray(x, np.float32)
        n, d = x.shape
        offsets = np.zeros(d + 1, np.int64)
        for f, u in enumerate(uppers):
            offsets[f + 1] = offsets[f] + len(u)
        edges = (
            np.concatenate([np.asarray(u, np.float64) for u in uppers])
            if offsets[-1]
            else np.zeros(0, np.float64)
        )
        out = np.empty((n, d), np.uint8)
        self._lib.mml_bin_features(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            d,
            edges.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out

    def parse_csv(self, data: bytes) -> np.ndarray:
        """Numeric CSV bytes -> (rows, cols) float64 (bad fields = NaN)."""
        n_rows = ctypes.c_int64()
        n_cols = ctypes.c_int64()
        self._lib.mml_csv_dims(data, len(data), ctypes.byref(n_rows), ctypes.byref(n_cols))
        out = np.empty((n_rows.value, n_cols.value), np.float64)
        got = self._lib.mml_parse_csv(
            data,
            len(data),
            n_cols.value,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_rows.value,
        )
        return out[:got]


def _build() -> Optional[Path]:
    so_path = library_path()
    if so_path.exists():
        return so_path
    so_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so_path.parent)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, so_path)  # atomic: concurrent builders race harmlessly
    return so_path


def try_load() -> Optional[_NativeLib]:
    """Build+load the native kernel library, or None if unavailable."""
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed:
        return None
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = _build()
        if so is None:
            _failed = True
            return None
        try:
            _lib = _NativeLib(ctypes.CDLL(str(so)))
        except OSError:
            _failed = True
            return None
    return _lib
