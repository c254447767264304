"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``. The build happens at first
use, from the sources in the checkout, into ``build/mmlspark_tpu_torch/`` at
the repository root (``MMLSPARK_TPU_TORCH_BUILD_DIR`` overrides it). A
library's file name carries a hash of its source, of every other file under
``csrc/`` (headers it may include) and of the flags, so an edited source or
header rebuilds and an unchanged one loads as it is.

Nothing here runs at import time: the CPU tests import every module, and a
machine without ``nvcc`` must still import the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("histogram.cu", "sgd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}  # source -> nvcc output of this process's build ("" if cached)


def build_dir() -> Path:
    env = os.environ.get("MMLSPARK_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "mmlspark_tpu_torch"


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "mmlspark_tpu_torch build from source at first use"
    )


def _lib_path(source: str) -> Path:
    h = hashlib.sha256(source.encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(CSRC)).encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _start(source: str) -> "tuple[Path, subprocess.Popen | None, str]":
    out = _lib_path(source)
    if out.exists():
        return out, None, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, proc, tmp


def build_all() -> dict:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, all started together. Returns {source: library path}; raises
    with the compiler's output if a build fails."""
    started = {s: _start(s) for s in SOURCES}
    paths = {}
    for source, (out, proc, tmp) in started.items():
        if proc is None:
            build_logs.setdefault(source, "")
            paths[source] = out
            continue
        log, _ = proc.communicate()
        build_logs[source] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
        paths[source] = out
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[source]))
            _libs[source] = lib
        return lib
