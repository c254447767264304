"""The port's native host library against the JAX package's hashing.

``mmlspark_tpu_torch.ops.native_loader`` builds its own copy of
``mmltpu.cc`` with ``g++`` into the port's build directory. Its murmur3
equals the JAX package's ``hash_strings`` bit for bit, and so does the
port's numpy path; building it writes nothing under ``mmlspark_tpu/``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mmlspark_tpu.ops import hashing as JH
from mmlspark_tpu_torch.ops import hashing as PH
from mmlspark_tpu_torch.ops import native_loader as PN

ROOT = Path(__file__).resolve().parents[1]

TOKENS = ["", "a", "ab", "abc", "abcd", "abcde", "Constant", "text=hello world",
          "naïve", "日本語", "x" * 1000, "w17", "col.key"] + [f"w{i}" for i in range(300)]


@pytest.fixture(scope="module")
def lib():
    lib = PN.try_load()
    if lib is None:
        pytest.skip("no g++: the native library cannot build here")
    return lib


@pytest.mark.parametrize("seed", [0, 1, 42, 0xFFFFFFFF])
def test_native_murmur3_equals_the_jax_package(lib, seed):
    got = lib.murmur3_batch([t.encode("utf-8") for t in TOKENS], seed)
    want = JH.hash_strings(TOKENS, seed)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert np.array_equal(PH.hash_strings(TOKENS, seed), want)


@pytest.mark.parametrize("seed", [0, 7])
def test_numpy_path_equals_the_jax_package(seed):
    got = np.array([PH.murmur3_bytes(t.encode("utf-8"), seed) for t in TOKENS], np.uint32)
    assert np.array_equal(got, JH.hash_strings(TOKENS, seed))
    assert PH.hash_feature_index("Constant", 18) == JH.hash_feature_index("Constant", 18)


def test_hash_strings_takes_the_numpy_path_without_the_library(monkeypatch):
    monkeypatch.setattr(PN, "try_load", lambda: None)
    assert np.array_equal(PH.hash_strings(TOKENS, 3), JH.hash_strings(TOKENS, 3))


def test_binning_and_csv_parse(lib):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 4)).astype(np.float32)
    x[rng.random((500, 4)) < 0.05] = np.nan
    uppers = [np.sort(rng.normal(size=int(rng.integers(0, 20)))) for _ in range(4)]
    got = lib.bin_features(x, uppers)
    for f in range(4):
        want = np.where(np.isnan(x[:, f]), 0, np.searchsorted(uppers[f], x[:, f]) + 1)
        assert np.array_equal(got[:, f], want.astype(np.uint8))
    out = lib.parse_csv(b"1,2.5,x\n3,4,5\n")
    assert out.shape == (2, 3) and out[1, 2] == 5.0 and np.isnan(out[0, 2])


def _tree_state(path: Path) -> dict:
    """Files under ``path`` and their mtimes, without what the JAX package
    writes there itself (bytecode caches and its own native build, which
    tests running beside this one may write)."""
    return {
        str(p): p.stat().st_mtime_ns for p in path.rglob("*")
        if "__pycache__" not in p.parts and "build" not in p.parts
    }


def test_builds_under_the_port_build_dir_only(tmp_path):
    """A fresh build lands in the port's build directory (here the override
    ``MMLSPARK_TPU_TORCH_BUILD_DIR``), keyed by the source's hash, and
    writes nothing under the JAX package."""
    before = _tree_state(ROOT / "mmlspark_tpu")
    code = (
        "from mmlspark_tpu_torch.ops import native_loader as N\n"
        "lib = N.try_load()\n"
        "assert lib is not None\n"
        "print(N.library_path())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), MMLSPARK_TPU_TORCH_BUILD_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0 and "assert lib is not None" in r.stderr:
        pytest.skip("no g++: the native library cannot build here")
    assert r.returncode == 0, r.stderr
    so = Path(r.stdout.strip())
    assert so.parent == tmp_path and so.is_file() and so.name.startswith("libmmltpu-")
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
    assert _tree_state(ROOT / "mmlspark_tpu") == before
    assert not list((ROOT / "mmlspark_tpu").rglob("libmmltpu-*"))


def test_default_build_dir_is_the_ports(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_TORCH_BUILD_DIR", raising=False)
    assert PN.library_path().parent == ROOT / "build" / "mmlspark_tpu_torch"
    assert PN.SOURCE == ROOT / "mmlspark_tpu_torch" / "ops" / "native" / "mmltpu.cc"
