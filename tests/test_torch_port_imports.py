"""The port imports neither JAX nor the JAX package.

``mmlspark_tpu_torch`` and ``chip_smoke.py`` run on a machine without JAX,
so the port keeps its own copies of what it needs from the JAX package,
even of modules there that do not import JAX themselves.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mmlspark_tpu_torch"


def test_import_with_jax_blocked(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import mmlspark_tpu_torch, mmlspark_tpu_torch.models.gbdt\n"
        "from mmlspark_tpu_torch.models.gbdt import LightGBMRanker, LightGBMRankerModel\n"
        "import mmlspark_tpu_torch.models.gbdt.sampling, mmlspark_tpu_torch.models.gbdt.evaluation\n"
        "import mmlspark_tpu_torch.models.gbdt.lgbm_format, mmlspark_tpu_torch.models.gbdt.treeshap\n"
        "import mmlspark_tpu_torch.models.gbdt.checkpoint, mmlspark_tpu_torch.models.gbdt.delegate\n"
        "import mmlspark_tpu_torch.ops.histogram, mmlspark_tpu_torch.ops.cuda_build\n"
        "import mmlspark_tpu_torch.models.image_featurizer, mmlspark_tpu_torch.image\n"
        "import mmlspark_tpu_torch.downloader, mmlspark_tpu_torch.downloader.flax_msgpack\n"
        "import mmlspark_tpu_torch.models.torch_model, mmlspark_tpu_torch.models.resnet\n"
        "import mmlspark_tpu_torch.ops.image, mmlspark_tpu_torch.core.utils\n"
        "from mmlspark_tpu_torch.models import ImageFeaturizer, TorchModel\n"
        "from mmlspark_tpu_torch.image import ImageTransformer, ImageSetAugmenter\n"
        "from mmlspark_tpu_torch.downloader import ModelDownloader, install_torch_checkpoint\n"
        "sys.modules['flax'] = sys.modules['msgpack'] = None\n"
        "ModelDownloader(sys.argv[1]).load_variables('ResNet18_Patches')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'mmlspark_tpu' or m.startswith('mmlspark_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _imports(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu"), (
            f"{path.relative_to(ROOT)} imports {name}"
        )


def test_kernel_sources_ship_with_the_package():
    from mmlspark_tpu_torch.ops import cuda_build

    for src in cuda_build.SOURCES:
        assert (cuda_build.CSRC / src).is_file()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
