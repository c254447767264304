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
        "import mmlspark_tpu_torch.models.gbdt.sketch, mmlspark_tpu_torch.models.gbdt.binning\n"
        "from mmlspark_tpu_torch.models.gbdt import (BinnedDataset, QuantileSketch,\n"
        "    TrainCheckpoint, load_checkpoint, save_checkpoint)\n"
        "import mmlspark_tpu_torch.ops.histogram, mmlspark_tpu_torch.ops.cuda_build\n"
        "import mmlspark_tpu_torch.models.image_featurizer, mmlspark_tpu_torch.image\n"
        "import mmlspark_tpu_torch.downloader, mmlspark_tpu_torch.downloader.flax_msgpack\n"
        "import mmlspark_tpu_torch.models.torch_model, mmlspark_tpu_torch.models.resnet\n"
        "import mmlspark_tpu_torch.ops.image, mmlspark_tpu_torch.core.utils\n"
        "from mmlspark_tpu_torch.models import ImageFeaturizer, TorchModel\n"
        "from mmlspark_tpu_torch.image import ImageTransformer, ImageSetAugmenter\n"
        "from mmlspark_tpu_torch.downloader import ModelDownloader, install_torch_checkpoint\n"
        "import mmlspark_tpu_torch.compiler, mmlspark_tpu_torch.obs, mmlspark_tpu_torch.stages\n"
        "import mmlspark_tpu_torch.featurize, mmlspark_tpu_torch.models.linear\n"
        "import mmlspark_tpu_torch.ops.hashing, mmlspark_tpu_torch.core.profiling\n"
        "from mmlspark_tpu_torch.compiler import CompiledPipeline, pairwise_sum\n"
        "from mmlspark_tpu_torch.featurize import Featurize, FeaturizeModel\n"
        "from mmlspark_tpu_torch.stages import UDFTransformer\n"
        "import mmlspark_tpu_torch.vw, mmlspark_tpu_torch.vw.learner, mmlspark_tpu_torch.ops.sgd\n"
        "import mmlspark_tpu_torch.ops.native_loader, mmlspark_tpu_torch.featurize.text\n"
        "from mmlspark_tpu_torch.vw import VowpalWabbitClassifier, VowpalWabbitContextualBandit\n"
        "from mmlspark_tpu_torch.stages import SummarizeData, FlattenBatch, VectorZipper\n"
        "from mmlspark_tpu_torch.featurize import CleanMissingData, ValueIndexer, TextFeaturizer\n"
        "from mmlspark_tpu_torch.ops.native_loader import try_load\n"
        "import mmlspark_tpu_torch.parallel, mmlspark_tpu_torch.core.faults\n"
        "from mmlspark_tpu_torch.parallel import collectives, distributed, sharding, mesh\n"
        "from mmlspark_tpu_torch.models.gbdt.voting import grow_tree_voting\n"
        "import mmlspark_tpu_torch.serving, mmlspark_tpu_torch.serving.modelstore\n"
        "from mmlspark_tpu_torch.serving import server, udfs, admission, query\n"
        "from mmlspark_tpu_torch.serving.modelstore import store, loaders, dispatch\n"
        "from mmlspark_tpu_torch.obs import flightrec, prof, watchdog\n"
        "import mmlspark_tpu_torch.io.port_forwarding\n"
        "from mmlspark_tpu_torch.serving import WorkerServer, ServingQuery, serve_transformer\n"
        "from mmlspark_tpu_torch.serving.modelstore import (ModelStore, ModelDispatcher,\n"
        "    HBMBudgetExceeded, build_loaded_model, tensor_nbytes)\n"
        "assert try_load() is not None\n"
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


def test_gbdt_exports_every_name_of_the_jax_package():
    """Every name in ``mmlspark_tpu.models.gbdt.__all__`` is in the port's
    ``__all__`` and importable from it (no exceptions left)."""
    import mmlspark_tpu.models.gbdt as J
    import mmlspark_tpu_torch.models.gbdt as P

    missing = [n for n in J.__all__ if n not in P.__all__ or not hasattr(P, n)]
    assert missing == []


# names of the JAX package's ``__all__`` the port does not export yet: none
# (ROADMAP.md Queue A items 6 and 8, ``vw`` included, are ported; so is
# A4 step 1, ``parallel``)
A6_REMAINDER = {"stages": set(), "featurize": set(), "vw": set(), "compiler": set(),
                "obs": set(), "parallel": set()}


@pytest.mark.parametrize("package", sorted(A6_REMAINDER))
def test_pipeline_slice_exports_every_name(package):
    """Each name of the JAX package's ``__all__`` is exported by the port
    (``A6_REMAINDER`` lists none)."""
    import importlib

    J = importlib.import_module(f"mmlspark_tpu.{package}")
    P = importlib.import_module(f"mmlspark_tpu_torch.{package}")
    missing = {n for n in J.__all__ if n not in P.__all__ or not hasattr(P, n)}
    assert missing == A6_REMAINDER[package] == set()


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
