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
        "import mmlspark_tpu_torch.io.http_schema, mmlspark_tpu_torch.io.clients\n"
        "from mmlspark_tpu_torch.io import HTTPRequestData, send_request, AdvancedHandler\n"
        "from mmlspark_tpu_torch.serving import DriverRegistry, registry, fleet\n"
        "from mmlspark_tpu_torch.parallel import elastic\n"
        "from mmlspark_tpu_torch.parallel.elastic import (ElasticTrainer, GangContext,\n"
        "    GangMember, TcpReducer, load_training_data, snapshot_checkpoint)\n"
        "from mmlspark_tpu_torch.serving import WorkerServer, ServingQuery, serve_transformer\n"
        "from mmlspark_tpu_torch.serving.modelstore import (ModelStore, ModelDispatcher,\n"
        "    HBMBudgetExceeded, build_loaded_model, tensor_nbytes)\n"
        "from mmlspark_tpu_torch.io import read_csv, read_images, StreamingDataFrame\n"
        "from mmlspark_tpu_torch.io.consolidator import PartitionConsolidator\n"
        "from mmlspark_tpu_torch.chaos import ChaosProxy, WireRule\n"
        "from mmlspark_tpu_torch.serving.artifacts import ArtifactStore, resolve_spec\n"
        "from mmlspark_tpu_torch.parallel.elastic import (load_streaming_data,\n"
        "    stream_from_dataframe, replicate_snapshot, gang_voting_k)\n"
        "from mmlspark_tpu_torch.models.gbdt.voting import grow_tree_voting_gang\n"
        "from mmlspark_tpu_torch.serving import (ServingGateway, BackendPool, Backend,\n"
        "    FleetSupervisor, WorkerCharge, distributed, supervisor)\n"
        "from mmlspark_tpu_torch.serving.distributed import (WireConn, CircuitBreaker,\n"
        "    RetryBudget, HedgeConnPool)\n"
        "from mmlspark_tpu_torch.obs import slo, traces, SLOEngine, SLOTarget\n"
        "from mmlspark_tpu_torch.online import Autoscaler, FleetSignals, ScaleSignals\n"
        "from mmlspark_tpu_torch.serving.fleet import (run_worker, run_gateway,\n"
        "    run_supervise, run_top, run_trace, run_traces_slowest, run_profile,\n"
        "    run_model_verb)\n"
        "from mmlspark_tpu_torch.online import (FeedbackStream, OnlineLearningLoop,\n"
        "    OnlineTrainer, PublishError, Publisher)\n"
        "from mmlspark_tpu_torch.online import feedback, loop, publisher, trainer\n"
        "from mmlspark_tpu_torch.automl import RandomSpace, DefaultHyperparams, hyperparams\n"
        "from mmlspark_tpu_torch.experiments import (asha, records, ExperimentState,\n"
        "    ExperimentController, run_trial)\n"
        "from mmlspark_tpu_torch.experiments import controller, trial\n"
        "from mmlspark_tpu_torch.chaos import (ChaosConductor, InvariantChecker, Scenario,\n"
        "    Violation, conductor, invariants)\n"
        "from mmlspark_tpu_torch.chaos.conductor import run_chaos_cli\n"
        "from mmlspark_tpu_torch.serving.fleet import run_online\n"
        "from mmlspark_tpu_torch.core.profiling import trace, annotate, ProfiledRun\n"
        "from mmlspark_tpu_torch.ops.ring_attention import ring_attention, dense_attention\n"
        "from mmlspark_tpu_torch.models import vit, sequence\n"
        "from mmlspark_tpu_torch.models.vit import ViT, VITS, init_flax_variables\n"
        "from mmlspark_tpu_torch.models.sequence import BiLSTMTagger, train_tagger\n"
        "from mmlspark_tpu_torch.downloader import import_torch_vit\n"
        "from mmlspark_tpu_torch.lime import ImageLIME, TabularLIME, slic, lasso\n"
        "from mmlspark_tpu_torch.nn import KNN, ConditionalKNN, BallTree\n"
        "from mmlspark_tpu_torch.recommendation import (SAR, SARModel, RankingEvaluator,\n"
        "    RankingAdapter, RankingTrainValidationSplit, RecommendationIndexer)\n"
        "from mmlspark_tpu_torch.recommendation import indexer, evaluator, adapter, split, sar\n"
        "from mmlspark_tpu_torch.isolationforest import IsolationForest, forest\n"
        "from mmlspark_tpu_torch.cyber import (AccessAnomaly, als_train, complement_sample,\n"
        "    synthetic_access_df, StandardScalarScaler, LinearScalarScaler)\n"
        "from mmlspark_tpu_torch.cyber import als, anomaly, complement, scalers, dataset\n"
        "from mmlspark_tpu_torch.lightgbm import LightGBMBooster, LightGBMClassifier\n"
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


@pytest.mark.parametrize("module", [
    "mmlspark_tpu_torch.io.csv", "mmlspark_tpu_torch.io.binary",
    "mmlspark_tpu_torch.io.consolidator", "mmlspark_tpu_torch.io.stream",
    "mmlspark_tpu_torch.chaos.wire", "mmlspark_tpu_torch.serving.artifacts",
    "mmlspark_tpu_torch.obs.traces", "mmlspark_tpu_torch.obs.slo",
    "mmlspark_tpu_torch.serving.distributed", "mmlspark_tpu_torch.online.autoscaler",
    "mmlspark_tpu_torch.serving.supervisor", "mmlspark_tpu_torch.serving.fleet",
    "mmlspark_tpu_torch.online.trainer", "mmlspark_tpu_torch.online.feedback",
    "mmlspark_tpu_torch.online.publisher", "mmlspark_tpu_torch.online.loop",
    "mmlspark_tpu_torch.online", "mmlspark_tpu_torch.automl.hyperparams",
    "mmlspark_tpu_torch.experiments.asha", "mmlspark_tpu_torch.experiments.records",
    "mmlspark_tpu_torch.experiments.trial", "mmlspark_tpu_torch.experiments.controller",
    "mmlspark_tpu_torch.experiments", "mmlspark_tpu_torch.chaos.invariants",
    "mmlspark_tpu_torch.chaos.conductor", "mmlspark_tpu_torch.chaos",
    "mmlspark_tpu_torch.core.profiling", "mmlspark_tpu_torch.ops.ring_attention",
    "mmlspark_tpu_torch.models.vit", "mmlspark_tpu_torch.models.sequence",
    "mmlspark_tpu_torch.downloader.torch_import", "mmlspark_tpu_torch.lime.superpixel",
    "mmlspark_tpu_torch.lime.lasso", "mmlspark_tpu_torch.lime.lime", "mmlspark_tpu_torch.lime",
    "mmlspark_tpu_torch.nn.balltree", "mmlspark_tpu_torch.nn.knn", "mmlspark_tpu_torch.nn",
    "mmlspark_tpu_torch.recommendation.indexer", "mmlspark_tpu_torch.recommendation.evaluator",
    "mmlspark_tpu_torch.recommendation.sar", "mmlspark_tpu_torch.recommendation.adapter",
    "mmlspark_tpu_torch.recommendation.split", "mmlspark_tpu_torch.recommendation",
    "mmlspark_tpu_torch.isolationforest.forest", "mmlspark_tpu_torch.isolationforest",
    "mmlspark_tpu_torch.cyber.als", "mmlspark_tpu_torch.cyber.complement",
    "mmlspark_tpu_torch.cyber.scalers", "mmlspark_tpu_torch.cyber.dataset",
    "mmlspark_tpu_torch.cyber.anomaly", "mmlspark_tpu_torch.cyber",
    "mmlspark_tpu_torch.lightgbm",
])
def test_no_shared_disk_modules_import_alone(module):
    """Each module of the gang's no-shared-disk modes, of the serving
    fleet, of continuous learning, of the experiments, of the chaos
    conductor, of the profiler, ring attention, the ViT and BiLSTM models,
    LIME, KNN, SAR, the isolation forest, CyberML and the ``lightgbm``
    alias, alone in a fresh interpreter, loads neither JAX nor the JAX
    package."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "             or m == 'mmlspark_tpu' or m.startswith('mmlspark_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
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
# (ROADMAP.md Queue A items 6 and 8, ``vw`` included, are ported; so are
# A4 step 1, ``parallel``, A7, ``serving``, ``online``, ``experiments``
# and ``chaos``, and A10's ``lime``, ``nn``, ``recommendation``,
# ``isolationforest``, ``cyber`` and the ``lightgbm`` alias)
A6_REMAINDER = {"stages": set(), "featurize": set(), "vw": set(), "compiler": set(),
                "obs": set(), "parallel": set(), "serving": set(), "online": set(),
                "experiments": set(), "chaos": set(), "lime": set(), "nn": set(),
                "downloader": set(), "recommendation": set(), "isolationforest": set(),
                "cyber": set(), "lightgbm": set()}


@pytest.mark.parametrize("package", sorted(A6_REMAINDER))
def test_pipeline_slice_exports_every_name(package):
    """Each name of the JAX package's ``__all__`` is exported by the port
    (``A6_REMAINDER`` lists none)."""
    import importlib

    J = importlib.import_module(f"mmlspark_tpu.{package}")
    P = importlib.import_module(f"mmlspark_tpu_torch.{package}")
    missing = {n for n in J.__all__ if n not in P.__all__ or not hasattr(P, n)}
    assert missing == A6_REMAINDER[package] == set()


def test_models_and_top_level_export_every_name():
    """``models`` exports every name of the JAX package's but ``XLAModel``,
    whose counterpart is ``TorchModel``; the top level exports the JAX
    package's names."""
    import mmlspark_tpu as JT
    import mmlspark_tpu.models as J
    import mmlspark_tpu_torch as PT
    import mmlspark_tpu_torch.models as P

    assert {n for n in J.__all__ if n not in P.__all__ or not hasattr(P, n)} == {"XLAModel"}
    assert "TorchModel" in P.__all__
    assert set(JT.__all__) == set(PT.__all__)


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
