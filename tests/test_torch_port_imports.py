"""The port imports neither JAX nor the JAX package.

``mmlspark_tpu_torch`` and ``chip_smoke.py`` run on a machine without JAX,
so the port keeps its own copies of what it needs from the JAX package,
even of modules there that do not import JAX themselves.
"""

from __future__ import annotations

import ast
import json
import os
import queue
import subprocess
import sys
import threading
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
        "from mmlspark_tpu_torch.io import (HTTPTransformer, SimpleHTTPTransformer,\n"
        "    JSONInputParser, JSONOutputParser, StringOutputParser, CustomInputParser,\n"
        "    CustomOutputParser, PowerBIWriter, SharedVariable, SharedSingleton)\n"
        "from mmlspark_tpu_torch.io import http_transformer, parsers, powerbi, shared\n"
        "from mmlspark_tpu_torch.train import (TrainClassifier, TrainRegressor, OneVsRest,\n"
        "    ComputeModelStatistics, ComputePerInstanceStatistics, TrainedClassifierModel)\n"
        "from mmlspark_tpu_torch.train import statistics\n"
        "from mmlspark_tpu_torch.automl import TuneHyperparameters, FindBestModel, tune\n"
        "from mmlspark_tpu_torch.cognitive import (TextSentiment, AnalyzeImage, DetectFace,\n"
        "    DetectAnomalies, SpeechToTextSDK, BingImageSearch, CognitiveServiceBase)\n"
        "from mmlspark_tpu_torch.cognitive import (schemas, base, text, vision, face,\n"
        "    anomaly, audio, speech, search)\n"
        "from mmlspark_tpu_torch import plot, codegen\n"
        "from mmlspark_tpu_torch.codegen import generate_manifest, generate_r_package\n"
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


# The import-alone check's helper: one interpreter per test module, which
# imports torch and numpy once, proves that neither loaded JAX, flax or the
# JAX package, and then forks a child per module to import; each child
# reports what its import loaded. No torch op runs before a fork and the
# thread pools are sized to one, so the helper forks with one thread.
_FORK_HELPER = r"""
import importlib, json, os, sys
import numpy, torch

def loaded(extra):
    tops = ("jax", "jaxlib", "flax") + tuple(extra)
    return sorted(m for m in sys.modules if m.split(".")[0] in tops
                  or m == "mmlspark_tpu" or m.startswith("mmlspark_tpu."))

assert not loaded(()), loaded(())
# one thread: no pool is live at a fork (the helper's environment sizes
# OpenMP's and OpenBLAS's pools to one)
assert len(os.listdir("/proc/self/task")) == 1, os.listdir("/proc/self/task")
print(json.dumps({"ready": True}), flush=True)
for line in sys.stdin:
    req = json.loads(line)
    pid = os.fork()
    if pid == 0:
        try:
            importlib.import_module(req["module"])
            out = {"bad": loaded(req["extra"])}
        except BaseException as e:
            out = {"error": repr(e)}
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()
        os._exit(0)
    _, status = os.waitpid(pid, 0)
    print(json.dumps({"status": status}), flush=True)
"""


class _ForkHelper:
    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _FORK_HELPER], cwd=ROOT, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                     OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1"),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()
        first = self._next()
        assert first == {"ready": True}, first

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def _next(self) -> dict:
        line = self.lines.get(timeout=120)
        assert line is not None, self.proc.stderr.read()
        return json.loads(line)

    def imports(self, module: str, extra: tuple = ()) -> dict:
        """What importing ``module`` alone loaded of JAX, flax, the JAX
        package and ``extra``, or its error."""
        self.proc.stdin.write(json.dumps({"module": module, "extra": list(extra)}) + "\n")
        self.proc.stdin.flush()
        out = self._next()
        if "status" in out:  # the child died before it could report
            return {"error": f"child exited with status {out['status']}"}
        status = self._next()
        assert status == {"status": 0}, status
        return out

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=30)


@pytest.fixture(scope="module")
def fork_helper():
    helper = _ForkHelper()
    yield helper
    helper.close()


ALONE = [
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
    "mmlspark_tpu_torch.io.shared", "mmlspark_tpu_torch.io.parsers",
    "mmlspark_tpu_torch.io.http_transformer", "mmlspark_tpu_torch.io.powerbi",
    "mmlspark_tpu_torch.io", "mmlspark_tpu_torch.train.statistics",
    "mmlspark_tpu_torch.train.train", "mmlspark_tpu_torch.train",
    "mmlspark_tpu_torch.automl.tune", "mmlspark_tpu_torch.automl",
    "mmlspark_tpu_torch.cognitive.schemas", "mmlspark_tpu_torch.cognitive.base",
    "mmlspark_tpu_torch.cognitive.text", "mmlspark_tpu_torch.cognitive.vision",
    "mmlspark_tpu_torch.cognitive.face", "mmlspark_tpu_torch.cognitive.anomaly",
    "mmlspark_tpu_torch.cognitive.audio", "mmlspark_tpu_torch.cognitive.speech",
    "mmlspark_tpu_torch.cognitive.search", "mmlspark_tpu_torch.cognitive",
    "mmlspark_tpu_torch.codegen",
]


@pytest.mark.parametrize("module", ALONE)
def test_no_shared_disk_modules_import_alone(fork_helper, module):
    """Each module of the gang's no-shared-disk modes, of the serving
    fleet, of continuous learning, of the experiments, of the chaos
    conductor, of the profiler, ring attention, the ViT and BiLSTM models,
    LIME, KNN, SAR, the isolation forest, CyberML, the ``lightgbm`` alias,
    the HTTP transformers, parsers and writers, training, tuning, the
    cognitive services and codegen, imported alone, loads neither JAX nor
    the JAX package.

    Each import runs in a child forked from a helper that has imported
    ``torch`` and numpy already (``fork_helper``). That leaves the check
    intact: ``torch`` and numpy never load JAX, flax or the JAX package,
    and the helper proves it before its first fork, so whatever of those
    a child holds after its import, that import loaded."""
    assert fork_helper.imports(module) == {"bad": []}


def test_plot_imports_alone_without_matplotlib(fork_helper):
    """``plot`` loads matplotlib only when a plot is drawn."""
    assert fork_helper.imports("mmlspark_tpu_torch.plot", ("matplotlib",)) == {"bad": []}


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
# and ``chaos``, and A10: ``lime``, ``nn``, ``recommendation``,
# ``isolationforest``, ``cyber``, the ``lightgbm`` alias, ``io``,
# ``train``, ``automl`` and ``cognitive``)
A6_REMAINDER = {"stages": set(), "featurize": set(), "vw": set(), "compiler": set(),
                "obs": set(), "parallel": set(), "serving": set(), "online": set(),
                "experiments": set(), "chaos": set(), "lime": set(), "nn": set(),
                "downloader": set(), "recommendation": set(), "isolationforest": set(),
                "cyber": set(), "lightgbm": set(), "io": set(), "train": set(),
                "automl": set(), "cognitive": set()}


@pytest.mark.parametrize("package", sorted(A6_REMAINDER))
def test_pipeline_slice_exports_every_name(package):
    """Each name of the JAX package's ``__all__`` is exported by the port
    (``A6_REMAINDER`` lists none)."""
    import importlib

    J = importlib.import_module(f"mmlspark_tpu.{package}")
    P = importlib.import_module(f"mmlspark_tpu_torch.{package}")
    missing = {n for n in J.__all__ if n not in P.__all__ or not hasattr(P, n)}
    assert missing == A6_REMAINDER[package] == set()


@pytest.mark.parametrize("module", ["codegen", "plot"])
def test_modules_without_all_export_every_public_function(module):
    """``codegen`` and ``plot`` have no ``__all__``: each public function
    of the JAX module is in the port's, with the same parameters."""
    import importlib
    import inspect

    J = importlib.import_module(f"mmlspark_tpu.{module}")
    P = importlib.import_module(f"mmlspark_tpu_torch.{module}")
    names = [n for n, f in vars(J).items() if inspect.isfunction(f)
             and f.__module__ == J.__name__ and not n.startswith("_")]
    assert names
    for n in names:
        assert list(inspect.signature(getattr(P, n)).parameters) == \
            list(inspect.signature(getattr(J, n)).parameters), n


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
