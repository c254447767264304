"""The port's ``codegen/`` and its stage registry against the JAX package's
committed manifest (``docs/api/manifest.json``, read-only), on the CPU.

Every one of the JAX package's stages has its counterpart in the port, of
the same name, kind and module path (package name swapped), with equal
params: names, docs, defaults, types and kinds. Stated exceptions, each
listed below with its reason:

- one rename: ``XLAModel`` is the port's ``TorchModel``;
- the port's own params: ``device`` on the stages that run on a card
  (``DEVICE_STAGES``), and ``module`` (a ``torch.nn.Module``) on
  ``TorchModel`` and ``ImageFeaturizer``;
- ``PORT_DOCS``: params whose JAX doc describes JAX or TPU machinery
  (jit, XLA, HBM, mesh, SPMD, scan), which the port documents as it runs.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

import mmlspark_tpu.codegen as JG
import mmlspark_tpu_torch.codegen as PG
from mmlspark_tpu_torch.core.pipeline import STAGE_REGISTRY

ROOT = Path(__file__).resolve().parents[1]
REF = json.loads((ROOT / "docs" / "api" / "manifest.json").read_text())

RENAME = {"XLAModel": "TorchModel"}

# the stages whose port runs on a card by default, each with the port's
# ``device`` param (the JAX package places work on its mesh instead)
DEVICE_STAGES = (
    "AccessAnomaly", "AccessAnomalyModel", "CompiledPipeline", "ConditionalKNN",
    "ConditionalKNNModel", "ImageFeaturizer", "ImageLIME", "ImageSetAugmenter",
    "ImageTransformer", "IsolationForest", "IsolationForestModel", "KNN", "KNNModel",
    "LightGBMClassificationModel", "LightGBMClassifier", "LightGBMRanker",
    "LightGBMRankerModel", "LightGBMRegressionModel", "LightGBMRegressor",
    "LinearRegression", "LogisticRegression", "LogisticRegressionModel",
    "ResizeImageTransformer", "SAR", "SARModel", "SuperpixelTransformer", "TabularLIME",
    "TabularLIMEModel", "TorchModel", "UDFTransformer", "UnrollBinaryImage", "UnrollImage",
    "VowpalWabbitClassificationModel", "VowpalWabbitClassifier",
    "VowpalWabbitContextualBandit", "VowpalWabbitContextualBanditModel",
    "VowpalWabbitRegressionModel", "VowpalWabbitRegressor",
)
# ``module``: a torch.nn.Module to run, the alternative to ``apply_fn``
MODULE_STAGES = ("ImageFeaturizer", "TorchModel")

# (stage or "*", param): the JAX doc names JAX/TPU machinery the port has not
_GBDT = ("LightGBMClassifier", "LightGBMRegressor", "LightGBMRanker")
PORT_DOCS = {
    # XLA compiles / optimization barriers -> CUDA graphs, host-bound stages
    ("CompiledPipeline", "exact"), ("CompiledPipeline", "max_bucket"),
    # "bounds HBM"
    ("*", "index_chunk_size"),
    # jittable apply_fn, mesh padding, pytree variables
    ("ImageFeaturizer", "apply_fn"), ("TorchModel", "apply_fn"),
    ("TorchModel", "batch_size"), ("TorchModel", "input_dtype"),
    ("TorchModel", "variables"), ("TorchModel", "output_node"),
    # "lower to the sharded program", "(parity)", "no sockets on TPU",
    # "SPMD is the gang", "scan-fused": the port's voting and graph rounds
    *((s, p) for s in _GBDT for p in ("parallelism", "top_k", "default_listen_port",
                                      "use_barrier_execution_mode", "fused_rounds")),
    # jnp-traceable under jax.jit
    ("UDFTransformer", "jit_compatible"),
    # "1024 on TPU" per mesh shard
    ("*", "batch_size"),
}
# stages whose class docstring's first line (the R constructor's title)
# describes the port's own scoring: the JAX models inherit "A fitted
# transformer.", or name an MXU solve or a jitted kernel
PORT_CLASS_DOCS = (
    "LightGBMClassificationModel", "LightGBMRegressionModel", "LightGBMRankerModel",
    "LinearRegression", "VowpalWabbitClassificationModel", "VowpalWabbitRegressionModel",
)


@pytest.fixture(scope="module")
def manifest():
    return PG.generate_manifest()


def _port_name(name: str) -> str:
    return RENAME.get(name, name)


def test_every_jax_stage_has_its_counterpart(manifest):
    port = set(manifest["stages"])
    assert len(REF["stages"]) == len(port) == 131
    assert port == {_port_name(n) for n in REF["stages"]}
    assert manifest["version"] == REF["version"]


def _own(stage: str) -> set:
    return ({"device"} if stage in DEVICE_STAGES else set()) | \
        ({"module"} if stage in MODULE_STAGES else set())


@pytest.mark.parametrize("name", sorted(REF["stages"]))
def test_stage_params_equal_the_jax_packages(manifest, name):
    ref, port = REF["stages"][name], manifest["stages"][_port_name(name)]
    assert port["kind"] == ref["kind"]
    assert port["module"] == ref["module"].replace("mmlspark_tpu.", "mmlspark_tpu_torch.", 1) \
        or name in RENAME
    own = _own(port["name"])
    assert set(port["params"]) == set(ref["params"]) | own
    for pname, r in ref["params"].items():
        p = dict(port["params"][pname])
        if (port["name"], pname) in PORT_DOCS or ("*", pname) in PORT_DOCS:
            p["doc"] = r["doc"]
        assert p == r, (name, pname)


def test_device_params_are_the_ports_own(manifest):
    """Each names the card ('cuda') and the CPU as its choices."""
    for name in DEVICE_STAGES:
        p = manifest["stages"][name]["params"]["device"]
        assert "'cuda'" in p["doc"] and "'cpu'" in p["doc"] and p["type"] == "str", name
    assert {n for n, s in manifest["stages"].items() if "device" in s["params"]} == \
        set(DEVICE_STAGES)


def test_generated_smoke_tests_pass_on_the_port(tmp_path, manifest):
    path = PG.generate_smoke_tests(str(tmp_path / "test_generated_smoke.py"), manifest)
    spec = importlib.util.spec_from_file_location("generated_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert len(mod.CASES) == 131
    assert all(m.startswith("mmlspark_tpu_torch.") for m, _ in mod.CASES)
    for module, name in mod.CASES:
        mod.test_stage_surface(module, name)


def test_api_docs_generated(tmp_path, manifest):
    written = PG.generate_api_docs(str(tmp_path / "api"), manifest)
    text = (tmp_path / "api" / "models.md").read_text()
    assert "# `mmlspark_tpu_torch.models`" in text and "TorchModel" in text
    assert (tmp_path / "api" / "README.md").read_text().count("stages)") == len(written) - 1
    assert {Path(p).parent for p in written} == {tmp_path / "api"}


def _swap(text: str) -> str:
    return re.sub(r"\bmmlspark_tpu\b", "mmlspark_tpu_torch", text).replace(
        "mmlsparktpu", "mmlsparktputorch")


def _functions(text: str) -> dict:
    """R source split at each ``#' `` title line: {constructor: lines}."""
    funcs, cur = {}, []
    for line in text.splitlines():
        if line.startswith("#' ") and (not cur or cur[-1] == ""):
            cur = [line]
            funcs[len(funcs)] = cur
        else:
            cur.append(line)
    named = {}
    for lines in funcs.values():
        m = next((re.match(r"^(mt_\w+) <- function", ln) for ln in lines
                  if re.match(r"^(mt_\w+) <- function", ln)), None)
        named[m.group(1) if m else f"_{len(named)}"] = lines
    return named


def test_r_package_equals_the_jax_packages(tmp_path, manifest):
    """The port's live manifest, without its own params, writes the JAX
    package's R package (from the committed manifest) with the package
    name swapped; ``mt_xla_model`` is ``mt_torch_model``, and the titles
    of ``PORT_CLASS_DOCS`` describe the port's scoring."""
    own_free = json.loads(json.dumps(manifest, default=str))
    for name, info in own_free["stages"].items():
        for p in _own(name):
            info["params"].pop(p)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    JG.generate_r_package(str(jdir), REF)
    written = PG.generate_r_package(str(pdir), own_free)
    assert {Path(p).relative_to(pdir) for p in written} == \
        {p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file()}
    for rel in ("DESCRIPTION", "NAMESPACE", "R/core.R"):
        assert (pdir / rel).read_text() == _swap((jdir / rel).read_text()), rel
    assert "Package: mmlsparktputorch" in (pdir / "DESCRIPTION").read_text()
    titles = {PG._r_name(n) for n in PORT_CLASS_DOCS}
    for path in sorted((jdir / "R").glob("*.R")):
        if path.name == "core.R":
            continue
        want = _functions(_swap(path.read_text()))
        got = _functions((pdir / "R" / path.name).read_text())
        if "mt_xla_model" in want:
            w, g = want.pop("mt_xla_model"), got.pop("mt_torch_model")
            assert [ln.replace("xla_model", "torch_model").replace("XLAModel", "TorchModel")
                    for ln in w] == g
        assert set(got) == set(want), path.name
        for fn, lines in want.items():
            if fn in titles:
                assert got[fn][1:] == lines[1:], fn
            else:
                assert got[fn] == lines, fn
    # with its own params the port's constructors take ``device``
    PG.generate_r_package(str(tmp_path / "full"), manifest)
    src = (tmp_path / "full" / "R" / "models.R").read_text()
    assert re.search(r"^mt_light_gbm_classifier <- function\(.*device = \"cuda\"", src, re.M)


def test_registry_holds_only_the_ports_classes():
    for name, cls in STAGE_REGISTRY.items():
        if not name.startswith("_"):
            assert not cls.__module__.startswith("mmlspark_tpu."), name
