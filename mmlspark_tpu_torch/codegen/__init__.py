"""Binding/codegen layer (reference: codegen/, SURVEY.md §2.17).

The reference reflects over every ``Wrappable`` stage in the jar to
generate PySpark/SparklyR wrapper classes and wrapper smoke tests
(WrapperGenerator.scala:22-117). This framework is Python-native, so the
equivalent deliverables are:

- :func:`reflect_stage` / :func:`generate_manifest` — a machine-readable
  API surface (stage -> module, kind, params with docs/defaults/types),
  the wrapper-metadata analogue, consumed by doc generation and smoke
  tests and exported for external binding writers.
- :func:`generate_api_docs` — per-package markdown API reference.
- :func:`generate_smoke_tests` — a pytest file instantiating every
  registered stage with defaults and asserting param integrity (the
  PySparkWrapperTest analogue).

Like the reference (which runs codegen inside the build), these run in the
test suite: tests/test_torch_port_codegen.py regenerates everything and
asserts the registry is fully covered.

The PyTorch port's copy of ``mmlspark_tpu.codegen``: it reflects over the
port's own registry (modules under ``mmlspark_tpu_torch.``), and the R
package it writes imports ``mmlspark_tpu_torch`` through reticulate. Every
generator writes only where its caller points it.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import pkgutil
from typing import Any, Optional

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import (
    STAGE_REGISTRY,
    Estimator,
    Model,
    PipelineStage,
    Transformer,
)


def import_all_packages() -> None:
    """Import every mmlspark_tpu_torch module so STAGE_REGISTRY is complete."""
    import mmlspark_tpu_torch

    root = os.path.dirname(mmlspark_tpu_torch.__file__)
    for mod in pkgutil.walk_packages([root], prefix="mmlspark_tpu_torch."):
        name = mod.name
        if ".native" in name or name.endswith("__main__"):
            continue
        try:
            importlib.import_module(name)
        except Exception:
            # optional modules (native toolchains etc.) must not break codegen
            pass


def _stage_kind(cls: type) -> str:
    if issubclass(cls, Model):
        return "model"
    if issubclass(cls, Estimator):
        return "estimator"
    if issubclass(cls, Transformer):
        return "transformer"
    return "stage"


def reflect_stage(cls: type) -> dict:
    """One stage's wrapper metadata."""
    params = {}
    for name, p in cls.params().items():
        params[name] = {
            "doc": p.doc,
            "complex": bool(p.is_complex),
            "type": p.type_.__name__ if p.type_ is not None else None,
            "has_default": p.has_default(),
            "default": (
                p.default
                if p.has_default() and isinstance(p.default, (int, float, str, bool, type(None), list))
                else ("<complex>" if p.has_default() else None)
            ),
        }
    return {
        "name": cls.__name__,
        "module": cls.__module__,
        "kind": _stage_kind(cls),
        "doc": inspect.getdoc(cls) or "",
        "params": params,
    }


def generate_manifest() -> dict:
    """Full API manifest over the (fully imported) stage registry."""
    import_all_packages()
    stages = {
        name: reflect_stage(cls)
        for name, cls in sorted(STAGE_REGISTRY.items())
        # library stages only — the registry may also hold test-local stages
        if not name.startswith("_") and cls.__module__.startswith("mmlspark_tpu_torch.")
    }
    from mmlspark_tpu_torch.version import __version__

    return {"version": __version__, "stages": stages}


def _group_by_package(manifest: dict) -> dict:
    """stage infos grouped by their top-level mmlspark_tpu_torch subpackage —
    the one grouping rule docs and R bindings must share."""
    by_pkg: dict[str, list] = {}
    for info in manifest["stages"].values():
        pkg = info["module"].split(".")[1] if "." in info["module"] else info["module"]
        by_pkg.setdefault(pkg, []).append(info)
    return by_pkg


def generate_api_docs(out_dir: str, manifest: Optional[dict] = None) -> list:
    """Write one markdown file per package; returns written paths."""
    manifest = manifest or generate_manifest()
    by_pkg = _group_by_package(manifest)

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for pkg, stages in sorted(by_pkg.items()):
        path = os.path.join(out_dir, f"{pkg}.md")
        lines = [f"# `mmlspark_tpu_torch.{pkg}`", ""]
        for info in sorted(stages, key=lambda s: s["name"]):
            lines.append(f"## {info['name']}  *({info['kind']})*")
            lines.append("")
            if info["doc"]:
                lines.append(info["doc"])
                lines.append("")
            if info["params"]:
                lines.append("| param | type | default | doc |")
                lines.append("|---|---|---|---|")
                for pname, p in sorted(info["params"].items()):
                    t = p["type"] or ("complex" if p["complex"] else "any")
                    d = repr(p["default"]) if p["has_default"] else "required"
                    doc = (p["doc"] or "").replace("|", "\\|")
                    lines.append(f"| `{pname}` | {t} | {d} | {doc} |")
                lines.append("")
        with open(path, "w") as f:
            f.write("\n".join(lines))
        written.append(path)
    index = os.path.join(out_dir, "README.md")
    with open(index, "w") as f:
        f.write("# mmlspark_tpu_torch API reference (generated)\n\n")
        f.write(f"{len(manifest['stages'])} stages.\n\n")
        for pkg in sorted(by_pkg):
            f.write(f"- [{pkg}]({pkg}.md) ({len(by_pkg[pkg])} stages)\n")
    written.append(index)
    return written


def generate_smoke_tests(out_path: str, manifest: Optional[dict] = None) -> str:
    """Emit a pytest module that default-constructs every stage and checks
    params round-trip through explain_params (PySparkWrapperTest analogue)."""
    manifest = manifest or generate_manifest()
    lines = [
        '"""GENERATED by mmlspark_tpu_torch.codegen - do not edit."""',
        "import importlib",
        "import pytest",
        "",
        "CASES = [",
    ]
    for name, info in sorted(manifest["stages"].items()):
        lines.append(f"    ({info['module']!r}, {name!r}),")
    lines += [
        "]",
        "",
        "",
        "@pytest.mark.parametrize('module,name', CASES)",
        "def test_stage_surface(module, name):",
        "    cls = getattr(importlib.import_module(module), name)",
        "    stage = cls()  # every stage must be default-constructible",
        "    assert stage.explain_params() is not None",
        "    for pname, p in cls.params().items():",
        "        assert p.name == pname",
        "",
    ]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    return out_path


def write_manifest(out_path: str, manifest: Optional[dict] = None) -> str:
    manifest = manifest or generate_manifest()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    return out_path


def _r_name(stage_name: str) -> str:
    """CamelCase stage -> mt_snake_case R constructor (the reference's
    SparklyRWrapper emits ml_/ft_-prefixed R functions the same way)."""
    import re as _re

    # acronym-aware camel -> snake: LightGBMClassifier -> light_gbm_classifier
    s = _re.sub(
        r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])", "_", stage_name
    ).lower()
    return f"mt_{s}"


def _r_default(p: dict) -> str:
    """Python param default -> R literal. Ints carry the L suffix so
    reticulate passes Python ints (a bare 0 is an R double -> float, which
    int-typed Params reject); non-scalar defaults (recorded by
    reflect_stage as the "<complex>" placeholder) become NULL so the
    python-side default applies."""
    if not p["has_default"] or p["complex"]:
        return "NULL"
    v = p["default"]
    if v is None or v == "<complex>":
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, int):
        return f"{v}L"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        if not v:
            return "list()"
        return "list(" + ", ".join(_r_default({"has_default": True, "complex": False, "default": x}) for x in v) + ")"
    return "NULL"


def generate_r_package(out_dir: str, manifest: Optional[dict] = None) -> list:
    """Generate an R binding package (reticulate-backed) from the manifest.

    The reference generates its R wrappers from Scala reflection
    (SparklyRWrapper.scala:22-117); here the SAME stage registry that
    feeds the manifest and docs emits one R constructor per stage:

        model <- mt_lightgbm_classifier(num_iterations = 50L)$fit(df)

    Each function imports the stage's python module through reticulate and
    forwards its (defaulted) arguments; NULL arguments are dropped so
    python defaults apply. Returns the written paths."""
    manifest = manifest or generate_manifest()
    os.makedirs(os.path.join(out_dir, "R"), exist_ok=True)
    written = []

    with open(os.path.join(out_dir, "DESCRIPTION"), "w") as f:
        f.write(
            "Package: mmlsparktputorch\n"
            "Type: Package\n"
            "Title: R bindings for the mmlspark_tpu_torch framework\n"
            f"Version: {manifest['version']}\n"
            "Description: Generated reticulate-backed wrappers for every\n"
            "    registered pipeline stage (one constructor per stage).\n"
            "Imports: reticulate\n"
            "License: MIT\n"
        )
    written.append(os.path.join(out_dir, "DESCRIPTION"))
    with open(os.path.join(out_dir, "NAMESPACE"), "w") as f:
        f.write('exportPattern("^mt_")\nexport(mt_data_frame)\n')
    written.append(os.path.join(out_dir, "NAMESPACE"))

    core = [
        "# Generated by mmlspark_tpu_torch.codegen.generate_r_package — do not edit.",
        "",
        "#' Build a mmlspark_tpu_torch DataFrame from a named list of vectors/arrays",
        "#' @export",
        "mt_data_frame <- function(columns, num_partitions = NULL) {",
        '  core <- reticulate::import("mmlspark_tpu_torch")',
        "  if (is.null(num_partitions)) core$DataFrame$from_dict(columns)",
        "  else core$DataFrame$from_dict(columns, num_partitions = as.integer(num_partitions))",
        "}",
        "",
        "#' Transform a DataFrame with a (fitted) stage",
        "#' (src/main/R/ml_utils.R sdf_transform analogue)",
        "#' @export",
        "mt_transform <- function(stage, df, ...) {",
        "  stage$transform(df, ...)",
        "}",
        "",
        "#' Fit an estimator on a DataFrame, returning the fitted model",
        "#' (src/main/R/ml_utils.R sdf_fit analogue)",
        "#' @export",
        "mt_fit <- function(estimator, df, ...) {",
        "  estimator$fit(df, ...)",
        "}",
        "",
        "#' Model zoo downloader (src/main/R/model_downloader.R",
        "#' smd_model_downloader analogue). Without server_url: the local",
        "#' repo client ($list_models(), $download_by_name(name)); with",
        "#' server_url: a RemoteRepository syncing into that local repo.",
        "#' @export",
        "mt_model_downloader <- function(local_path, server_url = NULL) {",
        '  d <- reticulate::import("mmlspark_tpu_torch.downloader")',
        "  local <- d$ModelDownloader(local_path)",
        "  if (is.null(server_url)) local",
        "  else d$RemoteRepository(server_url, local)",
        "}",
        "",
    ]
    with open(os.path.join(out_dir, "R", "core.R"), "w") as f:
        f.write("\n".join(core))
    written.append(os.path.join(out_dir, "R", "core.R"))

    by_pkg = _group_by_package(manifest)
    for pkg, stages in sorted(by_pkg.items()):
        lines = [
            "# Generated by mmlspark_tpu_torch.codegen.generate_r_package — do not edit.",
            "",
        ]
        for info in sorted(stages, key=lambda s: s["name"]):
            fn = _r_name(info["name"])
            params = sorted(info["params"].items())
            sig = ", ".join(f"{n} = {_r_default(p)}" for n, p in params)
            doc1 = (info["doc"] or info["name"]).splitlines()[0].replace("'", "")
            lines += [
                f"#' {doc1}",
                f"#' ({info['kind']}: mmlspark_tpu_torch.{info['module'].split('.', 1)[-1]}.{info['name']})",
                "#' @export",
                f"{fn} <- function({sig}) {{",
                "  # snapshot formals BEFORE any local assignment leaks in",
                "  args <- as.list(environment())",
                "  args <- args[!vapply(args, is.null, logical(1))]",
                f'  m <- reticulate::import("{info["module"]}")',
                f'  do.call(m${info["name"]}, args)',
                "}",
                "",
            ]
        path = os.path.join(out_dir, "R", f"{pkg}.R")
        with open(path, "w") as f:
            f.write("\n".join(lines))
        written.append(path)
    return written
